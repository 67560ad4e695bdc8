"""R1: the eval decode's tail, short-side bicubic resize and centre crop,
bit for bit as PIL computes them, as a CUDA kernel and its plain version.

It replaces the host PIL step of ``hmmc_tpu/data/datasets.py:36-61``
(``_decode_eval``): after the JPEG's IDCT, libjpeg's chroma upsampling and
colour conversion (what ``Image.open().convert("RGB")`` does past the
IDCT), then a resize of the short side to ``res`` (the long side to
``round(long * res / short)``, Python's ``round``) with ``Image.BICUBIC``,
and a crop of the centre at ``(n - res) // 2``. It is not a TPU kernel: the
JAX package runs this step on the host.

Frames come as interleaved RGB ``[H, W, 3]`` or as a JPEG's components as
encoded (:class:`YccFrame`: Y, and Cb and Cr at any of the samplings in
:data:`SAMPLING`, or Y alone; or, by its ``color`` (:data:`COLORS`), the
three planes of an RGB-coded JPEG or the four of a CMYK or YCCK one, the
fourth at full size). :func:`ycc_to_rgb_reference` does libjpeg's and
PIL's part: ``jdsample.c``'s upsampling, "fancy" where libjpeg is (h2v2,
h2v1 and h1v2: 3/4 of the nearer and 1/4 of the farther chroma sample
along each halved axis, edges replicated, libjpeg's alternating
rounding), replication elsewhere (4:4:4, 4:1:1, 4:1:0, and chroma two
samples wide or less under a halved width), then the colour conversion
``Image.open().convert("RGB")`` ends with: ``jdcolor.c``'s 16-bit
fixed-point ``ycc_rgb_convert`` for YCbCr; none for RGB planes; for CMYK
(Adobe's inverted planes) and YCCK (``ycck_cmyk_convert`` first), Pillow's
``cmyk2rgb``, ``k - k * c / 255`` rounded as its ``MULDIV255``, where k is
the stored fourth plane and c the ink. Pillow's 8-bit
resampler (``libImaging/Resample.c``) is two separable passes, horizontal
into a uint8 intermediate, then vertical. Each output pixel's taps come
from a bicubic filter (a = -0.5, support 2, widened by the downscale
factor), computed in double, normalised, and turned into int32 fixed point
with 22 fractional bits; a sum starts at ``1 << 21`` and is clipped to
0..255 after ``>> 22``. :func:`pil_coeffs` reproduces those tables in
Python doubles (the same operations in the same order), so the kernel and
:func:`resize_crop_reference` do integer arithmetic only and agree with
Pillow and with each other bit for bit.

The kernel (``csrc/resize_crop.cu``) is bound by bytes: the planes the
crop reads, once, and the crop written once. Pillow's taps are exact
integers, so the kernel runs them on the int8 tensor cores: each tap splits
into three byte limbs (:func:`limbs`) and each pass into three banded
integer matrix products whose int32 sums recombine into Pillow's sum bit
for bit; :func:`mma_tables` lays the limbs out as the fragments the
kernel's lanes load. One launch covers a whole batch of frames (arrays of
plane pointers, pitches, formats and geometries); persistent CTAs walk the
(frame, column strip, band of output rows) items, staging, converting and
filtering 16 source rows at a time, and write the ``[N, res, res, 3]``
output. Padded slots are zero-filled.

Device rule: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise. ``resize_crop.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

PRECISION_BITS = 22
CHUNK = 16                 # source rows a CTA stages and filters at once
# shared memory of a CTA: column strips narrow until a CTA fits, so that
# two (the most 128 registers a thread allow) share an SM (the path's
# 341x256 -> 224 takes ~77 KB)
SMEM_LIMIT = 100 * 1024
HEAD_WORDS = 16            # the descriptor's head, then 8 words a geometry
GEOM_WORDS = 8
_BICUBIC_SUPPORT = 2.0
FORMATS = {"rgb": 0, "ycc420": 1, "ycc444": 2, "gray": 3, "ycc422": 4,
           "ycc440": 5, "ycc411": 6, "ycc410": 7}
# what a three- or four-plane frame's planes hold (libjpeg's
# jpeg_color_space): YCbCr, RGB as coded (Adobe transform 0), CMYK (Adobe's
# inverted ink), YCCK (Adobe transform 2)
COLORS = {"ycc": 0, "rgb": 1, "cmyk": 2, "ycck": 3}
# chroma subsampling (horizontal, vertical factor) of each YCbCr format
SAMPLING = {FORMATS["ycc444"]: (1, 1), FORMATS["ycc422"]: (2, 1),
            FORMATS["ycc411"]: (4, 1), FORMATS["ycc440"]: (1, 2),
            FORMATS["ycc420"]: (2, 2), FORMATS["ycc410"]: (4, 2)}
PADDED = -1
# hf + 16 vf by format + 1 (0 for padded, RGB and grey slots)
_SAMPLING_WORD = np.array([0] + [hf + 16 * vf for hf, vf in (
    SAMPLING.get(f, (0, 0)) for f in range(8))], np.int64)


def chroma_format(w: int, h: int, cw: int, ch: int) -> Optional[int]:
    """The YCbCr format whose chroma planes are ``cw`` x ``ch`` for a
    ``w`` x ``h`` frame (libjpeg's ceil(w / factor)), or ``None``. Where
    two factors give the same size, every one of them upsamples alike."""
    hf = next((f for f in (1, 2, 4) if -(-w // f) == cw), None)
    vf = next((f for f in (1, 2) if -(-h // f) == ch), None)
    return next((k for k, s in SAMPLING.items() if s == (hf, vf)), None)


def output_size(w: int, h: int, res: int) -> Tuple[int, int]:
    """(new width, new height) of ``_decode_eval``'s short-side resize."""
    if w <= h:
        return res, max(res, round(h * res / w))
    return max(res, round(w * res / h)), res


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def pil_coeffs(in_size: int, out_size: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a
    full-extent box: per output index the first source index, the tap count
    and the int32 taps ``[out_size, ksize]`` (zero past the count)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int32)
    count = np.zeros(out_size, np.int32)
    taps = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x in range(xmax):
            v = w[x] / ww if ww != 0.0 else w[x]
            taps[xx, x] = int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
        first[xx], count[xx] = xmin, xmax
    return first, count, taps


@dataclasses.dataclass(frozen=True)
class CropTables:
    """The taps one source geometry needs for one ``res``: horizontal for
    the cropped columns, vertical for the cropped rows."""

    w: int
    h: int
    res: int
    x_first: np.ndarray    # [res] first source column of each output column
    x_count: np.ndarray
    x_taps: np.ndarray     # [res, kh]
    y_first: np.ndarray    # [res] first source row of each output row
    y_count: np.ndarray
    y_taps: np.ndarray     # [res, kv]

    @property
    def staged_cols(self) -> Tuple[int, int]:
        """First and end source column of the cropped output columns."""
        return (int(self.x_first[0]),
                int(self.x_first[-1] + self.x_count[-1]))


@functools.lru_cache(maxsize=64)
def crop_tables(w: int, h: int, res: int) -> CropTables:
    """Taps for a ``w`` x ``h`` source, cached: frames of one store share a
    size."""
    nw, nh = output_size(w, h, res)
    left, top = (nw - res) // 2, (nh - res) // 2
    xf, xc, xt = pil_coeffs(w, nw)
    yf, yc, yt = pil_coeffs(h, nh)
    sl, st = slice(left, left + res), slice(top, top + res)
    return CropTables(w, h, res, xf[sl].copy(), xc[sl].copy(),
                      np.ascontiguousarray(xt[sl]), yf[st].copy(),
                      yc[st].copy(), np.ascontiguousarray(yt[st]))


def limbs(taps: np.ndarray) -> np.ndarray:
    """int taps in [-2^23, 2^23) -> uint8 ``[3, *taps.shape]``: the byte
    limbs t0 and t1 (unsigned) and t2 (signed, stored as its byte), with
    ``t = t0 + 2^8 t1 + 2^16 t2``."""
    t = np.asarray(taps, np.int64)
    if t.size and (t.min() < -(1 << 23) or t.max() >= 1 << 23):
        raise ValueError("a tap outside [-2^23, 2^23) does not split into "
                         "three byte limbs")
    return np.stack([t & 255, (t >> 8) & 255, (t >> 16) & 255]
                    ).astype(np.uint8)


def _band(first: np.ndarray, count: np.ndarray, taps: np.ndarray,
          tile: int):
    """Per tile of ``tile`` outputs: the first source index its taps reach,
    rounded down to 4 (the band's base), the end of what they reach, and the
    taps as a dense band [n_tiles, tile, 32 * ks] from the base (zero
    outside each output's own taps), ks k-steps of 32."""
    n = len(first)
    n_t = -(-n // tile)
    last = np.minimum(np.arange(n_t) * tile + tile, n) - 1
    base = first[::tile].astype(np.int64) // 4 * 4    # first is monotone
    end = (first[last] + count[last]).astype(np.int64)
    ks = int(-(-int((end - base).max()) // 32))
    dense = np.zeros((n_t, tile, 32 * ks), np.int64)
    for o in range(n):
        i, m = divmod(o, tile)
        off = int(first[o] - base[i])
        dense[i, m, off:off + int(count[o])] = taps[o, :int(count[o])]
    return base, end, ks, dense


def _a_fragments(dense: np.ndarray) -> np.ndarray:
    """Dense bands [n, 16, 32 ks] -> their limbs as the A operand of
    ``mma.sync.m16n8k32`` (.u8 / .s8, row) loads them: uint32 [n, ks, 3
    limbs, 32 lanes, 4]; lane = 4 g + t, word 2 kw + mw holds row g + 8 mw,
    k = 32 s + 16 kw + 4 t + (0..3), byte i element i."""
    n, _, k = dense.shape
    a = limbs(dense).reshape(3, n, 2, 8, k // 32, 2, 4, 4)
    a = np.ascontiguousarray(a.transpose(1, 4, 0, 3, 6, 5, 2, 7))
    return a.view(np.uint32).reshape(n, k // 32, 3, 32, 4)


@dataclasses.dataclass(frozen=True)
class MmaTables:
    """R1's taps as its tensor-core passes take them, for one geometry: per
    tile of 16 output columns (horizontal) or rows (vertical), the band's
    first source column or row ``kb_*`` (a multiple of 4) and the taps as a
    dense band ``band_*`` [n_t, 16, 32 ks_*] from it; ``xend_h``: the end of
    the columns a tile's taps reach; [``ylo``, ``yhi``): the rows an
    m-tile's taps reach. A pass is three products, one per byte limb
    (:func:`limbs`), of the band with the pixels (int32 sums, exact),
    recombined as ``S0 + 2^8 S1 + 2^16 S2``."""

    kb_h: np.ndarray
    xend_h: np.ndarray
    ks_h: int
    band_h: np.ndarray
    kb_v: np.ndarray
    ylo: np.ndarray
    yhi: np.ndarray
    ks_v: int
    band_v: np.ndarray

    def fragments(self) -> Tuple[np.ndarray, np.ndarray]:
        """Both bands' limbs as A fragments (:func:`_a_fragments`)."""
        return _a_fragments(self.band_h), _a_fragments(self.band_v)

    def packed(self) -> np.ndarray:
        """int32 [kb_h, xend_h, kb_v, ylo, yhi, pad to 4, horizontal and
        vertical fragments], the kernel's layout."""
        head = np.concatenate([self.kb_h, self.xend_h, self.kb_v, self.ylo,
                               self.yhi]).astype(np.int32)
        head = np.concatenate([head, np.zeros(-len(head) % 4, np.int32)])
        ah, av = self.fragments()
        return np.concatenate([head, ah.ravel().view(np.int32),
                               av.ravel().view(np.int32)])


@functools.lru_cache(maxsize=64)
def mma_tables(w: int, h: int, res: int) -> MmaTables:
    """:func:`crop_tables` as banded limb fragments, cached per size."""
    t = crop_tables(w, h, res)
    kb_h, xend_h, ks_h, band_h = _band(t.x_first, t.x_count, t.x_taps, 16)
    kb_v, yhi, ks_v, band_v = _band(t.y_first, t.y_count, t.y_taps, 16)
    return MmaTables(kb_h, xend_h, ks_h, band_h, kb_v,
                     t.y_first[::16].astype(np.int64), yhi, ks_v, band_v)


def _gather_taps(first: np.ndarray, taps: np.ndarray, limit: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    idx = first[:, None] + np.arange(taps.shape[1])[None, :]
    return (torch.from_numpy(np.minimum(idx, limit - 1)).long().to(device),
            torch.from_numpy(taps).to(device))


@dataclasses.dataclass(frozen=True)
class YccFrame:
    """A JPEG's components as encoded: ``y`` [H, W], ``cb`` and ``cr`` of
    one size, [ceil(H / vf), ceil(W / hf)] for a sampling (hf, vf) of
    :data:`SAMPLING`, or both ``None`` (grayscale). ``color`` names what
    the planes hold (:data:`COLORS`): for "rgb" they are R, G and B, for
    "cmyk" and "ycck" ``k`` is the fourth plane, [H, W] with ``y``'s
    pitch. uint8; rows may be padded to a pitch."""

    y: torch.Tensor
    cb: Optional[torch.Tensor] = None
    cr: Optional[torch.Tensor] = None
    k: Optional[torch.Tensor] = None
    color: str = "ycc"

    @property
    def fmt(self) -> int:
        h, w = self.y.shape
        if self.cb is None:
            return FORMATS["gray"]
        fmt = chroma_format(w, h, self.cb.shape[1], self.cb.shape[0])
        if fmt is None or self.cr.shape != self.cb.shape:
            raise ValueError(
                f"chroma {tuple(self.cb.shape)} and {tuple(self.cr.shape)} "
                f"for luma {(h, w)}: no sampling of {sorted(SAMPLING.values())}"
                f" (horizontal, vertical) gives them")
        return fmt


def _upsample(c: torch.Tensor, h: int, w: int, hf: int, vf: int
              ) -> torch.Tensor:
    """jdsample.c's upsampling of one chroma plane to [h, w] (int32).
    h2v2, h2v1 (chroma wider than 2) and h1v2 are fancy: 3/4 nearer + 1/4
    farther sample along each halved axis, the neighbour past an edge
    replicated (libjpeg's context rows and end columns), rounding 8 / 7
    (h2v2) or 1 / 2 (one axis); every other sampling replicates."""
    ch, cw = c.shape
    c = c.to(torch.int32)
    y = torch.arange(h, device=c.device)
    x = torch.arange(w, device=c.device)
    cy, cx = y // vf, x // hf
    fancy_h = hf == 2 and vf <= 2 and cw > 2
    fancy_v = vf == 2 and (hf == 1 or fancy_h)
    rows = c[cy]                                            # [h, cw]
    if not (fancy_h or fancy_v):
        return rows[:, cx]
    if fancy_v:
        oy = torch.where(y & 1 == 1, cy + 1, cy - 1).clamp(0, ch - 1)
        rows = 3 * rows + c[oy]
        if not fancy_h:
            return (rows[:, cx] + torch.where(y & 1 == 1, 2, 1)[:, None]) >> 2
    ox = torch.where(x & 1 == 1, cx + 1, cx - 1).clamp(0, cw - 1)
    rnd = (torch.where(x & 1 == 1, 7, 8) if fancy_v
           else torch.where(x & 1 == 1, 2, 1)).to(torch.int32)
    return (3 * rows[:, cx] + rows[:, ox] + rnd) >> (4 if fancy_v else 2)


def _muldiv255(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pillow's MULDIV255: a * b / 255, rounded its way."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def ycc_to_rgb_reference(f: YccFrame, cmyk: str = "pil") -> torch.Tensor:
    """libjpeg's and PIL's output for decoded components: uint8 [H, W, 3]
    (plain version of R1's stage 0). ``cmyk="cv2"`` ends a CMYK or YCCK
    frame with OpenCV's ``icvCvt_CMYK2BGR``, ``k - ((ink * k) >> 8)``,
    in place of Pillow's ``cmyk2rgb`` (R2's stage 0)."""
    h, w = f.y.shape
    y = f.y.to(torch.int32)
    if f.fmt == FORMATS["gray"]:
        return f.y.unsqueeze(-1).expand(h, w, 3).contiguous()
    hf, vf = SAMPLING[f.fmt]
    cb, cr = _upsample(f.cb, h, w, hf, vf), _upsample(f.cr, h, w, hf, vf)
    if f.color in ("rgb", "cmyk"):
        rgb = torch.stack([y, cb, cr], -1)
        if f.color == "rgb":
            return rgb.to(torch.uint8)
        ink = 255 - rgb
    else:
        xb, xr = cb - 128, cr - 128
        r = y + ((91881 * xr + 32768) >> 16)
        g = y + ((-22554 * xb + 32768 - 46802 * xr) >> 16)
        b = y + ((116130 * xb + 32768) >> 16)
        rgb = torch.stack([r, g, b], -1).clamp_(0, 255)
        if f.color == "ycc":
            return rgb.to(torch.uint8)
        # ycck_cmyk_convert gives 255 - rgb, which Pillow reads inverted
        ink = rgb
    k = f.k.to(torch.int32).unsqueeze(-1)
    part = (ink * k) >> 8 if cmyk == "cv2" else _muldiv255(ink, k)
    return (k - part).clamp_(0, 255).to(torch.uint8)


def resize_crop_reference(frames: torch.Tensor, res: int) -> torch.Tensor:
    """Plain version of R1: uint8 ``[N, H, W, 3]`` frames of one size ->
    ``[N, res, res, 3]``, with the kernel's int32 arithmetic (gathers over
    the tap tables; taps past a count are zero)."""
    n, h, w, _ = frames.shape
    t = crop_tables(w, h, res)
    y0 = int(t.y_first[0])
    y1 = int(t.y_first[-1] + t.y_count[-1])
    x_idx, x_taps = _gather_taps(t.x_first, t.x_taps, w, frames.device)
    y_idx, y_taps = _gather_taps(t.y_first - y0, t.y_taps, y1 - y0,
                                 frames.device)
    src = frames[:, y0:y1].to(torch.int32)              # [N, R, W, 3]
    rnd = 1 << (PRECISION_BITS - 1)
    acc = (src[:, :, x_idx] * x_taps[None, None, :, :, None]).sum(3) + rnd
    tmp = (acc >> PRECISION_BITS).clamp_(0, 255)        # [N, R, res, 3]
    acc = (tmp[:, y_idx] * y_taps[None, :, :, None, None]).sum(2) + rnd
    return (acc >> PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from hmmc_tpu_torch.ops import kernel_build

    lib = kernel_build.load("resize_crop")
    lib.hmmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hmmc_cuda_error_string.restype = ctypes.c_char_p
    lib.hmmc_resize_crop_ctas.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.hmmc_resize_crop_ctas.restype = ctypes.c_int
    lib.hmmc_resize_crop.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.hmmc_resize_crop.restype = ctypes.c_int
    return lib


_device_tables: Dict[tuple, torch.Tensor] = {}


def tables_on(device: torch.device, key: tuple,
              packed: Callable[[], np.ndarray]) -> torch.Tensor:
    """A geometry's int32 table on ``device``, uploaded once and kept:
    launches point into it. The upload is synchronous, so a launch on any
    stream may read the table."""
    key = (device.type, device.index, *key)
    dev = _device_tables.get(key)
    if dev is None:
        dev = torch.from_numpy(packed()).to(device)
        _device_tables[key] = dev
    return dev


def upload(head: np.ndarray, rows: np.ndarray, device: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A launch's descriptor (``head`` then ``rows``) on the card without
    stalling the host: written into pinned memory and copied on the current
    stream (PyTorch's caching host allocator keeps the pinned block until
    the copy is done). Returns the host and device copies."""
    host = torch.empty(head.size + rows.size, dtype=torch.int64,
                       pin_memory=True)
    words = host.numpy()
    words[:head.size] = head
    words[head.size:] = rows.ravel()
    return host, host.to(device, non_blocking=True)


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


def _pitch16(x: int) -> int:
    """The least pitch >= x that is 16 mod 32 bytes: eight rows of 32-bit
    loads at one column fall in eight banks apart."""
    p = _roundup(x, 16)
    return p if p % 32 == 16 else p + 16


def raw_bound(fmt: int, four: bool, rows: int, cols: int) -> int:
    """Bytes of stage 0's buffer for ``rows`` x ``cols`` luma pixels of a
    frame of format ``fmt`` (with a fourth plane where ``four``), as
    ``csrc/jpeg_planes.cuh``'s layout bounds them: a plane of S bytes a row
    takes roundup(S, 16) + 16 (16-byte aligned copies), chroma (rows >> vs)
    + 4 rows of (cols >> hs) + 7 samples; 16 bytes beyond the last row
    (the 4:2:0 path reads chroma a word past a row's end)."""
    def plane(r, nbytes):
        return r * (_roundup(nbytes, 16) + 16)

    if fmt in (FORMATS["rgb"], FORMATS["gray"]):
        return plane(rows, cols * (3 if fmt == FORMATS["rgb"] else 1)) + 16
    hf, vf = SAMPLING[fmt]
    return (plane(rows, cols) * (2 if four else 1)
            + 2 * plane((rows >> (vf >> 1)) + 4, (cols >> (hf >> 1)) + 7)
            + 16)


def frame_kinds(batch: "PlaneBatch") -> Tuple[Tuple[int, bool], ...]:
    """The (format, fourth plane) pairs the batch's real slots hold."""
    codes = batch.fmt + 1                  # padded slots count at 0
    if batch.color is not None:
        codes = codes + 8 * (batch.color >= COLORS["cmyk"])
    found = np.flatnonzero(np.bincount(codes, minlength=17)[1:])
    return tuple((int(c % 8), bool(c >= 8)) for c in found)


def geometries(batch: "PlaneBatch") -> Tuple[tuple, np.ndarray]:
    """The distinct (w, h) of the batch's real slots and each slot's index
    among them (0 for padded slots)."""
    keys = batch.w * 65536 + batch.h       # 0 for padded slots
    lo, hi = keys.min(), keys.max()
    if hi == 0:
        return (), np.zeros(len(keys), np.int64)
    if lo == hi or (lo == 0 and (keys[keys != 0] == hi).all()):
        uniq, geom = [hi], np.zeros(len(keys), np.int64)   # one size
    else:
        real = batch.fmt != PADDED
        uniq, inv = np.unique(keys[real], return_inverse=True)
        geom = np.zeros(len(keys), np.int64)
        geom[real] = inv
    return tuple((int(k // 65536), int(k % 65536)) for k in uniq), geom


def frame_rows(batch: "PlaneBatch", geom: np.ndarray) -> np.ndarray:
    """The kernels' 10 int64 words a slot (``csrc/jpeg_planes.cuh``)."""
    zero = np.zeros(len(batch.fmt), np.int64)
    return np.stack([batch.p0, batch.pitch0, geom, batch.fmt, batch.p1,
                     batch.p2, batch.pitch1, batch.sampling,
                     zero if batch.color is None else batch.color,
                     zero if batch.p3 is None else batch.p3], axis=1)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch shape's layout: 16-column tiles per strip, the ring of
    intermediate rows and its pitch, the pitches of the RGB planes and of
    the output tile's interleaved rows, shared-memory regions (stage 0's
    buffer, twice; the RGB planes, twice, either also the output tile; the
    ring) and their sum."""

    strip_ct: int
    n_strips: int
    ring: int
    ring_pitch: int
    rgb_pitch: int
    tile_pitch: int
    raw_bytes: int
    rgb_bytes: int
    smem: int


@functools.lru_cache(maxsize=256)
def plan(sizes: tuple, res: int, kinds: tuple) -> Plan:
    """The layout for frames of ``sizes`` and ``kinds`` at ``res``: column
    strips as wide as a CTA of at most :data:`SMEM_LIMIT` bytes allows; the
    ring holds an m-tile's rows and a chunk besides (and a k-window)."""
    tabs = [mma_tables(w, h, res) for w, h in sizes]
    n_t = -(-res // 16)
    span = max([int((t.yhi - t.ylo).max()) for t in tabs] + [0])
    ks_v = max([t.ks_v for t in tabs] + [1])
    ring = _roundup(max(span + CHUNK - 1, 32 * ks_v), 4)
    ring_pitch = _pitch16(ring)
    strip_ct = n_t
    while True:
        n_strips = -(-n_t // strip_ct)
        reach, cols = 16, 0
        for t, (w, _) in zip(tabs, sizes):
            for j0 in range(0, n_t, strip_ct):
                j1 = min(j0 + strip_ct, n_t)
                xo = int(t.kb_h[j0]) & ~15
                xe = min(int(t.xend_h[j1 - 1]), w)
                # the taps' k-windows, and the 8-pixel units stage 0 writes
                reach = max(reach, int(t.kb_h[j1 - 1]) + 32 * t.ks_h - xo,
                            _roundup(xe, 8) - xo)
                cols = max(cols, xe - xo)
        rgb_pitch = _pitch16(reach)
        tile_pitch = _pitch16(3 * 16 * strip_ct)      # interleaved RGB
        raw = max([raw_bound(f, four, CHUNK, cols) for f, four in kinds]
                  + [0])
        rgb_bytes = _roundup(max(3 * CHUNK * rgb_pitch,
                                 16 * tile_pitch + 16), 16)
        smem = 2 * raw + 2 * rgb_bytes + 3 * 16 * strip_ct * ring_pitch
        if smem <= SMEM_LIMIT or strip_ct == 1:
            return Plan(strip_ct, n_strips, ring, ring_pitch, rgb_pitch,
                        tile_pitch, raw, rgb_bytes, smem)
        strip_ct = -(-strip_ct // 2)


def bands(items: int, n_tiles: int, ctas: int) -> int:
    """Tiles of output rows per band (R1's m-tiles, R2's tiles): whole
    frames, unless ``items`` (frames, or frames x strips) would leave CTAs
    of the persistent grid idle; then halved bands until they do not, or a
    band is one tile."""
    n = 1
    while items * n < ctas and n < n_tiles:
        n *= 2
    return -(-n_tiles // n)


@dataclasses.dataclass
class PlaneBatch:
    """A batch of frames for the kernel, one entry per slot: plane
    pointers and pitches, ``fmt`` (:data:`FORMATS`, or :data:`PADDED`),
    the frame's width and height, and what a three- or four-plane slot's
    planes hold (``color``, :data:`COLORS`). ``keep`` holds the tensors
    the pointers point into."""

    p0: np.ndarray
    pitch0: np.ndarray
    fmt: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    pitch1: np.ndarray
    w: np.ndarray
    h: np.ndarray
    keep: list
    color: Optional[np.ndarray] = None     # COLORS; None: every slot YCbCr
    p3: Optional[np.ndarray] = None        # the fourth plane (y's pitch)
    # what every launch over the batch reads, made once with the batch: the
    # distinct (w, h) (:func:`geometries`), the (format, fourth plane) pairs
    # (:func:`frame_kinds`) and the kernels' 10 words a slot
    sizes: tuple = dataclasses.field(init=False)
    kinds: tuple = dataclasses.field(init=False)
    rows: np.ndarray = dataclasses.field(init=False)

    def __post_init__(self):
        self.sizes, geom = geometries(self)
        self.kinds = frame_kinds(self)
        self.rows = frame_rows(self, geom)

    @property
    def sampling(self) -> np.ndarray:
        """The kernel's word for each slot's chroma factors, hf + 16 vf."""
        return _SAMPLING_WORD[self.fmt + 1]


Frame = Union[torch.Tensor, YccFrame, None]


def _check_plane(i: int, name: str, t: torch.Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"frame {i} {name} is on {t.device}, the batch on "
                         f"{device}")
    if t.dtype != torch.uint8:
        raise TypeError(f"frame {i} {name}: resize_crop takes uint8 planes; "
                        f"got {t.dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"frame {i} {name}: rows must be packed "
                         f"(unit stride); got strides {t.stride()}")


def _check_frame(i: int, f: Frame, device: torch.device) -> None:
    if isinstance(f, YccFrame):
        f.fmt  # noqa: B018  (raises on an unsupported subsampling)
        if f.color not in COLORS or (f.cb is None and f.color != "ycc"):
            raise ValueError(f"frame {i}: colour {f.color!r} of "
                             f"{'one plane' if f.cb is None else 'planes'}")
        if (f.k is not None) != (f.color in ("cmyk", "ycck")) or (
                f.k is not None and (f.k.shape != f.y.shape
                                     or f.k.stride(0) != f.y.stride(0))):
            raise ValueError(f"frame {i}: a {f.color} frame's fourth plane "
                             "is needed (CMYK and YCCK only), of y's shape "
                             "and pitch")
        for name in ("y", "cb", "cr", "k"):
            t = getattr(f, name)
            if t is not None:
                if t.dim() != 2:
                    raise ValueError(f"frame {i} {name}: a plane is 2-D; "
                                     f"got {tuple(t.shape)}")
                _check_plane(i, name, t, device)
    elif f is not None:
        if f.dim() != 3 or f.shape[2] != 3:
            raise TypeError(f"frame {i}: resize_crop takes uint8 [H, W, 3] "
                            f"frames; got {f.dtype} {tuple(f.shape)}")
        _check_plane(i, "rgb", f, device)
        if f.stride(1) != 3:
            raise ValueError(f"frame {i}: pixels must be packed RGB rows "
                             f"(strides [pitch, 3, 1]); got {f.stride()}")


def plane_batch(frames: Sequence[Frame]) -> PlaneBatch:
    """Frames (RGB tensors, :class:`YccFrame`s or ``None``) as the kernel's
    per-slot arrays."""
    n = len(frames)
    a = {k: np.zeros(n, np.int64) for k in ("p0", "pitch0", "p1", "p2",
                                            "pitch1", "w", "h", "color",
                                            "p3")}
    fmt = np.full(n, PADDED, np.int64)
    keep = []
    for i, f in enumerate(frames):
        if f is None:
            continue
        if isinstance(f, YccFrame):
            a["h"][i], a["w"][i] = f.y.shape
            a["p0"][i], a["pitch0"][i] = f.y.data_ptr(), f.y.stride(0)
            if f.cb is not None:
                a["p1"][i], a["p2"][i] = f.cb.data_ptr(), f.cr.data_ptr()
                if f.cb.stride(0) != f.cr.stride(0):
                    raise ValueError(f"frame {i}: cb and cr pitches differ")
                a["pitch1"][i] = f.cb.stride(0)
            if f.k is not None:
                a["p3"][i] = f.k.data_ptr()
            a["color"][i] = COLORS[f.color]
            fmt[i] = f.fmt
        else:
            a["h"][i], a["w"][i] = f.shape[:2]
            a["p0"][i], a["pitch0"][i] = f.data_ptr(), f.stride(0)
            fmt[i] = FORMATS["rgb"]
        keep.append(f)
    return PlaneBatch(fmt=fmt, keep=keep, **a)


def descriptor(batch: PlaneBatch, res: int, device: torch.device,
               ctas: Callable[[int], int] = lambda smem: 0):
    """The kernel's launch arguments for ``batch`` (layout in
    ``csrc/resize_crop.cu``): the int64 descriptor's head (16 words, then G
    geometries of 8), whose frame rows (10 words a slot) are
    ``batch.rows``; the tables it points to on ``device`` (which must
    outlive the launch), the work items and the :class:`Plan`.
    ``ctas(smem)`` gives the persistent grid's size, which sets the bands
    (:func:`bands`)."""
    n = len(batch.fmt)
    p = plan(batch.sizes, res, batch.kinds)
    n_t = -(-res // 16)
    band_mt = bands(n * p.n_strips, n_t, ctas(p.smem))
    n_bands = -(-n_t // band_mt)
    head = np.zeros((HEAD_WORDS + GEOM_WORDS * len(batch.sizes),), np.int64)
    head[:13] = (len(batch.sizes), n, res, p.strip_ct, p.n_strips, band_mt,
                 n_bands, p.ring, p.ring_pitch, p.rgb_pitch, p.raw_bytes,
                 p.rgb_bytes, p.tile_pitch)
    tabs = []
    for j, (w, h) in enumerate(batch.sizes):
        t = mma_tables(w, h, res)
        tabs.append(tables_on(device, ("r1", w, h, res), t.packed))
        at = HEAD_WORDS + GEOM_WORDS * j
        head[at:at + 5] = (tabs[-1].data_ptr(), w, h, t.ks_h, t.ks_v)
    return head, tabs, n * p.n_strips * n_bands, p


def persistent_ctas(smem: int) -> int:
    """CTAs of the kernel's persistent grid on the current device."""
    lib = _library()
    ctas = ctypes.c_int()
    err = lib.hmmc_resize_crop_ctas(smem, ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(
            f"resize_crop: no CTA of {smem} bytes of shared memory fits: "
            f"CUDA error {err} ({lib.hmmc_cuda_error_string(err).decode()})")
    return ctas.value


def launch(batch: PlaneBatch, res: int, device: torch.device) -> torch.Tensor:
    """One launch of the kernel over ``batch`` -> uint8 [N, res, res, 3] on
    ``device`` (a CUDA device). Nothing here waits for the card."""
    n = len(batch.fmt)
    out = torch.empty((n, res, res, 3), dtype=torch.uint8, device=device)
    if n == 0:
        return out
    lib = _library()
    grid = ctypes.c_int()
    with torch.cuda.device(device):
        head, tabs, items, p = descriptor(batch, res, device,
                                          persistent_ctas)
        host, desc = upload(head, batch.rows, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.hmmc_resize_crop(desc.data_ptr(), host.data_ptr(), items,
                                   p.smem, out.data_ptr(), stream,
                                   ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(
            f"resize_crop kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_cuda_error_string(err).decode()}) for {n} frames "
            f"at res {res}: {items} items (strips of {p.strip_ct} 16-column "
            f"tiles), {p.smem} bytes of shared memory")
    resize_crop.launches += 1
    resize_crop.last_launch = dict(items=items, grid=grid.value,
                                   smem=p.smem)
    return out


def resize_crop(frames: Sequence[Frame], res: int,
                device=None) -> torch.Tensor:
    """Frames of any sizes (uint8 RGB ``[H_i, W_i, 3]`` or
    :class:`YccFrame`; rows may be padded to a pitch; ``None`` for a padded
    slot) -> ``[N, res, res, 3]`` uint8, zeros in padded slots. CPU frames
    take the plain versions; CUDA frames go through one launch of the
    kernel. ``device`` is needed only when every slot is ``None``."""
    real = [f for f in frames if f is not None]
    if device is None:
        first = real[0] if real else None
        device = (first.y if isinstance(first, YccFrame) else first).device \
            if first is not None else torch.device("cpu")
    device = torch.device(device)
    for i, f in enumerate(frames):
        _check_frame(i, f, device)
    if device.type == "cpu":
        out = torch.zeros((len(frames), res, res, 3), dtype=torch.uint8)
        for i, f in enumerate(frames):
            if f is not None:
                rgb = ycc_to_rgb_reference(f) if isinstance(f, YccFrame) \
                    else f
                out[i] = resize_crop_reference(rgb[None], res)[0]
        return out
    if device.type != "cuda":
        raise ValueError(f"resize_crop runs on cuda or cpu; got {device}")
    return launch(plane_batch(frames), res, device)


resize_crop.launches = 0
resize_crop.last_launch = {}
