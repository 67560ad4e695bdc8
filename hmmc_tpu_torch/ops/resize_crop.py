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

The kernel (``csrc/resize_crop.cu``) is bound by the int32 multiply-adds of
the resize taps, with the bytes (the staged source read once, the output
written once) close behind; the note in the source gives the numbers. One
launch covers a whole batch of frames (arrays of plane pointers,
pitches, formats and geometries); a CTA takes one frame and a tile of
output rows, turns the source rows and columns that tile needs into RGB in
shared memory, runs the horizontal pass over only the cropped columns,
then the vertical pass into the ``[N, res, res, 3]`` output. Padded slots
are zero-filled.

Device rule: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise. ``resize_crop.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

PRECISION_BITS = 22
TILE_ROWS = 32             # output rows per CTA (halved while a tile's
SMEM_LIMIT = 160 * 1024    # staged pixels exceed this many bytes)
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

    def staged_rows(self, tile: int) -> int:
        """Most source rows one tile of ``tile`` output rows needs."""
        most = 0
        for r0 in range(0, self.res, tile):
            r1 = min(r0 + tile, self.res) - 1
            most = max(most, int(self.y_first[r1] + self.y_count[r1]
                                 - self.y_first[r0]))
        return most

    @property
    def staged_cols(self) -> Tuple[int, int]:
        """First and end source column of the cropped output columns."""
        return (int(self.x_first[0]),
                int(self.x_first[-1] + self.x_count[-1]))

    def smem_bytes(self, tile: int) -> int:
        """Shared memory one tile stages: its source pixels as RGB and the
        horizontal pass's rows."""
        xs, xe = self.staged_cols
        return self.staged_rows(tile) * 3 * ((xe - xs) + self.res)

    def packed(self) -> np.ndarray:
        """int32 [x_first, x_count, y_first, y_count, x_taps, y_taps], the
        kernel's layout."""
        return np.concatenate([self.x_first, self.x_count, self.y_first,
                               self.y_count, self.x_taps.ravel(),
                               self.y_taps.ravel()]).astype(np.int32)


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
    lib.hmmc_resize_crop.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.hmmc_resize_crop.restype = ctypes.c_int
    return lib


_device_tables: Dict[Tuple[int, int, int, int], torch.Tensor] = {}


def _tables_on(device: torch.device, t: CropTables) -> torch.Tensor:
    key = (device.index, t.w, t.h, t.res)
    dev = _device_tables.get(key)
    if dev is None:
        dev = torch.from_numpy(t.packed()).to(device)
        _device_tables[key] = dev
    return dev


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

    @property
    def sampling(self) -> np.ndarray:
        """The kernel's word for each slot's chroma factors, hf + 16 vf."""
        return np.array([hf + 16 * vf for hf, vf in (
            SAMPLING.get(int(f), (0, 0)) for f in self.fmt)], np.int64)


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


def descriptor(batch: PlaneBatch, res: int, device: torch.device):
    """The kernel's launch arguments for ``batch`` (layout in
    ``csrc/resize_crop.cu``): the int64 descriptor, G geometries of 8 words
    then N frames of 10; the tap tables it points to, on ``device``, which
    must outlive the launch; the output rows per CTA and the shared memory
    the largest tile stages."""
    n = len(batch.fmt)
    valid = batch.fmt != PADDED
    keys = batch.w * 65536 + batch.h
    uniq, inv = np.unique(keys[valid], return_inverse=True)
    geoms = [crop_tables(int(k // 65536), int(k % 65536), res) for k in uniq]
    tile = TILE_ROWS
    while tile > 1 and any(g.smem_bytes(tile) > SMEM_LIMIT for g in geoms):
        tile //= 2
    smem = max([g.smem_bytes(tile) for g in geoms] + [0])
    head = np.zeros((len(geoms), 8), np.int64)
    tabs = []
    for j, g in enumerate(geoms):
        tabs.append(_tables_on(device, g))
        head[j, :7] = (tabs[-1].data_ptr(), g.x_taps.shape[1],
                       g.y_taps.shape[1], g.w, g.h, *g.staged_cols)
    rows = np.zeros((n, 10), np.int64)
    geom = np.zeros(n, np.int64)
    geom[valid] = inv
    rows[:, 0], rows[:, 1], rows[:, 2] = batch.p0, batch.pitch0, geom
    rows[:, 3], rows[:, 4], rows[:, 5] = batch.fmt, batch.p1, batch.p2
    rows[:, 6], rows[:, 7] = batch.pitch1, batch.sampling
    if batch.color is not None:
        rows[:, 8], rows[:, 9] = batch.color, batch.p3
    return (np.concatenate([head.ravel(), rows.ravel()]), tabs, tile,
            smem)


def launch(batch: PlaneBatch, res: int, device: torch.device) -> torch.Tensor:
    """One launch of the kernel over ``batch`` -> uint8 [N, res, res, 3] on
    ``device`` (a CUDA device)."""
    n = len(batch.fmt)
    out = torch.empty((n, res, res, 3), dtype=torch.uint8, device=device)
    if n == 0:
        return out
    # one table per geometry; each stays alive over the launch
    words, tabs, tile, smem = descriptor(batch, res, device)
    desc = torch.from_numpy(words).to(device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.hmmc_resize_crop(desc.data_ptr(), len(tabs), n,
                                   out.data_ptr(), res, tile, smem, stream)
    if err != 0:
        raise RuntimeError(
            f"resize_crop kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_cuda_error_string(err).decode()}) for {n} frames "
            f"at res {res}, tile {tile}, {smem} bytes of shared memory")
    resize_crop.launches += 1
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
