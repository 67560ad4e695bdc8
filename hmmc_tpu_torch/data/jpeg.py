"""JPEG frames -> uint8 ``[N, res, res, 3]`` at the eval geometry: decode,
then R1 (``ops/resize_crop.py``: the short-side bicubic resize and centre
crop, bit for bit as PIL); or, in ``mode="aug"`` (the pretrain), at the aug
geometry: decode, then R2 (``ops/resize_area.py``: cv2's ``INTER_AREA``
short-side resize and centre crop, bit for bit as cv2), the counterpart of
``_decode_aug`` in ``hmmc_tpu/data/datasets.py:64-85``. The aug route
follows that cv2 route, not the JAX package's native decoder
(``native/hmmc_jpeg.cpp``: DCT-domain prescaling, which nvJPEG has no
counterpart of).

Counterpart of ``_decode_eval`` in ``hmmc_tpu/data/datasets.py:36-61``, which
decodes on the host with PIL. Here the host only hands compressed blobs
over:

- On a CUDA device, nvJPEG decodes the batch on the card
  (``csrc/jpeg_decode.cu``, C interface, loaded with ctypes): the H100's
  JPEG engines (``NVJPEG_BACKEND_HARDWARE``) take every frame they support
  in one batched call, and any other frame goes through nvJPEG's
  ``GPU_HYBRID`` decoder, still on the card. Each frame's components land
  as encoded (Y, and Cb and Cr at their subsampled size) in one device
  buffer the wrapper allocates, on PyTorch's current stream, and R1 does
  libjpeg's upsampling and colour conversion, resizes and crops them in one
  launch. What the planes hold is read from the blob's header on the host
  (:func:`parse_header`: the SOF's components, the JFIF and Adobe
  markers), as libjpeg reads it: YCbCr, RGB as coded (Adobe transform 0),
  CMYK or YCCK, each converted as PIL's ``convert("RGB")`` does. A frame
  whose layout R1 does not take (not grayscale; not three planes, the
  second and third at a sampling of ``resize_crop.SAMPLING``; not four
  with the fourth at full size) raises, naming the frame. There is no CPU
  decoder on this route: without nvJPEG it raises.
- On the CPU (``device="cpu"``: the tests, small runs), PIL decodes each
  blob (imported here, as ``_decode_eval`` does; without PIL it raises) and
  R1's plain version resizes and crops, so the frames equal the JAX
  package's bit for bit. In aug mode cv2 decodes (``imdecode``,
  ``cvtColor``; imported here, and the card's machine, which has no cv2,
  never takes this route) and R2's plain version resizes and crops.

``None`` in a batch is a padded slot and comes out zero. A blob that does
not decode (on the CPU: any exception PIL raises, a
``DecompressionBombError`` too) is zero-filled with a warning and counted
in ``decode_frames.decode_failures``, as the JAX package zero-fills
corrupt frames. ``decode_frames.launches`` counts calls that decoded on
the card, ``decode_frames.routes`` their frames by route,
``decode_frames.formats`` and ``decode_frames.colors`` by sampling and by
what the planes hold, ``decode_frames.h2d_bytes`` the compressed bytes
handed to nvJPEG. The two steps run inside
``record_function`` ranges ("nvjpeg_decode", "resize_crop") so a profile
can split their device time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import io
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from hmmc_tpu_torch.ops import resize_area as r2
from hmmc_tpu_torch.ops.resize_crop import (COLORS, FORMATS, PADDED,
                                            SAMPLING, Frame, PlaneBatch,
                                            YccFrame, chroma_format, launch,
                                            resize_crop)

logger = logging.getLogger(__name__)

PITCH_ALIGN = 256        # bytes: each decoded frame's start and row pitch
ROUTES = ("hardware", "hybrid", "single", "failed")
SAMPLING_NAMES = [n for n, c in FORMATS.items() if c in SAMPLING]


# start-of-frame markers (every coding process); libjpeg reads the frame
# header and the APP markers up to the first start of scan
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD,
        0xCE, 0xCF}


@dataclasses.dataclass(frozen=True)
class JpegHeader:
    """What libjpeg reads from a JPEG's markers before it decodes:
    ``components`` (id, horizontal, vertical sampling factor) from the
    SOF, whether a JFIF APP0 came, the Adobe APP14 transform (``None``
    without one), and so ``color``: "gray", "ycc", "rgb", "cmyk", "ycck",
    or ``None`` for a component count PIL does not convert (2, 5+)."""

    components: Tuple[Tuple[int, int, int], ...]
    jfif: bool
    adobe_transform: Optional[int]

    @property
    def color(self) -> Optional[str]:
        # jdapimin.c default_decompress_parms
        n = len(self.components)
        if n == 1:
            return "gray"
        if n == 3:
            if self.jfif:
                return "ycc"
            if self.adobe_transform is not None:
                return "rgb" if self.adobe_transform == 0 else "ycc"
            ids = tuple(c[0] for c in self.components)
            return "rgb" if ids == (82, 71, 66) else "ycc"
        if n == 4:
            if self.adobe_transform is None:
                return "cmyk"
            return "cmyk" if self.adobe_transform == 0 else "ycck"
        return None


def parse_header(blob) -> Optional[JpegHeader]:
    """The markers of ``blob`` up to its first start of scan, as libjpeg
    reads them (``jdmarker.c``: APP0 "JFIF" of 14 bytes or more, APP14
    "Adobe" of 12 or more, its transform byte at 11). ``None`` where the
    blob is not a JPEG or has no frame header before its scan."""
    b = bytes(blob)
    if b[:2] != b"\xff\xd8":
        return None
    i, jfif, adobe, comps = 2, False, None, None
    while i + 4 <= len(b) and b[i] == 0xFF:
        m = b[i + 1]
        if m == 0xFF:                       # fill byte
            i += 1
            continue
        if m == 0x01 or 0xD0 <= m <= 0xD7:  # markers without a length
            i += 2
            continue
        if m in (0xDA, 0xD9):               # start of scan, end of image
            break
        seg = b[i + 4:i + 2 + ((b[i + 2] << 8) | b[i + 3])]
        if m == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and len(seg) >= 12 and seg[:5] == b"Adobe":
            adobe = seg[11]
        elif m in _SOF and len(seg) >= 6:
            n = seg[5]
            if len(seg) < 6 + 3 * n:
                return None
            comps = tuple((seg[6 + 3 * c], seg[7 + 3 * c] >> 4,
                           seg[7 + 3 * c] & 15) for c in range(n))
        i += 2 + ((b[i + 2] << 8) | b[i + 3])
    return None if comps is None else JpegHeader(comps, jfif, adobe)


def _jfif_first(b: bytes) -> bool:
    """An APP0 "JFIF" segment of 14 bytes or more right after the SOI."""
    return (b[2:4] == b"\xff\xe0" and len(b) >= 11
            and ((b[4] << 8) | b[5]) >= 16 and b[6:11] == b"JFIF\0")


def _fourth_at_full_size(head: Optional[JpegHeader]) -> bool:
    comps = head.components if head is not None else ()
    return len(comps) == 4 and comps[3][1:] == (
        max(c[1] for c in comps), max(c[2] for c in comps))


def _pil_rgb(blob) -> Optional[np.ndarray]:
    from PIL import Image

    try:
        return np.array(Image.open(io.BytesIO(bytes(blob))).convert("RGB"),
                        np.uint8)
    except Exception:   # as _decode_eval: any failure zero-fills the frame
        return None


def _count_failure() -> None:
    logger.warning("corrupt JPEG frame (zero-filled)")
    decode_frames.decode_failures += 1


def _cv2_rgb(blob) -> Optional[np.ndarray]:
    import cv2

    bgr = cv2.imdecode(np.frombuffer(bytes(blob), np.uint8),
                       cv2.IMREAD_COLOR)
    return None if bgr is None else cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def _decode_cpu(blobs: Sequence[Optional[bytes]], res: int,
                mode: str = "eval") -> torch.Tensor:
    rgb_of, resize = ((_pil_rgb, resize_crop) if mode == "eval"
                      else (_cv2_rgb, r2.resize_area))
    frames: List[Optional[torch.Tensor]] = []
    for b in blobs:
        rgb = None if b is None else rgb_of(b)
        if b is not None and rgb is None:
            _count_failure()
        frames.append(None if rgb is None else torch.from_numpy(rgb))
    return resize(frames, res, device="cpu")


class _NvJpeg:
    """One nvJPEG context per device (``hmmc_jpeg_*`` in
    ``csrc/jpeg_decode.cu``): the hybrid handle, the hardware handle where
    the card exposes its JPEG engines, their batched states."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lib = _library()
        ctx = ctypes.c_void_p()
        hw = ctypes.c_int()
        with torch.cuda.device(device):
            self._check(self.lib.hmmc_jpeg_create(ctypes.byref(ctx),
                                                  ctypes.byref(hw)),
                        "create")
        self.ctx = ctx
        self.hardware = bool(hw.value)

    def _check(self, status: int, what: str) -> None:
        if status != 0:
            raise RuntimeError(
                f"nvJPEG {what} failed: "
                f"{self.lib.hmmc_jpeg_status_string(status).decode()} "
                f"(status {status})")

    def decode_planes(self, blobs: Sequence[Optional[bytes]]
                      ) -> Tuple[PlaneBatch, torch.Tensor]:
        """Decode on the card into one buffer: per slot its planes as R1
        takes them (:class:`PlaneBatch`; ``PADDED`` for a padded slot or a
        blob that failed), and the buffer."""
        n = len(blobs)
        idx = [i for i, b in enumerate(blobs) if b is not None]
        m = len(idx)
        planes = {k: np.zeros(n, np.int64) for k in (
            "p0", "pitch0", "p1", "p2", "pitch1", "w", "h", "color", "p3")}
        fmt = np.full(n, PADDED, np.int64)
        if not m:
            return PlaneBatch(fmt=fmt, keep=[], **planes), None
        data = [bytes(blobs[i]) for i in idx]
        ptrs = (ctypes.c_char_p * m)(*data)
        lens = np.array([len(d) for d in data], np.uint64)
        info = np.zeros((6, m), np.int32)     # w, h, cw, ch, ncomp, route
        self._check(self.lib.hmmc_jpeg_probe(
            self.ctx, ptrs, lens.ctypes.data, m,
            *(info[k].ctypes.data for k in range(6))), "probe")
        w, h, cw, ch, ncomp, route = (info[k].astype(np.int64)
                                      for k in range(6))
        ok = route >= 0
        form = np.full(m, FORMATS["gray"], np.int64)
        color = np.zeros(m, np.int64)
        for j in np.flatnonzero(ok & (ncomp != 1)):
            # a JFIF marker first (libjpeg's and cv2's default) settles a
            # three-plane frame as YCbCr without the whole parse
            head = (None if ncomp[j] == 3 and _jfif_first(data[j])
                    else parse_header(data[j]))
            code = (chroma_format(w[j], h[j], cw[j], ch[j])
                    if ncomp[j] in (3, 4) else None)
            if ncomp[j] == 4 and not _fourth_at_full_size(head):
                code = None
            if code is None:
                raise RuntimeError(
                    f"JPEG frame {idx[j]}: {ncomp[j]} components, planes 2 "
                    f"and 3 {cw[j]}x{ch[j]} (-1: they differ) for "
                    f"{w[j]}x{h[j]}; R1 takes grayscale, three planes with "
                    f"the second and third at "
                    f"{', '.join(sorted(SAMPLING_NAMES))}, and four with "
                    "the fourth at full size")
            form[j] = code
            name = head.color if head is not None else None
            if name is None or len(head.components) != ncomp[j]:
                name = "ycc" if ncomp[j] == 3 else "cmyk"   # libjpeg's guess
            color[j] = COLORS[name]
        pitch0 = _align(w) * ok
        pitch1 = _align(cw) * (ok & (ncomp >= 3))
        size0 = h * pitch0
        size1 = ch * pitch1
        size3 = size0 * (ncomp == 4)
        sizes = np.stack([size0, size1, size1, size3], 1).ravel()
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        buf = torch.empty(max(int(offsets[-1]), 1), dtype=torch.uint8,
                          device=self.device)
        base = buf.data_ptr()
        d0, d1, d2, d3 = (base + offsets[j:-1:4] for j in range(4))
        # the C call reads and writes these: each held by a name
        route32, nc32 = route.astype(np.int32), ncomp.astype(np.int32)
        p0_32, p1_32 = pitch0.astype(np.int32), pitch1.astype(np.int32)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            self._check(self.lib.hmmc_jpeg_decode(
                self.ctx, ptrs, lens.ctypes.data, m, route32.ctypes.data,
                nc32.ctypes.data, d0.ctypes.data, d1.ctypes.data,
                d2.ctypes.data, d3.ctypes.data, p0_32.ctypes.data,
                p1_32.ctypes.data, stream), "decode")
        decode_frames.launches += 1
        # nvJPEG has staged the blobs when it returns; they are kept until
        # the next call all the same
        self._inputs = data
        route = route32.astype(np.int64)
        decode_frames.h2d_bytes += int(lens.sum())
        for r, name in ((0, "hardware"), (1, "hybrid"), (2, "single")):
            decode_frames.routes[name] += int((route == r).sum())
        failed = int((route < 0).sum())
        decode_frames.routes["failed"] += failed
        for _ in range(failed):
            _count_failure()
        good = route >= 0
        for name, code in FORMATS.items():
            decode_frames.formats[name] += int(((form == code) & good).sum())
        for name, code in COLORS.items():
            decode_frames.colors[name] += int(((color == code) & good
                                               & (ncomp >= 3)).sum())
        sel = np.asarray(idx)
        fmt[sel] = np.where(good, form, PADDED)
        for key, val in (("p0", d0), ("pitch0", pitch0), ("p1", d1),
                         ("p2", d2), ("pitch1", pitch1), ("w", w),
                         ("h", h), ("color", color), ("p3", d3)):
            planes[key][sel] = val
        return PlaneBatch(fmt=fmt, keep=[buf], **planes), buf


def _align(nbytes: np.ndarray) -> np.ndarray:
    return -(-nbytes // PITCH_ALIGN) * PITCH_ALIGN


def frame_views(batch: PlaneBatch, buf: torch.Tensor) -> List[Frame]:
    """A decoded batch's slots as R1's frames (views into ``buf``):
    :class:`YccFrame`s, or ``None``."""
    base = buf.data_ptr() if buf is not None else 0
    out: List[Frame] = []
    for i, f in enumerate(batch.fmt):
        if f == PADDED:
            out.append(None)
            continue
        w, h = int(batch.w[i]), int(batch.h[i])

        def plane(ptr, pitch, rows, cols):
            o = int(ptr) - base
            return buf[o:o + rows * int(pitch)].view(rows, int(pitch))[
                :, :cols]

        y = plane(batch.p0[i], batch.pitch0[i], h, w)
        if f == FORMATS["gray"]:
            out.append(YccFrame(y))
            continue
        hf, vf = SAMPLING[int(f)]
        cw, ch = -(-w // hf), -(-h // vf)
        color = next(n for n, c in COLORS.items() if c == batch.color[i])
        k = (plane(batch.p3[i], batch.pitch0[i], h, w)
             if color in ("cmyk", "ycck") else None)
        out.append(YccFrame(y, plane(batch.p1[i], batch.pitch1[i], ch, cw),
                            plane(batch.p2[i], batch.pitch1[i], ch, cw),
                            k, color))
    return out


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from hmmc_tpu_torch.ops import kernel_build

    lib = kernel_build.load("jpeg_decode")
    lib.hmmc_jpeg_status_string.argtypes = [ctypes.c_int]
    lib.hmmc_jpeg_status_string.restype = ctypes.c_char_p
    lib.hmmc_jpeg_create.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_int)]
    lib.hmmc_jpeg_probe.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        *[ctypes.c_void_p] * 6]
    lib.hmmc_jpeg_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        *[ctypes.c_void_p] * 9]
    for fn in (lib.hmmc_jpeg_create, lib.hmmc_jpeg_probe,
               lib.hmmc_jpeg_decode):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _decoder(device: torch.device) -> _NvJpeg:
    return _NvJpeg(device)


MODES = ("eval", "aug")


def decode_frames(blobs: Sequence[Optional[bytes]], res: int,
                  device, mode: str = "eval") -> torch.Tensor:
    """JPEG blobs (``None`` = padded slot) -> uint8 ``[N, res, res, 3]`` on
    ``device``. ``mode="eval"``: nvJPEG + R1 on a CUDA device, PIL + R1's
    plain version on the CPU; ``mode="aug"``: nvJPEG + R2, or cv2 + R2's
    plain version."""
    if mode not in MODES:
        raise ValueError(f"decode mode {mode!r}: one of {MODES}")
    device = torch.device(device)
    if device.type == "cpu":
        return _decode_cpu(blobs, res, mode)
    if device.type != "cuda":
        raise ValueError(f"decode_frames runs on cuda or cpu; got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with record_function("nvjpeg_decode"):
        batch, _ = _decoder(device).decode_planes(blobs)
    if mode == "aug":
        with record_function("resize_area"):
            return r2.launch(batch, res, device)
    with record_function("resize_crop"):
        return launch(batch, res, device)


def decode_video_blobs(video_blobs: Sequence[Sequence[Optional[bytes]]],
                       res: int, device, mode: str = "eval"
                       ) -> torch.Tensor:
    """A loader batch's ``video_blobs`` (B lists of F blobs) -> uint8
    ``[B, F, res, res, 3]`` on ``device``."""
    b = len(video_blobs)
    f = len(video_blobs[0]) if b else 0
    flat = [blob for clip in video_blobs for blob in clip]
    return decode_frames(flat, res, device, mode).view(b, f, res, res, 3)


def reset_counters() -> None:
    decode_frames.launches = 0
    decode_frames.decode_failures = 0
    decode_frames.h2d_bytes = 0
    decode_frames.routes = {r: 0 for r in ROUTES}
    decode_frames.formats = {f: 0 for f in FORMATS}
    decode_frames.colors = {c: 0 for c in COLORS}


reset_counters()
