"""R2: the aug decode's tail, cv2's ``INTER_AREA`` short-side resize and a
centre crop, bit for bit as the cv2 the JAX package runs computes them, as
a CUDA kernel and its plain version.

It replaces the host cv2 step of ``hmmc_tpu/data/datasets.py:64-85``
(``_decode_aug``): after the JPEG's decode (R1's stage 0, with OpenCV's
CMYK rule), a resize of the short side to ``size`` (the long side to
``round(long * size / short)``, Python's ``round``) with
``cv2.INTER_AREA``, and a crop of the centre square at ``(n - size) //
2``. It is not a TPU kernel: the JAX package runs this step on the host,
and the card's machine has neither cv2 nor PIL.

``cv2.resize(..., INTER_AREA)`` on uint8 takes one of four paths, read from
OpenCV's ``imgproc/src/resize.cpp`` and held bit for bit against the
installed cv2 (5.0.0) by the tests:

- **copy**: the size does not change (``identity``).
- **integer factors** (``fast``): both scales whole numbers; each output
  pixel is the sum of its kx x ky box, rounded as ``(sum + 2) >> 2`` at
  2 x 2 (the SIMD branch) and as ``rint(float(sum) * (1.f / area))``
  otherwise.
- **area** (both scales >= 1, not whole): ``computeResizeAreaTab``'s
  per-axis cells (a partial first source pixel, whole ones, a partial
  last, weights ``float((...) / cellWidth)`` from doubles), then float
  sums in cv2's order: per source row ``buf = sum(src * alpha)`` over the
  column cell, per output ``sum(beta * buf)`` over the row cell, each
  product and sum rounded in fp32 (no fused multiply-add), then rounded
  half to even and clamped.
- **linear** (an axis upsamples): INTER_AREA falls to the bilinear resize
  with its area-style coefficients ``fx = (dx + 1) - (sx + 1) / scale``
  (wrapped to [0, 1)) in 11-bit fixed point; the horizontal pass is exact
  int32 (``S[sx] * 2048`` past the last full pair), the vertical pass is
  cv2's SIMD ``VResizeLinearVec_32s8u``: ``((h0 >> 4) * b0 >> 16) + ((h1 >>
  4) * b1 >> 16)``, then ``(v + 2) >> 2``, saturated.

:func:`area_tables` computes each path's per-axis taps on the host in
Python doubles, as cv2 does; :func:`resize_area_reference` applies them in
PyTorch with the same arithmetic, and the kernel (``csrc/resize_area.cu``)
does too. The kernel shares R1's stage 0 and launch: one launch per batch,
a descriptor of plane pointers, persistent CTAs over (frame, band of tiles
of output rows) items, each tile's planes staged while the previous tile
computes.
On the copy path (the pretrain's 341x256 store frames) stage 0 converts
straight into the tile's output rows; the other paths run a horizontal pass
into three planes of 4-byte sums (int32 or fp32 by path) and a vertical
pass into ``[N, size, size, 3]``. Padded slots are zeros.

Device rule: CPU tensors take the plain versions; CUDA tensors launch the
kernel or raise. ``resize_area.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from hmmc_tpu_torch.ops.resize_crop import (
    Frame, PlaneBatch, YccFrame, _check_frame, _pitch16, _roundup, bands,
    plane_batch, raw_bound, tables_on, upload, ycc_to_rgb_reference)

# the kernel's word for each path ("copy": fast at 1 x 1)
MODES = {"fast": 0, "area": 1, "linear": 2, "copy": 3}
COEF_ONE = 2048                   # INTER_RESIZE_COEF_SCALE (11 bits)
# output rows per tile, halved while a CTA would take more than SMEM_LIMIT
# bytes (the horizontal pass keeps 12 bytes a pixel); the copy path takes
# 30 (_copy_tile_rows), ~53 KB
TILE_ROWS = 32
SMEM_LIMIT = 100 * 1024
HEAD_WORDS = 16                   # the descriptor's head, then 12 words a
GEOM_WORDS = 12                   # geometry
_DBL_EPSILON = 2.220446049250313e-16


def output_size(w: int, h: int, size: int) -> Tuple[int, int]:
    """(new width, new height) of ``_decode_aug``'s short-side resize."""
    if w <= h:
        return size, max(size, round(h * size / w))
    return max(size, round(w * size / h)), size


def _cv_round(x: float) -> int:
    return int(np.rint(x))


def _area_cells(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab``: per output index its first source index
    and its float32 weights."""
    cells = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        first, wts = sx1, []
        if sx1 - fsx1 > 1e-3:
            first = sx1 - 1
            wts.append(np.float32((sx1 - fsx1) / cell))
        wts += [np.float32(1.0 / cell)] * (sx2 - sx1)
        if fsx2 - sx2 > 1e-3:
            wts.append(np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell))
        cells.append((first, wts))
    return cells


def _linear_taps(ssize: int, dsize: int, clamp_edge: bool):
    """The bilinear path's taps in area mode (``resize`` for
    ``INTER_AREA`` with a scale below 1): per output index its source
    index and its two 11-bit weights; with ``clamp_edge`` (the horizontal
    axis) indices from the first whose pair runs off the edge on take
    ``S[w - 1] * 2048``, as ``HResizeLinear`` does past ``xmax``."""
    inv = dsize / ssize
    scale = 1.0 / inv
    xmax = dsize
    out = []
    for dx in range(dsize):
        sx = math.floor(dx * scale)
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = np.float32(0) if fx <= 0 else np.float32(fx - np.floor(fx))
        if clamp_edge and sx + 1 >= ssize:
            xmax = min(xmax, dx)
            if sx >= ssize - 1:
                fx, sx = np.float32(0), ssize - 1
        a0 = _cv_round(np.float32(np.float32(1) - fx) * np.float32(COEF_ONE))
        a1 = _cv_round(fx * np.float32(COEF_ONE))
        out.append((sx, [COEF_ONE] if dx >= xmax else [a0, a1]))
    return out


@dataclasses.dataclass(frozen=True)
class AreaTables:
    """One source geometry's taps for one ``size``, over the cropped output
    columns and rows: first source index, tap count and weights [size, k]
    (int32, or float32 bits in ``area`` mode; zero past a count)."""

    w: int
    h: int
    size: int
    mode: str
    fast_shift: bool        # 2 x 2 integer factors: (sum + 2) >> 2
    inv_area: np.float32    # 1.f / (kx * ky)
    x_first: np.ndarray
    x_count: np.ndarray
    x_w: np.ndarray
    y_first: np.ndarray
    y_count: np.ndarray
    y_w: np.ndarray

    def rows(self, r0: int, r1: int) -> Tuple[int, int]:
        """First and end source row that output rows [r0, r1) read."""
        return (int(self.y_first[r0]),
                min(int(self.y_first[r1 - 1] + self.y_count[r1 - 1]),
                    self.h))

    @property
    def cols(self) -> Tuple[int, int]:
        return (int(self.x_first[0]),
                int(self.x_first[-1] + self.x_count[-1]))

    @property
    def copy(self) -> bool:
        """cv2's copy: integer factors of 1 x 1, the size unchanged."""
        return (self.mode == "fast" and self.x_w.shape[1] == 1
                and self.y_w.shape[1] == 1)

    def most_rows(self, tile: int) -> int:
        """Most source rows a tile of ``tile`` output rows reads."""
        return max(end - start for start, end in (
            self.rows(r0, min(r0 + tile, self.size))
            for r0 in range(0, self.size, tile)))

    def packed(self) -> np.ndarray:
        """int32 [x_first, x_count, y_first, y_count, x_w, y_w], the
        kernel's layout."""
        return np.concatenate([
            self.x_first, self.x_count, self.y_first, self.y_count,
            self.x_w.ravel(), self.y_w.ravel()]).astype(np.int32)


def _pack(cells, lo: int, n: int, as_float: bool):
    cells = cells[lo:lo + n]
    k = max(len(w) for _, w in cells)
    first = np.array([f for f, _ in cells], np.int32)
    count = np.array([len(w) for _, w in cells], np.int32)
    wts = np.zeros((n, k), np.float32 if as_float else np.int32)
    for i, (_, w) in enumerate(cells):
        wts[i, :len(w)] = w
    return first, count, wts.view(np.int32) if as_float else wts


@functools.lru_cache(maxsize=64)
def area_tables(w: int, h: int, size: int) -> AreaTables:
    """The taps ``cv2.resize(INTER_AREA)`` uses for a ``w`` x ``h`` source
    at ``_decode_aug``'s geometry, cropped; cached per size."""
    nw, nh = output_size(w, h, size)
    left, top = (nw - size) // 2, (nh - size) // 2
    inv_x, inv_y = nw / w, nh / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    ix, iy = _cv_round(sx), _cv_round(sy)
    fast = abs(sx - ix) < _DBL_EPSILON and abs(sy - iy) < _DBL_EPSILON
    if fast:
        mode = "fast"
        xc = [(d * ix, [1] * ix) for d in range(nw)]
        yc = [(d * iy, [1] * iy) for d in range(nh)]
    elif sx >= 1 and sy >= 1:
        mode = "area"
        xc, yc = _area_cells(w, nw, sx), _area_cells(h, nh, sy)
    else:
        mode = "linear"
        xc, yc = _linear_taps(w, nw, True), _linear_taps(h, nh, False)
    as_float = mode == "area"
    x = _pack(xc, left, size, as_float)
    y = _pack(yc, top, size, as_float)
    return AreaTables(w, h, size, mode, fast and (ix, iy) == (2, 2),
                      np.float32(1.0) / np.float32(ix * iy) if fast
                      else np.float32(0), *x, *y)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _gather(first: np.ndarray, k: int, limit: int, device) -> torch.Tensor:
    idx = first[:, None] + np.arange(k)[None, :]
    return torch.from_numpy(np.minimum(idx, limit - 1)).long().to(device)


def resize_area_reference(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of R2: uint8 ``[N, H, W, 3]`` frames of one size ->
    ``[N, size, size, 3]``, with the kernel's arithmetic (taps past a count
    weigh 0, which leaves an fp32 sum as it is)."""
    n, h, w, _ = frames.shape
    t = area_tables(w, h, size)
    dev = frames.device
    y0, y1 = t.rows(0, size)
    xi = _gather(t.x_first, t.x_w.shape[1], w, dev)
    yi = _gather(t.y_first - y0, t.y_w.shape[1], y1 - y0, dev)
    src = frames[:, y0:y1]
    if t.mode == "area":
        xw = torch.from_numpy(t.x_w.view(np.float32)).to(dev)
        yw = torch.from_numpy(t.y_w.view(np.float32)).to(dev)
        s = src.float()
        acc = torch.zeros((n, y1 - y0, size, 3), device=dev)
        for k in range(xw.shape[1]):
            acc = acc + s[:, :, xi[:, k]] * xw[None, None, :, k, None]
        out = torch.zeros((n, size, size, 3), device=dev)
        for k in range(yw.shape[1]):
            out = out + yw[None, :, k, None, None] * acc[:, yi[:, k]]
        return torch.round(out).clamp_(0, 255).to(torch.uint8)
    xw = torch.from_numpy(t.x_w).to(dev)
    yw = torch.from_numpy(t.y_w).to(dev)
    s = src.to(torch.int32)
    acc = (s[:, :, xi] * xw[None, None, :, :, None]).sum(3)  # [N, R, size, 3]
    if t.mode == "fast":
        tot = (acc[:, yi] * yw[None, :, :, None, None]).sum(2)
        if t.fast_shift:
            return ((tot + 2) >> 2).clamp_(0, 255).to(torch.uint8)
        v = torch.round(tot.float() * float(t.inv_area))
        return v.clamp_(0, 255).to(torch.uint8)
    h0, h1 = acc[:, yi[:, 0]] >> 4, acc[:, yi[:, 1]] >> 4
    b0 = yw[None, :, 0, None, None]
    b1 = yw[None, :, 1, None, None]
    v = ((h0 * b0) >> 16) + ((h1 * b1) >> 16)
    return ((v + 2) >> 2).clamp_(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from hmmc_tpu_torch.ops import kernel_build

    lib = kernel_build.load("resize_area")
    lib.hmmc_resize_area_error_string.argtypes = [ctypes.c_int]
    lib.hmmc_resize_area_error_string.restype = ctypes.c_char_p
    lib.hmmc_resize_area_ctas.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
    lib.hmmc_resize_area_ctas.restype = ctypes.c_int
    lib.hmmc_resize_area.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.hmmc_resize_area.restype = ctypes.c_int
    return lib


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch shape's layout: output rows per tile, the most source
    rows a tile reads, the pitches of the RGB planes and of the output
    tile's, and the shared-memory regions (stage 0's buffer, twice; RGB
    planes and 4-byte sums, none where every geometry copies; the output
    tile, interleaved rows) and their sum."""

    tile_rows: int
    n_tiles: int
    rows: int
    rgb_pitch: int
    tile_pitch: int
    raw_bytes: int
    rgb_bytes: int
    tmp_bytes: int
    smem: int


def _copy_tile_rows(size: int, threads: int = 256) -> int:
    """Output rows per tile on the copy path: the even height up to
    TILE_ROWS whose 8 x 2-pixel units (at most ceil((size + 7) / 8) a block
    row) fill the CTA's threads' passes best, the taller on a tie."""
    units = -(-(size + 7) // 8)

    def fill(t):
        n = t // 2 * units
        return n / (-(-n // threads) * threads)

    return max(range(2, TILE_ROWS + 1, 2), key=lambda t: (fill(t), t))


@functools.lru_cache(maxsize=256)
def plan(sizes: tuple, size: int, kinds: tuple) -> Plan:
    """The layout for frames of ``sizes`` and ``kinds``: tiles of output
    rows as tall as a CTA of at most :data:`SMEM_LIMIT` bytes allows."""
    tabs = [area_tables(w, h, size) for w, h in sizes]
    resize = any(not t.copy for t in tabs)
    cols = max([t.cols[1] - t.cols[0] for t in tabs] + [0])
    # planes start at the window's first column rounded down to 16, and
    # stage 0 writes whole 8-pixel units: up to 22 columns more
    rgb_pitch = _pitch16(cols + 22) if resize else 0
    tile_pitch = _pitch16(3 * (size + 22))            # interleaved RGB
    tile = TILE_ROWS if resize else _copy_tile_rows(size)
    while True:
        rows = max([t.most_rows(tile) for t in tabs] + [0])
        raw = max([raw_bound(f, four, rows, cols) for f, four in kinds]
                  + [0])
        rgb_bytes = _roundup(3 * rows * rgb_pitch, 16)
        tmp_bytes = _roundup(12 * rows * size, 16) if resize else 0
        smem = 2 * raw + rgb_bytes + tmp_bytes + tile * tile_pitch + 16
        if smem <= SMEM_LIMIT or tile == 1:
            return Plan(tile, -(-size // tile), rows, rgb_pitch, tile_pitch,
                        raw, rgb_bytes, tmp_bytes, smem)
        tile //= 2


def descriptor(batch: PlaneBatch, size: int, device: torch.device,
               ctas: Callable[[int], int] = lambda smem: 0):
    """The kernel's launch arguments for ``batch`` (layout in
    ``csrc/resize_area.cu``): the int64 descriptor's head (16 words, then G
    geometries of 12), whose frame rows (R1's, 10 words a slot) are
    ``batch.rows``; the tables it points to on ``device`` (which must
    outlive the launch), the work items and the :class:`Plan`. An item is
    a band of a frame's tiles: the whole frame unless ``ctas(smem)``, the
    persistent grid, would leave CTAs idle."""
    n = len(batch.fmt)
    p = plan(batch.sizes, size, batch.kinds)
    band_tiles = bands(n, p.n_tiles, ctas(p.smem))
    n_bands = -(-p.n_tiles // band_tiles)
    head = np.zeros((HEAD_WORDS + GEOM_WORDS * len(batch.sizes),), np.int64)
    head[:13] = (len(batch.sizes), n, size, p.tile_rows, p.n_tiles, p.rows,
                 p.rgb_pitch, p.raw_bytes, p.rgb_bytes, p.tmp_bytes,
                 p.tile_pitch, band_tiles, n_bands)
    tabs = []
    for j, (w, h) in enumerate(batch.sizes):
        g = area_tables(w, h, size)
        tabs.append(tables_on(device, ("r2", w, h, size), g.packed))
        at = HEAD_WORDS + GEOM_WORDS * j
        head[at:at + 10] = (
            tabs[-1].data_ptr(), g.x_w.shape[1], g.y_w.shape[1], w, h,
            *g.cols, MODES["copy" if g.copy else g.mode], int(g.fast_shift),
            int(np.float32(g.inv_area).view(np.int32)))
    return head, tabs, n * n_bands, p


def launch(batch: PlaneBatch, size: int,
           device: torch.device) -> torch.Tensor:
    """One launch of the kernel over ``batch`` -> uint8 [N, size, size, 3]
    on ``device`` (a CUDA device). Nothing here waits for the card."""
    n = len(batch.fmt)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    if n == 0:
        return out
    lib = _library()
    grid = ctypes.c_int()
    with torch.cuda.device(device):
        head, tabs, items, p = descriptor(batch, size, device,
                                          persistent_ctas)
        host, desc = upload(head, batch.rows, device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.hmmc_resize_area(desc.data_ptr(), host.data_ptr(), items,
                                   p.smem, out.data_ptr(), stream,
                                   ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(
            f"resize_area kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_resize_area_error_string(err).decode()}) for {n} "
            f"frames at size {size}: {items} items (tiles of {p.tile_rows} "
            f"rows), {p.smem} bytes of shared memory")
    resize_area.launches += 1
    resize_area.last_launch = dict(items=items, grid=grid.value,
                                   smem=p.smem)
    return out


def persistent_ctas(smem: int) -> int:
    """CTAs of the kernel's persistent grid on the current device."""
    lib = _library()
    ctas = ctypes.c_int()
    err = lib.hmmc_resize_area_ctas(smem, ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(
            f"resize_area: no CTA of {smem} bytes of shared memory fits: "
            f"CUDA error {err} "
            f"({lib.hmmc_resize_area_error_string(err).decode()})")
    return ctas.value


def resize_area(frames: Sequence[Frame], size: int,
                device=None) -> torch.Tensor:
    """Frames of any sizes (uint8 RGB ``[H_i, W_i, 3]`` or
    :class:`YccFrame`; ``None`` for a padded slot) -> ``[N, size, size, 3]``
    uint8, zeros in padded slots. CPU frames take the plain versions
    (a YccFrame's CMYK by OpenCV's rule); CUDA frames go through one launch
    of the kernel. ``device`` is needed only when every slot is ``None``."""
    real = [f for f in frames if f is not None]
    if device is None:
        first = real[0] if real else None
        device = (first.y if isinstance(first, YccFrame) else first).device \
            if first is not None else torch.device("cpu")
    device = torch.device(device)
    for i, f in enumerate(frames):
        _check_frame(i, f, device)
    if device.type == "cpu":
        out = torch.zeros((len(frames), size, size, 3), dtype=torch.uint8)
        for i, f in enumerate(frames):
            if f is not None:
                rgb = ycc_to_rgb_reference(f, cmyk="cv2") \
                    if isinstance(f, YccFrame) else f
                out[i] = resize_area_reference(rgb[None], size)[0]
        return out
    if device.type != "cuda":
        raise ValueError(f"resize_area runs on cuda or cpu; got {device}")
    return launch(plane_batch(frames), size, device)


resize_area.launches = 0
resize_area.last_launch = {}
