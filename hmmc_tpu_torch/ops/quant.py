"""Symmetric per-row int8 quantization for retrieval feature banks
(counterpart of ``hmmc_tpu/ops/quant.py``; the host side is a copy).

The video side of a retrieval index is static after ``--do_extract``;
quantizing it to int8 with per-row absmax scales makes the bank 4x smaller
than fp32, on disk and resident on the card, and lets the ranking product
run s8 x s8 -> s32. The features are L2-normalized CLIP embeddings, so
per-row absmax scales lose under 0.5% per element.

Layout of a quantized bank (``features.npz``):
  video        int8 [V, H]      + video_scale  f32 [V]
  frames       int8 [V, F, H]   + frame_scale  f32 [V, F]
  title        int8 [V, H]      + title_scale  f32 [V]   (retrieval_VT)
  quant        "int8"
Queries stay float: they are computed live at query time and are the small
side of every product.

The device side takes tensors. Its integer product is ``torch._int_mm``
(cuBLAS's s8 x s8 -> s32 on the card), where the JAX package leaves the
same product to XLA's ``lax.dot_general`` outside any Pallas kernel. On a
CUDA tensor ``_int_mm`` needs more than 16 rows and a depth and width that
are multiples of 8: :func:`int_mm` puts the bank on the rows, pads the
queries to a width of 8 and every other dimension as needed with zeros
(which add nothing to a dot), and slices the padding off. (A bank whose
rows or depth are not multiples of 8 is thus copied on every call.)
Rounding is half to even on both sides (``np.rint``, ``torch.round``), as
in the JAX package, so the int8 tensors equal its own bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

QUANT_KEY = "quant"
_EPS = 1e-12
_MIN_ROWS = 32          # _int_mm on the card: more than 16 rows


# ---------------------------------------------------------------- host side

def quantize_rows_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric absmax int8 quantization along the LAST axis.

    Returns ``(q, scale)`` with ``x ~= q * scale[..., None]``; ``scale``
    has ``x``'s shape minus the last axis.
    """
    x = np.asarray(x, np.float32)
    absmax = np.maximum(np.abs(x).max(axis=-1), _EPS)
    scale = (absmax / 127.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def dequantize_np(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Inverse of :func:`quantize_rows_np` (fp32)."""
    return q.astype(np.float32) * np.asarray(scale, np.float32)[..., None]


def quantize_bank(payload: dict) -> dict:
    """Quantize the video-side arrays of a ``--do_extract`` payload (returns
    a new dict; float keys are replaced by int8 + per-row scales, see the
    module docstring for the layout)."""
    out = dict(payload)
    if "video" in out:
        out["video"], out["video_scale"] = quantize_rows_np(out["video"])
    if "frames" in out:
        out["frames"], out["frame_scale"] = quantize_rows_np(out["frames"])
    if "title" in out:
        out["title"], out["title_scale"] = quantize_rows_np(out["title"])
    out[QUANT_KEY] = np.str_("int8")
    return out


def dequantize_bank(bank: dict) -> dict:
    """A float view of a (possibly) quantized bank: int8 arrays expanded to
    fp32 and the scale and marker keys dropped. Float banks pass through
    unchanged."""
    if str(bank.get(QUANT_KEY, "")) != "int8":
        return dict(bank)
    out = {k: v for k, v in bank.items()
           if k not in (QUANT_KEY, "video_scale", "frame_scale",
                        "title_scale")}
    if "video" in out:
        out["video"] = dequantize_np(bank["video"], bank["video_scale"])
    if "frames" in out:
        out["frames"] = dequantize_np(bank["frames"], bank["frame_scale"])
    if "title" in out:
        out["title"] = dequantize_np(bank["title"], bank["title_scale"])
    return out


# -------------------------------------------------------------- device side

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tensor twin of :func:`quantize_rows_np`, on ``x``'s device."""
    x = x.float()
    scale = x.abs().amax(dim=-1).clamp_min(_EPS) / 127.0
    q = torch.round(x / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _pad_to(x: torch.Tensor, dim: int, multiple: int, least: int = 0
            ) -> torch.Tensor:
    n = x.shape[dim]
    want = max(-(-n // multiple) * multiple, least)
    if want == n:
        return x
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, want - n]
    return F.pad(x, pad)


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] x int8 ``b_t`` [N, K] -> int32 [M, N]: a . b_tᵀ.
    On the card ``torch._int_mm`` takes the bank side (``b_t``, the many
    rows) as its row-major left operand and the queries as its
    column-major right one, so a single query costs a width of 8, not 32
    rows: both are zero-padded to the shapes it takes (rows above 16, depth
    and width multiples of 8) and the padding is sliced off. On the CPU the
    same product in int32."""
    m, n = a.shape[0], b_t.shape[0]
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b_t.to(torch.int32).T
    a = _pad_to(_pad_to(a, 1, 8), 0, 8)
    b_t = _pad_to(_pad_to(b_t, 1, 8), 0, 8, _MIN_ROWS)
    return torch._int_mm(b_t, a.T)[:n, :m].T


def int8_rank(q: torch.Tensor, bank_q: torch.Tensor,
              bank_scale: torch.Tensor) -> torch.Tensor:
    """Ranking logits against an int8 bank: float queries ``q`` [Q, H] x
    ``bank_q`` int8 [V, H] with ``bank_scale`` f32 [V]. The queries are
    quantized on the fly, the product runs s8 x s8 -> s32, and the two
    scale vectors bring the integer logits back to float. Returns f32
    [Q, V]; normalized-embedding logits agree with the fp32 product to
    ~1e-2 at unit scale (two absmax-127 roundings)."""
    qq, qs = quantize_rows(q)
    acc = int_mm(qq, bank_q)
    return acc.float() * qs[:, None] * bank_scale[None, :].float()


def int8_frame_rank(q: torch.Tensor, frames_q: torch.Tensor,
                    frame_scale: torch.Tensor) -> torch.Tensor:
    """Per-frame ranking logits: float queries [Q, H] x int8 frames
    [V, F, H] (+ scales [V, F]) -> f32 [Q, V, F]."""
    qq, qs = quantize_rows(q)
    v, f, h = frames_q.shape
    acc = int_mm(qq, frames_q.reshape(v * f, h)).reshape(q.shape[0], v, f)
    return (acc.float() * qs[:, None, None]
            * frame_scale[None, :, :].float())
