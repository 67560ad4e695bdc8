"""Fused attention: the CUDA kernels' wrappers (K1 forward, K2 backward),
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``fused_attention`` (a ``custom_vjp``), ``_flash_forward``
and ``_flash_backward`` in ``hmmc_tpu/ops/pallas_attention.py``. The kernels
are ``csrc/fused_attention_fwd.cu`` (K1: fp32 logits and softmax, P rounded
to v's dtype, fp32 accumulation; L <= 128) and ``csrc/fused_attention_bwd.cu``
(K2: P recomputed in fp32 and not rounded, dq / dk / dv accumulated in fp32;
L <= 112). Both take float32 and bfloat16 and head_dim 64, one CTA per
batch·head with the whole head in shared memory.

:func:`fused_attention` is the entry point: its forward is K1 and its
backward K2, and it saves q, k and v for the backward as the JAX
``custom_vjp`` does. Device rule: a CUDA tensor launches the kernels or
raises; a CPU tensor takes the plain forward and the plain backward, inside
the same Function. There is no fallback from one to the other.
``fused_attention.launches`` and ``fused_attention_backward.launches`` count
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

HEAD_DIM = 64
MAX_LEN = 128        # K1
MAX_LEN_BWD = 112    # K2 (kMaxLen in its source): its fp32 staging of
                     # q, k, v, g, P and dS fits 227 KB of shared memory
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _causal_fill(logits: torch.Tensor) -> torch.Tensor:
    l = logits.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool, device=logits.device).tril()
    return logits.masked_fill(~keep, -1e30)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """Plain version of K1 with the kernel's casts (``_attention_reference``
    in the JAX package): fp32 logits and softmax, P cast to v's dtype, the
    product accumulated in fp32 and returned in q's dtype."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        logits = _causal_fill(logits)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def fused_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, g: torch.Tensor,
                                       causal: bool = False) -> Grads:
    """Plain version of K2 (``_attention_bwd_kernel``), written out rather
    than taken from autograd of :func:`fused_attention_reference`: in bf16
    that autograd would use the rounded P for dV. Everything in fp32; dq,
    dk, dv returned in q's dtype."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        logits = _causal_fill(logits)
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_common(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"fused_attention takes [B, H, L, D]; got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_attention takes float32 or bfloat16 q, k, v of one dtype; "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_attention runs on cuda or cpu; got {q.device}")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, max_len: int = MAX_LEN) -> None:
    """Raise unless the CUDA kernels take these shapes, dtypes and strides
    (the device is checked by the caller). ``max_len`` is K1's limit, or
    :data:`MAX_LEN_BWD` where K2 will run too."""
    _check_common(q, k, v)
    b, h, l, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the fused attention kernels take head_dim "
                         f"{HEAD_DIM}; got {d}")
    if not 1 <= l <= max_len:
        raise ValueError(
            f"the fused attention kernels take 1 <= L <= {max_len} (backward: "
            f"{MAX_LEN_BWD}); got L={l}. Longer sequences (ViT-L/14@336px, "
            "L=577) need the KV-loop versions of K1 and K2, listed in "
            "ROADMAP.md Queue B")
    if b < 1 or h < 1:
        raise ValueError(f"empty batch or heads: {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis; "
                             f"strides {t.stride()}")


def _load(name: str) -> ctypes.CDLL:
    from hmmc_tpu_torch.ops import kernel_build

    lib = kernel_build.load(name)
    lib.hmmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hmmc_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _load("fused_attention_fwd")
    lib.hmmc_fused_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    lib.hmmc_fused_attention_fwd.restype = ctypes.c_int
    lib.hmmc_fused_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.hmmc_fused_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = _load("fused_attention_bwd")
    lib.hmmc_fused_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    lib.hmmc_fused_attention_bwd.restype = ctypes.c_int
    lib.hmmc_fused_attention_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.hmmc_fused_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(seq_len: int) -> int:
    """Dynamic shared memory K1 gives one CTA at this length (builds the
    kernel if needed)."""
    return int(_library().hmmc_fused_attention_smem_bytes(seq_len))


def kernel_bwd_smem_bytes(seq_len: int) -> int:
    """Dynamic shared memory K2 gives one CTA at this length."""
    return int(_library_bwd().hmmc_fused_attention_bwd_smem_bytes(seq_len))


def _raise_on(err: int, lib: ctypes.CDLL, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_cuda_error_string(err).decode()}) at shape "
            f"{tuple(q.shape)} {q.dtype}")


def _head_major(q: torch.Tensor) -> torch.Tensor:
    """A [B, L, H, D] buffer returned as its [B, H, L, D] view, so merging
    the heads afterwards is free."""
    b, h, l, d = q.shape
    return torch.empty((b, l, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def fused_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            causal: bool = False) -> torch.Tensor:
    """K1's wrapper, without autograd: q, k, v [B, H, L, D] -> [B, H, L, D]
    in q's dtype. CPU tensors take :func:`fused_attention_reference`; on
    CUDA the inputs may be strided views (head splits of a packed qkv
    projection: no copy is made)."""
    _check_common(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, causal)
    check_kernel_inputs(q, k, v)
    b, h, l, d = q.shape
    o = _head_major(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hmmc_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, l, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(bool(causal)), stream)
    _raise_on(err, lib, "fused attention forward", q)
    fused_attention.launches += 1
    return o


def fused_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, g: torch.Tensor,
                             causal: bool = False) -> Grads:
    """K2's wrapper: (dq, dk, dv) of :func:`fused_attention` at q, k, v for
    the output gradient ``g``, each [B, H, L, D] in q's dtype. CPU tensors
    take :func:`fused_attention_backward_reference`. On CUDA, q, k, v and g
    are read through their strides; a ``g`` whose last axis is not unit
    stride (an expanded gradient) is copied once to a contiguous tensor."""
    _check_common(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"g must match q in shape, dtype and device: {tuple(g.shape)} "
            f"{g.dtype} {g.device} vs {tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type == "cpu":
        return fused_attention_backward_reference(q, k, v, g, causal)
    check_kernel_inputs(q, k, v, MAX_LEN_BWD)
    if g.stride(-1) != 1:
        g = g.contiguous()
    b, h, l, d = q.shape
    dq, dk, dv = _head_major(q), _head_major(q), _head_major(q)
    strides = (ctypes.c_longlong * 21)(*(
        s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]))
    lib = _library_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hmmc_fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, l, d, strides, int(bool(causal)),
            stream)
    _raise_on(err, lib, "fused attention backward", q)
    fused_attention_backward.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward K1, backward K2; q, k, v are saved for the backward (the
    JAX ``custom_vjp``'s residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cuda" and any(ctx.needs_input_grad[:3]):
            # fail here, not in the middle of the backward pass
            check_kernel_inputs(q, k, v, MAX_LEN_BWD)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return fused_attention_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, g, ctx.causal)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, L, D] -> [B, H, L, D] in q's dtype, differentiable:
    K1 forward and K2 backward on CUDA, the plain versions on the CPU."""
    return _FusedAttention.apply(q, k, v, bool(causal))


fused_attention.launches = 0
fused_attention_backward.launches = 0
