"""Fused attention: the CUDA kernels' wrappers (K1 forward, K2 backward),
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``fused_attention`` (a ``custom_vjp``), ``_flash_forward``
and ``_flash_backward`` in ``hmmc_tpu/ops/pallas_attention.py``. The kernels
are ``csrc/fused_attention_fwd.cu`` (K1: fp32 logits and softmax, P rounded
to v's dtype, fp32 accumulation; L <= 128) and ``csrc/fused_attention_bwd.cu``
(K2: P recomputed in fp32 and not rounded, dq / dk / dv accumulated in fp32;
L <= 128 in bf16, 112 in fp32). Both take head_dim 64. In bfloat16 their
products run on the tensor cores and heads are staged by 16-byte copies, so
every pointer and batch / head / sequence stride must be 16-byte aligned;
float32 (the reference checks) keeps a CUDA-core body, one CTA per head.

:func:`fused_attention` is the entry point: its forward is K1 and its
backward K2, and it saves q, k and v for the backward as the JAX
``custom_vjp`` does. Device rule: a CUDA tensor launches the kernels or
raises; a CPU tensor takes the plain forward and the plain backward, inside
the same Function. There is no fallback from one to the other.
``fused_attention.launches`` and ``fused_attention_backward.launches`` count
kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

HEAD_DIM = 64
MAX_LEN = 128            # K1
MAX_LEN_BWD = 128        # K2 in bf16: q, k, v, g and P / dS (hi and lo)
                         # staged in bf16 fit 227 KB of shared memory
MAX_LEN_BWD_FP32 = 112   # K2 in fp32: its fp32 staging fits up to here
ALIGN = 16               # bytes: the bf16 kernels' copies are 16 bytes
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


def max_len_backward(dtype: torch.dtype) -> int:
    """The longest sequence K2 takes in this dtype."""
    return MAX_LEN_BWD_FP32 if dtype == torch.float32 else MAX_LEN_BWD


def is_aligned(t: torch.Tensor) -> bool:
    """Data pointer and every batch / head / sequence stride (of an axis
    longer than 1) a multiple of :data:`ALIGN` bytes."""
    elt = t.element_size()
    return t.data_ptr() % ALIGN == 0 and all(
        n == 1 or s * elt % ALIGN == 0
        for n, s in zip(t.shape[:3], t.stride()[:3]))


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not is_aligned(t):
            raise ValueError(
                f"{name} must be {ALIGN}-byte aligned for the fused "
                f"attention kernels' {ALIGN}-byte loads: data pointer "
                f"offset {t.data_ptr() % ALIGN} bytes (storage_offset "
                f"{t.storage_offset()}), strides {t.stride()} of "
                f"{t.element_size()}-byte elements")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, max_len: int = MAX_LEN) -> None:
    """Raise unless the CUDA kernels take these shapes, dtypes, strides and
    alignments (the device is checked by the caller). ``max_len`` is K1's
    limit, or :func:`max_len_backward` where K2 will run too."""
    _check_common(q, k, v)
    _check_kernel(q, k, v, max_len)


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  max_len: int) -> None:
    """:func:`check_kernel_inputs` after :func:`_check_common` passed."""
    b, h, l, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the fused attention kernels take head_dim "
                         f"{HEAD_DIM}; got {d}")
    if not 1 <= l <= max_len:
        raise ValueError(
            f"the fused attention kernels take 1 <= L <= {max_len} (forward: "
            f"{MAX_LEN}; backward: {MAX_LEN_BWD} in bfloat16, "
            f"{MAX_LEN_BWD_FP32} in float32); got L={l}. Longer sequences "
            "(ViT-B/16, L=197; ViT-L/14@336px, "
            "L=577) need the KV-loop versions of K1 and K2, listed in "
            "ROADMAP.md Queue B")
    if b < 1 or h < 1:
        raise ValueError(f"empty batch or heads: {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis; "
                             f"strides {t.stride()}")
    _check_aligned(q=q, k=k, v=v)


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
    lib.hmmc_fused_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.hmmc_fused_attention_smem_bytes.restype = ctypes.c_longlong
    lib.hmmc_fused_attention_heads_per_cta.argtypes = [ctypes.c_int]
    lib.hmmc_fused_attention_heads_per_cta.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = _load("fused_attention_bwd")
    lib.hmmc_fused_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    lib.hmmc_fused_attention_bwd.restype = ctypes.c_int
    lib.hmmc_fused_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.hmmc_fused_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(seq_len: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory K1 gives one CTA at this length and dtype
    (builds the kernel if needed)."""
    return int(_library().hmmc_fused_attention_smem_bytes(
        seq_len, _DTYPE_CODES[dtype]))


def kernel_heads_per_cta(dtype: torch.dtype) -> int:
    """(batch, head) pairs one K1 CTA takes in turn in this dtype, one
    head's loads overlapping the other's products."""
    return int(_library().hmmc_fused_attention_heads_per_cta(
        _DTYPE_CODES[dtype]))


def kernel_bwd_smem_bytes(seq_len: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory K2 gives one CTA at this length and dtype."""
    return int(_library_bwd().hmmc_fused_attention_bwd_smem_bytes(
        seq_len, _DTYPE_CODES[dtype]))


def _raise_on(err: int, lib: ctypes.CDLL, what: str, q: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_cuda_error_string(err).decode()}) at shape "
            f"{tuple(q.shape)} {q.dtype}")


def _on_device(t: torch.Tensor):
    """``t``'s device as the current one: a no-op where it already is (the
    context manager costs more host time than the launch itself)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


@functools.lru_cache(maxsize=256)
def _stride_array(strides: Tuple[int, ...]) -> ctypes.Array:
    """K2's 21 strides as a C array, made once per stride pattern."""
    return (ctypes.c_longlong * len(strides))(*strides)


def _head_major(q: torch.Tensor) -> torch.Tensor:
    """A [B, L, H, D] buffer as its [B, H, L, D] view, so merging the
    heads afterwards is free."""
    b, h, l, d = q.shape
    return torch.empty_strided((b, h, l, d), (l * h * d, d, h * d, 1),
                               dtype=q.dtype, device=q.device)


def fused_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            max_len: int = MAX_LEN) -> torch.Tensor:
    """K1's wrapper, without autograd: q, k, v [B, H, L, D] -> [B, H, L, D]
    in q's dtype. CPU tensors take :func:`fused_attention_reference`; on
    CUDA the inputs may be strided views (head splits of a packed qkv
    projection: no copy is made). ``max_len`` is the longest L accepted:
    K1's limit, or :func:`max_len_backward` where K2 will run too."""
    _check_common(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, causal)
    _check_kernel(q, k, v, max_len)
    b, h, l, d = q.shape
    o = _head_major(q)
    _check_aligned(o=o)
    lib = _library()
    with _on_device(q):
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
    stride (an expanded gradient) or that is not 16-byte aligned is copied
    once to a fresh contiguous tensor."""
    _check_common(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"g must match q in shape, dtype and device: {tuple(g.shape)} "
            f"{g.dtype} {g.device} vs {tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type == "cpu":
        return fused_attention_backward_reference(q, k, v, g, causal)
    _check_kernel(q, k, v, max_len_backward(q.dtype))
    if g.stride(-1) != 1 or not is_aligned(g):
        g = g.clone(memory_format=torch.contiguous_format)
    b, h, l, d = q.shape
    dq, dk, dv = _head_major(q), _head_major(q), _head_major(q)
    _check_aligned(dq=dq, dk=dk, dv=dv)
    strides = _stride_array(
        q.stride()[:3] + k.stride()[:3] + v.stride()[:3] + g.stride()[:3]
        + dq.stride()[:3] * 3)
    lib = _library_bwd()
    with _on_device(q):
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
        # K2's limit where a gradient will flow: fail here, not in the
        # middle of the backward pass
        max_len = (max_len_backward(q.dtype) if any(ctx.needs_input_grad[:3])
                   else MAX_LEN)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return fused_attention_forward(q, k, v, causal, max_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(q, k, v, g, ctx.causal)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, L, D] -> [B, H, L, D] in q's dtype, differentiable:
    K1 forward and K2 backward on CUDA, the plain versions on the CPU.
    Where no gradient can flow (inference, or no input requiring one) the
    forward is called without the ``autograd.Function``, whose ``apply``
    costs more host time than the launch."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return fused_attention_forward(q, k, v, causal)
    return _FusedAttention.apply(q, k, v, bool(causal))


fused_attention.launches = 0
fused_attention_backward.launches = 0
