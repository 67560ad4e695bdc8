"""Fused attention forward (K1): the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``fused_attention`` / ``_flash_forward`` in
``hmmc_tpu/ops/pallas_attention.py``. The kernel is
``csrc/fused_attention_fwd.cu`` (one CTA per batch·head, the whole head in
shared memory, fp32 logits and softmax, P rounded to v's dtype, fp32
accumulation); it takes float32 and bfloat16, head_dim 64 and L <= 128.

Device rule: a CUDA tensor launches the kernel or raises; a CPU tensor
takes :func:`fused_attention_reference`. There is no fallback from one to
the other. ``fused_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

HEAD_DIM = 64
MAX_LEN = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal: bool = False) -> torch.Tensor:
    """Plain version with the kernel's casts (``_attention_reference`` in
    the JAX package): fp32 logits and softmax, P cast to v's dtype, the
    product accumulated in fp32 and returned in q's dtype."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        l = q.shape[2]
        keep = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


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


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise unless the CUDA kernel takes these shapes, dtypes and strides
    (the device is checked by the caller)."""
    _check_common(q, k, v)
    b, h, l, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the fused attention kernel takes head_dim "
                         f"{HEAD_DIM}; got {d}")
    if not 1 <= l <= MAX_LEN:
        raise ValueError(
            f"the fused attention kernel takes 1 <= L <= {MAX_LEN}; got L={l}. "
            "Longer sequences (ViT-L/14@336px, L=577) need the KV-loop "
            "version of this kernel, listed under K1 in ROADMAP.md Queue B")
    if b < 1 or h < 1:
        raise ValueError(f"empty batch or heads: {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride on its last axis; "
                             f"strides {t.stride()}")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from hmmc_tpu_torch.ops import kernel_build

    lib = kernel_build.load("fused_attention_fwd")
    lib.hmmc_fused_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_void_p])
    lib.hmmc_fused_attention_fwd.restype = ctypes.c_int
    lib.hmmc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hmmc_cuda_error_string.restype = ctypes.c_char_p
    lib.hmmc_fused_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.hmmc_fused_attention_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(seq_len: int) -> int:
    """Dynamic shared memory the kernel gives one CTA at this length
    (builds the kernel if needed)."""
    return int(_library().hmmc_fused_attention_smem_bytes(seq_len))


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v: [B, H, L, D] -> [B, H, L, D] in q's dtype.

    On CUDA the inputs may be strided views (head splits of a packed qkv
    projection: no copy is made); the output is allocated [B, L, H, D] and
    returned as its [B, H, L, D] view, so merging the heads afterwards is
    free."""
    _check_common(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu; got {q.device}")
    check_kernel_inputs(q, k, v)
    b, h, l, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hmmc_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, l, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused attention kernel launch failed: CUDA error {err} "
            f"({lib.hmmc_cuda_error_string(err).decode()}) at shape "
            f"{tuple(q.shape)} {q.dtype}")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
