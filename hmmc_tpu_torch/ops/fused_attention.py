"""Fused attention: the CUDA kernels' wrappers (K1 forward, K2 backward),
their plain PyTorch versions, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``fused_attention`` (a ``custom_vjp``), ``_flash_forward``
and ``_flash_backward`` in ``hmmc_tpu/ops/pallas_attention.py``. The kernels
are ``csrc/fused_attention_fwd.cu`` (K1: fp32 logits and softmax, P rounded
to v's dtype, fp32 accumulation) and ``csrc/fused_attention_bwd.cu`` (K2: P
recomputed in fp32 and not rounded, dq / dk / dv accumulated in fp32). Both
take any L and a head_dim in :data:`HEAD_DIMS` (each a compile-time
instance of every body; the temporal transformer's head_dim is embed_dim /
8 under ``cross-base``: 96 at ViT-L/14). Each has two bodies, chosen by L:
the short one (one CTA per head, the whole [L, L] row block on chip) up to
:data:`SHORT_MAX_LEN` (K2: :func:`short_max_len_backward`, by dtype and
head_dim), and the tiled one past it (64-row tiles; K1 an online softmax
over a ring of KV tiles, K2 a rows pass and a keys pass on Hopper's
warpgroup products with TMA staging, no atomics). In bfloat16 their
products run on the tensor cores; every pointer and batch / head /
sequence stride must be 16-byte aligned (float32, the reference checks,
keeps CUDA-core bodies with 16-byte loads too).

K2's bf16 tiled pair takes K1's output and K1's row statistics (the
log-sum-exp of each row's scaled logits in log2 units, ``lse``) instead of
walking the logits for them: :func:`saves_statistics` says where, and
there K1 writes them when asked (``with_stats``) and K2 refuses to run
without them.

:func:`fused_attention` is the entry point: its forward is K1 and its
backward K2, and it saves q, k and v for the backward as the JAX
``custom_vjp`` does, and, where K2 will run its bf16 tiled pair, K1's
output and statistics beside them. Device rule: a CUDA tensor launches the
kernels or raises; a CPU tensor takes the plain forward and the plain
backward, inside the same Function. There is no fallback from one to the
other.
``fused_attention.launches`` and ``fused_attention_backward.launches`` count
the wrappers' launches (a tiled K2 call, two kernels, counts once);
``short_launches`` and ``tiled_launches`` on each split them by body, and
``head_dim_launches`` (a dict keyed by head_dim) by head_dim.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Tuple

import torch

HEAD_DIMS = (64, 80, 96, 128)   # the head_dims the kernels are built for
SHORT_MAX_LEN = 128      # K1's short body's longest L at every head_dim;
                         # longer: the tiled
# K2's short body's longest L by dtype and head_dim: the longest multiple
# of 16 up to 128 whose staging fits 227 KB of shared memory (bf16: q, k,
# v, g tiles of 2 x head_dim bytes a row and P / dS hi and lo; fp32: q, k,
# v, g rows and the P and dS rows); the CUDA entry points compute the same
SHORT_MAX_LEN_BWD = {torch.bfloat16: {64: 128, 80: 128, 96: 112, 128: 112},
                     torch.float32: {64: 112, 80: 96, 96: 96, 128: 80}}
ALIGN = 16               # bytes: the bf16 kernels' copies are 16 bytes
TILE_ROWS = 64           # the tiled bodies' tile; K1's statistics are rows
                         # of L rounded up to it
# the shortest L at which K2 runs its bf16 tiled pair at some head_dim
# (K2's short limits are 112 and 128 in bf16): K1 writes its statistics
# from here (attention_mma.cuh's kStatsMinLen)
STATS_MIN_LEN = min(SHORT_MAX_LEN_BWD[torch.bfloat16].values()) + 1
_LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _causal_fill(logits: torch.Tensor) -> torch.Tensor:
    l = logits.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool, device=logits.device).tril()
    return logits.masked_fill(~keep, -1e30)


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              with_stats: bool = False):
    """Plain version of K1 with the kernel's casts (``_attention_reference``
    in the JAX package): fp32 logits and softmax, P cast to v's dtype, the
    product accumulated in fp32 and returned in q's dtype. ``with_stats``:
    also each row's log-sum-exp of its fp32 logits in log2 units, [B, H,
    L] fp32, the statistics K1 saves for K2."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        logits = _causal_fill(logits)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(w.float(), v.float()).to(q.dtype)
    if not with_stats:
        return o
    return o, torch.logsumexp(logits, dim=-1) * _LOG2E


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


def short_max_len_backward(dtype: torch.dtype, head_dim: int) -> int:
    """The longest sequence K2's short body takes in this dtype at this
    head_dim (one of :data:`HEAD_DIMS`)."""
    return SHORT_MAX_LEN_BWD[dtype][head_dim]


def kernel_body(seq_len: int, dtype: torch.dtype, head_dim: int,
                backward: bool = False) -> str:
    """"short" or "tiled": the body K1 (``backward``: K2) runs at this
    length, dtype and head_dim; the CUDA entry points choose by the same
    limits."""
    limit = (short_max_len_backward(dtype, head_dim) if backward
             else SHORT_MAX_LEN)
    return "short" if seq_len <= limit else "tiled"


def saves_statistics(seq_len: int, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether K2 runs its bf16 tiled pair here, which takes K1's output
    and row statistics (so the forward keeps them for the backward)."""
    return (dtype == torch.bfloat16 and head_dim in HEAD_DIMS
            and kernel_body(seq_len, dtype, head_dim, backward=True)
            == "tiled")


def tiles_len(seq_len: int) -> int:
    """L rounded up to whole 64-row tiles: the row stride of K1's
    statistics, so K2 reads a tile's 64 values as one aligned block."""
    return -(-seq_len // TILE_ROWS) * TILE_ROWS


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
                        v: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take these shapes, dtypes, strides and
    alignments (the device is checked by the caller). Any L >= 1, a
    head_dim in :data:`HEAD_DIMS`."""
    _check_common(q, k, v)
    _check_kernel(q, k, v)


def _check_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """:func:`check_kernel_inputs` after :func:`_check_common` passed."""
    b, h, l, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(
            f"the fused attention kernels take head_dim "
            f"{', '.join(map(str, HEAD_DIMS))}; got {d} (the temporal "
            "transformer's is embed_dim / the cross config's "
            "temporal_attention_heads)")
    if l < 1:
        raise ValueError(f"empty sequence: {tuple(q.shape)}")
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
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    lib.hmmc_fused_attention_fwd.restype = ctypes.c_int
    lib.hmmc_fused_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.hmmc_fused_attention_smem_bytes.restype = ctypes.c_longlong
    lib.hmmc_fused_attention_heads_per_cta.argtypes = [ctypes.c_int]
    lib.hmmc_fused_attention_heads_per_cta.restype = ctypes.c_int
    lib.hmmc_fused_attention_short_max_len.argtypes = [ctypes.c_int] * 2
    lib.hmmc_fused_attention_short_max_len.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_bwd() -> ctypes.CDLL:
    lib = _load("fused_attention_bwd")
    lib.hmmc_fused_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p])
    lib.hmmc_fused_attention_bwd.restype = ctypes.c_int
    lib.hmmc_fused_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.hmmc_fused_attention_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.hmmc_fused_attention_bwd_short_max_len.argtypes = [ctypes.c_int] * 2
    lib.hmmc_fused_attention_bwd_short_max_len.restype = ctypes.c_int
    lib.hmmc_fused_attention_bwd_stats_floats.argtypes = [ctypes.c_int] * 3
    lib.hmmc_fused_attention_bwd_stats_floats.restype = ctypes.c_longlong
    return lib


def kernel_smem_bytes(seq_len: int, dtype: torch.dtype,
                      head_dim: int) -> int:
    """Dynamic shared memory K1 gives one CTA at this length, dtype and
    head_dim (builds the kernel if needed)."""
    return int(_library().hmmc_fused_attention_smem_bytes(
        seq_len, _DTYPE_CODES[dtype], head_dim))


def kernel_heads_per_cta(dtype: torch.dtype) -> int:
    """(batch, head) pairs one K1 CTA takes in turn in this dtype, one
    head's loads overlapping the other's products."""
    return int(_library().hmmc_fused_attention_heads_per_cta(
        _DTYPE_CODES[dtype]))


def kernel_bwd_smem_bytes(seq_len: int, dtype: torch.dtype,
                          head_dim: int) -> int:
    """Dynamic shared memory K2 gives one CTA at this length, dtype and
    head_dim (the tiled pair: the larger of its two kernels')."""
    return int(_library_bwd().hmmc_fused_attention_bwd_smem_bytes(
        seq_len, _DTYPE_CODES[dtype], head_dim))


def kernel_short_max_len(dtype: torch.dtype, head_dim: int,
                         backward: bool = False) -> int:
    """The short body's limit as the built library has it (K1, or K2 with
    ``backward``; 0 for a head_dim it was not built for), to hold against
    :func:`kernel_body`'s."""
    code = _DTYPE_CODES[dtype]
    if backward:
        return int(_library_bwd().hmmc_fused_attention_bwd_short_max_len(
            code, head_dim))
    return int(_library().hmmc_fused_attention_short_max_len(code, head_dim))


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
    """K2's 24 strides as a C array, made once per stride pattern."""
    return (ctypes.c_longlong * len(strides))(*strides)


def _head_major(q: torch.Tensor) -> torch.Tensor:
    """A [B, L, H, D] buffer as its [B, H, L, D] view, so merging the
    heads afterwards is free."""
    b, h, l, d = q.shape
    return torch.empty_strided((b, h, l, d), (l * h * d, d, h * d, 1),
                               dtype=q.dtype, device=q.device)


def _count(fn, body: str, head_dim: int) -> None:
    fn.launches += 1
    if body == "tiled":
        fn.tiled_launches += 1
    else:
        fn.short_launches += 1
    fn.head_dim_launches[head_dim] += 1


def fused_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = False,
                            with_stats: bool = False):
    """K1's wrapper, without autograd: q, k, v [B, H, L, D] -> [B, H, L, D]
    in q's dtype. CPU tensors take :func:`fused_attention_reference`; on
    CUDA the inputs may be strided views (head splits of a packed qkv
    projection: no copy is made). ``with_stats``: also the rows'
    log-sum-exp in log2 units, [B, H, L] fp32 (on CUDA a view of rows of
    :func:`tiles_len` floats, bf16 and L >= :data:`STATS_MIN_LEN` only:
    K2's fp32 and short bodies take none)."""
    _check_common(q, k, v)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, causal, with_stats)
    _check_kernel(q, k, v)
    b, h, l, d = q.shape
    lse = None
    if with_stats:
        if q.dtype != torch.bfloat16 or l < STATS_MIN_LEN:
            raise ValueError(
                f"K1 writes row statistics in bfloat16 only and from L = "
                f"{STATS_MIN_LEN} (where K2's tiled pair can run); got "
                f"{q.dtype} at L = {l}")
        lse = torch.empty(b, h, tiles_len(l), dtype=torch.float32,
                          device=q.device)[..., :l]
    o = _head_major(q)
    _check_aligned(o=o)
    lib = _library()
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hmmc_fused_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, l, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            int(bool(causal)), stream, None if lse is None else lse.data_ptr())
    _raise_on(err, lib, "fused attention forward", q)
    _count(fused_attention, kernel_body(l, q.dtype, d), d)
    return o if lse is None else (o, lse)


def _check_saved(q: torch.Tensor, o, lse) -> None:
    """K2's bf16 tiled pair reads K1's output ``o`` and statistics ``lse``
    (as :func:`fused_attention_forward` returns them with ``with_stats``):
    raise unless both are there in that form."""
    b, h, l, d = q.shape
    if o is None or lse is None:
        raise ValueError(
            f"K2's bfloat16 tiled body (L = {l} past the short limit "
            f"{short_max_len_backward(q.dtype, d)} at head_dim {d}) takes "
            "K1's output and row statistics: pass o and lse from "
            "fused_attention_forward(..., with_stats=True)")
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device \
            or o.stride(-1) != 1:
        raise ValueError(
            f"o must be K1's output for q: {tuple(o.shape)} {o.dtype} "
            f"{o.device} strides {o.stride()} vs {tuple(q.shape)} {q.dtype}")
    _check_aligned(o=o)
    lp = tiles_len(l)
    if lse.shape != (b, h, l) or lse.dtype != torch.float32 \
            or lse.device != q.device or lse.stride() != (h * lp, lp, 1) \
            or lse.data_ptr() % ALIGN:
        raise ValueError(
            f"lse must be K1's row statistics for q: fp32 [B, H, L] rows of "
            f"{lp} floats; got {tuple(lse.shape)} {lse.dtype} strides "
            f"{lse.stride()}")


def fused_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, g: torch.Tensor,
                             causal: bool = False, o=None, lse=None) -> Grads:
    """K2's wrapper: (dq, dk, dv) of :func:`fused_attention` at q, k, v for
    the output gradient ``g``, each [B, H, L, D] in q's dtype. CPU tensors
    take :func:`fused_attention_backward_reference` (``o`` and ``lse`` are
    not needed there). On CUDA, q, k, v and g are read through their
    strides; a ``g`` whose last axis is not unit stride (an expanded
    gradient) or that is not 16-byte aligned is copied once to a fresh
    contiguous tensor. Where :func:`saves_statistics` holds, K1's output
    ``o`` and statistics ``lse`` are required (it raises without them) and
    the pair takes fp32 scratch for the rows' D (:func:`tiles_len` floats a
    head); the fp32 tiled pair takes scratch for its own statistics (3 x
    that)."""
    _check_common(q, k, v)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            f"g must match q in shape, dtype and device: {tuple(g.shape)} "
            f"{g.dtype} {g.device} vs {tuple(q.shape)} {q.dtype} {q.device}")
    if q.device.type == "cpu":
        return fused_attention_backward_reference(q, k, v, g, causal)
    _check_kernel(q, k, v)
    b, h, l, d = q.shape
    if saves_statistics(l, q.dtype, d):
        _check_saved(q, o, lse)
    else:
        o = lse = None
    if g.stride(-1) != 1 or not is_aligned(g):
        g = g.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = _head_major(q), _head_major(q), _head_major(q)
    _check_aligned(dq=dq, dk=dk, dv=dv)
    strides = _stride_array(
        q.stride()[:3] + k.stride()[:3] + v.stride()[:3] + g.stride()[:3]
        + dq.stride()[:3] * 3 + (o.stride()[:3] if o is not None
                                 else (0, 0, 0)))
    lib = _library_bwd()
    code = _DTYPE_CODES[q.dtype]
    stats = None
    per_head = lib.hmmc_fused_attention_bwd_stats_floats(l, code, d)
    if per_head:
        stats = torch.empty(b * h * per_head, dtype=torch.float32,
                            device=q.device)
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hmmc_fused_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            None if o is None else o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            code, b, h, l, d, strides,
            None if stats is None else stats.data_ptr(), int(bool(causal)),
            stream)
    _raise_on(err, lib, "fused attention backward", q)
    _count(fused_attention_backward,
           kernel_body(l, q.dtype, d, backward=True), d)
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward K1, backward K2; q, k, v are saved for the backward (the
    JAX ``custom_vjp``'s residuals), and where K2 runs its bf16 tiled pair
    (:func:`saves_statistics`) K1's output and row statistics too (the
    output's storage is the one the out-projection keeps anyway)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        b, h, l, d = q.shape
        if saves_statistics(l, q.dtype, d):
            o, lse = fused_attention_forward(q, k, v, causal, with_stats=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        return fused_attention_forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *saved = ctx.saved_tensors
        o, lse = saved if saved else (None, None)
        dq, dk, dv = fused_attention_backward(q, k, v, g, ctx.causal, o, lse)
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


def reset_launch_counts() -> None:
    """Every launch counter of K1 and K2 to 0."""
    for fn in (fused_attention, fused_attention_backward):
        fn.launches = fn.short_launches = fn.tiled_launches = 0
        fn.head_dim_launches = dict.fromkeys(HEAD_DIMS, 0)


reset_launch_counts()
