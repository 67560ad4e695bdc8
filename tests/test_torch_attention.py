"""Port attention (hmmc_tpu_torch.ops) against the JAX package.

On the CPU the port's ``fused_attention`` takes its plain forward and plain
backward; the JAX ``fused_attention`` runs its Pallas kernels in interpret
mode, as tests/test_pallas_attention.py does. Inputs are made with numpy
from a seed and handed to both. Tolerances (fp32): outputs atol 2e-5, rtol
1e-4, the JAX package's own kernel-vs-XLA tolerance; gradients atol 5e-5,
rtol 1e-3, its fused-gradient tolerance (values there reach ~10, the
products of two unit-variance heads over 64 dims, scaled).

The ``gpu`` tests hold the CUDA kernels against the plain versions on the
card at every head_dim they are built for (64, 80, 96, 128), both bodies
of each (short up to 128, K2's up to 128, 112, 96 or 80 by dtype and
head_dim, and tiled past it; the plain versions at the tiled bodies'
lengths and at the other head_dims are held to JAX in
tests/test_torch_model.py), K1's row statistics against the plain
version's, and the gradients of an attention block on the card against the
CPU; they skip without one. K2's bf16 tiled pair is called as the autograd
Function calls it, with K1's output and statistics (``_k2``).
"""

import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from hmmc_tpu_torch.models.layers import ResidualAttentionBlock
from hmmc_tpu_torch.ops.attention import causal_mask, multi_head_attention
from hmmc_tpu_torch.ops import kernel_build
from hmmc_tpu_torch.ops import fused_attention as fa
from hmmc_tpu_torch.ops.fused_attention import (
    HEAD_DIMS, SHORT_MAX_LEN, SHORT_MAX_LEN_BWD, check_kernel_inputs,
    fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_forward,
    fused_attention_reference, kernel_body, kernel_heads_per_cta,
    kernel_short_max_len, reset_launch_counts, saves_statistics,
    short_max_len_backward, tiles_len)

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3
# K1's statistics (fp32, log2 units) against the plain version's: the
# kernel sums exact products in another order and takes ex2 / lg2
# approximations (about 2^-22 relative each)
STATS_ATOL, STATS_RTOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:  # the reference; the card's machine has no JAX and runs the gpu tests
    import jax
    import jax.numpy as jnp

    import hmmc_tpu.ops.pallas_attention as pa
    from hmmc_tpu.ops.attention import causal_mask as jax_causal_mask
    from hmmc_tpu.ops.attention import multi_head_attention as jax_mha
except ImportError:
    pa = None


@pytest.fixture(autouse=True)
def interpret_mode(request, monkeypatch):
    """CPU has no Mosaic backend; run the JAX kernel in interpreter mode."""
    if request.node.get_closest_marker("gpu") is None:
        if pa is None:
            pytest.skip("needs jax and hmmc_tpu (the reference)")
        from jax.experimental import pallas as pl

        monkeypatch.setattr(pa.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    yield


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("b,h,l,d,causal", [
    (2, 3, 50, 32, False),     # ViT-like, unaligned L
    (2, 2, 77, 64, True),      # CLIP text context, causal
    (2, 8, 12, 64, False),     # temporal transformer
    (3, 8, 32, 64, True),      # text at max_words
])
def test_fused_attention_matches_jax(b, h, l, d, causal):
    rng = np.random.default_rng(l + d)
    q, k, v = (_normal(rng, b, h, l, d) for _ in range(3))
    ref = np.asarray(pa.fused_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal))
    ours = fused_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           causal)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_fused_attention_cpu_counts_no_launch():
    before = (fused_attention.launches,
              dict(fused_attention.head_dim_launches))
    for d in (64, 96):
        x = torch.zeros(1, 1, 4, d)
        fused_attention(x, x, x)
    assert (fused_attention.launches,
            fused_attention.head_dim_launches) == before


@pytest.mark.parametrize("b,h,l,d,causal", [
    (1, 2, 33, 16, True),      # tests/test_pallas_attention.py's causal case
    (2, 3, 50, 32, False),     # ViT-like, unaligned L and head_dim
    (2, 8, 12, 64, False),     # temporal transformer
])
def test_backward_reference_matches_jax_flash_backward(b, h, l, d, causal):
    """K2's plain version against the JAX K2 (interpret mode)."""
    rng = np.random.default_rng(100 + l)
    q, k, v, g = (_normal(rng, b, h, l, d) for _ in range(4))
    ref = pa._flash_backward(*(jnp.asarray(t) for t in (q, k, v, g)), causal)
    ours = fused_attention_backward_reference(
        *(torch.tensor(t) for t in (q, k, v, g)), causal)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_attention_autograd_matches_jax_vjp(causal):
    """Autograd through the port's Function (CPU: plain forward and plain
    backward) against ``jax.vjp`` of the JAX ``fused_attention``."""
    b, h, l, d = 2, 3, 20, 64
    rng = np.random.default_rng(7 + causal)
    q, k, v, g = (_normal(rng, b, h, l, d) for _ in range(4))
    out, vjp = jax.vjp(lambda *a: pa.fused_attention(*a, causal),
                       *(jnp.asarray(t) for t in (q, k, v)))
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    before = (fused_attention.launches, fused_attention_backward.launches)
    o = fused_attention(tq, tk, tv, causal)
    assert o.grad_fn is not None
    o.backward(torch.tensor(g))
    assert (fused_attention.launches,
            fused_attention_backward.launches) == before   # CPU: no kernel
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=ATOL, rtol=RTOL)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def test_backward_through_packed_qkv_views():
    """Gradients reach the packed qkv projection through the head views and
    the transposed output gradient, as in ``multi_head_attention``."""
    b, l, h, d = 2, 9, 2, 64
    rng = np.random.default_rng(3)
    x = _normal(rng, b, l, 3 * h * d)
    w = torch.tensor(_normal(rng, b, l, h * d))

    def qkv_grad(attend):
        qkv = torch.tensor(x, requires_grad=True)
        q, k, v = (t.transpose(1, 2) for t in
                   qkv.view(b, l, 3, h, d).unbind(2))
        out = attend(q, k, v).transpose(1, 2).reshape(b, l, h * d)
        (out * w).sum().backward()
        return qkv.grad.numpy()

    def plain(q, k, v):
        logits = (q @ k.transpose(-1, -2)) * d ** -0.5 + causal_mask(l)
        return torch.softmax(logits, -1) @ v

    np.testing.assert_allclose(
        qkv_grad(lambda q, k, v: fused_attention(q, k, v, True)),
        qkv_grad(plain), atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "causal", "additive"])
def test_multi_head_attention_matches_jax(use_pallas, mask_kind):
    b, l, d, heads = 3, 17, 64, 2
    rng = np.random.default_rng(5)
    x = _normal(rng, b, l, d)
    in_k = _normal(rng, d, 3 * d) * d ** -0.5     # JAX [in, out] layout
    in_b = _normal(rng, 3 * d) * 0.1
    out_k = _normal(rng, d, d) * d ** -0.5
    out_b = _normal(rng, d) * 0.1
    causal = mask_kind == "causal"
    jmask = tmask = None
    if causal:
        jmask, tmask = jax_causal_mask(l), causal_mask(l)
    elif mask_kind == "additive":
        keep = rng.random((b, 1, 1, l)) > 0.3
        keep[..., 0] = True
        add = np.where(keep, 0.0, -1e9).astype(np.float32)
        jmask, tmask = jnp.asarray(add), torch.tensor(add)
    ref = np.asarray(jax_mha(
        jnp.asarray(x), jnp.asarray(in_k), jnp.asarray(in_b),
        jnp.asarray(out_k), jnp.asarray(out_b), heads, jmask,
        use_pallas=use_pallas, causal=causal))
    ours = multi_head_attention(
        torch.tensor(x), torch.tensor(in_k.T.copy()), torch.tensor(in_b),
        torch.tensor(out_k.T.copy()), torch.tensor(out_b), heads, tmask,
        use_fused=use_pallas, causal=causal)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", [
    "rank", "shape_mismatch", "float16", "mixed_dtype"])
def test_wrapper_rejects_bad_inputs(case):
    x = torch.zeros(2, 2, 8, 64)
    args = {
        "rank": (x[0], x[0], x[0]),
        "shape_mismatch": (x, x, x[:, :, :4]),
        "float16": (x.half(), x.half(), x.half()),
        "mixed_dtype": (x, x.bfloat16(), x),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        fused_attention(*args)


@pytest.mark.parametrize("shape,match", [
    ((2, 2, 8, 32), "head_dim 64, 80, 96, 128; got 32"),
    ((2, 2, 8, 72), "head_dim 64, 80, 96, 128; got 72"),
    ((2, 2, 8, 160), "head_dim 64, 80, 96, 128; got 160"),
    ((2, 2, 0, 64), "empty sequence"),
    ((2, 0, 8, 64), "empty"),
])
def test_kernel_input_checks(shape, match):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        check_kernel_inputs(x, x, x)


@pytest.mark.parametrize("d", [64, 80, 96, 128])
def test_kernel_input_checks_take_the_head_dims(d):
    """Exactly 64, 80, 96 and 128, each in both dtypes and on packed head
    views (a row of 2 x head_dim bytes is a multiple of 16 at each)."""
    assert HEAD_DIMS == (64, 80, 96, 128)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.zeros(2, 12, 3 * 8 * d, dtype=dtype)
        q, k, v = (t.transpose(1, 2) for t in
                   qkv.view(2, 12, 3, 8, d).unbind(2))
        check_kernel_inputs(q, k, v)


def test_kernel_scales_are_the_plain_versions():
    """The kernels' per-head_dim scale is the plain version's
    ``head_dim ** -0.5`` rounded once to fp32, bit for bit, and the tiled
    bodies' log2 constant is that value times log2(e) within an fp32 ulp
    (attention_mma.cuh)."""
    import math
    import re

    src = open(os.path.join(REPO, "hmmc_tpu_torch", "csrc",
                            "attention_mma.cuh")).read()
    found = {int(d): (float.fromhex(sc), float.fromhex(lg)) for d, sc, lg in
             re.findall(r"struct Scale<(\d+)> \{\s*static constexpr float "
                        r"kScale = (\S+)f;\s*static constexpr float kLog2 = "
                        r"(\S+)f;", src)}
    assert sorted(found) == list(HEAD_DIMS)
    for d, (scale, log2) in found.items():
        plain = np.float32(d ** -0.5)
        assert np.float32(scale) == scale and scale == float(plain), d
        want = np.float32(float(plain) * math.log2(math.e))
        assert abs(np.float32(log2) - want) <= np.spacing(want), d
        logits = torch.randn(64, generator=torch.Generator().manual_seed(d))
        torch.testing.assert_close(logits * np.float32(scale),
                                   logits * d ** -0.5, rtol=0, atol=0)


@pytest.mark.parametrize("l", [129, 577, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_take_any_length(dtype, l):
    """No length limit: past the short bodies the tiled ones run."""
    x = torch.zeros(2, 2, l, 64, dtype=dtype)
    check_kernel_inputs(x, x, x)
    for d in HEAD_DIMS:
        assert kernel_body(l, dtype, d) == kernel_body(l, dtype, d, True) \
            == "tiled"


def _k2_short_smem(dtype, d, l):
    """Shared memory of K2's short body (fused_attention_bwd.cu's
    smem_bytes_mma / smem_bytes_fp32) at head_dim d and length l."""
    if dtype == torch.bfloat16:
        lp = (l + 15) // 16 * 16
        return 4 * lp * 2 * d + 4 * lp * (2 * (lp // 16) + 1) * 16
    lp4 = (l + 3) // 4 * 4
    return 4 * (l * (2 * d + 2 * (d + 4)) + 2 * l * lp4)


def test_backward_input_checks():
    """Each body's range: K1 short up to 128 at every head_dim; K2 up to
    the longest multiple of 16 (at most 128) whose staging fits 227 KB of
    shared memory, by dtype and head_dim (bf16 128, 128, 112, 112 and fp32
    112, 96, 96, 80 at 64, 80, 96, 128); tiled past (the CUDA entry points
    hold the same limits, see test_kernel_bodies_and_counters_on_card)."""
    assert SHORT_MAX_LEN == 128
    assert SHORT_MAX_LEN_BWD == {
        torch.bfloat16: {64: 128, 80: 128, 96: 112, 128: 112},
        torch.float32: {64: 112, 80: 96, 96: 96, 128: 80}}
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            bwd_limit = short_max_len_backward(dtype, d)
            assert bwd_limit == SHORT_MAX_LEN_BWD[dtype][d]
            assert bwd_limit == max(
                l for l in range(16, 129, 16)
                if _k2_short_smem(dtype, d, l) <= 232448), (dtype, d)
            for l, fwd, bwd in ((1, "short", "short"),
                                (bwd_limit, "short", "short"),
                                (bwd_limit + 1, "short" if bwd_limit
                                 < SHORT_MAX_LEN else "tiled", "tiled"),
                                (SHORT_MAX_LEN + 1, "tiled", "tiled")):
                assert kernel_body(l, dtype, d) == fwd, (dtype, d, l)
                assert kernel_body(l, dtype, d, backward=True) == bwd, (
                    dtype, d, l)
    x = torch.zeros(2, 2, SHORT_MAX_LEN_BWD[torch.float32][64] + 1, 64)
    check_kernel_inputs(x, x, x)   # K1's short body, K2's tiled one
    y = torch.zeros(2, 2, 8, 64)
    with pytest.raises(ValueError, match="g must match"):
        fused_attention_backward(y, y, y, y[:, :, :4])
    with pytest.raises(ValueError, match="g must match"):
        fused_attention_backward(y, y, y, y.bfloat16())


def test_kernel_input_checks_stride():
    x = torch.zeros(2, 2, 64, 8).transpose(-1, -2)   # last-axis stride 8
    with pytest.raises(ValueError, match="unit stride"):
        check_kernel_inputs(x, x, x)
    # head views of a packed qkv projection are accepted as they are
    qkv = torch.zeros(2, 50, 3 * 12 * 64)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(2, 50, 3, 12, 64).unbind(2))
    check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_input_checks_alignment(dtype):
    """The kernels' 16-byte loads need 16-byte aligned pointers and
    strides: a view one element into its storage is refused by name."""
    flat = torch.zeros(2 * 2 * 8 * 64 + 1, dtype=dtype)
    odd = flat[1:].view(2, 2, 8, 64)
    assert odd.storage_offset() == 1
    ok = torch.zeros(2, 2, 8, 64, dtype=dtype)
    check_kernel_inputs(ok, ok, ok)
    with pytest.raises(ValueError, match=r"k must be 16-byte aligned.*"
                       r"storage_offset 1"):
        check_kernel_inputs(ok, odd, ok)
    # a sequence stride of 3 * 64 + 1 elements is not 16-byte aligned
    wide = torch.zeros(2, 8, 3 * 64 + 1, dtype=dtype)
    q = wide[..., :64].view(2, 1, 8, 64)
    with pytest.raises(ValueError, match="q must be 16-byte aligned"):
        check_kernel_inputs(q, q, q)


def test_kernel_build_key_covers_headers(tmp_path, monkeypatch):
    """An edited shared header changes the library's key, so the kernels
    that include it are rebuilt; nothing is compiled here."""
    monkeypatch.setattr(kernel_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "mma.cuh"\n')
    (tmp_path / "mma.cuh").write_text("// v1\n")
    fake_nvcc = str(tmp_path / "bin" / "nvcc")
    first = kernel_build._target("k", fake_nvcc)
    assert kernel_build._target("k", fake_nvcc) == first
    (tmp_path / "mma.cuh").write_text("// v2\n")
    second = kernel_build._target("k", fake_nvcc)
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert kernel_build._target("k", fake_nvcc) not in (first, second)
    assert not (tmp_path / "build").exists()


def test_import_needs_neither_nvcc_nor_triton():
    """Importing the ops builds nothing: no nvcc on PATH and a blocked
    ``triton`` import still import cleanly."""
    code = ("import sys; sys.modules['triton'] = None; "
            "import hmmc_tpu_torch.ops.attention, "
            "hmmc_tpu_torch.ops.fused_attention as fa; "
            "assert fa._library.cache_info().currsize == 0")
    env = {k: v for k, v in os.environ.items() if k != "CUDA_HOME"}
    env["PATH"] = os.path.dirname(sys.executable)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("l", [113, 129, 197, 577])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_statistics_are_the_log_sum_exp(causal, l):
    """The plain K1's statistics are each row's log-sum-exp of its fp32
    scaled logits in log2 units (float64 here), so 2^(logits log2 e - lse)
    is the softmax: rows summing to 1, masked keys 0."""
    rng = np.random.default_rng(l + causal)
    q, k, v = (torch.tensor(_normal(rng, 2, 3, l, 64)) for _ in range(3))
    o, lse = fused_attention_reference(q, k, v, causal, with_stats=True)
    assert lse.shape == (2, 3, l) and lse.dtype == torch.float32
    torch.testing.assert_close(o, fused_attention_reference(q, k, v, causal),
                               rtol=0, atol=0)
    logits = (q.double() @ k.double().transpose(-1, -2)) * 64 ** -0.5
    keep = torch.ones(l, l, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    logits = logits.masked_fill(~keep, -np.inf) * np.log2(np.e)
    m = logits.amax(-1, keepdim=True)
    want = m[..., 0] + torch.log2(torch.exp2(logits - m).sum(-1))
    torch.testing.assert_close(lse.double(), want, atol=STATS_ATOL,
                               rtol=STATS_RTOL)
    p = torch.exp2(logits - lse.double()[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones(2, 3, l, dtype=p.dtype),
                               atol=1e-5, rtol=0)
    assert not p.masked_select(~keep).any()


def test_function_saves_statistics_only_when_a_gradient_flows(monkeypatch):
    """The Function asks K1 for its statistics, and saves them with its
    output beside q, k, v, only where K2 runs its bf16 tiled pair and a
    gradient flows; inference takes K1 without them. The CPU results are
    the plain versions' either way."""
    asked = []
    real = fa.fused_attention_forward

    def spy(*args, **kw):
        asked.append(kw.get("with_stats", False))
        return real(*args, **kw)

    monkeypatch.setattr(fa, "fused_attention_forward", spy)
    rng = np.random.default_rng(11)
    for l, dtype, d, saved in ((129, torch.bfloat16, 64, 5),
                               (113, torch.bfloat16, 96, 5),
                               (113, torch.bfloat16, 64, 3),
                               (50, torch.bfloat16, 64, 3),
                               (577, torch.float32, 64, 3)):
        assert saves_statistics(l, dtype, d) == (saved == 5)
        q, k, v, g = (torch.tensor(_normal(rng, 1, 2, l, d)).to(dtype)
                      for _ in range(4))
        asked.clear()
        with torch.no_grad():
            plain = fused_attention(q, k, v)
        assert asked == [False]
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        asked.clear()
        out = fused_attention(*leaves)
        assert asked == [saved == 5]
        tensors = out.grad_fn.saved_tensors
        assert len(tensors) == saved
        if saved == 5:
            assert torch.equal(tensors[3], out)
            assert tensors[4].shape == (1, 2, l)
            assert tensors[4].dtype == torch.float32
        assert torch.equal(out.detach(), plain)
        assert torch.equal(plain, fused_attention_reference(q, k, v))
        out.backward(g)
        for t, want in zip(leaves, fused_attention_backward_reference(
                q, k, v, g)):
            assert torch.equal(t.grad, want)


def test_tiles_len_is_whole_tiles():
    """K1's statistics rows (and K2's D scratch) are L rounded up to whole
    64-row tiles, the row stride K2's tiled pair reads them by; K1 writes
    them from the shortest L at which K2's bf16 pair runs, the length the
    CUDA source holds too."""
    assert [tiles_len(l) for l in (1, 64, 65, 113, 129, 577)] == [
        64, 64, 128, 128, 192, 640]
    src = open(os.path.join(REPO, "hmmc_tpu_torch", "csrc",
                            "attention_mma.cuh")).read()
    assert int(re.search(r"kStatsMinLen = (\d+);", src).group(1)) \
        == fa.STATS_MIN_LEN == 113
    for d in HEAD_DIMS:
        assert not saves_statistics(fa.STATS_MIN_LEN - 1, torch.bfloat16, d)
    assert saves_statistics(fa.STATS_MIN_LEN, torch.bfloat16, 96)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _k2(q, k, v, go, causal=False):
    """K2 as the autograd Function calls it: where its bf16 tiled pair
    runs, with the output and statistics of one K1 launch."""
    b, h, l, d = q.shape
    saved = {}
    if saves_statistics(l, q.dtype, d):
        o, lse = fused_attention_forward(q, k, v, causal, with_stats=True)
        saved = dict(o=o, lse=lse)
    return fused_attention_backward(q, k, v, go, causal, **saved)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,causal", [
    (768, 12, 50, False),      # ViT-B/32, 64 clips x 12 frames
    (512, 8, 32, True),        # text block, causal
    (64, 8, 12, False),        # temporal transformer
    (4, 3, 77, True),
    (4, 3, 128, False),
    (3, 2, 1, False),
    (96, 12, 197, False),      # ViT-B/16, 8 clips x 12 frames
    (96, 16, 577, False),      # ViT-L/14@336px, 8 clips x 12 frames
])
def test_kernel_matches_plain_on_card(cuda, dtype, b, h, l, causal):
    g = torch.Generator(device=cuda).manual_seed(l)
    qkv = torch.randn(b, l, 3 * h * 64, device=cuda, generator=g).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(b, l, 3, h, 64).unbind(2))
    before = fused_attention.launches
    out = fused_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = fused_attention_reference(q, k, v, causal)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    else:   # both round P to bf16; allow one output ulp
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,causal", [
    (768, 12, 50, False),      # ViT-B/32, a 64-clip micro-batch x 12 frames
    (64, 8, 32, True),         # text, causal
    (64, 8, 12, False),        # temporal transformer
    (4, 3, 77, True),
    (4, 3, SHORT_MAX_LEN_BWD[torch.float32][64], False),
    (3, 2, 1, False),
    (48, 16, 257, False),      # ViT-L/14, 4 clips x 12 frames
    (48, 16, 577, False),      # ViT-L/14@336px, 4 clips x 12 frames
])
def test_backward_kernel_matches_plain_on_card(cuda, dtype, b, h, l, causal):
    """K2 on the main path's layout (head views of a packed qkv output, the
    output gradient as the transposed view of a [B, L, H, 64] tensor)."""
    g = torch.Generator(device=cuda).manual_seed(l)
    qkv = torch.randn(b, l, 3 * h * 64, device=cuda, generator=g).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(b, l, 3, h, 64).unbind(2))
    go = torch.randn(b, l, h, 64, device=cuda, generator=g).to(dtype)
    go = go.transpose(1, 2)
    before = fused_attention_backward.launches
    got = _k2(q, k, v, go, causal)
    torch.cuda.synchronize()
    assert fused_attention_backward.launches == before + 1
    ref = fused_attention_backward_reference(q, k, v, go, causal)
    for a, r in zip(got, ref):
        assert a.shape == q.shape and a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, r, atol=GRAD_ATOL, rtol=GRAD_RTOL)
        else:   # fp32 inside both, one rounding of each output: one ulp
            torch.testing.assert_close(a.float(), r.float(), atol=1e-2,
                                       rtol=2 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [50, 577])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_gradients_on_card_match_cpu(cuda, causal, l):
    """Every parameter of an attention block, and its input, gets on the
    card the gradient the CPU gives (fp32, TF32 off; sums in another
    order), through the short bodies (L = 50) and the tiled ones (L = 577,
    ViT-L/14@336px). The kernel's output must carry the graph: an output
    written outside autograd leaves the qkv projection and everything below
    the attention without a gradient."""
    torch.manual_seed(0)
    cpu = ResidualAttentionBlock(128, 2, causal=causal, use_fused=True)
    cpu.reset_parameters(torch.Generator().manual_seed(1))
    card = ResidualAttentionBlock(128, 2, causal=causal, use_fused=True)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    rng = np.random.default_rng(2)
    x = _normal(rng, 3, l, 128)
    w = _normal(rng, 3, l, 128)
    grads, launches = {}, {}
    for name, block, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        mask = causal_mask(l, device=dev) if causal else None
        before = fused_attention_backward.launches
        (block(xt, mask) * torch.tensor(w, device=dev)).sum().backward()
        launches[name] = fused_attention_backward.launches - before
        grads[name] = {"x": xt.grad, **{n: p.grad for n, p in
                                        block.named_parameters()}}
    assert launches == {"cpu": 0, "card": 1}
    for n, ref in grads["cpu"].items():
        got = grads["card"][n]
        assert got is not None, f"{n}: no gradient on the card"
        torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=1e-4,
                                   msg=n)


# every edge of the 16-row / 8-key mma tiles up to the short bodies' limits,
# both sides of each limit at every head_dim, and the tiled bodies' 64-row
# tile edges up to ViT-L/14@336px's 577 and an odd length past it
SWEEP_LENGTHS = [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 49, 50, 63, 64, 65, 77,
                 80, 81, 96, 97, 112, 113, 128, 129, 160, 191, 192, 193, 197,
                 256, 257, 577, 613]
# 3 x 5 = 15 heads: not a multiple of K1's heads per CTA
SWEEP_B, SWEEP_H = 3, 5


def _packed_qkv(device, dtype, b, h, l, seed, d=64):
    """Head views of a packed [B, L, 3·H·D] projection, the main path's
    layout, and an output gradient that is the transposed view of a
    [B, L, H, D] tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * d, device=device, generator=g).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(b, l, 3, h, d).unbind(2))
    go = torch.randn(b, l, h, d, device=device, generator=g).to(dtype)
    return q, k, v, go.transpose(1, 2)


def _assert_close_on_card(got, ref, dtype, grad=False):
    if dtype == torch.float32:
        atol, rtol = (GRAD_ATOL, GRAD_RTOL) if grad else (ATOL, RTOL)
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    else:   # one output ulp: 2^-7 relative
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)


def test_sweep_lengths_reach_the_limits():
    """The sweep takes each body on both sides of each limit at every
    head_dim, the towers' lengths, and an odd length past the longest."""
    limits = {SHORT_MAX_LEN} | {short_max_len_backward(dtype, d)
                                for dtype in SHORT_MAX_LEN_BWD
                                for d in HEAD_DIMS}
    for limit in limits:
        assert limit in SWEEP_LENGTHS and limit + 1 in SWEEP_LENGTHS
    for l in (197, 257, 577):   # ViT-B/16, ViT-L/14, ViT-L/14@336px
        assert l in SWEEP_LENGTHS
    assert max(SWEEP_LENGTHS) > 577 and max(SWEEP_LENGTHS) % 2 == 1
    bodies = {(kernel_body(l, dt, d), kernel_body(l, dt, d, True))
              for l in SWEEP_LENGTHS for dt in (torch.float32, torch.bfloat16)
              for d in HEAD_DIMS}
    assert bodies == {("short", "short"), ("short", "tiled"),
                      ("tiled", "tiled")}


@pytest.mark.gpu
def test_sweep_shapes_cross_heads_per_cta(cuda):
    """The sweep's last bf16 K1 CTA takes fewer heads than the others."""
    assert (SWEEP_B * SWEEP_H) % kernel_heads_per_cta(torch.bfloat16) != 0
    assert kernel_heads_per_cta(torch.float32) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", SWEEP_LENGTHS)
def test_kernel_length_sweep_on_card(cuda, dtype, causal, l, d):
    """K1 at every tile edge and head_dim, on packed head views, and
    bitwise equal over two launches; the launches counted on the body the
    length takes and on the head_dim."""
    q, k, v, _ = _packed_qkv(cuda, dtype, SWEEP_B, SWEEP_H, l, l, d)
    body = kernel_body(l, dtype, d)
    before = (fused_attention.launches,
              getattr(fused_attention, f"{body}_launches"),
              fused_attention.head_dim_launches[d])
    out = fused_attention(q, k, v, causal)
    again = fused_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert (fused_attention.launches,
            getattr(fused_attention, f"{body}_launches"),
            fused_attention.head_dim_launches[d]) == (
                before[0] + 2, before[1] + 2, before[2] + 2)
    assert torch.equal(out, again)
    _assert_close_on_card(out, fused_attention_reference(q, k, v, causal),
                          dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", SWEEP_LENGTHS)
def test_backward_kernel_length_sweep_on_card(cuda, dtype, causal, l, d):
    """K2 at every tile edge of both bodies and every head_dim, with the
    output gradient a transposed view, and bitwise equal over two launches
    (neither body has atomics); the launches counted on the body the
    length takes and on the head_dim."""
    q, k, v, go = _packed_qkv(cuda, dtype, SWEEP_B, SWEEP_H, l, 1000 + l, d)
    body = kernel_body(l, dtype, d, backward=True)
    before = (fused_attention_backward.launches,
              getattr(fused_attention_backward, f"{body}_launches"),
              fused_attention_backward.head_dim_launches[d])
    got = _k2(q, k, v, go, causal)
    again = _k2(q, k, v, go, causal)
    torch.cuda.synchronize()
    assert (fused_attention_backward.launches,
            getattr(fused_attention_backward, f"{body}_launches"),
            fused_attention_backward.head_dim_launches[d]) == (
                before[0] + 2, before[1] + 2, before[2] + 2)
    ref = fused_attention_backward_reference(q, k, v, go, causal)
    for a, b, r in zip(got, again, ref):
        assert torch.equal(a, b)
        _assert_close_on_card(a, r, dtype, grad=True)


@pytest.mark.gpu
def test_misaligned_inputs_on_card(cuda):
    """A CUDA q one element into its storage raises rather than launching;
    a misaligned output gradient is copied once and gives the aligned
    one's result."""
    q, k, v, go = _packed_qkv(cuda, torch.bfloat16, 2, 3, 50, 5)
    flat = torch.empty(q.numel() + 1, device=cuda, dtype=q.dtype)
    odd = flat[1:].view(q.shape).copy_(q)
    before = (fused_attention.launches, fused_attention_backward.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention(odd, k, v)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_attention_backward(odd, k, v, go)
    assert (fused_attention.launches,
            fused_attention_backward.launches) == before
    flat_g = torch.empty(go.numel() + 1, device=cuda, dtype=go.dtype)
    odd_g = flat_g[1:].view(go.shape).copy_(go)
    for a, b in zip(fused_attention_backward(q, k, v, odd_g),
                    fused_attention_backward(q, k, v, go)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_bodies_and_counters_on_card(cuda):
    """The built libraries hold the short bodies' limits the wrapper
    dispatches by at every head_dim (and none at another), and each
    body's and head_dim's counter moves only for its launches."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in HEAD_DIMS:
            assert kernel_short_max_len(dtype, d) == SHORT_MAX_LEN
            assert kernel_short_max_len(dtype, d, backward=True) == \
                short_max_len_backward(dtype, d)
        for d in (32, 72, 160):
            assert kernel_short_max_len(dtype, d) == 0
            assert kernel_short_max_len(dtype, d, backward=True) == 0
    reset_launch_counts()
    for l, d in ((50, 64), (577, 96)):
        q, k, v, go = _packed_qkv(cuda, torch.bfloat16, 2, 3, l, l, d)
        if saves_statistics(l, torch.bfloat16, d):
            _k2(q, k, v, go)   # one K1 launch with statistics, one K2
        else:
            fused_attention(q, k, v)
            fused_attention_backward(q, k, v, go)
    torch.cuda.synchronize()
    for fn in (fused_attention, fused_attention_backward):
        assert (fn.launches, fn.short_launches, fn.tiled_launches) == (2, 1, 1)
        assert fn.head_dim_launches == {64: 1, 80: 0, 96: 1, 128: 0}


@pytest.mark.gpu
def test_other_head_dims_raise_on_card(cuda):
    """On CUDA tensors a head_dim outside 64, 80, 96, 128 raises by name in
    both wrappers and launches nothing; every head_dim in the set launches
    the kernel (the counters move), none takes the plain path."""
    reset_launch_counts()
    for d in (32, 72, 160):
        q, k, v, go = _packed_qkv(cuda, torch.bfloat16, 2, 3, 12, d, d)
        with pytest.raises(ValueError, match=f"head_dim 64, 80, 96, 128; "
                                             f"got {d}"):
            fused_attention(q, k, v)
        with pytest.raises(ValueError, match=f"got {d}"):
            fused_attention_backward(q, k, v, go)
    assert (fused_attention.launches, fused_attention_backward.launches) \
        == (0, 0)
    for d in HEAD_DIMS:
        q, k, v, go = _packed_qkv(cuda, torch.float32, 2, 3, 12, d, d)
        out = fused_attention(q, k, v)
        grads = fused_attention_backward(q, k, v, go)
        torch.cuda.synchronize()
        assert fused_attention.head_dim_launches[d] == 1
        assert fused_attention_backward.head_dim_launches[d] == 1
        _assert_close_on_card(out, fused_attention_reference(q, k, v),
                              torch.float32)
        for a, r in zip(grads, fused_attention_backward_reference(
                q, k, v, go)):
            _assert_close_on_card(a, r, torch.float32, grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [113, 128, 129, 197, 577, 613])
def test_k1_statistics_match_plain_on_card(cuda, causal, l, d):
    """K1's statistics from both bf16 bodies (113 and 128 run the short one,
    which K2's tiled pair follows at head_dim 96 and 128) against the plain
    version's, laid out in rows of whole 64-row tiles; the output is the
    one K1 gives without them, bit for bit."""
    q, k, v, _ = _packed_qkv(cuda, torch.bfloat16, SWEEP_B, SWEEP_H, l,
                             2000 + l, d)
    o, lse = fused_attention_forward(q, k, v, causal, with_stats=True)
    torch.cuda.synchronize()
    lp = tiles_len(l)
    assert lse.shape == (SWEEP_B, SWEEP_H, l)
    assert lse.stride() == (SWEEP_H * lp, lp, 1)
    assert torch.equal(o, fused_attention_forward(q, k, v, causal))
    _, want = fused_attention_reference(q, k, v, causal, with_stats=True)
    torch.testing.assert_close(lse, want, atol=STATS_ATOL, rtol=STATS_RTOL)


@pytest.mark.gpu
def test_tiled_backward_takes_k1_statistics_on_card(cuda):
    """A bf16 tiled K2 launch without K1's output and statistics, or with
    statistics of another layout, raises and launches nothing; the short
    body and float32 need none, and K1 refuses statistics in float32."""
    q, k, v, go = _packed_qkv(cuda, torch.bfloat16, 2, 3, 577, 9, 64)
    o, lse = fused_attention_forward(q, k, v, with_stats=True)
    before = fused_attention_backward.launches
    with pytest.raises(ValueError, match="K1's output and row statistics"):
        fused_attention_backward(q, k, v, go)
    with pytest.raises(ValueError, match="K1's output and row statistics"):
        fused_attention_backward(q, k, v, go, o=o)
    with pytest.raises(ValueError, match="lse must be K1's row statistics"):
        fused_attention_backward(q, k, v, go, o=o, lse=lse.contiguous())
    assert fused_attention_backward.launches == before
    fused_attention_backward(q, k, v, go, o=o, lse=lse)
    for dtype, l in ((torch.bfloat16, 50), (torch.float32, 577)):
        q, k, v, go = _packed_qkv(cuda, dtype, 2, 3, l, 9, 64)
        fused_attention_backward(q, k, v, go)
    torch.cuda.synchronize()
    assert fused_attention_backward.launches == before + 3
    with pytest.raises(ValueError, match="bfloat16 only"):
        fused_attention_forward(q, k, v, with_stats=True)
    q, k, v, go = _packed_qkv(cuda, torch.bfloat16, 2, 3, 112, 9, 64)
    with pytest.raises(ValueError, match="from L = 113"):
        fused_attention_forward(q, k, v, with_stats=True)
