"""Port attention (hmmc_tpu_torch.ops) against the JAX package.

On the CPU the port's ``fused_attention`` takes its plain forward and plain
backward; the JAX ``fused_attention`` runs its Pallas kernels in interpret
mode, as tests/test_pallas_attention.py does. Inputs are made with numpy
from a seed and handed to both. Tolerances (fp32): outputs atol 2e-5, rtol
1e-4, the JAX package's own kernel-vs-XLA tolerance; gradients atol 5e-5,
rtol 1e-3, its fused-gradient tolerance (values there reach ~10, the
products of two unit-variance heads over 64 dims, scaled).

The ``gpu`` tests hold the CUDA kernels against the plain versions on the
card, and the gradients of an attention block on the card against the CPU;
they skip without one.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hmmc_tpu_torch.models.layers import ResidualAttentionBlock
from hmmc_tpu_torch.ops.attention import causal_mask, multi_head_attention
from hmmc_tpu_torch.ops import kernel_build
from hmmc_tpu_torch.ops.fused_attention import (
    MAX_LEN, MAX_LEN_BWD, MAX_LEN_BWD_FP32, check_kernel_inputs,
    fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference,
    kernel_heads_per_cta, max_len_backward)

ATOL, RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-3
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
    before = fused_attention.launches
    x = torch.zeros(1, 1, 4, 64)
    fused_attention(x, x, x)
    assert fused_attention.launches == before


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
    ((2, 2, 8, 32), "head_dim"),
    ((2, 2, 129, 64), "KV-loop"),
    ((2, 0, 8, 64), "empty"),
])
def test_kernel_input_checks(shape, match):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        check_kernel_inputs(x, x, x)


def test_backward_input_checks():
    x = torch.zeros(2, 2, MAX_LEN_BWD_FP32 + 1, 64)
    check_kernel_inputs(x, x, x)                      # K1 takes it
    with pytest.raises(ValueError, match="KV-loop"):  # K2 in fp32 does not
        check_kernel_inputs(x, x, x, max_len_backward(x.dtype))
    xb = x.bfloat16()                                 # K2 in bf16 does
    check_kernel_inputs(xb, xb, xb, max_len_backward(xb.dtype))
    assert max_len_backward(torch.bfloat16) == MAX_LEN_BWD == MAX_LEN
    xl = torch.zeros(2, 2, MAX_LEN_BWD + 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="KV-loop"):
        check_kernel_inputs(xl, xl, xl, max_len_backward(xl.dtype))
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


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

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
    (4, 3, MAX_LEN_BWD_FP32, False),
    (3, 2, 1, False),
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
    got = fused_attention_backward(q, k, v, go, causal)
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
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_gradients_on_card_match_cpu(cuda, causal):
    """Every parameter of an attention block, and its input, gets on the
    card the gradient the CPU gives (fp32, TF32 off; sums in another
    order). The kernel's output must carry the graph: an output written
    outside autograd leaves the qkv projection and everything below the
    attention without a gradient."""
    torch.manual_seed(0)
    cpu = ResidualAttentionBlock(128, 2, causal=causal, use_fused=True)
    cpu.reset_parameters(torch.Generator().manual_seed(1))
    card = ResidualAttentionBlock(128, 2, causal=causal, use_fused=True)
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    rng = np.random.default_rng(2)
    x = _normal(rng, 3, 50, 128)
    w = _normal(rng, 3, 50, 128)
    grads, launches = {}, {}
    for name, block, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        mask = causal_mask(50, device=dev) if causal else None
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


# every edge of the 16-row / 8-key mma tiles, up to the kernels' limits
SWEEP_LENGTHS = [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 49, 50, 63, 64, 65, 77,
                 96, 112, 128]
# 3 x 5 = 15 heads: not a multiple of K1's heads per CTA
SWEEP_B, SWEEP_H = 3, 5


def _packed_qkv(device, dtype, b, h, l, seed):
    """Head views of a packed [B, L, 3·H·64] projection, the main path's
    layout, and an output gradient that is the transposed view of a
    [B, L, H, 64] tensor."""
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * 64, device=device, generator=g).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(b, l, 3, h, 64).unbind(2))
    go = torch.randn(b, l, h, 64, device=device, generator=g).to(dtype)
    return q, k, v, go.transpose(1, 2)


def _assert_close_on_card(got, ref, dtype, grad=False):
    if dtype == torch.float32:
        atol, rtol = (GRAD_ATOL, GRAD_RTOL) if grad else (ATOL, RTOL)
        torch.testing.assert_close(got, ref, atol=atol, rtol=rtol)
    else:   # one output ulp: 2^-7 relative
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2 ** -7)


def test_sweep_lengths_reach_the_limits():
    assert max(SWEEP_LENGTHS) == MAX_LEN == MAX_LEN_BWD


@pytest.mark.gpu
def test_sweep_shapes_cross_heads_per_cta(cuda):
    """The sweep's last bf16 K1 CTA takes fewer heads than the others."""
    assert (SWEEP_B * SWEEP_H) % kernel_heads_per_cta(torch.bfloat16) != 0
    assert kernel_heads_per_cta(torch.float32) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", SWEEP_LENGTHS)
def test_kernel_length_sweep_on_card(cuda, dtype, causal, l):
    """K1 at every tile edge, on packed head views, and bitwise equal over
    two launches."""
    q, k, v, _ = _packed_qkv(cuda, dtype, SWEEP_B, SWEEP_H, l, l)
    before = fused_attention.launches
    out = fused_attention(q, k, v, causal)
    again = fused_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 2
    assert torch.equal(out, again)
    _assert_close_on_card(out, fused_attention_reference(q, k, v, causal),
                          dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", SWEEP_LENGTHS)
def test_backward_kernel_length_sweep_on_card(cuda, dtype, causal, l):
    """K2 at every tile edge up to its limit in the dtype (a longer
    sequence raises), with the output gradient a transposed view, and
    bitwise equal over two launches."""
    q, k, v, go = _packed_qkv(cuda, dtype, SWEEP_B, SWEEP_H, l, 1000 + l)
    if l > max_len_backward(dtype):
        with pytest.raises(ValueError, match="KV-loop"):
            fused_attention_backward(q, k, v, go, causal)
        return
    before = fused_attention_backward.launches
    got = fused_attention_backward(q, k, v, go, causal)
    again = fused_attention_backward(q, k, v, go, causal)
    torch.cuda.synchronize()
    assert fused_attention_backward.launches == before + 2
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
