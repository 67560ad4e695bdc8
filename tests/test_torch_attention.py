"""Port attention (hmmc_tpu_torch.ops) against the JAX package.

On the CPU the port's ``fused_attention`` takes its plain version; the JAX
``fused_attention`` runs its Pallas kernel in interpret mode, as
tests/test_pallas_attention.py does. Inputs are made with numpy from a
seed and handed to both. Tolerance (fp32): atol 2e-5, rtol 1e-4, the JAX
package's own kernel-vs-XLA tolerance.

The ``gpu`` tests hold the CUDA kernel against the plain version on the
card; they skip without one.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hmmc_tpu_torch.ops.attention import causal_mask, multi_head_attention
from hmmc_tpu_torch.ops.fused_attention import (check_kernel_inputs,
                                                fused_attention,
                                                fused_attention_reference)

ATOL, RTOL = 2e-5, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:  # the reference; the card's machine has no JAX and runs the gpu tests
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


def test_kernel_input_checks_stride():
    x = torch.zeros(2, 2, 64, 8).transpose(-1, -2)   # last-axis stride 8
    with pytest.raises(ValueError, match="unit stride"):
        check_kernel_inputs(x, x, x)
    # head views of a packed qkv projection are accepted as they are
    qkv = torch.zeros(2, 50, 3 * 12 * 64)
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(2, 50, 3, 12, 64).unbind(2))
    check_kernel_inputs(q, k, v)


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
