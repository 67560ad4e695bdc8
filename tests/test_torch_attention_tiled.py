"""The arithmetic of K2's bf16 tiled pair (csrc/fused_attention_bwd.cu),
emulated in PyTorch on the CPU and held to K2's plain version.

The pair runs its products on the tensor cores with one bf16 operand each
and fp32 accumulation, takes P from K1's row statistics, and takes dQ in
one walk with a shifted D. This module rounds operands to bf16 where the
kernels do, with K1's statistics and output from K1's plain version, at
every length of ``chip_smoke.HEAD_DIM_LENGTHS`` past each head_dim's short
limit, causal and not, and holds dq, dk, dv to
``fused_attention_backward_reference`` within the card's bf16 tolerance
(atol 1e-2, rtol 2^-7: one output ulp). Torch only.

Run as a script, it prints the worst error (as a share of that tolerance)
of the shipped design and of the two it replaced:
``python tests/test_torch_attention_tiled.py``.
"""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hmmc_tpu_torch.ops.fused_attention import (  # noqa: E402
    HEAD_DIMS, SHORT_MAX_LEN_BWD, fused_attention_backward_reference,
    fused_attention_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-2, 2.0 ** -7      # chip_smoke.BWD_TOLERANCE[bfloat16]
# chip_smoke.HEAD_DIM_LENGTHS, the card's head_dim sweep
LENGTHS = (12, 50, 80, 81, 96, 97, 112, 113, 128, 129, 197, 577)
B, H = 3, 5                       # chip_smoke.HEAD_DIM_SWEEP_BH
CASES = [(d, l, causal) for d in HEAD_DIMS for l in LENGTHS
         if l > SHORT_MAX_LEN_BWD[torch.bfloat16][d]
         for causal in (False, True)]


def bf16(x):
    return x.bfloat16().float()


def emulate(q, k, v, g, causal, design="shipped"):
    """dq, dk, dv of the tiled pair's arithmetic (bf16 out). ``design``:
    "shipped" (D~ = rowsum(g o o) shifts dS in the rows pass, the exact D
    corrects dQ at the end), "rowsum_go" (D = rowsum(g o o) for every dS)
    or "unshifted" (dQ = scale ((P o dP) k - D P k) in one walk)."""
    d = q.shape[-1]
    scale = float(np.float32(d ** -0.5))
    log2c = float(np.float32(scale * math.log2(math.e)))  # Scale<D>::kLog2
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    o, lse = fused_attention_reference(q, k, v, causal, with_stats=True)
    l = q.shape[-2]
    keep = torch.ones(l, l, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    # both passes: S and dP exact in fp32 from bf16 inputs, P from K1's
    # statistics (2^(S c - lse): one ex2 of an FMA)
    p = torch.exp2(qf @ kf.transpose(-1, -2) * log2c - lse[..., None])
    p = p.masked_fill(~keep, 0.0)
    dp = gf @ vf.transpose(-1, -2)
    d_exact = (p * dp).sum(-1, keepdim=True)
    d_go = (gf * o.float()).sum(-1, keepdim=True)
    if design == "shipped":
        ds_shift = p * (dp - d_go) * scale
        y = bf16(p) @ kf
        dq = bf16(ds_shift) @ kf - scale * (d_exact - d_go) * y
        d_keys = d_exact
    elif design == "rowsum_go":
        dq = bf16(p * (dp - d_go) * scale) @ kf
        d_keys = d_go
    else:
        dq = scale * (bf16(p * dp) @ kf - d_exact * (bf16(p) @ kf))
        d_keys = d_exact
    ds = p * (dp - d_keys) * scale              # keys pass, exact D
    dk = bf16(ds).transpose(-1, -2) @ qf
    dv = bf16(p).transpose(-1, -2) @ gf
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def inputs(d, l, seed):
    """The sweep's layout: head views of a packed projection and a
    transposed output gradient, bf16, from a seed."""
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.normal(size=(B, l, 3 * H * d)),
                       dtype=torch.float32).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.view(B, l, 3, H, d).unbind(2))
    g = torch.tensor(rng.normal(size=(B, l, H, d)),
                     dtype=torch.float32).bfloat16().transpose(1, 2)
    return q, k, v, g


def share_of_tolerance(got, ref):
    """max over elements of |got - ref| / (atol + rtol |ref|)."""
    return max(float(((a.float() - r.float()).abs()
                      / (ATOL + RTOL * r.float().abs())).max())
               for a, r in zip(got, ref))


@pytest.mark.parametrize("d,l,causal", CASES)
def test_tiled_backward_arithmetic_within_tolerance(d, l, causal):
    q, k, v, g = inputs(d, l, seed=d * 1000 + l + causal)
    ref = fused_attention_backward_reference(q, k, v, g, causal)
    got = emulate(q, k, v, g, causal)
    assert share_of_tolerance(got, ref) <= 1.0


def test_lengths_are_chip_smokes():
    """The emulated lengths and sweep shape are the card sweep's."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    consts = {t.id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Name)
              and t.id in ("HEAD_DIM_LENGTHS", "HEAD_DIM_SWEEP_BH")}
    assert consts == {"HEAD_DIM_LENGTHS": LENGTHS,
                      "HEAD_DIM_SWEEP_BH": (B, H)}
    assert len(CASES) == 2 * (3 + 3 + 5 + 5)


if __name__ == "__main__":
    for design in ("shipped", "rowsum_go", "unshifted"):
        worst = max(
            (share_of_tolerance(emulate(*inputs(d, l, d * 1000 + l + c), c,
                                        design=design),
                                fused_attention_backward_reference(
                                    *inputs(d, l, d * 1000 + l + c), c)),
             d, l, c) for d, l, c in CASES)
        print(f"{design}: worst share of tolerance {worst[0]:.4f} at "
              f"head_dim {worst[1]}, L = {worst[2]}, causal = {worst[3]}")
