"""Attention ops (counterpart of ``hmmc_tpu/ops/attention.py``).

Semantics match ``torch.nn.MultiheadAttention`` as the reference uses it:
scaled dot product, optional additive mask, softmax over keys, with the
logits and the softmax in fp32 whatever the compute dtype. Routing follows
the JAX package: with ``use_fused`` and either no mask or ``causal``, the
heads go to the fused kernel (:mod:`hmmc_tpu_torch.ops.fused_attention`);
an additive mask takes the plain path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from hmmc_tpu_torch.ops.fused_attention import fused_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, L, Dh]; mask: additive, broadcastable to
    [B, H, L, L]. Returns [B, H, L, Dh] in v's dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def multi_head_attention(x: torch.Tensor, in_proj_weight: torch.Tensor,
                         in_proj_bias: torch.Tensor,
                         out_proj_weight: torch.Tensor,
                         out_proj_bias: torch.Tensor, num_heads: int,
                         mask: Optional[torch.Tensor] = None,
                         use_fused: bool = False,
                         causal: bool = False) -> torch.Tensor:
    """Self-attention with a packed qkv projection.

    x: [B, L, D]. ``in_proj_weight`` [3D, D] and ``out_proj_weight``
    [D, D] are in torch layout and are cast to x's dtype here. ``mask`` is
    additive (the caller builds causality into it); ``causal`` flags the
    causal pattern statically so the fused kernel applies it itself."""
    b, l, d = x.shape
    head_dim = d // num_heads
    dtype = x.dtype
    qkv = F.linear(x, in_proj_weight.to(dtype), in_proj_bias.to(dtype))
    # [B, L, 3, H, Dh] -> three [B, H, L, Dh] views of the packed output
    q, k, v = (t.transpose(1, 2) for t in
               qkv.view(b, l, 3, num_heads, head_dim).unbind(2))
    if use_fused and (mask is None or causal):
        out = fused_attention(q, k, v, causal)
    else:
        out = dot_product_attention(q, k, v, mask)
    out = out.transpose(1, 2).reshape(b, l, d)
    return F.linear(out, out_proj_weight.to(dtype), out_proj_bias.to(dtype))


def causal_mask(length: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal mask (module_clip.py:441-447): -1e9 above the
    diagonal, [1, 1, L, L]."""
    mask = torch.full((length, length), -1e9, dtype=dtype, device=device)
    return mask.triu(1)[None, None]
