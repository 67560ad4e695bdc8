"""Shared transformer building blocks (counterpart of
``hmmc_tpu/models/layers.py``).

- batch-first [B, L, D] layout, as in the JAX package;
- parameters stay fp32 and are cast to the activations' dtype where they
  are used (the compute dtype is set once, at each tower's input);
- LayerNorm takes its statistics in fp32 and casts back;
- parameter names are the reference checkpoint's (OpenAI CLIP), so a
  ``state_dict`` reads ``transformer.resblocks.{i}.attn.in_proj_weight``,
  ``.ln_1``, ``.mlp.c_fc`` and so on.

Linear layers add their bias inside the product (``F.linear``), so in bf16
the sum is rounded once.

Parameters are allocated uninitialized; ``reset_parameters(generator)``
draws them from the JAX package's initializer distributions
(:func:`hmmc_tpu_torch.factory.build_model` calls it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmmc_tpu_torch.ops.attention import multi_head_attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x) (module_cross.py:110-112)."""
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """fp32-statistics LayerNorm returning the input dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def normal_(t: torch.Tensor, std: float,
            generator: Optional[torch.Generator]) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, rescaled to variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Linear(nn.Module):
    """Dense layer, weight [out, in] (torch layout), cast to x's dtype."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class SelfAttention(nn.Module):
    """Packed-qkv self-attention with nn.MultiheadAttention's parameter
    names (``in_proj_weight`` [3D, D], ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 use_fused: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.use_fused = use_fused
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim)

    def reset_parameters(self, generator=None) -> None:
        std = self.in_proj_weight.shape[1] ** -0.5
        normal_(self.in_proj_weight, std, generator)
        normal_(self.out_proj.weight, std, generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return multi_head_attention(
            x, self.in_proj_weight, self.in_proj_bias, self.out_proj.weight,
            self.out_proj.bias, self.num_heads, mask,
            use_fused=self.use_fused, causal=self.causal)


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = Linear(dim, 4 * dim)
        self.c_proj = Linear(4 * dim, dim)

    def reset_parameters(self, generator=None) -> None:
        self.c_fc.reset_parameters(generator)
        self.c_proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN transformer block with a QuickGELU MLP
    (module_clip.py:231-257)."""

    def __init__(self, dim: int, num_heads: int, causal: bool = False,
                 use_fused: bool = False):
        super().__init__()
        self.attn = SelfAttention(dim, num_heads, causal, use_fused)
        self.ln_1 = LayerNorm(dim)
        self.mlp = Mlp(dim)
        self.ln_2 = LayerNorm(dim)

    def reset_parameters(self, generator=None) -> None:
        for m in (self.attn, self.ln_1, self.mlp, self.ln_2):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, num_heads: int,
                 causal: bool = False, use_fused: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads, causal, use_fused)
            for _ in range(layers))

    def reset_parameters(self, generator=None) -> None:
        for blk in self.resblocks:
            blk.reset_parameters(generator)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, mask)
        return x
