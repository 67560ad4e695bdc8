"""CLIP Vision Transformer (counterpart of ``hmmc_tpu/models/vit.py``).

2d patch embedding -> class token + positional embedding -> ln_pre ->
pre-LN transformer -> ln_post on token 0 only -> proj, returned in fp32
(module_clip.py:271-325, module_cross.py:222-237). The public input is
NHWC ``[N, H, W, 3]`` as in JAX; the convolution reads it as a
channels-last NCHW view.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmmc_tpu_torch.config import ClipArch
from hmmc_tpu_torch.models.layers import (LayerNorm, Transformer,
                                          lecun_normal_, normal_)


class VisionTransformer(nn.Module):
    def __init__(self, arch: ClipArch, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False):
        super().__init__()
        if arch.linear_patch != "2d":
            raise NotImplementedError(
                "the 3d tube patch embedding is not ported yet (ROADMAP.md "
                "Queue A 10, 'Other towers')")
        self.arch = arch
        self.dtype = dtype
        width, patch = arch.vision_width, arch.vision_patch_size
        self.conv1 = nn.Conv2d(3, width, patch, patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(arch.grid_size ** 2 + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = Transformer(width, arch.vision_layers,
                                       arch.vision_heads, use_fused=use_fused)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, arch.embed_dim))

    def reset_parameters(self, generator=None) -> None:
        patch = self.arch.vision_patch_size
        lecun_normal_(self.conv1.weight, 3 * patch * patch, generator)
        scale = self.arch.vision_width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            normal_(p, scale, generator)
        for m in (self.ln_pre, self.transformer, self.ln_post):
            m.reset_parameters(generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [N, H, W, 3] normalized floats -> pooled [N, embed_dim]
        fp32."""
        dtype = self.dtype
        x = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2),
                     self.conv1.weight.to(dtype),
                     stride=self.arch.vision_patch_size)      # [N, W, gh, gw]
        x = x.flatten(2).transpose(1, 2)                      # [N, gh*gw, W]
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        pooled = self.ln_post(x[:, 0, :]) @ self.proj.to(dtype)
        return pooled.float()
