"""CLIP Vision Transformer (counterpart of ``hmmc_tpu/models/vit.py``).

Patch embedding -> class token + positional embedding -> ln_pre ->
pre-LN transformer -> ln_post on token 0 only -> proj, returned in fp32
(module_clip.py:271-325, module_cross.py:222-237). The patch embedding is
the 2d ``conv1`` (input NHWC ``[N, H, W, 3]``, as in JAX; the convolution
reads it as a channels-last NCHW view) or, for ``linear_patch="3d"``, the
tube ``conv2`` over a whole video (input ``[N, F, H, W, 3]``; kernel
(3, p, p), stride (1, p, p), one frame of zero padding each side), whose
``N * F`` frames then go through the transformer as the 2d path's.
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
        if arch.linear_patch not in ("2d", "3d"):
            raise ValueError(f"linear_patch must be '2d' or '3d'; got "
                             f"{arch.linear_patch!r}")
        self.arch = arch
        self.dtype = dtype
        width, patch = arch.vision_width, arch.vision_patch_size
        if arch.linear_patch == "3d":
            self.conv2 = nn.Conv3d(3, width, (3, patch, patch),
                                   (1, patch, patch), padding=(1, 0, 0),
                                   bias=False)
        else:
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
        if self.arch.linear_patch == "3d":
            lecun_normal_(self.conv2.weight, 3 * 3 * patch * patch, generator)
        else:
            lecun_normal_(self.conv1.weight, 3 * patch * patch, generator)
        scale = self.arch.vision_width ** -0.5
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            normal_(p, scale, generator)
        for m in (self.ln_pre, self.transformer, self.ln_post):
            m.reset_parameters(generator)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """pixels: [N, H, W, 3] (3d: [N, F, H, W, 3]) normalized floats ->
        pooled [N, embed_dim] (3d: [N * F, embed_dim]) fp32."""
        dtype = self.dtype
        patch = self.arch.vision_patch_size
        if self.arch.linear_patch == "3d":
            x = F.conv3d(pixels.to(dtype).permute(0, 4, 1, 2, 3),
                         self.conv2.weight.to(dtype), stride=(1, patch, patch),
                         padding=(1, 0, 0))           # [N, W, F, gh, gw]
            x = x.permute(0, 2, 3, 4, 1).flatten(0, 1)  # [N*F, gh, gw, W]
            x = x.flatten(1, 2)                         # [N*F, gh*gw, W]
        else:
            x = F.conv2d(pixels.to(dtype).permute(0, 3, 1, 2),
                         self.conv1.weight.to(dtype),
                         stride=patch)                  # [N, W, gh, gw]
            x = x.flatten(2).transpose(1, 2)            # [N, gh*gw, W]
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x)
        pooled = self.ln_post(x[:, 0, :]) @ self.proj.to(dtype)
        return pooled.float()
