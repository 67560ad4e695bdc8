"""Visual encoder: per-frame CLIP tower + temporal transformer
(counterpart of ``hmmc_tpu/models/visual.py``, module_cross.py:152-237).

- every frame goes through the tower: the ViT (the 3d tube patch takes the
  video whole: its convolution spans neighbouring frames) or the
  ModifiedResNet (:mod:`hmmc_tpu_torch.models.resnet`; ``train`` puts its
  BatchNorm on the batch's statistics, as the JAX encoder's flag does); the
  per-frame features, in fp32, BEFORE the temporal transformer are
  returned as ``frame_output``;
- with ``use_temp``: add the frame position embeddings (sized from the
  tower's output width), run the temporal transformer, add the residual.
  The reference's temporal mask is all ones, so no mask is applied; a
  ``frame_mask`` [B, F] (1 = real frame) masks padded frames out of the
  temporal attention instead (an additive mask, so the plain attention);
- the video feature is the mean over frames of the L2-normalized frame
  vectors (normalize-then-mean).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from hmmc_tpu_torch.config import ClipArch, CrossConfig
from hmmc_tpu_torch.models.layers import Transformer, normal_
from hmmc_tpu_torch.models.resnet import ModifiedResNet
from hmmc_tpu_torch.models.vit import VisionTransformer


class VisualEncoder(nn.Module):
    def __init__(self, arch: ClipArch, cross_config: CrossConfig = CrossConfig(),
                 use_temp: bool = True, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False):
        super().__init__()
        self.arch = arch
        self.use_temp = use_temp
        self.dtype = dtype
        if arch.is_resnet:
            self.visual = ModifiedResNet(
                tuple(arch.vision_layers), arch.embed_dim, arch.vision_heads,
                arch.image_resolution, arch.vision_width, dtype)
        else:
            self.visual = VisionTransformer(arch, dtype, use_fused)
        if use_temp:
            cc = cross_config
            self.frame_position_embeddings = nn.Embedding(
                cc.max_position_embeddings, arch.embed_dim,
                _weight=torch.empty(cc.max_position_embeddings, arch.embed_dim))
            self.temporal_transformer = Transformer(
                arch.embed_dim, cc.temporal_hidden_layers,
                cc.temporal_attention_heads, use_fused=use_fused)

    def reset_parameters(self, generator=None) -> None:
        self.visual.reset_parameters(generator)
        if self.use_temp:
            normal_(self.frame_position_embeddings.weight, 0.02, generator)
            self.temporal_transformer.reset_parameters(generator)

    def forward(self, video: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """video: [B, F, H, W, 3] normalized floats; frame_mask: [B, F] or
        None; ``train``: the ResNet's BatchNorm in train mode (the ViT has
        no train-time behaviour). Returns (video_feature [B, D] fp32,
        frame_output [B, F, D] fp32)."""
        b, f, h, w, c = video.shape
        if self.arch.is_resnet:
            per_frame = self.visual(video.reshape(b * f, h, w, c),
                                    train).float()
        elif self.arch.linear_patch == "3d":
            per_frame = self.visual(video)
        else:
            per_frame = self.visual(video.reshape(b * f, h, w, c))
        hidden = per_frame.reshape(b, f, per_frame.shape[-1])
        frame_output = hidden
        if self.use_temp:
            x = hidden + self.frame_position_embeddings.weight[:f].to(
                hidden.dtype)
            add_mask = None
            if frame_mask is not None:
                add_mask = (1.0 - frame_mask.float())[:, None, None, :] * -1e6
            x = self.temporal_transformer(x.to(self.dtype), add_mask)
            hidden = x.float() + hidden
        normed = hidden / hidden.norm(dim=-1, keepdim=True)
        return normed.mean(dim=1).float(), frame_output
