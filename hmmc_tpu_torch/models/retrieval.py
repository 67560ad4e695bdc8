"""Fine-tune retrieval model (counterpart of
``hmmc_tpu/models/retrieval.py``; reference BirdModel, modeling.py:648-663).
A query-text / video dual encoder; the evaluator calls ``encode_text`` and
``encode_video`` with feature caching."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from hmmc_tpu_torch.config import ClipArch, CrossConfig
from hmmc_tpu_torch.models.text import TextEncoder
from hmmc_tpu_torch.models.visual import VisualEncoder


class BirdModel(nn.Module):
    def __init__(self, arch: ClipArch, cross_config: CrossConfig = CrossConfig(),
                 language: str = "english", use_temp: bool = True,
                 dtype: torch.dtype = torch.float32, use_fused: bool = False):
        super().__init__()
        self.arch = arch
        self.cross_config = cross_config
        self.use_temp = use_temp
        self.dtype = dtype
        self.use_fused = use_fused
        self.text_encoder = TextEncoder(arch, cross_config, language, dtype,
                                        use_fused)
        self.visual_encoder = VisualEncoder(arch, cross_config, use_temp,
                                            dtype, use_fused)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        self.text_encoder.reset_parameters(generator)
        self.visual_encoder.reset_parameters(generator)

    def encode_text(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, L] token ids -> [B, embed_dim] fp32."""
        return self.text_encoder(input_ids)

    def encode_video(self, video: torch.Tensor,
                     frame_mask: Optional[torch.Tensor] = None,
                     train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, F, H, W, 3] normalized floats (and an optional [B, F] frame
        mask, 1 = real frame) -> (video feature [B, D], frame features
        [B, F, D]), fp32. ``train``: a ResNet tower's BatchNorm on the
        batch's statistics (moving the running ones)."""
        return self.visual_encoder(video, frame_mask, train)

    def logit_scale(self) -> torch.Tensor:
        """exp(logit_scale) clamped to 100; no gradient reaches it
        (modeling.py:216-217)."""
        return self.text_encoder.get_logit_scale()
