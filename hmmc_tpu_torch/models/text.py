"""Text towers (counterpart of ``hmmc_tpu/models/text.py``).

- :class:`ClipTextTower`: CLIP's causal text transformer; the pooled
  feature is the projected hidden state at the EOT position, found as the
  argmax of the ids (module_clip.py:470-487, module_cross.py:287-305).
- :class:`TextEncoder`: the English encoder. Its parameters sit at the top
  level, so keys read ``text_encoder.token_embedding.weight`` as in the
  reference checkpoint. ``logit_scale`` is ln(100), clamped to 100 at use.
  The reference never trains it; the JAX package keeps it as a parameter
  whose gradient is stopped, and its BertAdam still decays it. Here it is
  a parameter with ``requires_grad=False``: no gradient reaches it, but
  the optimizer holds it (with a zero gradient) and decays it as JAX does.
  The Chinese BERT tower is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from hmmc_tpu_torch.config import ClipArch, CrossConfig
from hmmc_tpu_torch.models.layers import LayerNorm, Transformer, normal_
from hmmc_tpu_torch.ops.attention import causal_mask


class ClipTextTower(nn.Module):
    def __init__(self, arch: ClipArch, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        width = arch.transformer_width
        self.token_embedding = nn.Embedding(
            arch.vocab_size, width, _weight=torch.empty(arch.vocab_size, width))
        self.positional_embedding = nn.Parameter(
            torch.empty(arch.context_length, width))
        self.transformer = Transformer(width, arch.transformer_layers,
                                       arch.transformer_heads, causal=True,
                                       use_fused=use_fused)
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, arch.embed_dim))

    def reset_parameters(self, generator=None) -> None:
        normal_(self.token_embedding.weight, 0.02, generator)
        normal_(self.positional_embedding, 0.01, generator)
        normal_(self.text_projection, self.arch.transformer_width ** -0.5,
                generator)
        self.transformer.reset_parameters(generator)
        self.ln_final.reset_parameters(generator)

    def forward(self, input_ids: torch.Tensor, return_hidden: bool = False):
        """input_ids: [B, L] -> pooled [B, embed_dim] fp32. Pad id is 0, so
        EOT (49407) is each row's maximum. ``return_hidden`` also returns
        every position's projected hidden state, after ``ln_final`` and
        ``text_projection`` ([B, L, embed_dim] fp32, the MLM head's input,
        as ``hmmc_tpu/models/text.py:48,82``)."""
        dtype = self.dtype
        l = input_ids.shape[1]
        x = self.token_embedding.weight[input_ids].to(dtype)
        x = x + self.positional_embedding[:l].to(dtype)
        x = self.transformer(x, causal_mask(l, device=x.device))
        hidden = self.ln_final(x) @ self.text_projection.to(dtype)
        eot = input_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        eot].float()
        if return_hidden:
            return pooled, hidden.float()
        return pooled


class TextEncoder(ClipTextTower):
    """English text encoder (module_cross.py:240-305)."""

    def __init__(self, arch: ClipArch, cross_config: CrossConfig = CrossConfig(),
                 language: str = "english", dtype: torch.dtype = torch.float32,
                 use_fused: bool = False):
        if language != "english":
            raise NotImplementedError(
                f"language {language!r}: only the English CLIP text tower is "
                "ported; the Chinese BERT tower is ROADMAP.md Queue A, "
                "'Chinese branch'")
        super().__init__(arch, dtype, use_fused)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(100.0)),
                                        requires_grad=False)

    def reset_parameters(self, generator=None) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            self.logit_scale.fill_(math.log(100.0))

    def get_logit_scale(self) -> torch.Tensor:
        """exp(logit_scale) clamped to 100 (modeling.py:216-217)."""
        return torch.clamp(self.logit_scale.exp(), max=100.0)
