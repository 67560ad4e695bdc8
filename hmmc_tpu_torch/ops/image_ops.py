"""Device-side image preprocessing (counterpart of the deterministic ops
of ``hmmc_tpu/ops/image_ops.py``): the host hands over decoded uint8
frames and the cast and CLIP normalization run on the device."""

from __future__ import annotations

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1] (ToTensor)."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def normalize(x: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """x: [..., H, W, 3] float in [0, 1]."""
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std
