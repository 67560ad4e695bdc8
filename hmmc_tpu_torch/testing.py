"""Frame layouts for checking the frame kernels (R1, R2) against their
plain versions: planes and RGB rows at any base and pitch, as the card
tests and ``chip_smoke.py`` build them."""

from __future__ import annotations

from typing import List

import torch

from hmmc_tpu_torch.ops.resize_crop import YccFrame


def pitched(values: torch.Tensor, pitch: int, offset: int = 0
            ) -> torch.Tensor:
    """``values`` (uint8 [h, w] or [h, w, 3]) copied into a view whose rows
    are ``pitch`` bytes apart, ``offset`` bytes into its buffer."""
    h = values.shape[0]
    row = values[0].numel()
    buf = torch.zeros(offset + h * pitch, dtype=torch.uint8,
                      device=values.device)
    view = buf[offset:].view(h, pitch)[:, :row]
    view.copy_(values.reshape(h, row))
    return view if values.dim() == 2 else view.unflatten(1, (-1, 3))


def aligned_and_odd_layouts(rgb: torch.Tensor, y: torch.Tensor,
                            cb: torch.Tensor, cr: torch.Tensor
                            ) -> List[object]:
    """One frame's RGB rows ``rgb`` [h, w, 3] and 4:2:0 planes four ways:
    RGB at a 16-byte aligned pitch, RGB at an odd base and pitch, the
    planes at 16-byte aligned bases and pitches (stage 0's ``cp.async``
    route and 4:2:0 fast path), the planes at odd bases and pitches
    (staged with a row skew, converted pixel by pixel)."""
    w = y.shape[1]
    cp = -(-cb.shape[1] // 16) * 16 + 16
    return [pitched(rgb, -(-3 * w // 16) * 16 + 16),
            pitched(rgb, 3 * w + 5, 9),
            YccFrame(pitched(y, -(-w // 16) * 16 + 32), pitched(cb, cp),
                     pitched(cr, cp)),
            YccFrame(pitched(y, w + 3, 1), pitched(cb, cp + 5, 3),
                     pitched(cr, cp + 5, 7))]
