"""Device-side image preprocessing (counterpart of
``hmmc_tpu/ops/image_ops.py``): the host hands over decoded uint8 frames
and the cast, the SimCLR augmentation of the pretrain and the
normalization run on the device, in plain PyTorch (the JAX package
computes them in XLA, outside any Pallas kernel).

:func:`simclr_augment` is the pretrain's transform stack
(dataloader_bird.py:113-121): RandomResizedCrop(224, scale (0.2, 1)) ->
ColorJitter(0.4, 0.4, 0.4, 0.1) with p 0.8 -> RandomGrayscale(p 0.2) ->
GaussianBlur(sigma U[0.1, 2], 9 taps, edge padding) with p 0.5 ->
RandomHorizontalFlip -> normalize with :data:`BIRD_PRETRAIN_MEAN`. It
keeps the JAX package's documented deviations from torchvision (one
clamped box draw instead of the 10-try loop; the jitter's four ops in a
fixed order) and its mean quirk: the reference's pretrain mean repeats the
green value in the blue channel. Each random op is a sampler
(:func:`sample_simclr`, draws from a ``torch.Generator``) and a
deterministic apply (:func:`simclr_apply`, and the ops it composes) that
takes the drawn decisions, so the applies can be held to the JAX
package's at equal decisions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BIRD_PRETRAIN_MEAN = (0.48145466, 0.4578275, 0.4578275)  # reference quirk
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


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


# ---------------------------------------------------------------------------
# deterministic applies ([N, H, W, 3] float images, per-image parameters)
# ---------------------------------------------------------------------------

def bilinear_crop(img: torch.Tensor, box: torch.Tensor,
                  out: int) -> torch.Tensor:
    """``_bilinear_crop_one`` over a batch: img [N, H, W, C] float, box
    [N, 4] = (y0, x0, h, w) in pixels -> [N, out, out, C], an out x out grid
    over each box sampled bilinearly (edges clamped)."""
    n, h, w = img.shape[:3]
    grid = torch.arange(out, dtype=torch.float32, device=img.device) + 0.5
    y0, x0, bh, bw = (box[:, i:i + 1] for i in range(4))
    ys = (y0 + grid * bh / out - 0.5).clamp(0.0, h - 1.0)     # [N, out]
    xs = (x0 + grid * bw / out - 0.5).clamp(0.0, w - 1.0)
    y_lo, x_lo = ys.floor().long(), xs.floor().long()
    y_hi, x_hi = (y_lo + 1).clamp(max=h - 1), (x_lo + 1).clamp(max=w - 1)
    wy = (ys - y_lo)[:, :, None, None]
    wx = (xs - x_lo)[:, None, :, None]
    b = torch.arange(n, device=img.device)[:, None, None]

    def at(yy, xx):
        return img[b, yy[:, :, None], xx[:, None, :]]

    top = at(y_lo, x_lo) * (1 - wx) + at(y_lo, x_hi) * wx
    bot = at(y_hi, x_lo) * (1 - wx) + at(y_hi, x_hi) * wx
    return top * (1 - wy) + bot * wy


def _per_image(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None, None]


def _blend(a: torch.Tensor, b: torch.Tensor,
           factor: torch.Tensor) -> torch.Tensor:
    return (b + (a - b) * _per_image(factor)).clamp(0.0, 1.0)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    wts = torch.tensor(GRAY_WEIGHTS, dtype=x.dtype, device=x.device)
    return (x * wts).sum(dim=-1, keepdim=True)


def adjust_brightness(x, factor):
    return _blend(x, torch.zeros_like(x), factor)


def adjust_contrast(x, factor):
    gray = rgb_to_grayscale(x).mean(dim=(-3, -2, -1), keepdim=True)
    return _blend(x, gray.expand_as(x), factor)


def adjust_saturation(x, factor):
    return _blend(x, rgb_to_grayscale(x).expand_as(x), factor)


def adjust_hue(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Hue rotation by ``delta`` [N] turns through an HSV round trip."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.max(dim=-1).values
    mn = x.min(dim=-1).values
    diff = mx - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    zero = torch.zeros_like(diff)
    hr = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0), zero)
    hg = torch.where((mx == g) & (mx != r), (b - r) / safe + 2.0, zero)
    hb = torch.where((mx == b) & (mx != r) & (mx != g),
                     (r - g) / safe + 4.0, zero)
    hue = torch.where(diff == 0, zero, (hr + hg + hb) / 6.0)
    sat = torch.where(mx == 0, zero,
                      diff / torch.where(mx == 0, torch.ones_like(mx), mx))
    val = mx
    hue = torch.remainder(hue + delta[:, None, None], 1.0)
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    i = torch.remainder(i.long(), 6).unsqueeze(0)

    def choose(*opts):
        return torch.gather(torch.stack(opts), 0, i)[0]

    return torch.stack([choose(val, q, p, p, t, val),
                        choose(t, val, val, q, p, p),
                        choose(p, p, t, val, val, q)], dim=-1)


def color_jitter(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, saturation and hue in that fixed order;
    factors [N, 4]."""
    x = adjust_brightness(x, factors[:, 0])
    x = adjust_contrast(x, factors[:, 1])
    x = adjust_saturation(x, factors[:, 2])
    return adjust_hue(x, factors[:, 3])


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor,
                  kernel_size: int = 9) -> torch.Tensor:
    """Separable gaussian blur, a per-image ``sigma`` [N]; rows first, then
    columns, edge padding (the MoCo-v2 GaussianBlur, dataloader_bird.py:
    118)."""
    half = kernel_size // 2
    tap = torch.arange(-half, half + 1, dtype=torch.float32,
                       device=x.device)
    k = torch.exp(-(tap[None, :] ** 2) / (2 * sigma[:, None] ** 2))
    k = k / k.sum(dim=1, keepdim=True)                          # [N, K]
    h, w = x.shape[1], x.shape[2]
    rows = F.pad(x.permute(0, 3, 1, 2), (0, 0, half, half),
                 mode="replicate").permute(0, 2, 3, 1)
    v = sum(rows[:, t:t + h] * _per_image(k[:, t])
            for t in range(kernel_size))
    cols = F.pad(v.permute(0, 3, 1, 2), (half, half, 0, 0),
                 mode="replicate").permute(0, 2, 3, 1)
    return sum(cols[:, :, t:t + w] * _per_image(k[:, t])
               for t in range(kernel_size))


def _where(take: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_image(take), a, b)


# ---------------------------------------------------------------------------
# samplers and the composition
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimclrDecisions:
    """One :func:`simclr_augment` call's draws, per image: the crop box
    [N, 4] (y0, x0, h, w), whether the jitter applies and its factors
    [N, 4] (brightness, contrast, saturation, hue), grayscale, whether the
    blur applies and its sigma, and the flip."""

    box: torch.Tensor
    jitter: torch.Tensor
    factors: torch.Tensor
    gray: torch.Tensor
    blur: torch.Tensor
    sigma: torch.Tensor
    flip: torch.Tensor


def crop_boxes(u_area: torch.Tensor, u_ratio: torch.Tensor,
               u_y: torch.Tensor, u_x: torch.Tensor, h: int, w: int,
               scale: Tuple[float, float] = (0.2, 1.0),
               ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> torch.Tensor:
    """RandomResizedCrop's boxes from four U[0, 1) draws per image: the
    area a share U[scale] of the image, the log aspect U[log ratio], the
    size clamped to the image, the corner uniform over what is left."""
    area = h * w * (scale[0] + u_area * (scale[1] - scale[0]))
    lo, hi = math.log(ratio[0]), math.log(ratio[1])
    aspect = torch.exp(lo + u_ratio * (hi - lo))
    bw = torch.sqrt(area * aspect).clamp(1.0, w)
    bh = torch.sqrt(area / aspect).clamp(1.0, h)
    return torch.stack([u_y * (h - bh), u_x * (w - bw), bh, bw], dim=1)


def sample_simclr(generator: torch.Generator, n: int, h: int, w: int,
                  device=None) -> SimclrDecisions:
    """The draws of :func:`simclr_augment` for ``n`` images of ``h`` x
    ``w``, from ``generator`` (on ``device``)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    box = crop_boxes(u(n), u(n), u(n), u(n), h, w)
    lo = torch.tensor([0.6, 0.6, 0.6, -0.1], device=device)
    hi = torch.tensor([1.4, 1.4, 1.4, 0.1], device=device)
    return SimclrDecisions(
        box=box, jitter=u(n) < 0.8, factors=lo + u(n, 4) * (hi - lo),
        gray=u(n) < 0.2, blur=u(n) < 0.5, sigma=0.1 + u(n) * 1.9,
        flip=u(n) < 0.5)


def simclr_apply(frames: torch.Tensor, d: SimclrDecisions, out: int = 224,
                 mean=BIRD_PRETRAIN_MEAN) -> torch.Tensor:
    """The transform stack at decisions ``d``: frames uint8 (or float in
    [0, 1]) [N, H, W, 3] -> float32 normalized [N, out, out, 3]. Each
    conditional op is computed for every image and kept where drawn, as the
    JAX package's ``random_apply`` does."""
    x = bilinear_crop(to_float(frames), d.box, out)
    x = _where(d.jitter, color_jitter(x, d.factors), x)
    x = _where(d.gray, rgb_to_grayscale(x).expand_as(x), x)
    x = _where(d.blur, gaussian_blur(x, d.sigma), x)
    x = _where(d.flip, x.flip(2), x)
    return normalize(x, mean, CLIP_STD)


def simclr_augment(generator: torch.Generator, frames: torch.Tensor,
                   out: int = 224, chunk: int = 768,
                   positions: Optional[torch.Tensor] = None,
                   total: Optional[int] = None) -> torch.Tensor:
    """:func:`sample_simclr` then :func:`simclr_apply` over uint8 frames
    [N, H, W, 3] on their device, ``chunk`` images at a time (a full-width
    step augments 3072 frames; each apply holds several float copies).
    With ``positions`` (N indices into ``total``) the draws are made for
    ``total`` images, the global batch's frames, and those at
    ``positions`` are applied: a rank augments its frames as the
    single-process run does. ``torch.profiler`` sees it as the range
    ``simclr_augment``."""
    n, h, w = frames.shape[:3]
    with torch.profiler.record_function("simclr_augment"):
        d = sample_simclr(generator, n if total is None else total, h, w,
                          frames.device)
        if positions is not None:
            d = SimclrDecisions(*(getattr(d, f.name)[positions]
                                  for f in dataclasses.fields(d)))
        parts = []
        for s in range(0, n, chunk):
            sl = slice(s, s + chunk)
            parts.append(simclr_apply(frames[sl], SimclrDecisions(
                *(getattr(d, f.name)[sl] for f in dataclasses.fields(d))),
                out))
        return torch.cat(parts) if parts else frames.new_empty(
            (0, out, out, 3), dtype=torch.float32)
