"""CLIP's ModifiedResNet visual tower (counterpart of
``hmmc_tpu/models/resnet.py``; reference module_clip.py:68-214).

- a 3-convolution stem (stride 2, then two stride-1 3x3 convolutions),
  each followed by BatchNorm and ReLU, then a 2x2 average pool;
- four stages of :class:`Bottleneck` blocks: 1x1, 3x3, 1x1 convolutions,
  anti-aliased where the stage strides (a ``stride``-wide average pool
  before the last convolution, and on the identity before its
  ``downsample`` convolution); the first block of ``layer1`` downsamples by
  channel count alone;
- :class:`AttentionPool2d`: the grid's mean token prepended, the
  positional embedding added, one query (the mean token) attending over
  every token through the plain attention (as the JAX tower does: the
  query length is 1, no fused kernel).

Module names are OpenAI's (``conv1``, ``bn1``, ``layer{s}.{b}.conv1``,
``layer{s}.{b}.downsample.{0,1}``, ``attnpool.q_proj``, ...), so the
tower's ``state_dict`` is an OpenAI RN file's ``visual.*`` part,
BatchNorm running statistics included. The input is ``[N, H, W, 3]``
frames, as the ViT's; the convolutions (``F.conv2d``, cuDNN on the card)
read them as a channels-last NCHW view and keep that layout.

:class:`BatchNorm2d` has the JAX tower's semantics (flax ``nn.BatchNorm``
with momentum 0.9, eps 1e-5), not ``torch.nn.BatchNorm2d``'s: in train mode
it normalises with the batch mean and the biased batch variance
E[x^2] - E[x]^2 (clipped at 0) and moves the running variance by that same
BIASED variance (torch moves it by the unbiased one). The statistics and
the normalisation are computed in fp32 under any compute dtype. Over
several ranks the batch statistics are the global batch's: the sums of x,
x^2 and the count are summed over ranks (the JAX package's batch axis is
global under ``jit``), and the backward sums the two reductions it needs
over ranks in turn. ``torch.nn.SyncBatchNorm`` is not used: it refuses CPU
tensors, where the tests hold the port to JAX. The normalisation is one
autograd function that saves only its input (in the compute dtype) and the
per-channel statistics, and recomputes the normalised input in the
backward, so a train-mode BatchNorm keeps no fp32 copy of its activation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmmc_tpu_torch.models.layers import Linear, lecun_normal_, normal_
from hmmc_tpu_torch.ops.attention import dot_product_attention
from hmmc_tpu_torch.parallel import distributed

_CHANNEL = (1, -1, 1, 1)
_REDUCE = (0, 2, 3)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or wider where it is (flax promotes its statistics)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_statistics(x: torch.Tensor):
    """(mean, biased variance, count) of ``x`` [N, C, H, W] per channel, in
    fp32 (or wider), over every rank's rows: flax's fast variance
    E[x^2] - E[x]^2, clipped at 0. No gradient."""
    with torch.no_grad():
        xf = _wide(x)
        c = x.shape[1]
        stats = torch.cat([xf.sum(_REDUCE), (xf * xf).sum(_REDUCE),
                           xf.new_full((1,), x.numel() // c)])
        del xf
        distributed.all_reduce_([stats])
        count = stats[-1]
        mean = stats[:c] / count
        var = (stats[c:2 * c] / count - mean * mean).clamp_(min=0.0)
    return mean, var, count


class _Normalize(torch.autograd.Function):
    """y = (x - mean) * (rstd * weight) + bias per channel, in fp32 (or
    wider), returned in x's dtype. With ``batch`` (the statistics are x's
    own, over ``count`` rows of every rank) the backward carries the
    gradient through mean and rstd: dx = rstd * weight * (dy - sum(dy) /
    count - xhat * sum(dy * xhat) / count), the two sums over every rank;
    the weight's and bias's gradients are this rank's sums."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, rstd, count, batch):
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.count, ctx.batch = count, batch
        scale = (rstd * weight).view(_CHANNEL)
        y = (_wide(x) - mean.view(_CHANNEL)) * scale + bias.view(_CHANNEL)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        dyf = _wide(dy)
        xhat = (_wide(x) - mean.view(_CHANNEL)) * rstd.view(_CHANNEL)
        sums = torch.cat([dyf.sum(_REDUCE), (dyf * xhat).sum(_REDUCE)])
        db, dw = sums.chunk(2)
        scale = (rstd * weight).view(_CHANNEL)
        if ctx.batch:
            sums = sums.clone()
            distributed.all_reduce_([sums])
            mean_dy, mean_dy_xhat = (sums / ctx.count).chunk(2)
            dx = (dyf - mean_dy.view(_CHANNEL)
                  - xhat * mean_dy_xhat.view(_CHANNEL)) * scale
        else:
            dx = dyf * scale
        return dx.to(x.dtype), dw, db, None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over dim 1 of [N, C, H, W] with the JAX tower's semantics
    (see the module docstring) and an explicit ``train`` flag; buffers and
    parameters named as torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``num_batches_tracked``), momentum 0.1 in torch's
    sense (flax's 0.9)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def reset_parameters(self, generator=None) -> None:  # noqa: ARG002
        super().reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean, var, count = batch_statistics(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var, count = self.running_mean, self.running_var, None
        rstd = torch.rsqrt(var + self.eps)
        return _Normalize.apply(x, self.weight, self.bias, mean, rstd, count,
                                train)


class Conv2d(nn.Module):
    """A convolution without bias (``weight`` [O, I, k, k], fp32, cast to
    the input's dtype); initialised as flax's ``nn.Conv`` (lecun
    normal)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                        self.padding)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = Conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, out, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample: Optional[nn.ModuleDict] = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.ModuleDict(
                {"0": Conv2d(inplanes, out, 1), "1": BatchNorm2d(out)})

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample["1"](self.downsample["0"](identity),
                                            train)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def reset_parameters(self, generator=None) -> None:
        normal_(self.positional_embedding,
                self.positional_embedding.shape[1] ** -0.5, generator)
        for m in (self.q_proj, self.k_proj, self.v_proj, self.c_proj):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, C, h, w] -> [N, output_dim] in x's dtype."""
        n, c, h, w = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)
        hd = c // self.num_heads

        def heads(t):
            return t.view(n, t.shape[1], self.num_heads, hd).transpose(1, 2)

        out = dot_product_attention(heads(self.q_proj(tokens[:, :1])),
                                    heads(self.k_proj(tokens)),
                                    heads(self.v_proj(tokens)))
        return self.c_proj(out.transpose(1, 2).reshape(n, c))


class ModifiedResNet(nn.Module):
    def __init__(self, layers: Sequence[int], output_dim: int, heads: int,
                 input_resolution: int = 224, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        half = width // 2
        self.conv1 = Conv2d(3, half, 3, stride=2, padding=1)
        self.bn1 = BatchNorm2d(half)
        self.conv2 = Conv2d(half, half, 3, padding=1)
        self.bn2 = BatchNorm2d(half)
        self.conv3 = Conv2d(half, width, 3, padding=1)
        self.bn3 = BatchNorm2d(width)
        inplanes, planes = width, width
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            stage_blocks = [Bottleneck(inplanes, planes, stride)]
            inplanes = planes * Bottleneck.expansion
            stage_blocks += [Bottleneck(inplanes, planes)
                             for _ in range(1, blocks)]
            setattr(self, f"layer{stage + 1}", nn.ModuleList(stage_blocks))
            planes *= 2
        self.num_stages = len(layers)
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32,
                                        heads, output_dim)

    def reset_parameters(self, generator=None) -> None:
        for m in self.modules():
            if isinstance(m, (Conv2d, BatchNorm2d, AttentionPool2d)):
                m.reset_parameters(generator)

    def forward(self, pixels: torch.Tensor, train: bool = False
                ) -> torch.Tensor:
        """pixels: [N, H, W, 3] normalized floats -> [N, output_dim] in the
        compute dtype. ``train``: BatchNorm on the batch's statistics,
        moving the running ones; otherwise on the running statistics."""
        x = pixels.to(self.dtype).permute(0, 3, 1, 2)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = F.relu(bn(conv(x), train))
        x = F.avg_pool2d(x, 2)
        for stage in range(1, self.num_stages + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block(x, train)
        return self.attnpool(x)
