"""Prediction heads of the pretrain model (counterpart of
``hmmc_tpu/models/heads.py``).

- :class:`MLMHead`: BERT's LM prediction head (module_cross.py:308-341):
  dense -> erf-GELU -> LayerNorm (eps 1e-12) -> an untied vocabulary
  decoder whose bias is the separate ``bias`` parameter. Names:
  ``transform.dense``, ``transform.LayerNorm``, ``decoder.weight``,
  ``bias``.
- :class:`BatchNorm`: ``nn.BatchNorm1d`` (running variance updated with
  the unbiased batch variance, momentum 0.1, eps 1e-5: the semantics the
  JAX package's ``TorchBatchNorm`` copies), with the train flag an
  argument, as the JAX module takes it, and its arithmetic in fp32 under
  any compute dtype. Over several ranks its train-mode statistics are the
  GLOBAL batch's (:func:`global_batch_norm`): the JAX heads normalise
  over the global batch ("plain BatchNorm over the batch axis IS
  sync-BN", ``hmmc_tpu/models/heads.py:6-9``). ``torch.nn.SyncBatchNorm``
  is not used: it refuses CPU tensors, where the tests hold the port to
  JAX.
- :class:`ProjectorMLP`: the SimSiam-style projector / predictor
  (modeling.py:788-807): ``num_layers - 1`` blocks of Linear -> BatchNorm
  -> ReLU, then a Linear. Its names are the reference ``nn.Sequential``'s:
  ``linear_hidden.{1 + 3j}`` (Linear), ``linear_hidden.{2 + 3j}``
  (BatchNorm), ``linear_out``.

Inputs are cast to the compute dtype at each head's entry, as the JAX
``Linear`` casts its input.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from hmmc_tpu_torch.models.layers import LayerNorm, Linear, lecun_normal_
from hmmc_tpu_torch.parallel import distributed


class MLMHead(nn.Module):
    def __init__(self, dim: int, vocab_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.transform = nn.Module()
        self.transform.dense = Linear(dim, dim)
        self.transform.LayerNorm = LayerNorm(dim, eps=1e-12)
        self.decoder = nn.Module()
        self.decoder.weight = nn.Parameter(torch.empty(vocab_size, dim))
        self.bias = nn.Parameter(torch.empty(vocab_size))

    def reset_parameters(self, generator=None) -> None:
        self.transform.dense.reset_parameters(generator)
        self.transform.LayerNorm.reset_parameters(generator)
        lecun_normal_(self.decoder.weight, self.decoder.weight.shape[1],
                      generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        """[..., dim] -> logits [..., vocab] in the compute dtype."""
        x = self.transform.dense(hidden.to(self.dtype))
        x = self.transform.LayerNorm(F.gelu(x))
        return F.linear(x, self.decoder.weight.to(x.dtype),
                        self.bias.to(x.dtype))


def global_batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """Train-mode batch norm of ``x`` [n, C] (fp32) with the statistics of
    the rows of every rank: the count and the sum, then the sum of squared
    deviations from the global mean, each summed over ranks by
    :func:`distributed.all_reduce_sum`, whose backward sums the two
    gradient reductions over ranks. Moves ``bn``'s running mean and its
    running variance (unbiased over the global count) by its momentum."""
    stats = distributed.all_reduce_sum(torch.cat(
        [x.sum(dim=0), x.new_full((1,), x.shape[0])]))
    count = stats[-1]
    mean = stats[:-1] / count
    centred = x - mean
    var = distributed.all_reduce_sum((centred * centred).sum(dim=0)) / count
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(
            var.detach() * (count / (count - 1)), alpha=m)
    return centred * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` called with an explicit ``train`` flag: in train
    mode it normalises with the biased batch variance and moves the running
    mean and the running (unbiased) variance by momentum 0.1 (over several
    ranks, of the global batch: :func:`global_batch_norm`); otherwise it
    normalises with the running statistics. Computes in fp32 (or wider)
    and returns ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=1e-5, momentum=0.1)
        self.dtype = dtype

    def reset_parameters(self, generator=None) -> None:  # noqa: ARG002
        super().reset_parameters()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if train:
            self.num_batches_tracked.add_(1)
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        if train and distributed.world_size() > 1:
            return global_batch_norm(x, self).to(self.dtype)
        y = F.batch_norm(x, self.running_mean, self.running_var,
                         self.weight, self.bias, train, self.momentum,
                         self.eps)
        return y.to(self.dtype)


class ProjectorMLP(nn.Module):
    def __init__(self, num_layers: int = 2, in_dim: int = 512,
                 inner_dim: int = 4096, out_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers, dim = [nn.Identity()], in_dim
        for _ in range(num_layers - 1):
            layers += [Linear(dim, inner_dim), BatchNorm(inner_dim, dtype),
                       nn.ReLU()]
            dim = inner_dim
        self.linear_hidden = nn.Sequential(*layers)
        self.linear_out = Linear(dim, out_dim)

    def reset_parameters(self, generator=None) -> None:
        for m in list(self.linear_hidden) + [self.linear_out]:
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        for m in list(self.linear_hidden)[1:]:
            x = m(x, train) if isinstance(m, BatchNorm) else m(x)
        return self.linear_out(x)
