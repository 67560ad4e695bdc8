"""The fine-tune step (counterpart of ``make_finetune_step`` and
``_accumulate`` in ``hmmc_tpu/train/trainer.py``, the non-BatchNorm branch;
reference train_epoch, main_task_retrieval.py:250-318).

One step: for each of ``n_accum`` micro-batches, encode the queries and the
video, take the VTM + FTM CrossEn loss (:mod:`hmmc_tpu_torch.losses`) with
the scale ``min(exp(logit_scale), 100)`` held out of the graph, and add its
gradients into ``.grad``; then divide by ``n_accum`` (the mean of the
micro-batch gradients, summed first as the JAX scan does), read the global
gradient norm before clipping, and take one optimizer step. Parameters stay
fp32 and the towers compute in their compute dtype; gradients arrive in
fp32. Metrics are device tensors (the mean over micro-batches) so the step
never waits for the card; the caller reads them when it logs.

``torch.profiler`` sees the step as two ranges, ``finetune_step.grads`` and
``finetune_step.optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from hmmc_tpu_torch import losses
from hmmc_tpu_torch.config import CrossConfig

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FinetuneState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def split_microbatches(batch: Batch, n: int) -> List[Batch]:
    """n equal consecutive slices along the batch axis (the JAX package's
    reshape to [n, B/n, ...])."""
    b = batch["query_ids"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} is not divisible into {n} micro-batches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_finetune_step(cross_config: CrossConfig, use_frame_fea: bool = True,
                       n_accum: int = 1, use_frame_mask: bool = False
                       ) -> Callable[[FinetuneState, Batch],
                                     Tuple[FinetuneState, Metrics]]:
    """Returns ``step(state, batch) -> (state, metrics)``. batch keys:
    ``query_ids`` [B, L], ``query_mask`` [B, L], ``video`` [B, F, H, W, 3]
    normalized floats, optional ``nframes`` [B] (read with
    ``use_frame_mask``: frames past a clip's count are masked out of the
    temporal attention). metrics: ``loss``, ``sim_loss``, ``frame_loss``,
    ``grad_norm``."""
    w_vtm = cross_config.weight_VTM_finetune
    w_ftm = cross_config.weight_FTM_finetune

    def frame_mask(batch: Batch):
        if use_frame_mask and "nframes" in batch:
            n_f = batch["video"].shape[1]
            frames = torch.arange(n_f, device=batch["nframes"].device)
            return (frames[None, :] < batch["nframes"][:, None]).int()
        return None

    def loss_fn(model, batch: Batch) -> Metrics:
        q = model.encode_text(batch["query_ids"])
        v, f = model.encode_video(batch["video"], frame_mask(batch))
        scale = model.logit_scale().detach()
        return losses.finetune_retrieval_loss(
            q, v, f if use_frame_fea else None, scale, w_vtm, w_ftm)

    def step(state: FinetuneState, batch: Batch
             ) -> Tuple[FinetuneState, Metrics]:
        model = state.model
        with torch.profiler.record_function("finetune_step.grads"):
            model.zero_grad(set_to_none=True)
            sums: Metrics = {}
            for mb in split_microbatches(batch, n_accum):
                out = loss_fn(model, mb)
                out["loss"].backward()
                for k, v in out.items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if n_accum > 1:
                for g in grads:
                    g.div_(n_accum)
            metrics = {k: v / n_accum for k, v in sums.items()}
            metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        with torch.profiler.record_function("finetune_step.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step
