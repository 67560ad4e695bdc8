"""The fine-tune run (counterpart of the loop of ``run_finetune`` in
``hmmc_tpu/runner.py``; reference main() of main_task_retrieval.py).

:func:`run_finetune` builds the model (seeded random weights), BertAdam over
``t_total = steps_per_epoch * epochs`` and the train step, then for each
epoch trains over the caller's loader, logging every ``n_display`` steps the
reference's console line (epoch, step, the scheduled learning rates, loss,
host seconds in data and step), and runs ``Evaluator.run`` at the epoch's
end, keeping the best t2v R@1.

Not ported yet (ROADMAP.md Queue A): the dataset registry (the caller
passes the loaders and the eval dataset), checkpoint save / resume, the
mesh, the profiler hook, retrieval_VT. It runs on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.evaluation import Evaluator
from hmmc_tpu_torch.factory import build_model, resolve_device
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.train.optimization import build_optimizer, scheduled_lr
from hmmc_tpu_torch.train.trainer import FinetuneState, make_finetune_step

logger = logging.getLogger(__name__)


def prepare_finetune_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Host loader batch -> device tensors; uint8 frames are cast and
    CLIP-normalized on the device (the train datasets decode at the final
    resolution)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {"query_ids": put(batch["query_ids"]).long(),
           "query_mask": put(batch["query_mask"]),
           "video": image_ops.normalize(image_ops.to_float(
               put(batch["video"])))}
    if "nframes" in batch:
        out["nframes"] = put(batch["nframes"])
    return out


def log_lrs(task: TaskConfig, step: int, t_total: int) -> str:
    """Every distinct group lr, scheduled at ``step`` and sorted ascending,
    joined as the reference's console line prints them
    (main_task_retrieval.py:305-314)."""
    unique = sorted({task.lr * task.coef_lr, task.text_lr, task.lr})
    return "-".join("%.9f" % scheduled_lr(base, step, t_total,
                                          warmup=task.warmup_proportion)
                    for base in unique)


@dataclasses.dataclass
class FinetuneRun:
    best_metrics: Dict[str, float]
    epoch_metrics: List[Dict[str, float]]
    displayed: List[Dict]        # one row per logged step
    state: FinetuneState


def run_finetune(task: TaskConfig, cross: CrossConfig, train_loader,
                 eval_loader, eval_dataset=None,
                 arch: Optional[ClipArch] = None, device=None,
                 log: Optional[logging.Logger] = None) -> FinetuneRun:
    """``train_loader``: a sized iterable of host batches (``query_ids``,
    ``query_mask``, uint8 ``video`` [B, F, H, W, 3], optional ``nframes``),
    one batch per optimizer step, iterated once per epoch.
    ``eval_loader`` / ``eval_dataset``: as for ``Evaluator.run``."""
    log = log or logger
    device = resolve_device(device)
    model = build_model(task, cross, arch=arch, device=device)
    steps_per_epoch = len(train_loader)
    t_total = steps_per_epoch * task.epochs
    optimizer = build_optimizer(
        model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
        coef_lr=task.coef_lr, weight_decay=task.weight_decay,
        warmup_proportion=task.warmup_proportion, t_total=t_total,
        state_dtype=torch.bfloat16 if task.optim_bf16_state else None)
    state = FinetuneState(model, optimizer)
    step_fn = make_finetune_step(
        cross, use_frame_fea=task.use_frame_fea,
        n_accum=task.gradient_accumulation_steps,
        use_frame_mask=task.use_frame_mask)
    evaluator = Evaluator(model, task, device=device)

    best_r1, best_metrics = -1.0, {}
    epoch_metrics, displayed = [], []
    for epoch in range(task.epochs):
        t_data, t_step = 0.0, 0.0
        t0 = time.time()
        for batch in train_loader:
            t1 = time.time()
            state, metrics = step_fn(state, prepare_finetune_batch(batch,
                                                                   device))
            t2 = time.time()
            t_data += t1 - t0
            t_step += t2 - t1
            if state.step % task.n_display == 0:
                names = sorted(metrics)
                values = torch.stack([metrics[k].float() for k in names])
                row = dict(zip(names, values.tolist()))
                lrs = log_lrs(task, state.step, t_total)
                log.info("epoch %d step %d lr %s loss %.4f "
                         "(data %.3fs step %.3fs)", epoch, state.step, lrs,
                         row["loss"], t_data, t_step)
                displayed.append(dict(row, epoch=epoch, step=state.step,
                                      lr=lrs, data_s=t_data, step_s=t_step))
                t_data = t_step = 0.0
            t0 = time.time()
        metrics = evaluator.run(eval_loader, eval_dataset, log)
        epoch_metrics.append(metrics)
        if metrics["R1"] > best_r1:
            best_r1, best_metrics = metrics["R1"], metrics
            log.info("new best R@1 %.1f at epoch %d", best_r1, epoch)
    log.info("best t2v R@1: %.1f", best_r1)
    return FinetuneRun(best_metrics, epoch_metrics, displayed, state)
