"""Run modes: fine-tune and eval (counterpart of ``hmmc_tpu/runner.py``;
reference main() of main_task_retrieval.py:528-635).

:func:`run_finetune` and :func:`run_eval` take the CLI's arguments: they
build the tokenizer, the registry's loaders (data first, so a bad
``--data_dir`` fails before the model build) and the model (seeded random
weights, overlaid by ``--init_model``), then hand over to :func:`finetune`
or ``Evaluator.run``. :func:`finetune` is the loop, callable with any
loaders: BertAdam over ``t_total = steps_per_epoch * epochs``, per epoch
``set_epoch``, the train step over the loader, the reference's console line
every ``n_display`` steps (epoch, step, the scheduled learning rates, loss,
host seconds in data and step), ``pytorch_model.bin.{epoch}`` under
``output_dir`` in the reference's names, then ``Evaluator.run`` and the best
t2v R@1.

Batches carry compressed frames (``video_blobs``: decoded on the device,
nvJPEG and R1 on the card) or host uint8 ``video``. Not ported yet
(ROADMAP.md Queue A): Orbax state checkpoints, ``--resume`` and preemption
saves, the profiler hook, the mesh, pretrain, extract, retrieval_VT. It runs
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from hmmc_tpu_torch.cli import (MetricsWriter, make_tokenizer, set_seed,
                                setup_logging, to_task_config)
from hmmc_tpu_torch.config import (ClipArch, CrossConfig, TaskConfig,
                                   load_cross_config)
from hmmc_tpu_torch.data.jpeg import decode_video_blobs
from hmmc_tpu_torch.data.registry import get_factory
from hmmc_tpu_torch.evaluation import Evaluator
from hmmc_tpu_torch.factory import build_model, resolve_device
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.train.checkpoint import save_reference_checkpoint
from hmmc_tpu_torch.train.optimization import build_optimizer, scheduled_lr
from hmmc_tpu_torch.train.trainer import FinetuneState, make_finetune_step

logger = logging.getLogger(__name__)


def prepare_finetune_batch(batch: Dict, device,
                           resolution: int = 224) -> Dict[str, torch.Tensor]:
    """Host loader batch -> device tensors. Frames come as ``video_blobs``
    (decoded on the device at ``resolution``) or as host uint8 ``video``
    (copied over); either way they are cast and CLIP-normalized on the
    device (the train datasets decode at the final resolution)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if "video_blobs" in batch:
        video = decode_video_blobs(batch["video_blobs"], resolution, device)
    else:
        video = put(batch["video"])
    out = {"query_ids": put(batch["query_ids"]).long(),
           "query_mask": put(batch["query_mask"]),
           "video": image_ops.normalize(image_ops.to_float(video))}
    if "nframes" in batch:
        out["nframes"] = put(batch["nframes"])
    return out


def log_lrs(task: TaskConfig, step: int, t_total: int,
            writer: Optional[MetricsWriter] = None) -> str:
    """Every distinct group lr, scheduled at ``step`` and sorted ascending,
    joined as the reference's console line prints them
    (main_task_retrieval.py:305-314); each also goes to ``writer`` as
    ``lr/lr{i}``."""
    unique = sorted({task.lr * task.coef_lr, task.text_lr, task.lr})
    lrs = [scheduled_lr(base, step, t_total, warmup=task.warmup_proportion)
           for base in unique]
    if writer is not None:
        for i, lr in enumerate(lrs):
            writer.scalar(f"lr/lr{i}", lr, step)
    return "-".join("%.9f" % lr for lr in lrs)


@dataclasses.dataclass
class FinetuneRun:
    best_metrics: Dict[str, float]
    epoch_metrics: List[Dict[str, float]]
    displayed: List[Dict]        # one row per logged step
    state: FinetuneState


def finetune(task: TaskConfig, cross: CrossConfig, train_loader,
             eval_loader, eval_dataset=None, arch: Optional[ClipArch] = None,
             device=None, log: Optional[logging.Logger] = None,
             writer: Optional[MetricsWriter] = None) -> FinetuneRun:
    """The fine-tune loop. ``train_loader``: a sized iterable of host
    batches (``query_ids``, ``query_mask``, ``video_blobs`` or uint8
    ``video`` [B, F, H, W, 3], optional ``nframes``), one batch per
    optimizer step, iterated once per epoch (``set_epoch(epoch)`` first
    where it has one). ``eval_loader`` / ``eval_dataset``: as for
    ``Evaluator.run``. ``task.init_model`` overlays a checkpoint;
    ``task.output_dir`` receives ``pytorch_model.bin.{epoch}``."""
    log = log or logger
    device = resolve_device(device)
    model = build_model(task, cross, arch=arch, device=device,
                        init_model_path=task.init_model)
    resolution = task.image_resolution or model.arch.image_resolution
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
        if hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch)
        t_data, t_step = 0.0, 0.0
        t0 = time.time()
        for batch in train_loader:
            t1 = time.time()
            state, metrics = step_fn(state, prepare_finetune_batch(
                batch, device, resolution))
            t2 = time.time()
            t_data += t1 - t0
            t_step += t2 - t1
            if state.step % task.n_display == 0:
                names = sorted(metrics)
                values = torch.stack([metrics[k].float() for k in names])
                row = dict(zip(names, values.tolist()))
                if writer is not None:
                    writer.scalar("loss", row["loss"], state.step)
                lrs = log_lrs(task, state.step, t_total, writer)
                log.info("epoch %d step %d lr %s loss %.4f "
                         "(data %.3fs step %.3fs)", epoch, state.step, lrs,
                         row["loss"], t_data, t_step)
                displayed.append(dict(row, epoch=epoch, step=state.step,
                                      lr=lrs, data_s=t_data, step_s=t_step))
                t_data = t_step = 0.0
            t0 = time.time()
        if task.output_dir:
            save_reference_checkpoint(
                os.path.join(task.output_dir, f"pytorch_model.bin.{epoch}"),
                model)
        metrics = evaluator.run(eval_loader, eval_dataset, log)
        if writer is not None:
            writer.scalar("R1", metrics["R1"], epoch)
        epoch_metrics.append(metrics)
        if metrics["R1"] > best_r1:
            best_r1, best_metrics = metrics["R1"], metrics
            log.info("new best R@1 %.1f at epoch %d", best_r1, epoch)
    log.info("best t2v R@1: %.1f", best_r1)
    return FinetuneRun(best_metrics, epoch_metrics, displayed, state)


def _task_with_resolution(args):
    task = to_task_config(args)
    cross = load_cross_config(task.cross_model)
    if not task.image_resolution:
        arch = ClipArch.by_name(cross.pretrained_clip_name)
        task = task.replace(image_resolution=arch.image_resolution)
    return task, cross


def run_eval(args, log=None, device=None) -> Dict[str, float]:
    """``--do_eval``: the test split (or val) through ``Evaluator.run``."""
    task, cross = _task_with_resolution(args)
    log = log or setup_logging(task.output_dir)
    set_seed(task.seed)
    tokenizer = make_tokenizer(task)
    split = "test"
    loader, dataset = get_factory(task.dataset, split)(task, tokenizer)
    device = resolve_device(device)
    model = build_model(task, cross, device=device,
                        init_model_path=task.init_model)
    return Evaluator(model, task, device=device).run(loader, dataset, log)


def run_finetune(args, log=None, device=None) -> FinetuneRun:
    """``--do_train``: the registry's train and test loaders through
    :func:`finetune`."""
    task, cross = _task_with_resolution(args)
    log = log or setup_logging(task.output_dir)
    set_seed(task.seed)
    tokenizer = make_tokenizer(task)
    writer = MetricsWriter(task.logdir)
    train_loader, _ = get_factory(task.dataset, "train")(task, tokenizer)
    eval_loader, eval_dataset = get_factory(task.dataset, "test")(
        task, tokenizer)
    try:
        return finetune(task, cross, train_loader, eval_loader, eval_dataset,
                        device=device, log=log, writer=writer)
    finally:
        writer.close()


def main(args, device=None):
    """``--do_train`` (with its epoch-end evals; returns the
    :class:`FinetuneRun`), else ``--do_eval`` (returns its metrics)."""
    if args.do_train:
        return run_finetune(args, device=device)
    if args.do_eval:
        return run_eval(args, device=device)
    raise ValueError("nothing to do: pass --do_train or --do_eval")
