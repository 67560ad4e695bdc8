"""Run modes: pretrain, fine-tune, eval, feature extract and parameter
count (counterpart of ``hmmc_tpu/runner.py``; reference main() of
main_task_retrieval.py:528-635 and of main_pretrain.py).

:func:`run_pretrain` (``--do_pretrain``, ``hmmc_tpu/runner.py:394-560``)
builds the ``BirdPretrainModel``, its key towers and queues (a pretrain
``--init_model`` loads all three), BertAdam and the pretrain step; each
batch is decoded on the device in aug mode (nvJPEG + R2 on the card), run
through the SimCLR augmentation there and placed ahead of the step by
``device_prefetch``; VATEX's caption serves as the title (and the tag).
Random streams come from (seed, purpose, global position), as the JAX
package's ``fold_in``: the augmentation's by batch, the MLM masks' by
step. It logs the four losses every ``n_display`` steps, writes
``pytorch_model.bin.{epoch}`` (the pretrain file, key towers and queues
included) at each epoch's end, then evaluates on MSR-VTT's test split when
that data is present (the reference's pretrain evaluates on it whatever
``--dataset`` is).

:func:`run_finetune`, :func:`run_eval`, :func:`run_extract` and
:func:`run_params` take the CLI's arguments: they build the tokenizer, the
registry's loaders (data first, so a bad ``--data_dir`` fails before the
model build) and the model (seeded random weights, overlaid by
``--clip_model``, then by ``--init_model``), then hand over to
:func:`finetune`, ``Evaluator.run``, the feature cache or the counters.
:func:`finetune` is the loop, callable with any loaders: BertAdam over
``t_total = steps_per_epoch * epochs``, per epoch ``set_epoch``, the train
step over the loader, the reference's console line every ``n_display``
steps (epoch, step, the scheduled learning rates, loss, host seconds in
data and step), ``pytorch_model.bin.{epoch}`` under ``output_dir`` in the
reference's names, then ``Evaluator.run`` and the best t2v R@1.

:func:`run_extract` writes ``output_dir/features.npz`` with the JAX
package's keys and dtypes (``tools/retrieve.py``, :mod:`hmmc_tpu_torch.
retrieve` and :mod:`hmmc_tpu_torch.serve` read it), int8 video side with
``--quantize_bank int8``. :func:`run_params` counts parameters and the
forward's FLOPs at batch 1 with ``torch.utils.flop_counter``, over the
plain attention: the counter sees PyTorch's operators, not K1 behind its
ctypes call. It counts matrix products and convolutions only, where the
JAX package's XLA cost analysis counts elementwise work too.

Batches carry compressed frames (``video_blobs``: decoded on the device,
nvJPEG and R1 on the card) or host uint8 ``video``.

:func:`main` runs the mode data-parallel over torchrun's ranks
(``torchrun --nproc_per_node N -m hmmc_tpu_torch ...``;
:mod:`hmmc_tpu_torch.parallel.distributed`): the loaders shard each
global batch by micro-batch, the steps compute the global batch's losses
and gradients, the eval deals its blocks out to the ranks, and rank 0
alone writes ``log.txt``, ``scalars.jsonl``, the state files and
``pytorch_model.bin.{epoch}``. :class:`TrainControl` gives both train
loops their train-state checkpoints (``--resume`` exact mid-epoch,
``--save_steps``, ``--async_save``, the SIGTERM save) and
``--profile_dir``. Not ported yet (ROADMAP.md Queue A): the bird
pretrain, retrieval_VT. It runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hmmc_tpu_torch.cli import (MetricsWriter, make_tokenizer, set_seed,
                                setup_logging, to_task_config)
from hmmc_tpu_torch.config import (ClipArch, CrossConfig, TaskConfig,
                                   load_cross_config)
from hmmc_tpu_torch.data.jpeg import decode_video_blobs
from hmmc_tpu_torch.data.loader import device_prefetch
from hmmc_tpu_torch.data.registry import get_factory
from hmmc_tpu_torch.evaluation import Evaluator
from hmmc_tpu_torch.factory import build_model, resolve_device
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.ops.quant import quantize_bank
from hmmc_tpu_torch.parallel import distributed
from hmmc_tpu_torch.train import state_io
from hmmc_tpu_torch.train.checkpoint import save_reference_checkpoint
from hmmc_tpu_torch.train.optimization import build_optimizer, scheduled_lr
from hmmc_tpu_torch.models.pretrain import MoCoQueues, init_key_params
from hmmc_tpu_torch.train.trainer import (FinetuneState, PretrainState,
                                          make_finetune_step,
                                          make_pretrain_step)
from hmmc_tpu_torch.utils.preemption import PreemptionWatcher

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


def _optimizer(task: TaskConfig, model, t_total: int):
    return build_optimizer(
        model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
        coef_lr=task.coef_lr, weight_decay=task.weight_decay,
        warmup_proportion=task.warmup_proportion, t_total=t_total,
        state_dtype=torch.bfloat16 if task.optim_bf16_state else None,
        zero=task.zero_opt)


class Profiler:
    """``torch.profiler`` over the first ``steps`` train steps of a run,
    one Chrome trace per rank under ``profile_dir``
    (``trace_rank{r}.json``; the counterpart of the JAX runner's
    ``_Profiler``, ``hmmc_tpu/runner.py:651-676``). :meth:`step` is called
    before each step."""

    def __init__(self, profile_dir: Optional[str], device, steps: int = 10):
        self.dir = profile_dir
        self.device = torch.device(device)
        self.steps = steps
        self._seen = 0
        self._prof = None

    def step(self) -> None:
        if not self.dir:
            return
        if self._seen == 0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        self._seen += 1
        if self._seen > self.steps:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self.dir, f"trace_rank{distributed.rank()}.json"))


class TrainControl:
    """What a train loop does around its steps (``hmmc_tpu/runner.py:
    150-175, 247-341, 435-561``): ``--resume`` from the newest state
    under ``output_dir/ckpt`` (exact mid-epoch: the loader skips the
    batches the cut run trained), a save every ``--save_steps`` steps and
    at each epoch's end (``--async_save``: on a thread), and on SIGTERM
    seen by any rank a save at the same step on every rank and a stop;
    ``--profile_dir``'s profiler. Without ``task.output_dir`` nothing is
    saved or resumed. A context manager: the signal handler and the writer
    live while it is entered."""

    def __init__(self, task: TaskConfig, steps_per_epoch: int, device,
                 log: logging.Logger, pretrain: bool = False):
        self.task = task
        self.steps_per_epoch = steps_per_epoch
        self.device = device
        self.log = log
        self.pretrain = pretrain
        self.dir = (os.path.join(task.output_dir, "ckpt")
                    if task.output_dir else None)
        self.writer = state_io.CheckpointWriter(
            self.dir, async_save=task.async_save,
            enabled=distributed.is_main() and self.dir is not None)
        self.preempt = PreemptionWatcher()
        self.profiler = Profiler(task.profile_dir, device)
        self.last_saved = None

    def __enter__(self) -> "TrainControl":
        self.preempt.install()
        return self

    def __exit__(self, *exc) -> bool:
        self.preempt.uninstall()
        self.profiler.close()
        self.writer.close()
        return False

    def resume(self, state) -> Tuple[int, int]:
        """Load the newest state into ``state``; (start epoch, batches of
        it to skip)."""
        if not (self.task.resume and self.dir):
            return 0, 0
        latest = state_io.latest_step(self.dir)
        if latest is None:
            self.log.info("--resume: no state under %s; starting fresh",
                          self.dir)
            return 0, 0
        meta = state_io.load_progress_meta(self.dir, latest) or {}
        if self.pretrain and meta.get("fused_ema", False):
            # the JAX package's --fused_ema saves params_k one EMA ahead
            # (hmmc_tpu/runner.py:436-450); the port never fuses
            raise ValueError(
                f"{self.dir} (step {latest}) was saved with fused_ema=True; "
                "its params_k convention differs by one EMA application "
                "and the port runs without --fused_ema")
        state_io.restore(state, state_io.load_state(self.dir, latest))
        if meta.get("epoch_end", True):
            self.log.info("resumed at epoch %d from %s (step %d)",
                          meta.get("epoch", -1) + 1, self.dir, latest)
            return meta.get("epoch", -1) + 1, 0
        self.log.info("resumed MID-EPOCH at epoch %d batch %d/%d from %s "
                      "(step %d)", meta["epoch"], meta["batch_in_epoch"],
                      meta["steps_per_epoch"], self.dir, latest)
        return meta["epoch"], meta["batch_in_epoch"]

    def save(self, state, epoch: int, batch_in_epoch: int,
             epoch_end: bool = False) -> None:
        if self.dir is None:
            return
        meta = {"epoch": epoch, "batch_in_epoch": batch_in_epoch,
                "steps_per_epoch": self.steps_per_epoch,
                "epoch_end": epoch_end, "world_size":
                distributed.world_size(), "zero_opt": self.task.zero_opt}
        if self.pretrain:
            meta["fused_ema"] = False
        if self.last_saved == state.step:
            self.writer.refresh_meta(state.step, meta)
            return
        self.writer.save(state.step, state_io.snapshot(state), meta)
        self.last_saved = state.step

    def after_step(self, state, epoch: int, batch_in_epoch: int) -> bool:
        """The save at ``--save_steps``; on a preemption signal that any
        rank saw, the save and True (the loop returns)."""
        every = self.task.save_steps
        if every and state.step % every == 0:
            self.save(state, epoch, batch_in_epoch)
        if distributed.any_rank(self.preempt.triggered, self.device):
            self.save(state, epoch, batch_in_epoch,
                      epoch_end=batch_in_epoch == self.steps_per_epoch)
            self.writer.wait()
            self.log.warning(
                "preemption signal: exact state saved at step %d (epoch %d, "
                "batch %d/%d); rerun with --resume to continue", state.step,
                epoch, batch_in_epoch, self.steps_per_epoch)
            return True
        return False


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
    ``video`` [B, F, H, W, 3], optional ``nframes``; over several ranks,
    this rank's shard), one batch per optimizer step, iterated once per
    epoch (``set_epoch(epoch)`` first where it has one; ``skip_batches``
    where a resume starts mid-epoch). ``eval_loader`` / ``eval_dataset``:
    as for ``Evaluator.run``. ``task.init_model`` overlays a checkpoint;
    ``task.output_dir`` receives ``pytorch_model.bin.{epoch}`` and the
    train states under ``ckpt/`` (rank 0 writes)."""
    log = log or logger
    device = resolve_device(device)
    model = build_model(task, cross, arch=arch, device=device,
                        init_model_path=task.init_model,
                        clip_model_path=task.clip_model)
    distributed.broadcast_module(model)
    resolution = task.image_resolution or model.arch.image_resolution
    steps_per_epoch = len(train_loader)
    t_total = steps_per_epoch * task.epochs
    state = FinetuneState(model, _optimizer(task, model, t_total))
    step_fn = make_finetune_step(
        cross, use_frame_fea=task.use_frame_fea,
        n_accum=task.gradient_accumulation_steps,
        use_frame_mask=task.use_frame_mask)
    evaluator = Evaluator(model, task, device=device)

    best_r1, best_metrics = -1.0, {}
    epoch_metrics, displayed = [], []
    with TrainControl(task, steps_per_epoch, device, log) as control:
        start_epoch, skip = control.resume(state)
        for epoch in range(start_epoch, task.epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            batch_in_epoch, skip = skip, 0
            if batch_in_epoch:
                train_loader.skip_batches(batch_in_epoch)
            t_data, t_step = 0.0, 0.0
            t0 = time.time()
            for batch in train_loader:
                control.profiler.step()
                t1 = time.time()
                state, metrics = step_fn(state, prepare_finetune_batch(
                    batch, device, resolution))
                t2 = time.time()
                t_data += t1 - t0
                t_step += t2 - t1
                batch_in_epoch += 1
                if control.after_step(state, epoch, batch_in_epoch):
                    return FinetuneRun(best_metrics, epoch_metrics,
                                       displayed, state)
                if state.step % task.n_display == 0:
                    names = sorted(metrics)
                    values = torch.stack([metrics[k].float() for k in names])
                    row = dict(zip(names, values.tolist()))
                    if writer is not None:
                        writer.scalar("loss", row["loss"], state.step)
                    lrs = log_lrs(task, state.step, t_total, writer)
                    log.info("epoch %d step %d lr %s loss %.4f "
                             "(data %.3fs step %.3fs)", epoch, state.step,
                             lrs, row["loss"], t_data, t_step)
                    displayed.append(dict(row, epoch=epoch, step=state.step,
                                          lr=lrs, data_s=t_data,
                                          step_s=t_step))
                    t_data = t_step = 0.0
                t0 = time.time()
            control.save(state, epoch, batch_in_epoch, epoch_end=True)
            if task.output_dir and distributed.is_main():
                save_reference_checkpoint(
                    os.path.join(task.output_dir,
                                 f"pytorch_model.bin.{epoch}"), model)
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
    # the resolution comes from pretrained_clip_name even where --clip_model
    # names a file of another size, as in the JAX package
    # (hmmc_tpu/runner.py:101-109)
    task = to_task_config(args)
    cross = load_cross_config(task.cross_model)
    if not task.image_resolution:
        arch = ClipArch.by_name(cross.pretrained_clip_name)
        task = task.replace(image_resolution=arch.image_resolution)
    return task, cross


# purposes of the random streams (the JAX runner's fold_in constants)
QUEUE_STREAM, AUG_STREAM, STEP_STREAM = 0, 1, 2


def stream(seed: int, purpose: int, position: int,
           device="cpu") -> torch.Generator:
    """A generator on ``device`` for (seed, purpose, position): the JAX
    package's ``fold_in(fold_in(PRNGKey(seed), purpose), position)``, so a
    run that resumes at a position draws what it would have drawn."""
    state = np.random.SeedSequence([seed, purpose, position]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def prepare_pretrain_batch(batch: Dict, device, generator: torch.Generator,
                           resolution: int = 224, aug_size: int = 256,
                           rows: Optional[np.ndarray] = None,
                           global_batch: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """A VATEX loader batch -> the pretrain step's device batch
    (``_prepare_pretrain_batch`` and ``place``, ``hmmc_tpu/runner.py:54-76,
    493-505``): the ``video_blobs`` decoded on the device in aug mode at
    ``aug_size``, then :func:`image_ops.simclr_augment` over the flattened
    frames from ``generator``; the captions serve as the titles. Over
    several ranks ``rows`` says where this rank's clips sit in the global
    batch of ``global_batch`` clips (``BatchLoader.global_rows``): the
    draws are made for the global batch's frames and this rank's applied,
    as the single-process run applies them."""
    video = decode_video_blobs(batch["video_blobs"], aug_size, device,
                               mode="aug")
    b, f = video.shape[:2]
    positions = total = None
    if rows is not None:
        positions = torch.from_numpy(
            (np.asarray(rows)[:, None] * f + np.arange(f)).reshape(-1)
        ).to(device)
        total = global_batch * f
    aug = image_ops.simclr_augment(
        generator, video.reshape(b * f, *video.shape[2:]), out=resolution,
        positions=positions, total=total)
    ids = torch.from_numpy(np.ascontiguousarray(batch["query_ids"]))
    return {"video": aug.view(b, f, resolution, resolution, 3),
            "title_ids": ids.to(device).long()}


@dataclasses.dataclass
class PretrainRun:
    displayed: List[Dict]        # one row per logged step
    epoch_metrics: List[Dict[str, float]]
    state: PretrainState


def pretrain_state(task: TaskConfig, model, t_total: int,
                   log: Optional[logging.Logger] = None) -> PretrainState:
    """The state a pretrain starts from: key towers copied from ``model``,
    queues drawn from the seed's stream, BertAdam over the query model;
    then a pretrain ``--init_model``'s key towers and queues, where the
    factory kept them (queues only at this run's shapes)."""
    log = log or logger
    device = next(model.parameters()).device
    towers = init_key_params(model)
    queues = MoCoQueues.create(
        stream(task.seed, QUEUE_STREAM, 0), model.arch.embed_dim,
        task.contrast_num_negative, task.max_frames, device)
    extra = getattr(model, "pretrain_import", None)
    if extra and extra["towers"]:
        towers.load_state_dict(extra["towers"], strict=False)
        log.info("restored momentum (key) towers from checkpoint")
    if extra and extra["queues"]:
        q = extra["queues"]
        if all(tuple(q[f].shape) == tuple(getattr(queues, f).shape)
               for f in MoCoQueues.NAMES if f in q):
            for f in MoCoQueues.NAMES:
                if f in q:
                    getattr(queues, f).copy_(q[f])
            queues.ptr = int(q.get("ptr", 0))
            log.info("restored MoCo queues (ptr=%d)", queues.ptr)
        else:
            log.warning("checkpoint queue shapes do not match "
                        "--contrast_num_negative/--max_frames; queues start "
                        "fresh")
    return PretrainState(model, towers, queues,
                         _optimizer(task, model, t_total))


LOSS_NAMES = ("loss", "loss_FAM", "loss_VTM", "loss_FTM", "loss_MLM")


def run_pretrain(args, log=None, device=None) -> PretrainRun:
    """``--do_pretrain``: the registry's pretrain loader through the MoCo
    pretrain step (see the module docstring)."""
    task, cross = _task_with_resolution(args)
    log = log or setup_logging(task.output_dir)
    set_seed(task.seed)
    tokenizer = make_tokenizer(task)
    writer = MetricsWriter(task.logdir)
    loader, _ = get_factory(task.dataset, "pretrain")(task, tokenizer)
    device = resolve_device(device)
    model = build_model(task, cross, device=device,
                        init_model_path=task.init_model,
                        clip_model_path=task.clip_model, pretrain=True,
                        vocab_size=tokenizer.vocab_size)
    steps_per_epoch = len(loader)
    t_total = steps_per_epoch * task.epochs
    state = pretrain_state(task, model, t_total, log)
    for module in (state.model, state.towers):
        distributed.broadcast_module(module)
    distributed.broadcast_([getattr(state.queues, f)
                            for f in MoCoQueues.NAMES])
    step_fn = make_pretrain_step(
        cross, tokenizer.mask_token_id, tokenizer.pad_token_id,
        tokenizer.cls_token_id,
        temperature=task.contrast_temperature,
        momentum=task.contrast_momentum, use_frame_fea=task.use_frame_fea,
        n_accum=task.gradient_accumulation_steps)
    resolution = task.image_resolution or model.arch.image_resolution
    rows = loader.global_rows()
    displayed, epoch_metrics = [], []
    try:
        with TrainControl(task, steps_per_epoch, device, log,
                          pretrain=True) as control:
            start_epoch, skip = control.resume(state)
            for epoch in range(start_epoch, task.epochs):
                loader.set_epoch(epoch)
                batch_in_epoch, skip = skip, 0
                if batch_in_epoch:
                    loader.skip_batches(batch_in_epoch)
                position = epoch * steps_per_epoch + batch_in_epoch

                def place(batch):
                    nonlocal position
                    gen = stream(task.seed, AUG_STREAM, position, device)
                    position += 1
                    return prepare_pretrain_batch(
                        batch, device, gen, resolution, task.aug_size, rows,
                        task.batch_size)

                t0 = time.time()
                for dev_batch in device_prefetch(iter(loader), place):
                    control.profiler.step()
                    state, metrics = step_fn(
                        state, dev_batch,
                        stream(task.seed, STEP_STREAM, state.step, device))
                    batch_in_epoch += 1
                    if control.after_step(state, epoch, batch_in_epoch):
                        return PretrainRun(displayed, epoch_metrics, state)
                    if state.step % task.n_display == 0:
                        values = torch.stack([metrics[k].float()
                                              for k in LOSS_NAMES]).tolist()
                        row = dict(zip(LOSS_NAMES, values))
                        for k, v in row.items():
                            writer.scalar(k, v, state.step)
                        lrs = log_lrs(task, state.step, t_total, writer)
                        wall = time.time() - t0
                        log.info("epoch %d step %d lr %s loss %.4f (FAM %.3f "
                                 "VTM %.3f FTM %.3f MLM %.3f) %.3fs", epoch,
                                 state.step, lrs, *values, wall)
                        displayed.append(dict(row, epoch=epoch,
                                              step=state.step, lr=lrs,
                                              wall_s=wall,
                                              ptr=state.queues.ptr))
                        t0 = time.time()
                control.save(state, epoch, batch_in_epoch, epoch_end=True)
                if task.output_dir and distributed.is_main():
                    save_reference_checkpoint(
                        os.path.join(task.output_dir,
                                     f"pytorch_model.bin.{epoch}"),
                        model, pretrain_state=state)
                epoch_metrics.append(_pretrain_eval(
                    task, tokenizer, model, device, log, writer, epoch))
    finally:
        writer.close()
    return PretrainRun(displayed, epoch_metrics, state)


def _pretrain_eval(task, tokenizer, model, device, log, writer, epoch):
    """MSR-VTT's test split through ``Evaluator.run`` where its data is
    present (main_pretrain.py:512-515; the Chinese eval on VATEX waits with
    the Chinese tower); ``{}`` where it is not."""
    eval_task = task.replace(dataset="msrvtt")
    try:
        loader, dataset = get_factory("msrvtt", "test")(eval_task,
                                                        tokenizer)
    except FileNotFoundError as e:
        log.info("skipping pretrain eval (msrvtt data not found: %s)", e)
        return {}
    metrics = Evaluator(model, eval_task, device=device).run(loader, dataset,
                                                             log)
    writer.scalar("R1", metrics["R1"], epoch)
    return metrics


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
                        init_model_path=task.init_model,
                        clip_model_path=task.clip_model)
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


def _dataset_video_ids(dataset):
    ids = getattr(dataset, "video_ids", None)
    if ids is not None:
        return list(ids)
    rows = getattr(dataset, "data", None)
    if rows and "video_id" in rows[0]:
        return [r["video_id"] for r in rows]
    return None


def run_extract(args, log=None, device=None) -> str:
    """``--do_extract``: the eval split's features as a bank,
    ``output_dir/features.npz`` (phase 1 of eval_epoch,
    main_task_retrieval.py:383-441, as an artifact). Returns its path."""
    task, cross = _task_with_resolution(args)
    log = log or setup_logging(task.output_dir)
    set_seed(task.seed)
    tokenizer = make_tokenizer(task)
    loader, dataset = get_factory(task.dataset, "test")(task, tokenizer)
    device = resolve_device(device)
    model = build_model(task, cross, device=device,
                        init_model_path=task.init_model,
                        clip_model_path=task.clip_model)
    q, v, f, multi, cut_off = Evaluator(model, task, device=device
                                        ).cache_features(loader, dataset)
    payload = {"query": q, "video": v, "frames": f,
               "logit_scale": np.float32(float(model.logit_scale())),
               "multi_sentence": np.bool_(multi),
               "cut_off_points": np.asarray(cut_off, np.int64),
               "top_frames": np.int32(task.top_frames),
               "use_frame_fea": np.bool_(task.use_frame_fea)}
    ids = _dataset_video_ids(dataset)
    if ids is not None:
        payload["video_ids"] = np.asarray(ids)
    if args.quantize_bank == "int8":
        payload = quantize_bank(payload)
    out = os.path.join(task.output_dir or ".", "features.npz")
    if distributed.is_main():
        np.savez(out, **payload)
        log.info("wrote %d query / %d video features to %s", len(q),
                 len(v), out)
    return out


def run_params(args, log=None, device=None) -> Dict[str, float]:
    """``--do_params``: the parameter count and the forward's FLOPs at batch
    1 (``encode_text`` + ``encode_video`` of zeros), counted by
    ``FlopCounterMode`` over the plain attention (reference: thop.profile,
    main_task_retrieval.py:623-633)."""
    from torch.utils.flop_counter import FlopCounterMode

    task, cross = _task_with_resolution(args)
    log = log or setup_logging(task.output_dir)
    device = resolve_device(device)
    model = build_model(task.replace(use_fused_attention="off"), cross,
                        device=device, init_model_path=task.init_model,
                        clip_model_path=task.clip_model)
    n_params = sum(p.numel() for p in model.parameters())
    res = task.image_resolution or 224
    ids = torch.zeros((1, task.max_words), dtype=torch.long, device=device)
    video = torch.zeros((1, task.max_frames, res, res, 3), device=device)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model.encode_text(ids)
        model.encode_video(video)
    flops = float(counter.get_total_flops())
    log.info("params: %.2fM  forward flops (batch 1): %.2fG",
             n_params / 1e6, flops / 1e9)
    return {"params": n_params, "flops": flops}


def main(args, device=None):
    """As the JAX runner dispatches: ``--do_params`` first (its counts are
    returned when nothing else runs), then ``--do_pretrain`` (returns the
    :class:`PretrainRun`), then ``--do_train`` (with its
    epoch-end evals; returns the :class:`FinetuneRun`), else
    ``--do_extract`` (returns the bank's path), else ``--do_eval``
    (returns its metrics). Under torchrun (or in a process group the
    caller made) the run is data-parallel over the ranks
    (:func:`distributed.init_distributed`; a group made here is destroyed
    at the end)."""
    device, created = distributed.init_distributed(args, device)
    try:
        return _dispatch(args, device)
    finally:
        if created:
            distributed.shutdown()


def _dispatch(args, device):
    out = None
    if args.do_params:
        out = run_params(args, device=device)
    if args.do_pretrain:
        return run_pretrain(args, device=device)
    if args.do_train:
        return run_finetune(args, device=device)
    if args.do_extract:
        return run_extract(args, device=device)
    if args.do_eval:
        return run_eval(args, device=device)
    if out is None:
        raise ValueError("nothing to do: pass --do_train, --do_eval, "
                         "--do_extract or --do_params")
    return out
