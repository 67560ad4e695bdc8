"""The fine-tune and pretrain steps (counterparts of ``make_finetune_step``
and ``_accumulate``, both branches, and of ``PretrainState`` and
``make_pretrain_step`` in ``hmmc_tpu/train/trainer.py``; reference
train_epoch, main_task_retrieval.py:250-318, and modeling.py:334-436).

One step: for each of ``n_accum`` micro-batches, encode the queries and the
video, take the VTM + FTM CrossEn loss (:mod:`hmmc_tpu_torch.losses`) with
the scale ``min(exp(logit_scale), 100)`` held out of the graph, and add its
gradients into ``.grad``; then divide by ``n_accum`` (the mean of the
micro-batch gradients, summed first as the JAX scan does), read the global
gradient norm before clipping, and take one optimizer step. Parameters stay
fp32 and the towers compute in their compute dtype; gradients arrive in
fp32. A ModifiedResNet tower runs its BatchNorm in train mode (the JAX
step's BatchNorm branch, ``hmmc_tpu/train/trainer.py:194-240``): each
micro-batch normalises over its own frames, the gradient flows through
those statistics, and the running statistics move once a micro-batch, in
turn (the JAX scan threads ``batch_stats`` through its micro-batches).
Metrics are device tensors (the mean over micro-batches) so the step
never waits for the card; the caller reads them when it logs.

Over several ranks (:mod:`hmmc_tpu_torch.parallel.distributed`) each rank
holds its share of every global micro-batch (``BatchLoader``'s rank
shard), so the steps compute what the JAX package computes on the global
batch: the fine-tune gathers the query, video and frame features of the
micro-batch (``all_gather_rows``, one collective) and takes the CrossEn
over the global similarity, identical on every rank; the pretrain's MoCo,
FAM and frame losses are per-row means, so each rank takes its rows' share
of the global mean (its mean over the world size) and the MLM loss divides
by the global count of masked tokens, and the metrics are summed over
ranks. After the micro-batches one flat all-reduce sums the gradients, so
every rank holds the single-process gradient before ``grad_norm`` is read
and the optimizer steps; the projectors' BatchNorm takes the global
batch's statistics, as does a ModifiedResNet's BatchNorm in the
fine-tune, the mask and augmentation draws are made for the
global batch and applied to this rank's rows, and each micro-batch's keys
are gathered before the enqueue, so the queues, ``ptr`` and the key
towers stay identical on every rank.

``torch.profiler`` sees the step as two ranges, ``finetune_step.grads`` and
``finetune_step.optimizer``.

The pretrain step (:func:`make_pretrain_step`) runs, for each micro-batch
in order: the momentum EMA of the key towers; the key forwards under
``no_grad`` (the key projector in train mode, moving the key BatchNorm
statistics); the query forwards; FAM, VTM and FTM against the queues as
they stand, then MLM; the backward; the enqueue of this micro-batch's keys
(after the backward: the losses' saved tensors read the queues). A
ModifiedResNet tower's BatchNorm stays frozen on both sides (its running
statistics, as the JAX step reads them); only the projectors' move. The
mean of the micro-batch gradients feeds one BertAdam update, as in the
fine-tune. Its ranges are ``pretrain_step.grads`` (which holds
``pretrain_step.keys``: the EMA and the key forwards) and
``pretrain_step.optimizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from hmmc_tpu_torch import losses
from hmmc_tpu_torch.config import CrossConfig
from hmmc_tpu_torch.parallel import distributed
from hmmc_tpu_torch.models.pretrain import (BirdPretrainModel, MaskDecisions,
                                            MoCoQueues, MomentumTowers,
                                            apply_mask_decisions,
                                            momentum_pairs, momentum_update,
                                            mlm_loss, sample_mask_decisions)

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
    b = len(next(iter(batch.values())))
    if b % n:
        raise ValueError(f"batch {b} is not divisible into {n} micro-batches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def gather_rows(*xs: Optional[torch.Tensor]) -> List[Optional[torch.Tensor]]:
    """The ranks' rows of each tensor (fp32), concatenated in rank order
    by one differentiable all-gather; None stays None; without a process
    group the tensors as they are."""
    if not distributed.is_initialized():
        return list(xs)
    present = [x for x in xs if x is not None]
    flat = distributed.all_gather_rows(torch.cat(
        [x.float().reshape(x.shape[0], -1) for x in present], dim=1))
    parts = iter(flat.split([x[0].numel() for x in present], dim=1))
    return [None if x is None
            else next(parts).reshape(flat.shape[0], *x.shape[1:])
            for x in xs]


def reduce_gradients(model: torch.nn.Module, n_accum: int) -> List:
    """The accumulated gradients summed over ranks (one flat all-reduce)
    and divided by ``n_accum``: the mean of the global micro-batches'
    gradients, on every rank."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    distributed.all_reduce_grads(grads)
    if n_accum > 1:
        for g in grads:
            g.div_(n_accum)
    return grads


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
        v, f = model.encode_video(batch["video"], frame_mask(batch),
                                  train=True)
        q, v, f = gather_rows(q, v, f if use_frame_fea else None)
        scale = model.logit_scale().detach()
        return losses.finetune_retrieval_loss(q, v, f, scale, w_vtm, w_ftm)

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
            grads = reduce_gradients(model, n_accum)
            metrics = {k: v / n_accum for k, v in sums.items()}
            metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        with torch.profiler.record_function("finetune_step.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# pretrain step (BirdPretrainModel + MoCo)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PretrainState:
    """The pretrain's state (the JAX ``PretrainState``): the query model
    (``params`` and its projectors' ``batch_stats``), the key towers
    (``params_k``, their projectors' statistics ``batch_stats_k``), the
    queues, the optimizer over the query model and the step."""

    model: BirdPretrainModel
    towers: MomentumTowers
    queues: MoCoQueues
    optimizer: torch.optim.Optimizer
    step: int = 0

    def __post_init__(self):
        self.pairs = momentum_pairs(self.model, self.towers)


MLM_STREAMS = ("title", "tag")


def make_pretrain_step(cross_config: CrossConfig, mask_token_id: int,
                       pad_token_id: int, cls_token_id: int,
                       temperature: float = 0.07, momentum: float = 0.99,
                       use_frame_fea: bool = True, use_tag: bool = False,
                       n_accum: int = 1) -> Callable:
    """Returns ``step(state, batch, generator, decisions=None) -> (state,
    metrics)``. batch: ``title_ids`` [B, L], ``video`` [B, F, H, W, 3]
    normalized floats, and with ``use_tag`` (the bird datasets) ``tag_ids``
    (this rank's rows). ``generator`` draws the MLM masks on the batch's
    device, for the global micro-batch; ``decisions`` (one dict per
    micro-batch of :class:`MaskDecisions` by :data:`MLM_STREAMS` name, at
    the global micro-batch's shape) replaces those draws. metrics:
    ``loss``, ``loss_FAM``, ``loss_VTM``, ``loss_FTM``, ``loss_MLM`` (means
    over the micro-batches) and ``grad_norm``."""
    w = cross_config
    t = temperature

    def key_forwards(towers: MomentumTowers, mb: Batch) -> Batch:
        title_k = towers.encode_text(mb["title_ids"])
        tag_k = towers.encode_text(mb["tag_ids"]) if use_tag else title_k
        v_k, frame_k = towers.encode_video(mb["video"])
        return dict(title_k=title_k, tag_k=tag_k, v_k=v_k, frame_k=frame_k,
                    frame_proj_k=towers.project_frames_key(frame_k, True))

    def loss_fn(model: BirdPretrainModel, mb: Batch, keys: Batch,
                queues: MoCoQueues, dec: Dict[str, MaskDecisions],
                share: float) -> Metrics:
        """This rank's share of the micro-batch's losses: the per-row
        means times ``share`` (1 / world), the MLM sum over the global
        count of masked tokens."""
        v_fea, frame_fea = model.encode_video(mb["video"])
        title_fea = model.encode_text(mb["title_ids"])
        tag_fea = model.encode_text(mb["tag_ids"]) if use_tag else title_fea
        _, frame_pred = model.project_frames(frame_fea, True)
        # FAM (modeling.py:385)
        loss_fam = losses.frame_self_loss(frame_pred, keys["frame_proj_k"],
                                          queues.frame_proj, t)
        # VTM (modeling.py:387-394)
        loss_vtm = (
            losses.moco_contrastive(v_fea, keys["title_k"],
                                    queues.title_cross, t)
            + losses.moco_contrastive(title_fea, keys["v_k"],
                                      queues.v_cross, t))
        if use_tag:
            v_tag = (losses.moco_contrastive(v_fea, keys["tag_k"],
                                             queues.tag_cross, t)
                     + losses.moco_contrastive(tag_fea, keys["v_k"],
                                               queues.v_cross, t))
            loss_vtm = (v_tag + loss_vtm) / 2
        # FTM (modeling.py:396-405)
        loss_ftm = loss_vtm.new_zeros(())
        if use_frame_fea:
            loss_ftm = losses.frame_cross_loss(
                frame_fea, keys["frame_k"], queues.frame_cross, title_fea,
                keys["title_k"], queues.title_cross, t)
            if use_tag:
                f_tag = losses.frame_cross_loss(
                    frame_fea, keys["frame_k"], queues.frame_cross, tag_fea,
                    keys["tag_k"], queues.tag_cross, t)
                loss_ftm = (f_tag + loss_ftm) / 2

        loss_fam, loss_vtm, loss_ftm = (share * loss_fam, share * loss_vtm,
                                        share * loss_ftm)

        # MLM (modeling.py:416-421)
        def one_mlm(ids, d):
            masked, labels = apply_mask_decisions(
                ids, d, mask_token_id, pad_token_id, cls_token_id)
            count = (labels != -100).sum()
            distributed.all_reduce_([count])
            return mlm_loss(model.mlm_logits(masked), labels, count)

        loss_mlm = one_mlm(mb["title_ids"], dec["title"])
        if use_tag:
            loss_mlm = (loss_mlm + one_mlm(mb["tag_ids"], dec["tag"])) / 2
        loss = (w.weight_FAM * loss_fam + w.weight_VTM * loss_vtm
                + w.weight_FTM * loss_ftm + w.weight_MLM * loss_mlm)
        return {"loss": loss, "loss_FAM": loss_fam, "loss_VTM": loss_vtm,
                "loss_FTM": loss_ftm, "loss_MLM": loss_mlm}

    def draw(generator, mb: Batch, vocab: int, world: int
             ) -> Dict[str, MaskDecisions]:
        out = {}
        for name in MLM_STREAMS:
            if f"{name}_ids" in mb:
                ids = mb[f"{name}_ids"]
                out[name] = sample_mask_decisions(
                    generator, (ids.shape[0] * world, *ids.shape[1:]), vocab,
                    w.mlm_probability, ids.device)
        return out

    def own_rows(dec: Dict[str, MaskDecisions], n: int
                 ) -> Dict[str, MaskDecisions]:
        """This rank's ``n`` rows of the global micro-batch's draws."""
        lo = distributed.rank() * n
        return {name: MaskDecisions(*(getattr(d, f.name)[lo:lo + n]
                                      for f in dataclasses.fields(d)))
                for name, d in dec.items()}

    def step(state: PretrainState, batch: Batch,
             generator: Optional[torch.Generator] = None,
             decisions: Optional[List[Dict[str, MaskDecisions]]] = None
             ) -> Tuple[PretrainState, Metrics]:
        model, towers, queues = state.model, state.towers, state.queues
        world = distributed.world_size()
        with torch.profiler.record_function("pretrain_step.grads"):
            model.zero_grad(set_to_none=True)
            sums: Metrics = {}
            for i, mb in enumerate(split_microbatches(batch, n_accum)):
                with torch.profiler.record_function("pretrain_step.keys"), \
                        torch.no_grad():
                    momentum_update(model, towers, momentum, state.pairs)
                    keys = key_forwards(towers, mb)
                dec = (decisions[i] if decisions is not None
                       else draw(generator, mb, model.vocab_size, world))
                n = len(mb["title_ids"])
                out = loss_fn(model, mb, keys, queues, own_rows(dec, n),
                              1.0 / world)
                out["loss"].backward()
                with torch.no_grad():
                    queues.enqueue(*gather_rows(
                        keys["v_k"], keys["tag_k"], keys["title_k"],
                        keys["frame_k"], keys["frame_proj_k"]))
                for k, v in out.items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
            names = sorted(sums)
            totals = torch.stack([sums[k] for k in names])
            distributed.all_reduce_([totals])
            grads = reduce_gradients(model, n_accum)
            metrics = {k: v / n_accum for k, v in zip(names, totals)}
            metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
        with torch.profiler.record_function("pretrain_step.optimizer"):
            state.optimizer.step()
        state.step += 1
        return state, metrics

    return step
