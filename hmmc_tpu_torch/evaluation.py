"""Retrieval evaluation (counterpart of ``hmmc_tpu/evaluation.py``;
reference eval_epoch, main_task_retrieval.py:360-525).

Two phases on one device, under ``torch.inference_mode()``:

1. Feature caching: the text and video encoders run over FIXED-size
   blocks (only the last partial block is zero-padded, then trimmed);
   uint8 frames are cast and CLIP-normalized on the device. A loader
   batch that carries compressed frames (``video_blobs``, the frame-store
   datasets') is decoded on the evaluator's device first
   (:func:`hmmc_tpu_torch.data.jpeg.decode_video_blobs`: nvJPEG and R1 on
   the card); one that carries host uint8 ``video`` is copied over. A
   ModifiedResNet tower runs its BatchNorm on the running statistics
   (``hmmc_tpu/evaluation.py:213-221``). Multi-sentence datasets encode
   every sentence but only the videos at the cut-off indices.
2. Similarity: ``scale * cos(q, v)`` plus, with ``use_frame_fea``, the
   mean of each query's top-``top_frames`` frame logits, blocked over
   queries so the [Q, V, F] frame logits never exceed one block; then
   R@1/5/10, MedR and MeanR (t2v and v2t) by
   :func:`hmmc_tpu_torch.metrics.logging_rank`.

Over several ranks (:mod:`hmmc_tpu_torch.parallel.distributed`) every
rank iterates the same global loader, and the fixed-size blocks are dealt
out round-robin: block k is encoded by rank k % world, which decodes only
that block's clips. The blocks hold the rows a single process would put
in them, so each feature equals the single process's; the features are
all-gathered in block order, rank 0 computes the similarity and the
metrics (as the JAX package's process 0 does, ``hmmc_tpu/evaluation.py:
146-152``) and broadcasts the metrics.

Not ported yet: dual-softmax reweighting, the retrieval_VT title mix and
token filtering.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Union

import numpy as np
import torch

from hmmc_tpu_torch.config import TaskConfig
from hmmc_tpu_torch.data.jpeg import decode_video_blobs
from hmmc_tpu_torch.factory import resolve_device
from hmmc_tpu_torch.metrics import logging_rank
from hmmc_tpu_torch.ops import image_ops
from hmmc_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


Rows = Union[np.ndarray, torch.Tensor]


def _concat(parts) -> Rows:
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


def _pad_to(x: Rows, n: int) -> Rows:
    if x.shape[0] == n:
        return x
    if isinstance(x, torch.Tensor):
        pad = x.new_zeros((n - x.shape[0], *x.shape[1:]))
    else:
        pad = np.zeros((n - x.shape[0], *x.shape[1:]), x.dtype)
    return _concat([x, pad])


def auto_video_block(arch, frames: int, budget_bytes: float = 2.5e9) -> int:
    """The largest power of two <= 64 whose fp32 attention probabilities
    [B*F, H, L, L] fit ``budget_bytes`` (copied as it is; the budget was
    sized for a TPU's memory and is still to be re-derived for the H100,
    see ROADMAP.md)."""
    if arch.is_resnet:
        return 64
    seq = arch.grid_size ** 2 + 1
    heads = arch.vision_heads
    b = 64
    while b > 1 and b * frames * heads * seq * seq * 4.0 > budget_bytes:
        b //= 2
    return b


def _owned(start: int, n: int, block: int) -> list:
    """Of the rows [start, start + n), the offsets of those in this
    rank's blocks (block k belongs to rank k % world)."""
    world, me = distributed.world_size(), distributed.rank()
    if world == 1:
        return list(range(n))
    return [i for i in range(n) if (start + i) // block % world == me]


def _gather_blocks(local, width: int, total: int, block: int, device):
    """This rank's block outputs (``width`` arrays over its blocks' rows,
    or ``()``) -> the same arrays over all ``total`` rows in block order,
    on every rank."""
    world = distributed.world_size()
    if world == 1:
        return local
    n_blocks = -(-total // block)
    out = []
    for i in range(width):
        parts = distributed.all_gather_arrays(
            local[i] if local else None, device)
        taken = [0] * world
        rows = []
        for k in range(n_blocks):
            r = k % world
            size = min(block, total - k * block)
            rows.append(parts[r][taken[r]:taken[r] + size])
            taken[r] += size
        out.append(np.concatenate(rows, axis=0))
    return tuple(out)


class _BlockedEncoder:
    """Accumulates rows (host numpy arrays, or tensors already on the
    device) and runs an encoder over FIXED-size blocks, padding only the
    final partial block. Bounds the encoder's footprint by the block size,
    not by the loader's batch size."""

    def __init__(self, fn, block: int):
        self.fn = fn
        self.block = block
        self.bufs = None
        self.n = 0
        self.outs = []

    def add(self, *arrays: Rows) -> None:
        if self.bufs is None:
            self.bufs = [[] for _ in arrays]
        for buf, a in zip(self.bufs, arrays):
            buf.append(a if isinstance(a, torch.Tensor) else np.asarray(a))
        self.n += arrays[0].shape[0]
        while self.n >= self.block:
            self._compact()
            blk = [c[:self.block] for c in self._cat]
            self._run(blk, self.block)
            self._cat = [c[self.block:] for c in self._cat]
            self.bufs = [[c] for c in self._cat]
            self.n -= self.block

    def _compact(self) -> None:
        self._cat = [_concat(b) for b in self.bufs]

    def _run(self, blk, n_valid: int) -> None:
        out = self.fn(*blk)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        self.outs.append(tuple(np.asarray(o)[:n_valid] for o in out))

    def finish(self):
        """Returns a tuple of concatenated outputs (empty tuple if no rows
        were added)."""
        if self.n:
            self._compact()
            self._run([_pad_to(c, self.block) for c in self._cat], self.n)
            self.bufs, self.n = None, 0
        if not self.outs:
            return ()
        width = len(self.outs[0])
        return tuple(np.concatenate([o[i] for o in self.outs], axis=0)
                     for i in range(width))


class Evaluator:
    def __init__(self, model, task: TaskConfig, query_block: int = 512,
                 text_block: int = 512, video_block: Optional[int] = None,
                 device=None):
        """``model``: a ``BirdModel`` already on ``device`` (default: the
        current CUDA device; without a card, pass ``device="cpu"``)."""
        self.device = resolve_device(device)
        p = next(model.parameters())
        if p.device.type != self.device.type or (
                self.device.index is not None
                and p.device.index != self.device.index):
            raise ValueError(f"model is on {p.device}, evaluator on "
                             f"{self.device}")
        self.model = model
        self.task = task
        self.query_block = query_block
        self.text_block = text_block
        if video_block is None:
            video_block = auto_video_block(model.arch, task.max_frames)
            logger.info("eval video block auto-sized to %d", video_block)
        self.video_block = video_block

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _encode_text(self, ids: np.ndarray) -> np.ndarray:
        return self.model.encode_text(self._to_device(ids).long()).cpu().numpy()

    @property
    def resolution(self) -> int:
        return self.task.image_resolution or self.model.arch.image_resolution

    def frames(self, batch, keep=None) -> Rows:
        """A loader batch's uint8 frames [B, F, S, S, 3] (only the clips in
        ``keep``, if given): its ``video_blobs`` decoded on this device, or
        its host ``video``."""
        if "video_blobs" in batch:
            blobs = batch["video_blobs"]
            if keep is not None:
                blobs = [blobs[i] for i in keep]
            return decode_video_blobs(blobs, self.resolution, self.device)
        return batch["video"] if keep is None else batch["video"][keep]

    def _encode_video(self, video_u8: Rows):
        if not isinstance(video_u8, torch.Tensor):
            video_u8 = self._to_device(video_u8)
        video = image_ops.normalize(image_ops.to_float(video_u8))
        v, f = self.model.encode_video(video)
        return v.cpu().numpy(), f.cpu().numpy()

    def _block_sims(self, q: torch.Tensor, v: torch.Tensor,
                    frames: torch.Tensor, scale: float):
        qn = q / q.norm(dim=-1, keepdim=True)
        vn = v / v.norm(dim=-1, keepdim=True)
        sim = scale * qn @ vn.T
        fn = frames / frames.norm(dim=-1, keepdim=True)
        # [Q, V, F] frame logits for this query block
        fl = scale * torch.einsum("qh,vfh->qvf", qn, fn)
        k = min(self.task.top_frames, fl.shape[-1])
        sim_frame = fl.topk(k, dim=-1).values.mean(dim=-1)
        return sim, sim_frame

    @torch.inference_mode()
    def cache_features(self, loader, dataset=None):
        """-> (q [Q, D], v [V, D], f [V, F, D], multi, cut_off), numpy (on
        every rank; each rank encodes its blocks, see the module
        docstring)."""
        multi = bool(getattr(dataset, "multi_sentence_per_video", False))
        cut_off = ([c - 1 for c in dataset.cut_off_points] if multi else [])
        q_enc = _BlockedEncoder(self._encode_text, self.text_block)
        v_enc = _BlockedEncoder(self._encode_video, self.video_block)
        total_video = n_queries = n_videos = 0
        for batch in loader:
            n = batch["query_ids"].shape[0]
            mine = _owned(n_queries, n, self.text_block)
            if mine:
                ids = batch["query_ids"]
                q_enc.add(ids if len(mine) == n else ids[mine])
            n_queries += n
            if multi:
                # encode only the videos at the cut-off indices
                s_ = total_video
                keep = [i - s_ for i in cut_off if s_ <= i < s_ + n]
                total_video += n
            else:
                keep = list(range(n))
            own = [keep[i] for i in _owned(n_videos, len(keep),
                                           self.video_block)]
            n_videos += len(keep)
            if own:
                v_enc.add(self.frames(batch, None if len(own) == n
                                      else own))
        q = _gather_blocks(q_enc.finish(), 1, n_queries, self.text_block,
                           self.device)
        vf = _gather_blocks(v_enc.finish(), 2, n_videos, self.video_block,
                            self.device)
        return q[0], vf[0], vf[1], multi, cut_off

    @torch.inference_mode()
    def similarity(self, q: np.ndarray, v: np.ndarray,
                   f: np.ndarray) -> np.ndarray:
        scale = float(self.model.logit_scale())
        v_dev, f_dev = self._to_device(v), self._to_device(f)
        blocks, frame_blocks = [], []
        qb = self.query_block
        nq = q.shape[0]
        for s in range(0, nq, qb):
            sim, sim_frame = self._block_sims(
                self._to_device(_pad_to(q[s:s + qb], qb)), v_dev, f_dev, scale)
            n = min(qb, nq - s)
            blocks.append(sim[:n].cpu().numpy())
            frame_blocks.append(sim_frame[:n].cpu().numpy())
        sim = np.concatenate(blocks, axis=0)
        if self.task.use_frame_fea:
            sim = sim + np.concatenate(frame_blocks, axis=0)
        return sim

    def run(self, loader, dataset=None,
            log: Optional[logging.Logger] = None) -> Dict[str, float]:
        q, v, f, multi, cut_off = self.cache_features(loader, dataset)
        metrics = None
        if distributed.is_main():
            logger.info("eval features: %d queries, %d videos", len(q),
                        len(v))
            sim = self.similarity(q, v, f)
            metrics = logging_rank(sim, multi, cut_off, log or logger)
        return distributed.broadcast_object(metrics, self.device)
