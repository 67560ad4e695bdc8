"""Batching loader with parallel host reads and a device prefetch helper
(counterpart of ``hmmc_tpu/data/loader.py``; reference: the torch
DataLoader + DistributedSampler stack, dataloaders/dataloader.py:9-177).

- The loader thinks in GLOBAL batches: the index order comes from
  (seed, epoch) identically on every process, and each process reads only
  its shard of every global batch (DistributedSampler semantics,
  dataloaders/dataloader.py:14). With ``n_accum`` micro-batches a step,
  the shard is this process's contiguous 1/process_count of EVERY global
  micro-batch (:func:`rank_rows`): the JAX step splits the global batch
  into contiguous micro-batches (``hmmc_tpu/train/trainer.py:89-91``), so
  the rows the processes gather for local micro-batch i are the JAX
  package's micro-batch i, in order. A final partial batch is wrap-padded
  to a multiple of ``n_accum * process_count`` first.
- Samples are read in a thread pool; here they carry compressed frames
  (``video_blobs``), which the consumer decodes on its device.
- ``prefetch`` keeps N batches in flight so host reads overlap device work.

Epoch seeding mirrors DistributedSampler.set_epoch: ``shuffle(epoch)``
reshuffles deterministically from (seed, epoch).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np


def rank_rows(batch: int, n_accum: int, rank: int, world: int) -> np.ndarray:
    """The rows of a global batch of ``batch`` that rank ``rank`` of
    ``world`` holds, in its order: its contiguous 1/world of each of the
    ``n_accum`` contiguous micro-batches."""
    if batch % (n_accum * world):
        raise ValueError(f"global batch {batch} is not divisible into "
                         f"{n_accum} micro-batches x {world} processes")
    m = batch // n_accum
    q = m // world
    return (np.arange(n_accum)[:, None] * m + rank * q
            + np.arange(q)[None, :]).reshape(-1)


def _stack_samples(samples: List[Dict]) -> Dict:
    """Arrays stack along a new batch axis; ``video_blobs`` stays a B-long
    list of per-sample blob lists."""
    return {k: ([s[k] for s in samples] if k == "video_blobs"
                else np.stack([s[k] for s in samples]))
            for k in samples[0].keys()}


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 42,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
        n_accum: int = 1,
    ):
        """``batch_size`` is the GLOBAL batch; with process_count > 1 each
        process yields its batch_size/process_count shard of every global
        batch, :func:`rank_rows` of it (with ``n_accum`` 1 the shards
        concatenate, in process order, to the exact single-process
        batch)."""
        if process_count > 1 and batch_size % (n_accum * process_count):
            raise ValueError(
                f"global batch_size {batch_size} must divide by "
                f"gradient_accumulation_steps x process_count = "
                f"{n_accum} x {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.process_index = process_index
        self.process_count = process_count
        self.n_accum = n_accum
        self._epoch = 0
        self._skip_next = 0
        # seed the frame-sampling RNG for epoch 0 even if the caller never
        # calls set_epoch (one-off eval loops)
        self._seed_dataset(0)

    def _seed_dataset(self, epoch: int) -> None:
        set_ds_epoch = getattr(self.dataset, "set_epoch", None)
        if set_ds_epoch is not None:
            set_ds_epoch(epoch, seed=self.seed)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._seed_dataset(epoch)

    def skip_batches(self, n: int) -> None:
        """Fast-forward the NEXT iteration past its first ``n`` batches
        (the (seed, epoch) order is deterministic). One-shot: cleared when
        iteration starts."""
        self._skip_next = int(n)

    def global_rows(self) -> Optional[np.ndarray]:
        """Where this process's rows of a full batch sit in the global
        batch (None for one process): the samplers that draw over the
        global batch apply their draws at these rows."""
        if self.process_count == 1:
            return None
        return rank_rows(self.batch_size, self.n_accum, self.process_index,
                         self.process_count)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(self.seed + self._epoch)
        return rng.permutation(n)

    def batch_indices(self) -> List[np.ndarray]:
        """This process's dataset indices of each batch of the next
        iteration (order, drop_last, shard and skip applied)."""
        order = self._order()
        n = len(order)
        limit = (n // self.batch_size * self.batch_size
                 if self.drop_last else n)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, limit, self.batch_size)]
        if self.process_count > 1:
            p, count = self.process_index, self.process_count
            unit = count * self.n_accum

            def local_shard(bidx: np.ndarray) -> np.ndarray:
                if len(bidx) % unit:
                    # final partial batch: wrap-pad so every process holds
                    # an equal shard (DistributedSampler pads the same way)
                    bidx = np.resize(bidx, -(-len(bidx) // unit) * unit)
                return bidx[rank_rows(len(bidx), self.n_accum, p, count)]

            batches = [local_shard(b) for b in batches]
        if self._skip_next:
            batches = batches[self._skip_next:]
            self._skip_next = 0
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self.batch_indices()
        if not batches:
            return iter(())

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(
                        self.dataset.__getitem__, batch_idx.tolist()))
                    out_q.put(_stack_samples(samples))
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()

        def gen():
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()
                # drain so a producer blocked on put() can observe stop and
                # exit, with a bounded join
                deadline = time.monotonic() + 5.0
                while producer.is_alive() and time.monotonic() < deadline:
                    try:
                        while True:
                            out_q.get_nowait()
                    except queue.Empty:
                        pass
                    producer.join(timeout=0.1)
                pool.shutdown(wait=False)

        return gen()


def device_prefetch(iterator, place_fn: Callable, depth: int = 2):
    """Pipelines host->device placement: keeps ``depth`` batches placed
    ahead of the consumer."""
    buf = collections.deque()
    for batch in iterator:
        buf.append(place_fn(batch))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
