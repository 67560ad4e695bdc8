"""MSR-VTT datasets over a frame store (counterpart of
``hmmc_tpu/data/datasets.py``: ``FrameSource`` in ``eval`` mode,
``_get_video``, ``SeededFrameSampling``, ``MsrvttEvalDataset``,
``MsrvttTrainDataset``).

A sample carries the frames still compressed: ``video_blobs``, ``want``
JPEG blobs as ``bytes`` (``None`` in zero-padded slots up to
``max_frames``), beside ``query_ids``, ``query_mask``, ``nframes`` and
``idx``. The consumer decodes a whole batch on its device
(:func:`hmmc_tpu_torch.data.jpeg.decode_video_blobs`); no pixel is decoded
on the host. :meth:`FrameSource.load` decodes on the CPU, as the JAX
package's ``FrameSource.load`` does (PIL, then R1's plain version: the same
frames bit for bit).

CSV files are read with the standard ``csv`` module (the card's machine has
no pandas), every field kept as the string it is, in file order.

Not ported yet (ROADMAP.md Queue A): the ``aug`` decode mode (pretrain),
the LMDB reader, and the VATEX, bird, MSVD and LSMDC datasets.
"""

from __future__ import annotations

import csv
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hmmc_tpu_torch.data.framepack import open_frame_store
from hmmc_tpu_torch.data.jpeg import decode_frames
from hmmc_tpu_torch.data.sampling import sample_frame_indices
from hmmc_tpu_torch.data.text import encode_text

Blobs = List[Optional[bytes]]


def read_csv(path: str) -> List[Dict[str, str]]:
    """Rows of a headed CSV as dicts of strings, in file order."""
    with open(path, "r", encoding="utf-8", newline="") as f:
        return list(csv.DictReader(f))


class FrameSource:
    """Frame store + the eval decode geometry (the JAX package's ``eval``
    mode; its ``aug`` mode is not ported)."""

    def __init__(self, store_path: str, resolution: int = 224):
        self.store = open_frame_store(store_path)
        self.resolution = resolution

    def stored_frames(self, video_id: str) -> int:
        return self.store.num_frames(video_id)

    def blobs(self, video_id: str, indices: Sequence[int]) -> Blobs:
        """The compressed frames at ``indices``, copied out of the map."""
        return [bytes(b) for b in self.store.get_frames(
            video_id, [int(i) for i in indices])]

    def load(self, video_id: str, indices: Sequence[int]) -> np.ndarray:
        """Decoded on the CPU: uint8 [n, res, res, 3]."""
        return decode_frames(self.blobs(video_id, indices), self.resolution,
                             "cpu").numpy()


def _get_video(source: FrameSource, video_id: str, want: int,
               max_frames: int, frame_sample: str,
               rng: Optional[np.random.Generator]) -> Tuple[Blobs, int]:
    """Sample ``want`` frames' blobs, padded with ``None`` to
    ``max_frames`` (dataloader_bird.py:210-216)."""
    stored = source.stored_frames(video_id)
    idx = sample_frame_indices(stored, want, frame_sample, rng)
    blobs: Blobs = list(source.blobs(video_id, idx))
    return blobs + [None] * (max_frames - want), want


class SeededFrameSampling:
    """Deterministic frame-sampling RNG for train datasets: each sample
    derives its own generator from (seed, epoch, idx), so sampling is the
    same run to run and for any number of loader threads.
    ``BatchLoader.set_epoch`` threads (epoch, seed) through here."""

    _seed: int = 0
    _epoch: int = 0

    def set_epoch(self, epoch: int, seed: Optional[int] = None) -> None:
        self._epoch = int(epoch)
        if seed is not None:
            self._seed = int(seed)

    def _sample_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng((self._seed, self._epoch, int(idx)))


def _sample(ids, mask, blobs: Blobs, nframes: int, idx: int) -> Dict:
    return {"query_ids": ids, "query_mask": mask, "video_blobs": blobs,
            "nframes": np.int32(nframes), "idx": np.int32(idx)}


class MsrvttEvalDataset:
    """JSFUSION 1k-A test csv: one (sentence, video) pair per row
    (dataloader_msrvtt_retrieval.py:38-164)."""

    multi_sentence_per_video = False

    def __init__(self, source: FrameSource, csv_path: str, tokenizer,
                 max_words: int = 32, max_frames: int = 12,
                 frame_sample: str = "uniform", language: str = "english"):
        self.data = read_csv(csv_path)
        self.source = source
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.frame_sample = frame_sample
        self.language = language

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        row = self.data[idx]
        ids, mask = encode_text(self.tokenizer, row["sentence"],
                                self.max_words, self.language)
        blobs, nframes = _get_video(
            self.source, row["video_id"], self.max_frames, self.max_frames,
            self.frame_sample, None)
        return _sample(ids, mask, blobs, nframes, idx)


class MsrvttTrainDataset(SeededFrameSampling):
    """9k-split training sentences, unfolded: every (video, caption) pair is
    one sample (dataloader_msrvtt_retrieval.py:205-211)."""

    def __init__(self, source: FrameSource, csv_path: str, json_path: str,
                 tokenizer, max_words: int = 32, max_frames: int = 12,
                 frame_sample: str = "random", language: str = "english"):
        train_ids = {row["video_id"] for row in read_csv(csv_path)}
        with open(json_path, "r", encoding="utf-8") as f:
            data = json.load(f)
        self.samples: List[Tuple[str, str]] = [
            (itm["video_id"], itm["caption"]) for itm in data["sentences"]
            if itm["video_id"] in train_ids]
        self.source = source
        self.tokenizer = tokenizer
        self.max_words = max_words
        self.max_frames = max_frames
        self.frame_sample = frame_sample
        self.language = language

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        video_id, caption = self.samples[idx]
        ids, mask = encode_text(self.tokenizer, caption, self.max_words,
                                self.language)
        blobs, nframes = _get_video(
            self.source, video_id, self.max_frames, self.max_frames,
            self.frame_sample, self._sample_rng(idx))
        return _sample(ids, mask, blobs, nframes, idx)
