"""MSR-VTT and VATEX datasets over a frame store (counterpart of
``hmmc_tpu/data/datasets.py``: ``FrameSource`` in ``eval`` and ``aug``
mode, ``_get_video``, ``SeededFrameSampling``, ``MsrvttEvalDataset``,
``MsrvttTrainDataset``, ``VatexDataset``).

A sample carries the frames still compressed: ``video_blobs``, ``want``
JPEG blobs as ``bytes`` (``None`` in zero-padded slots up to
``max_frames``), beside ``query_ids``, ``query_mask``, ``nframes`` and
``idx``. The consumer decodes a whole batch on its device
(:func:`hmmc_tpu_torch.data.jpeg.decode_video_blobs`); no pixel is decoded
on the host. The source's ``mode`` says how (``"eval"``: R1's geometry at
``resolution``; ``"aug"``: R2's at ``aug_size``), and the consumer decodes
in that mode. :meth:`FrameSource.load` decodes on the CPU, as the
JAX package's ``FrameSource.load`` does (PIL, then R1's plain version, or
cv2, then R2's: the same frames bit for bit as its PIL and cv2 routes).

CSV files are read with the standard ``csv`` module (the card's machine has
no pandas), every field kept as the string it is, in file order.

Not ported yet (ROADMAP.md Queue A): the LMDB reader, and the bird, MSVD
and LSMDC datasets.
"""

from __future__ import annotations

import csv
import json
import os
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
    """Frame store + decode policy: ``mode="eval"`` decodes at
    ``resolution`` (R1's geometry), ``mode="aug"`` at ``aug_size`` (R2's:
    the pretrain's 256 for 224)."""

    def __init__(self, store_path: str, resolution: int = 224,
                 mode: str = "eval", aug_size: int = 256):
        if mode not in ("eval", "aug"):
            raise ValueError(f"decode mode {mode!r}: eval or aug")
        self.store = open_frame_store(store_path)
        self.resolution = resolution
        self.mode = mode
        self.aug_size = aug_size
        self.out_size = resolution if mode == "eval" else aug_size

    def stored_frames(self, video_id: str) -> int:
        return self.store.num_frames(video_id)

    def blobs(self, video_id: str, indices: Sequence[int]) -> Blobs:
        """The compressed frames at ``indices``, copied out of the map."""
        return [bytes(b) for b in self.store.get_frames(
            video_id, [int(i) for i in indices])]

    def load(self, video_id: str, indices: Sequence[int]) -> np.ndarray:
        """Decoded on the CPU: uint8 [n, out_size, out_size, 3]."""
        return decode_frames(self.blobs(video_id, indices), self.out_size,
                             "cpu", self.mode).numpy()


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


class VatexDataset(SeededFrameSampling):
    """VATEX, multi-sentence (dataloader_vatex_retrieval.py): every caption
    (``enCap``) of every listed video is a sample; ``cut_off_points`` mark
    each video's last sentence index + 1, and the eval groups sentences per
    video. ``list_path`` overrides the split list's location."""

    multi_sentence_per_video = True
    LISTS = {"pretrain": "train_list.txt", "train": "train_list.txt",
             "val": "val_list.txt", "test": "test_list.txt"}

    def __init__(self, source: FrameSource, data_path: str, subset: str,
                 tokenizer, language: str = "english", max_words: int = 32,
                 max_frames: int = 12, frame_sample: str = "uniform",
                 list_path: Optional[str] = None):
        if language != "english":
            raise NotImplementedError(
                "VATEX's Chinese captions need the Chinese tower, not "
                "ported yet (ROADMAP.md Queue A 8, 'Chinese branch')")
        with open(list_path or os.path.join(data_path, self.LISTS[subset]),
                  "r", encoding="utf-8") as f:
            video_ids = [line.strip() for line in f if line.strip()]
        with open(os.path.join(data_path, "vatex_data.json"), "r",
                  encoding="utf-8") as f:
            captions = json.load(f)
        self.samples: List[Tuple[str, str]] = []
        self.cut_off_points: List[int] = []
        for vid in video_ids:
            for cap in captions[vid]["enCap"]:
                self.samples.append((vid, cap))
            self.cut_off_points.append(len(self.samples))
        self.video_num = len(video_ids)
        self.sentence_num = len(self.samples)
        self.video_ids = video_ids
        self.source = source
        self.tokenizer = tokenizer
        self.language = language
        self.max_words = max_words
        self.max_frames = max_frames
        self.frame_sample = frame_sample

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
