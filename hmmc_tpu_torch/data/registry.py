"""Dataset registry (counterpart of ``hmmc_tpu/data/registry.py``;
reference: DATALOADER_DICT, dataloaders/dataloader.py:172-177).

Factories take (task: TaskConfig, tokenizer) and return (BatchLoader,
dataset). Data roots are resolved from ``task.data_dir`` with the
reference's file layout:

    {data_dir}/
      frames.fpk                     — frame store (or msrvtt/frames.fpk)
      msrvtt/MSRVTT_JSFUSION_test.1k.csv
      msrvtt/MSRVTT_train.9k.csv
      msrvtt/MSRVTT_data.json
      vatex/{train,val,test}_list.txt, vatex/vatex_data.json

MSR-VTT and VATEX (English captions) are ported; the other datasets wait
in ROADMAP.md Queue A. VATEX's split lists fall back to the copies the
repository ships under ``tools/vatex_txt/`` (read as data files).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

from hmmc_tpu_torch.config import TaskConfig
from hmmc_tpu_torch.data.datasets import (FrameSource, MsrvttEvalDataset,
                                          MsrvttTrainDataset, VatexDataset)
from hmmc_tpu_torch.data.loader import BatchLoader
from hmmc_tpu_torch.parallel import distributed


def _store_path(task: TaskConfig, sub: str) -> str:
    base = task.data_dir or "."
    for cand in (os.path.join(base, sub, "frames.fpk"),
                 os.path.join(base, "frames.fpk"),
                 os.path.join(base, sub, "lmdb"),
                 os.path.join(base, "lmdb")):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"no frame store under {base!r} (looked for frames.fpk / lmdb)")


def _source(task: TaskConfig, sub: str, mode: str = "eval") -> FrameSource:
    """The frame source: ``eval`` mode for every split but the pretrain's
    (``aug``, at ``task.aug_size``)."""
    return FrameSource(_store_path(task, sub),
                       resolution=task.image_resolution or 224, mode=mode,
                       aug_size=task.aug_size)


def _loader(dataset, task: TaskConfig, train: bool) -> BatchLoader:
    # Train loaders shard each global batch across processes, by
    # micro-batch; eval loaders stay global on every process (the
    # Evaluator shards its blocks and gathers the features).
    pi, pc = ((distributed.rank(), distributed.world_size()) if train
              else (0, 1))
    # The eval batch only sets the host feed's granularity (the Evaluator
    # re-blocks on the device), so it is capped: the reference default
    # --batch_size_val 3500 would stack ~6 GB of frames.
    bs = task.batch_size if train else min(task.batch_size_val, 512)
    return BatchLoader(
        dataset, batch_size=bs, shuffle=train, drop_last=train,
        num_workers=max(1, task.num_thread_reader), seed=task.seed,
        process_index=pi, process_count=pc,
        n_accum=task.gradient_accumulation_steps if train else 1)


def msrvtt_train(task: TaskConfig, tokenizer):
    base = os.path.join(task.data_dir or ".", "msrvtt")
    ds = MsrvttTrainDataset(
        _source(task, "msrvtt"),
        csv_path=os.path.join(base, "MSRVTT_train.9k.csv"),
        json_path=os.path.join(base, "MSRVTT_data.json"),
        tokenizer=tokenizer, max_words=task.max_words,
        max_frames=task.max_frames, frame_sample=task.frame_sample,
        language=task.language)
    return _loader(ds, task, train=True), ds


def msrvtt_test(task: TaskConfig, tokenizer):
    base = os.path.join(task.data_dir or ".", "msrvtt")
    ds = MsrvttEvalDataset(
        _source(task, "msrvtt"),
        csv_path=os.path.join(base, "MSRVTT_JSFUSION_test.1k.csv"),
        tokenizer=tokenizer, max_words=task.max_words,
        max_frames=task.max_frames, frame_sample="uniform",
        language=task.language)
    return _loader(ds, task, train=False), ds


BUNDLED_VATEX_LISTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tools", "vatex_txt")


def vatex_split(subset: str, train: bool) -> Callable:
    """The factory of a VATEX split (``hmmc_tpu/data/registry.py:97-128``):
    the data dir's split list, else the bundled one; the pretrain split
    decodes in ``aug`` mode (256, centre square) for the device-side
    RandomResizedCrop, the others in ``eval`` mode."""
    def factory(task: TaskConfig, tokenizer):
        base = os.path.join(task.data_dir or ".", "vatex")
        list_file = VatexDataset.LISTS[subset]
        list_path = None
        if not os.path.isfile(os.path.join(base, list_file)):
            cand = os.path.join(BUNDLED_VATEX_LISTS, list_file)
            if os.path.isfile(cand):
                list_path = cand
        ds = VatexDataset(
            _source(task, "vatex", "aug" if subset == "pretrain" else "eval"),
            data_path=base, subset=subset, tokenizer=tokenizer,
            language=task.language, max_words=task.max_words,
            max_frames=task.max_frames,
            frame_sample=task.frame_sample if train else "uniform",
            list_path=list_path)
        return _loader(ds, task, train=train), ds

    return factory


def vatex_pretrain(task: TaskConfig, tokenizer):
    """Pretrain over VATEX: its captions serve as the titles (and as the
    tags, which the English VATEX pretrain does not read;
    dataloader_vatex_retrieval.py:248-249), taken so by
    ``runner.prepare_pretrain_batch``."""
    return vatex_split("pretrain", train=True)(task, tokenizer)


DATALOADER_DICT: Dict[str, Dict[str, Callable]] = {
    "msrvtt": {"train": msrvtt_train, "test": msrvtt_test},
    "vatex": {"pretrain": vatex_pretrain,
              "train": vatex_split("train", train=True),
              "val": vatex_split("val", train=False),
              "test": vatex_split("test", train=False)},
}


def get_factory(dataset: str, split: str) -> Callable:
    """The loader factory of ``dataset`` / ``split``; datasets not ported
    raise."""
    if dataset not in DATALOADER_DICT:
        raise NotImplementedError(
            f"dataset {dataset!r} is not ported yet: only "
            f"{sorted(DATALOADER_DICT)} (ROADMAP.md Queue A)")
    if split not in DATALOADER_DICT[dataset]:
        raise NotImplementedError(
            f"dataset {dataset!r} has no {split!r} split in the port (its "
            f"splits: {sorted(DATALOADER_DICT[dataset])}; ROADMAP.md Queue "
            "A)")
    return DATALOADER_DICT[dataset][split]
