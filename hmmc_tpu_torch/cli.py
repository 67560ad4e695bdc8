"""The port's command line (counterpart of ``hmmc_tpu/cli.py``).

    python -m hmmc_tpu_torch --do_train --do_eval --dataset msrvtt \\
        --language english --use_temp --use_frame_fea \\
        --data_dir D --output_dir O

:func:`get_args` has the JAX package's flag surface (itself the reference's,
main_task_retrieval.py:33-97), so launch commands carry over. What the port
does not run is still accepted where its default asks for nothing:
- the reference's DDP flags (--local_rank/--rank/--world_size/--n_gpu),
  --enable_amp and --cache_dir are ignored, as in the JAX package (the
  ranks come from torchrun's environment);
- --tp_size and --sp_size above 1 and --fused_ema raise with the flag's
  name and their ROADMAP.md item;
- so do the modes and options not ported yet, each naming its ROADMAP.md
  item: --eval_dual_softmax, --token_filter_keep, --use_randaugment and
  --task retrieval_VT, and a pretrain over another dataset than VATEX.
Data parallelism (``torchrun --nproc_per_node N -m hmmc_tpu_torch``):
--dp_size (0 or the world size), --dcn_dp_size (divides it), --multihost
(a multi-node torchrun) and --zero_opt (ZeRO-1), checked against the world
by ``parallel.distributed.init_distributed``. Train-state checkpoints:
--resume, --save_steps, --async_save, and --profile_dir (torch.profiler
over the first 10 steps).
--do_pretrain (VATEX, English), --do_extract (with --quantize_bank),
--do_params and --clip_model run as in the JAX package; any mode alone is
a run.
--use_pallas_attention maps "auto" and "on" to the CUDA attention kernels
(``use_fused_attention="on"``) and "off" to the plain attention.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import random
from typing import Optional

import numpy as np

from hmmc_tpu_torch.config import TaskConfig
from hmmc_tpu_torch.parallel import distributed

logger = logging.getLogger(__name__)


def get_args(description: str = "HMMC on Retrieval Task (PyTorch port)",
             argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--do_pretrain", action="store_true")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--do_params", action="store_true")
    p.add_argument("--do_extract", action="store_true")
    p.add_argument("--quantize_bank", type=str, default="none",
                   choices=["none", "int8"])
    p.add_argument("--use_frame_fea", action="store_true")
    p.add_argument("--task", type=str, default="retrieval",
                   choices=["retrieval_VT", "retrieval"])
    p.add_argument("--dataset", type=str, default="bird",
                   choices=["bird", "msrvtt", "vatex", "msvd", "lsmdc"])
    p.add_argument("--num_thread_reader", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--text_lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--batch_size_val", type=int, default=3500)
    p.add_argument("--lr_decay", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.2)
    p.add_argument("--n_display", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_words", type=int, default=32)
    p.add_argument("--max_frames", type=int, default=12)
    p.add_argument("--top_frames", type=int, default=3)
    p.add_argument("--frame_sample", type=str, default="uniform",
                   choices=["uniform", "random", "uniform_random"])
    p.add_argument("--frame_sample_len", type=str, default="fix",
                   choices=["dynamic", "fix"])
    p.add_argument("--language", type=str, default="chinese",
                   choices=["chinese", "english"])
    p.add_argument("--use_temp", action="store_true")
    p.add_argument("--logdir", default=None, type=str)
    p.add_argument("--output_dir", default=None, type=str, required=True)
    p.add_argument("--cross_model", default="cross-base", type=str)
    p.add_argument("--init_model", default=None, type=str)
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--cache_dir", default="", type=str)
    p.add_argument("--enable_amp", action="store_true",
                   help="accepted; --compute_dtype sets the precision")
    # accepted-and-ignored DDP flags
    p.add_argument("--n_gpu", type=int, default=1)
    p.add_argument("--world_size", default=0, type=int)
    p.add_argument("--local_rank", default=0, type=int)
    p.add_argument("--rank", default=0, type=int)
    p.add_argument("--coef_lr", type=float, default=1.0)
    p.add_argument("--contrast_num_negative", type=int, default=1024)
    p.add_argument("--contrast_momentum", type=float, default=0.99)
    p.add_argument("--contrast_temperature", type=float, default=0.07)
    p.add_argument("--data_dir", default=None, type=str,
                   help="root of frame stores + annotations")
    p.add_argument("--clip_model", default=None, type=str)
    p.add_argument("--pretrained_text", default="hfl/chinese-roberta-wwm-ext",
                   type=str)
    p.add_argument("--compute_dtype", default="bfloat16", type=str,
                   choices=["bfloat16", "float32"])
    p.add_argument("--dp_size", type=int, default=0)
    p.add_argument("--tp_size", type=int, default=1)
    p.add_argument("--sp_size", type=int, default=1)
    p.add_argument("--dcn_dp_size", type=int, default=1)
    p.add_argument("--use_pallas_attention", nargs="?", const="on",
                   default="auto", choices=["auto", "on", "off"],
                   help="the fused attention kernels: auto/on = the CUDA "
                        "kernels, off = the plain attention")
    p.add_argument("--optim_bf16_state", action="store_true")
    p.add_argument("--zero_opt", action="store_true")
    p.add_argument("--fused_ema", action="store_true")
    p.add_argument("--eval_dual_softmax", action="store_true")
    p.add_argument("--token_filter_keep", type=int, default=0)
    p.add_argument("--token_filter_layer", type=int, default=4)
    p.add_argument("--use_randaugment", action="store_true")
    p.add_argument("--randaugment_n", type=int, default=2)
    p.add_argument("--randaugment_m", type=int, default=10)
    p.add_argument("--use_frame_mask", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save_steps", type=int, default=0)
    p.add_argument("--async_save", action="store_true")
    p.add_argument("--profile_dir", default=None, type=str)
    p.add_argument("--multihost", action="store_true")
    return p.parse_args(argv)


# flag -> its default; any other value raises
# flag -> (its default, the ROADMAP.md item that ports it)
_NOT_PORTED = {"eval_dual_softmax": (False, "Queue A 9, retrieval_VT"),
               "token_filter_keep": (0, "Queue A 11, token filter"),
               "use_randaugment": (False, "Queue A 7, RandAugment"),
               "task": ("retrieval", "Queue A 9, retrieval_VT")}
# datasets the pretrain runs over
PRETRAIN_DATASETS = ("vatex",)


def to_task_config(args: argparse.Namespace) -> TaskConfig:
    distributed.check_parallel_flags(args)
    if args.fused_ema:
        raise ValueError("--fused_ema: a TPU program flag the port does not "
                         "run (ROADMAP.md Queue A 7, fused EMA)")
    for flag, (default, item) in _NOT_PORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)!r} is not ported yet "
                f"(ROADMAP.md {item})")
    if args.do_pretrain and (args.dataset not in PRETRAIN_DATASETS
                             or args.language != "english"):
        raise NotImplementedError(
            f"--do_pretrain --dataset {args.dataset} --language "
            f"{args.language}: the port pretrains in English over "
            f"{', '.join(PRETRAIN_DATASETS)} only (the bird pretrain and the "
            "Chinese MLM are ROADMAP.md Queue A 8)")
    if not (args.do_pretrain or args.do_train or args.do_eval
            or args.do_params or args.do_extract):
        raise ValueError("At least one of do_pretrain/do_train/do_eval/"
                         "do_params/do_extract must be set")
    fields = {f.name for f in dataclasses.fields(TaskConfig)}
    kv = {k: v for k, v in vars(args).items() if k in fields}
    kv["use_fused_attention"] = ("off" if args.use_pallas_attention == "off"
                                 else "on")
    task = TaskConfig(**kv)
    task.validate()
    return task


def setup_logging(output_dir: Optional[str]) -> logging.Logger:
    """util.get_logger parity (util.py:64-75): console + output_dir/log.txt
    on rank 0; the other ranks log warnings to the console only."""
    handlers = [logging.StreamHandler()]
    main = distributed.is_main()
    if output_dir and main:
        os.makedirs(output_dir, exist_ok=True)
        handlers.append(logging.FileHandler(
            os.path.join(output_dir, "log.txt")))
    logging.basicConfig(
        level=logging.INFO if main else logging.WARNING,
        format="%(asctime)s - %(levelname)s: %(message)s",
        handlers=handlers, force=True)
    return logging.getLogger("hmmc_tpu_torch")


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def make_tokenizer(task: TaskConfig):
    if task.language == "chinese":
        raise NotImplementedError(
            "--language chinese needs the BERT tower and WordPiece "
            "tokenizer, not ported yet (ROADMAP.md Queue A)")
    from hmmc_tpu_torch.tokenization import ClipTokenizer

    return ClipTokenizer()


class MetricsWriter:
    """Scalar logging to ``logdir/scalars.jsonl`` (the JAX package's JSONL
    fallback; no TensorBoard writer), by rank 0 only."""

    def __init__(self, logdir: Optional[str]):
        self._jsonl = None
        if logdir and distributed.is_main():
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": step}) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
