#!/usr/bin/env python3
"""Drive the hmmc_tpu_torch port on one NVIDIA card and check it.

    python3 chip_smoke.py [--clips 1000] [--seed 0]

Phases (any failure raises, exits non-zero and prints no ``ok`` line):

1. device   the card's name and power limit (nvidia-smi), torch's name for it;
2. build    every kernel in hmmc_tpu_torch/csrc/ with nvcc for sm_90a, one
            nvcc per source, all started together (seconds, ptxas lines);
3. kernels  each kernel against its plain PyTorch version at the shapes its
            path gives it, in bf16 and fp32, with TF32 off: K1 (attention
            forward) at the eval path's shapes, K2 (attention backward) at
            the fine-tune path's (a 64-clip micro-batch); max abs difference
            within the stated tolerance, kernel / plain / library times from
            CUDA events, the bound from bytes and operations and the share
            of it achieved, the kernels' and the library call's device time
            from torch.profiler (no host gaps), the wrappers' host
            microseconds per call at the text site, two launches bitwise
            equal; K1 also at one served query's text site (batch 1);
            K1 and K2 at every head_dim they are built for (64, 80, 96,
            128): timed in bf16 at the temporal site [64, 8, 12, D] and
            at [48, 8, 577, D], and against their plain versions in bf16
            and fp32, causal and not, at L = 12, 50, 80, 81, 96, 97, 112,
            113, 128, 129, 197 and 577 (every body on both sides of each
            head_dim's limits), each bitwise over two launches;
   frames   R1 (the PIL-exact resize and crop) against its plain version,
            bitwise, at the path's 768-frame block (341x256 -> 224, planes
            laid out as the decoder leaves them; timed also with packed
            rows) and at 320x240, 256x341, 640x360, 1280x720, 224x224 and
            160x120, two launches bitwise equal, one launch over mixed
            sizes and padded slots, RGB-coded, CMYK and YCCK planes, RGB
            rows and planes at aligned and at odd bases and pitches; its
            kernel, plain and library times and bound. nvJPEG on the card
            against the committed fixture's PIL decodes (max and mean abs
            difference, routes; a row for each RGB-coded, CMYK and YCCK
            frame), R1 on PIL's pixels against PIL's crops (bitwise), a
            batch with padded and corrupt slots, and
            decode + R1 of one 768-frame block (ms, frames/s; D's bound:
            the bitstream read and the planes written once). R2 (cv2's
            INTER_AREA resize and crop) against its plain version, bitwise,
            on every cv2 path (copy at 341x256 and 256x341, integer factors,
            area at non-integer factors, up-scale), RGB and 4:2:0, the
            pretrain micro-batch's 768 frames at 341x256, two launches
            bitwise equal, one launch over the other samplings, grayscale,
            RGB-coded, CMYK and YCCK planes at odd sizes and padded slots,
            RGB rows and planes at aligned and at odd bases and pitches;
            its kernel, plain and library times and bound at three paths;
            nvJPEG + R2 against the fixture's cv2 crops (max and mean abs
            difference), decode + R2 of 768 frames. R1 at 336
            (ViT-L/14@336px's decode, up-scaling the store's frames): the
            same checks as at 224 on the towers eval's 384-frame block and
            16 frames elsewhere; nvJPEG + R1 at 336 against PIL's crops
            (R1's plain version on PIL's decode), max and mean abs
            difference. R1 at 288, 384 and 448 (the ResNets' decodes): the
            same checks on a 96-frame block and 8 frames elsewhere;
4. eval     the full-width ViT-B/32 BirdModel (12 frames at 224 px, 32
            query tokens, temporal transformer, top-3 frame similarity;
            seeded random weights, bf16 compute) evaluated over ``--clips``
            synthetic clips through Evaluator.cache_features -> similarity
            -> metrics.logging_rank (the body of Evaluator.run). Kernel
            launches are counted over that run and must equal the count the
            block structure predicts. The same eval with the attention
            switch off gives the similarity difference. torch.profiler
            splits the eval's device time by kernel and gives the device's
            idle share. A small input runs through the fp32 model on the
            card and on the CPU (plain attention) for a reference check.
5. train    the same model fine-tuned through runner.finetune: batch 256
            in 4 micro-batches of 64, one synthetic 256-clip batch taken for
            6 optimizer steps (t_total 6, the JAX package's default lr,
            text_lr, coef_lr, weight decay and warmup), then the runner's
            epoch-end eval of 256 clips. Per-step loss and grad norm, K1 and
            K2 launches over the steps (and the eval's K1 launches apart),
            each against the block structure's prediction; the device ms of
            one optimizer step (CUDA events), peak memory; a torch.profiler
            breakdown of one warm step; the same 6 steps with the attention
            switch off (no launches, losses within the stated tolerance);
            one fp32 step on 2 clips, kernels on the card against the plain
            attention on the CPU, every gradient compared.
   pretrain the full-width BirdPretrainModel (ViT-B/32, cross-base,
            vocab 49408, projector and predictor MLPs of inner width 4096,
            1024 negatives, momentum 0.99, temperature 0.07, bf16) on
            synthetic uint8 frames at 256 through simclr_augment: 6 steps of
            256 in 4 micro-batches; the four losses, device ms (CUDA
            events) and clips/s, peak memory, ptr after each step, the key
            towers' gap against the EMA's prediction, K1 / K2 launches
            against the prediction (272 / 160 a step); then one fp32
            micro-batch at ViT-B/32's widths and 2 layers a tower, kernels
            on the card against the plain attention on the CPU (losses and
            every gradient);
   cli      the port's CLI in process, runner.main(cli.get_args([...])), over
            a FramePack of 1000 videos x 30 frames cycled from the fixture:
            --do_train at full width, bf16, batch 256 in 4 micro-batches, 2
            steps, the epoch-end eval of 1000 clips and pytorch_model.bin.0;
            then --do_eval --init_model that file, which must give the same
            metrics. K1, K2, R1 and decoder launches against their
            predictions, no decode failure, finite losses that fall along
            the run's update (fp32), the reload eval profiled (wall, device
            busy and idle share, decode and R1 per block, H2D bytes), peak
            memory; the trained model's sims from the card decode against
            those from the fixture's PIL crops of the same frames (R@1 of
            both);
   serve    over cli's FramePack and pytorch_model.bin.0: a seeded
            full-width ViT-B/32 CLIP archive (fp16, TorchScript, as OpenAI
            ships it) through --do_params --clip_model (the arch from its
            shapes, every overlaid weight against the file); --do_extract
            over the 1000 clips, float and --quantize_bank int8 (wall,
            clips/s, device busy and idle share; the bank's metrics against
            cli's --do_eval); the RetrievalService answering 200 test
            captions with host ranking and with --device_rank (p50 / p99
            latency, K1 launches against the prediction, top-5 against
            similarity_from_bank, device top-1 agreement, where a query's
            time goes), one POST /search
            round trip; --device_rank over a synthetic 1,000,000-video bank
            against the same ranking in fp32 with torch.matmul;
   cli_pretrain  --do_pretrain --dataset vatex at full width over a VATEX
            layout beside cli's (256 videos x 30 frames cycled from the
            fixture's three-plane JPEGs, 2 captions each): 2 steps of 256,
            then the MSR-VTT eval of 1000 clips; R2, decoder, K1, K2 and R1
            launches against the prediction, decode routes, wall per step,
            the checkpoint's keys; pytorch_model.bin.0 loads as a
            fine-tune's --init_model;
   ddp      data parallelism and train-state checkpoints: (i) 2 fine-tune
            steps at full width (batch 256 in 4 micro-batches) in a world
            of 1 over NCCL through init_distributed, against the same steps
            without a process group and phase train's first two; the
            state's save (sync, async) and resume times; (ii) two ranks on
            the one card over gloo (this script again, --ddp_worker): 2
            fine-tune and 2 pretrain steps against world 1 (losses, grad
            norm, largest parameter difference, queues, ptr), both again in
            fp32 at 2 layers a tower to 1e-5, peak memory per rank; (iv) in
            the same group the sharded --do_eval of cli's 1000 clips
            against cli's reload metrics; (v) meanwhile in this process the
            CLI fine-tune cut by SIGTERM after step 1 (--save_steps 1) and
            --resume'd, against an uncut run and its rerun; (iii) two cards
            over NCCL where the machine has them, else a row saying so;
   towers   ViT-B/16, ViT-L/14 and ViT-L/14@336px (L = 197, 257, 577),
            through the tiled bodies of K1 and K2 (L > 128): each kernel
            against its plain version at each tower's ViT site (its
            micro-batch's frames x heads) in bf16 and fp32, bitwise over
            two launches, kernel / plain / SDPA times and the bound (these
            rows run right after phase 3's, where the profiler is fresh);
            one
            bf16 fine-tune step at full width of ViT-B/16 (16 clips a
            micro-batch) and of ViT-L/14 (4), launches per body against
            the block structure; the full-width ViT-L/14@336px BirdModel
            (12 frames at 336, 32 query tokens, the temporal transformer
            at 768 with cross-base's 8 heads: head_dim 96) through the
            CLI: a seeded OpenAI-named
            state dict as --clip_model, --do_train of 2 steps of 8 clips
            in micro-batches of 4 over a FramePack cycled from the fixture
            (40 K1 and 40 K2 launches a micro-batch: 24 tiled, 16 short;
            36 at head_dim 64, 4 at 96),
            the epoch-end eval of 32 clips, --do_eval --init_model the
            saved file (profiled, the same metrics), --do_extract of a
            768-wide bank that the retrieval service answers queries from;
            then the geometry at 2 layers a tower in fp32, card against
            CPU: the L/14@336px forward, and a ViT-L/14 fine-tune step
            under cross-base (losses and every gradient; K1 and K2 at
            head_dim 96);
   resnet   CLIP's ModifiedResNet towers, their BatchNorm with the JAX
            package's train-mode semantics: nvJPEG + R1 at 288, 384 and
            448 against PIL's crops of the fixture (R1 on PIL's pixels
            bitwise its plain version); the full-width RN50 BirdModel (12
            frames at 224, the temporal transformer at 1024 with
            cross-base's 8 heads: head_dim 128) through the CLI: a seeded
            OpenAI-named state dict as --clip_model (its running
            statistics loaded), --do_train of 2 steps of 8 clips in
            micro-batches of 4, the epoch-end eval of 32 clips, --do_eval
            --init_model the saved file (profiled, the same metrics),
            --do_extract of a 1024-wide bank and 8 served queries; one
            bf16 fine-tune step in 2 micro-batches and an eval forward at
            full width and resolution of RN101 (8 clips a micro-batch),
            RN50x4 (4), RN50x16 (2) and RN50x64 (2); every path's K1 and
            K2 launches by body and head_dim (64 in the text tower; 128,
            64, 80, 96, 128 at the temporal site) against the block
            structure, peak memory; one fp32 step of an RN50-width tower
            cut to (1, 1, 1, 1) blocks, card against CPU (loss 1e-4,
            gradients 1e-3 of their largest magnitude, running statistics
            1e-5);
6. result   the nvidia-smi line as it prints it, the kernel table as one
            JSON line (K1 and K2 with the head_dims checked and every
            launch of the run by phase and head_dim beside the
            prediction), then ``{"ok": true, "device": {...}}`` as the
            last.

Every line before those is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from hmmc_tpu_torch import cli, runner
from hmmc_tpu_torch.config import (ClipArch, CrossConfig, TaskConfig,
                                   load_cross_config)
from hmmc_tpu_torch.data import jpeg
from hmmc_tpu_torch.data.framepack import FramePackWriter
from hmmc_tpu_torch.data.loader import rank_rows
from hmmc_tpu_torch.data.registry import get_factory
from hmmc_tpu_torch.data.sampling import sample_frame_indices
from hmmc_tpu_torch.data.text import encode_text
from hmmc_tpu_torch.evaluation import Evaluator
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.losses import finetune_retrieval_loss
from hmmc_tpu_torch.metrics import logging_rank
from hmmc_tpu_torch.ops import fused_attention as fa
from hmmc_tpu_torch.models.resnet import ModifiedResNet
from hmmc_tpu_torch.models.pretrain import (MOMENTUM_SUBTREES, MoCoQueues,
                                            init_key_params,
                                            sample_mask_decisions)
from hmmc_tpu_torch.ops import image_ops, kernel_build, quant
from hmmc_tpu_torch.ops import resize_area as r2
from hmmc_tpu_torch.ops import resize_crop as rc
from hmmc_tpu_torch.ops.fused_attention import (
    HEAD_DIMS, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference,
    kernel_body, kernel_bwd_smem_bytes, kernel_smem_bytes,
    short_max_len_backward)
from hmmc_tpu_torch.parallel import distributed
from hmmc_tpu_torch.ops.resize_crop import (
    FORMATS, SAMPLING, YccFrame, crop_tables, launch, output_size,
    plane_batch, resize_crop, resize_crop_reference, ycc_to_rgb_reference)
from hmmc_tpu_torch.testing import aligned_and_odd_layouts
from hmmc_tpu_torch.tokenization import ClipTokenizer
from hmmc_tpu_torch.train.optimization import build_optimizer
from hmmc_tpu_torch.train import checkpoint as ckpt_io
from hmmc_tpu_torch.train.trainer import (FinetuneState, PretrainState,
                                          make_finetune_step,
                                          make_pretrain_step,
                                          split_microbatches)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# int32 multiply-adds per second: sm_90 runs 64 IMAD per clock per SM
# against 128 FFMA (CUDA C++ Programming Guide, arithmetic instruction
# throughput), so half the FFMA rate behind the fp32 peak above
IMAD_PER_S = PEAK_FLOPS[torch.float32] / 2 / 2
# dense int8 tensor-core operations per second (a multiply-add is two)
INT8_OPS_PER_S = 1979e12
TOLERANCE = {
    torch.float32: dict(atol=2e-5, rtol=1e-4, reason=(
        "same arithmetic, sums in another order: the JAX package's own "
        "kernel-vs-XLA tolerance")),
    torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7, reason=(
        "both round P to bf16 and the output once; allow one output ulp "
        "(2^-7 relative)")),
}
SIM_ON_OFF_ATOL = 1.0
SIM_ON_OFF_REASON = (
    "bf16 model, kernel vs plain attention round at other places in 16 "
    "layers; sims are 100 * cosine plus the top-3 frame term, and 1.0 is "
    "1% of the logit scale")
REFERENCE_ATOL = 1e-3
REFERENCE_REASON = ("fp32 with TF32 off on both sides: sums in another "
                    "order through 12 + 4 layers")
# K1's row statistics (log2-sum-exp of the scaled logits) against the
# plain version's
STATS_TOLERANCE = dict(atol=1e-4, rtol=1e-5, reason=(
    "fp32 statistics of the same bf16 inputs: the kernel sums the logits' "
    "exact products in another order and takes ex2 / lg2 approximations "
    "(about 2^-22 relative each); a wrong row is off by far more"))
BWD_TOLERANCE = {
    torch.float32: dict(atol=5e-5, rtol=1e-3, reason=(
        "same arithmetic, sums in another order: the JAX package's own "
        "fused-gradient tolerance (tests/test_pallas_attention.py)")),
    torch.bfloat16: dict(atol=1e-2, rtol=2.0 ** -7, reason=(
        "both compute in fp32 from the same bf16 inputs and round each "
        "output once; allow one output ulp (2^-7 relative)")),
}
TRAIN_STEPS = 6
TRAIN_LOSS_ON_OFF_ATOL = 0.1
TRAIN_LOSS_ON_OFF_REASON = (
    "bf16 towers; the kernels and the plain attention round at other places "
    "in 28 layers, and after step 0 Adam turns gradient differences near "
    "zero into lr-sized steps: 1% of a loss near 10")
GRAD_REFERENCE_LOSS_ATOL = 1e-3
GRAD_REFERENCE_REL = 1e-3
GRAD_REFERENCE_REASON = (
    "fp32 with TF32 off on both sides: sums in another order through the "
    "28 layers forward and back; each gradient's max abs difference "
    "relative to its own max abs value")

WORDS = ("a man woman child dog cat car bird people group is are playing "
         "running cooking singing talking driving dancing swimming on in at "
         "with the of and red blue green small large street kitchen stage "
         "beach field video clip shows two three person ball guitar food "
         "water road night day slowly quickly").split()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout
    return out.strip().splitlines()[0]


def jpeg_toolkit():
    """What the JPEG decoder can build on: nvJPEG's header and libraries
    in the CUDA toolkit beside nvcc, and whether libjpeg's header is
    installed (the decoder uses nvJPEG; libjpeg would be the host route)."""
    cuda = os.path.dirname(os.path.dirname(os.path.realpath(
        kernel_build.find_nvcc())))
    lib = os.path.join(cuda, "lib64")
    return dict(cuda_home=cuda,
                nvjpeg_h=os.path.isfile(os.path.join(cuda, "include",
                                                     "nvjpeg.h")),
                libnvjpeg=sorted(n for n in os.listdir(lib)
                                 if n.startswith("libnvjpeg.so"))
                if os.path.isdir(lib) else [],
                jpeglib_h=os.path.isfile("/usr/include/jpeglib.h"))


def ptxas_by_function(lines):
    """Group ``-Xptxas -v`` lines by compiled entry: registers, barriers,
    static shared memory and spills of each kernel instance."""
    out = []
    for ln in lines:
        if "Compiling entry function" in ln:
            out.append({"entry": ln.split("'")[1]})
        elif out and ("Used" in ln or "spill" in ln):
            out[-1].setdefault("info", []).append(
                ln.replace("ptxas info    : ", ""))
    return out


# the tiled bf16 kernel instances: K1's body and K2's two passes
TILED_KERNELS = {"fused_attention_fwd": ("attention_fwd_tiled_kernel",),
                 "fused_attention_bwd": ("attention_bwd_rows_kernel",
                                         "attention_bwd_keys_kernel")}


def tiled_kernel_resources(info):
    """Registers, spill bytes and shared memory of each tiled bf16 kernel
    instance by head_dim (K1's: with and without its statistics), from the
    build's ``-Xptxas -v`` lines (a library reused from an earlier build
    has none), beside the dynamic shared memory its launch asks for (K2's
    pair: the larger of its two)."""
    out = []
    for lib, names in TILED_KERNELS.items():
        for f in ptxas_by_function(info.get(lib, {}).get("ptxas", [])):
            name = next((n for n in names if n in f["entry"]), None)
            d = re.search(r"ILi(\d+)E", f["entry"])
            if name is None or d is None:
                continue
            text = " ".join(f.get("info", []))
            def num(pattern):
                m = re.search(pattern, text)
                return int(m.group(1)) if m else None
            d = int(d.group(1))
            smem = (fa.kernel_smem_bytes(TILED_LEN, torch.bfloat16, d)
                    if lib.endswith("fwd") else fa.kernel_bwd_smem_bytes(
                        TILED_LEN, torch.bfloat16, d))
            stats = re.search(r"ILi\d+ELb([01])E", f["entry"])
            out.append(dict(kernel=name, head_dim=d,
                            writes_statistics=(bool(int(stats.group(1)))
                                               if stats else None),
                            registers=num(r"Used (\d+) registers"),
                            spill_store_bytes=num(r"(\d+) bytes spill stores"),
                            spill_load_bytes=num(r"(\d+) bytes spill loads"),
                            static_smem_bytes=num(r"(\d+) bytes smem"),
                            dynamic_smem_bytes=smem))
    return out


TILED_LEN = 129     # a length every tiled body takes (its smem is fixed)


def cuda_ms(fn, iters: int, warmup: int = 3, windows: int = 1,
            per_window=None) -> float:
    """ms per call by CUDA events after ``warmup``: the time of ``windows``
    windows of ``iters`` calls each over the calls of all of them. Each
    window's own ms per call is appended to ``per_window`` where given."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        if per_window is not None:
            per_window.append(start.elapsed_time(end) / iters)
    return total / (windows * iters)


def kernel_device_ms(fn, iters: int = 10):
    """Device ms per call summed over the kernels a call launches
    (torch.profiler, after a warm call): the time of the work without the
    host gaps between launches that a host-bound call leaves in a CUDA-event
    timing. "not measured" where the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages()
             if e.device_type.name == "CUDA"
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / iters if us > 0 else "not measured"


def host_us_per_call(fn, calls: int = 200) -> float:
    """Host microseconds per call: the wall time of ``calls`` calls issued
    without synchronising (the device works behind them), after a warm
    call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host_us


# K1 and K2 launches by phase of this run and head_dim: the wrappers'
# head_dim_launches are folded in here at every reset of the counters and
# at each phase's end, so each launch lands in the phase it ran in (a ddp
# worker's, from its own process, under "ddp_ranks")
HEAD_DIM_LAUNCHES = {}
PHASE = ["setup"]
PHASE_T0 = [time.perf_counter()]


def add_head_dim_launches(phase, kernel, by_head_dim):
    tally = HEAD_DIM_LAUNCHES.setdefault(phase, {}).setdefault(
        kernel, dict.fromkeys(HEAD_DIMS, 0))
    for d, n in by_head_dim.items():
        tally[int(d)] += n


def reset_attention_counts():
    """K1's and K2's counters to 0, their launches by head_dim folded into
    HEAD_DIM_LAUNCHES first."""
    for kernel, fn in (("k1", fused_attention),
                       ("k2", fused_attention_backward)):
        add_head_dim_launches(PHASE[0], kernel, fn.head_dim_launches)
    fa.reset_launch_counts()


def start_phase(name):
    """Close the running phase's tally (and emit its wall seconds) and
    open ``name``'s."""
    reset_attention_counts()
    now = time.perf_counter()
    emit(dict(phase="phase_wall", ended=PHASE[0], seconds=now - PHASE_T0[0]))
    PHASE[0], PHASE_T0[0] = name, now


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def attention_bound(b, h, l, d, causal, dtype):
    """Least time for the work: q, k, v read once, o written once; the two
    products over the key positions each query needs."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * b * h * l * d * elt
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 4 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def kernel_ctas(bh, l, dtype, d, backward=False):
    """CTAs a launch runs: the short bodies take a (batch, head) per CTA
    (K1 in bf16: two), the tiled ones a 64-row tile of one (fp32: K1's
    and K2's rows pass 32 rows; K2's bf16 pair two 64-row tiles, one a
    consumer warpgroup); K2's tiled pair runs two grids of this size."""
    if kernel_body(l, dtype, d, backward) == "short":
        per = 1 if backward else fa.kernel_heads_per_cta(dtype)
        return math.ceil(bh / per)
    if dtype != torch.bfloat16:
        return bh * math.ceil(l / 32)
    return bh * math.ceil(l / (128 if backward else 64))


def check_attention(site, b, h, l, causal, dtype, gen, iters=50,
                    host_calls=200, d=64, profile=True):
    """The main path's layout: head views of a packed qkv projection.
    ``profile``: the kernel's and the library's device time by the
    profiler too (else "not measured")."""
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, l, 3, h, d).unbind(2))
    out = fused_attention(q, k, v, causal)
    again = fused_attention(q, k, v, causal)
    torch.cuda.synchronize()
    bitwise_repeat = bool(torch.equal(out, again))
    ref = fused_attention_reference(q, k, v, causal)
    diff = (out.float() - ref.float()).abs()
    tol = TOLERANCE[dtype]
    ok = bitwise_repeat and bool(
        (diff <= tol["atol"] + tol["rtol"] * ref.float().abs()).all())
    smem = kernel_smem_bytes(l, dtype, d)
    ms = cuda_ms(lambda: fused_attention(q, k, v, causal), iters)
    host_us = host_us_per_call(lambda: fused_attention(q, k, v, causal),
                               host_calls)
    plain_ms = cuda_ms(lambda: fused_attention_reference(q, k, v, causal), iters)
    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    library_ms = cuda_ms(library, iters)
    prof_iters = min(10, iters)
    kernel_only_ms = library_kernels_ms = "not measured"
    if profile:
        kernel_only_ms = kernel_device_ms(
            lambda: fused_attention(q, k, v, causal), prof_iters)
        library_kernels_ms = kernel_device_ms(library, prof_iters)
    bound_ms, bound_by, nbytes, flops = attention_bound(b, h, l, d, causal,
                                                        dtype)
    row = dict(phase="kernel", kernel="fused_attention_fwd", site=site,
               shape=[b, h, l, d], causal=causal, dtype=str(dtype),
               head_dim=d, body=kernel_body(l, dtype, d),
               max_abs_err=float(diff.max()), tolerance=tol,
               bitwise_repeat=bitwise_repeat, ok=ok,
               ms=ms, host_us_per_call=host_us, plain_ms=plain_ms,
               library_ms=library_ms, kernel_device_ms=kernel_only_ms,
               library_kernels_device_ms=library_kernels_ms,
               library="torch.nn.functional.scaled_dot_product_attention",
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, share_of_bound=bound_ms / ms,
               ctas=kernel_ctas(b * h, l, dtype, d),
               dynamic_smem_bytes_per_cta=smem)
    emit(row)
    if not ok:
        raise AssertionError(f"fused attention kernel disagrees with its "
                             f"plain version: {row}")
    return row


def attention_bwd_bound(b, h, l, d, causal, dtype):
    """Least time for K2's work: q, k, v, g read once, dq, dk, dv written
    once; the five products over the key positions each query needs."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 7 * b * h * l * d * elt
    pairs = l * (l + 1) // 2 if causal else l * l
    flops = 10 * b * h * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def k1_statistics(q, k, v, causal):
    """K1's output and row statistics, as the forward saves them for K2's
    bf16 tiled pair (an empty dict where K2 takes neither), and the
    statistics' max abs difference from the plain version's (None where
    there are none). Raises where they disagree."""
    b, h, l, d = q.shape
    if not fa.saves_statistics(l, q.dtype, d):
        return {}, None
    o, lse = fa.fused_attention_forward(q, k, v, causal, with_stats=True)
    _, ref = fused_attention_reference(q, k, v, causal, with_stats=True)
    err, ok = _within(lse, ref, STATS_TOLERANCE)
    if not ok:
        raise AssertionError(f"K1's statistics disagree with the plain "
                             f"version's at {tuple(q.shape)} causal={causal}: "
                             f"max abs {err}")
    return dict(o=o, lse=lse), err


def check_attention_backward(site, b, h, l, causal, dtype, gen, iters=30,
                             host_calls=200, d=64, profile=True):
    """K2 on the fine-tune path's layout: q, k, v head views of a packed
    qkv projection, the output gradient the transposed view of a
    [B, L, H, D] tensor (as the merge of heads hands it back). Where K2
    runs its bf16 tiled pair, K1's output and statistics come from one K1
    launch before, outside the timed region: K2 is timed alone, as SDPA's
    backward is after one forward (K1 with its statistics is timed beside,
    ``k1_stats_ms``)."""
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, l, 3, h, d).unbind(2))
    g = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
    g = g.transpose(1, 2)
    saved, stats_err = k1_statistics(q, k, v, causal)
    got = fused_attention_backward(q, k, v, g, causal, **saved)
    again = fused_attention_backward(q, k, v, g, causal, **saved)
    torch.cuda.synchronize()
    bitwise_repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    ref = fused_attention_backward_reference(q, k, v, g, causal)
    tol = BWD_TOLERANCE[dtype]
    errs, ok = [], bitwise_repeat
    for a, r in zip(got, ref):
        diff = (a.float() - r.float()).abs()
        errs.append(float(diff.max()))
        ok &= bool((diff <= tol["atol"] + tol["rtol"] * r.float().abs()).all())
    ms = cuda_ms(lambda: fused_attention_backward(q, k, v, g, causal,
                                                  **saved), iters)
    host_us = host_us_per_call(
        lambda: fused_attention_backward(q, k, v, g, causal, **saved),
        host_calls)
    k1_stats_ms = (cuda_ms(lambda: fa.fused_attention_forward(
        q, k, v, causal, with_stats=True), iters) if saved else None)
    plain_ms = cuda_ms(lambda: fused_attention_backward_reference(
        q, k, v, g, causal), iters)
    # the library yardstick: SDPA's backward alone, after one forward
    leaf = qkv.detach().requires_grad_(True)
    lq, lk, lv = (t.transpose(1, 2) for t in
                  leaf.view(b, l, 3, h, d).unbind(2))
    out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    def library():
        return torch.autograd.grad(out, (lq, lk, lv), g, retain_graph=True)

    library_ms = cuda_ms(library, iters)
    prof_iters = min(10, iters)
    kernel_only_ms = library_kernels_ms = "not measured"
    if profile:
        kernel_only_ms = kernel_device_ms(
            lambda: fused_attention_backward(q, k, v, g, causal, **saved),
            prof_iters)
        library_kernels_ms = kernel_device_ms(library, prof_iters)
    del out, leaf, library, saved
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound(b, h, l, d, causal,
                                                            dtype)
    row = dict(phase="kernel", kernel="fused_attention_bwd", site=site,
               shape=[b, h, l, d], causal=causal, dtype=str(dtype),
               head_dim=d, body=kernel_body(l, dtype, d, backward=True),
               max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
               tolerance=tol, bitwise_repeat=bitwise_repeat, ok=ok, ms=ms,
               k1_stats_max_abs_err=stats_err, k1_stats_ms=k1_stats_ms,
               host_us_per_call=host_us, plain_ms=plain_ms,
               library_ms=library_ms, kernel_device_ms=kernel_only_ms,
               library_kernels_device_ms=library_kernels_ms,
               library="scaled_dot_product_attention backward "
                       "(torch.autograd.grad after one forward)",
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, share_of_bound=bound_ms / ms,
               ctas=kernel_ctas(b * h, l, dtype, d, backward=True),
               dynamic_smem_bytes_per_cta=kernel_bwd_smem_bytes(l, dtype, d))
    emit(row)
    if not ok:
        raise AssertionError(f"fused attention backward kernel disagrees "
                             f"with its plain version: {row}")
    return row


# K1 and K2 at every head_dim they are built for: the sweep's lengths take
# each body on both sides of every head_dim's limits (K2's short body ends
# at 128, 112, 96 or 80 by dtype and head_dim; K1's at 128), the temporal
# site (12), the ViT-B/32 site (50) and the towers' lengths
HEAD_DIM_LENGTHS = (12, 50, 80, 81, 96, 97, 112, 113, 128, 129, 197, 577)
HEAD_DIM_SWEEP_BH = (3, 5)     # 15 heads: not a multiple of K1's 2 a CTA
# the timed head_dim rows' sites (bf16, B, H, L): the temporal
# transformer's at a 64-clip micro-batch (cross-base: 8 heads, 12 frames)
# and a 577-long one of 8 heads (the ViT-L/14@336px length)
HEAD_DIM_SITES = (("temporal", 64, 8, 12), ("long", 48, 8, 577))


def _within(got, ref, tol):
    diff = (got.float() - ref.float()).abs()
    bound = tol["atol"] + tol["rtol"] * ref.float().abs()
    return float(diff.max()), bool((diff <= bound).all())


def head_dim_sweep(gen):
    """K1 and K2 against their plain versions at every head_dim, dtype,
    causal and length of HEAD_DIM_LENGTHS, on head views of a packed
    [3, L, 3 x 5 x D] projection, each bitwise over two launches; a row a
    (head_dim, dtype, kernel) with the worst error and the bodies taken."""
    b, h = HEAD_DIM_SWEEP_BH
    rows, failed = [], []
    for d in HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            res = {"fused_attention_fwd": [], "fused_attention_bwd": []}
            for l in HEAD_DIM_LENGTHS:
                for causal in (False, True):
                    qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                                      generator=gen).to(dtype)
                    q, k, v = (t.transpose(1, 2) for t in
                               qkv.view(b, l, 3, h, d).unbind(2))
                    g = torch.randn(b, l, h, d, device="cuda",
                                    generator=gen).to(dtype).transpose(1, 2)
                    outs = [(fa.fused_attention_forward(q, k, v, causal),)
                            for _ in range(2)]
                    saved, stats_err = k1_statistics(q, k, v, causal)
                    if saved:   # the statistics leave K1's output as it is
                        outs[1] = (saved["o"],)
                    grads = [fused_attention_backward(q, k, v, g, causal,
                                                      **saved)
                             for _ in range(2)]
                    torch.cuda.synchronize()
                    for name, (one, two), ref, tol, bwd in (
                            ("fused_attention_fwd", outs,
                             (fused_attention_reference(q, k, v, causal),),
                             TOLERANCE[dtype], False),
                            ("fused_attention_bwd", grads,
                             fused_attention_backward_reference(
                                 q, k, v, g, causal),
                             BWD_TOLERANCE[dtype], True)):
                        errs = [_within(a, r, tol) for a, r in zip(one, ref)]
                        case = dict(
                            l=l, causal=causal,
                            body=kernel_body(l, dtype, d, bwd),
                            max_abs_err=max(e for e, _ in errs),
                            within=all(ok for _, ok in errs),
                            bitwise_repeat=all(bool(torch.equal(x, y))
                                               for x, y in zip(one, two)))
                        if not bwd and stats_err is not None:
                            case["k1_stats_max_abs_err"] = stats_err
                        res[name].append(case)
            for name, cases in res.items():
                bad = [c for c in cases
                       if not (c["within"] and c["bitwise_repeat"])]
                tol = (BWD_TOLERANCE if name.endswith("bwd")
                       else TOLERANCE)[dtype]
                row = dict(phase="kernel_head_dim_sweep", kernel=name,
                           head_dim=d, dtype=str(dtype), shape=[b, h, None, d],
                           lengths=list(HEAD_DIM_LENGTHS),
                           causal=[False, True],
                           cases=len(cases),
                           bodies=sorted({c["body"] for c in cases}),
                           max_abs_err=max(c["max_abs_err"] for c in cases),
                           tolerance=tol, bitwise_repeat=all(
                               c["bitwise_repeat"] for c in cases),
                           k1_stats_max_abs_err=max(
                               (c["k1_stats_max_abs_err"] for c in cases
                                if "k1_stats_max_abs_err" in c),
                               default=None),
                           ok=not bad, failed=bad)
                emit(row)
                rows.append(row)
                failed += bad
    if failed:
        raise AssertionError(f"head_dim sweep: {len(failed)} cases failed "
                             f"(rows above)")
    return rows


def head_dim_kernels(gen):
    """K1 and K2 timed at every head_dim at HEAD_DIM_SITES in bf16
    (kernel, plain and SDPA by CUDA events; the bound), within tolerance
    and bitwise over two launches. No profiler session: the run's later
    profiles read device times only while few sessions have been opened."""
    rows, bwd_rows = [], []
    for d in HEAD_DIMS:
        for site, b, h, l in HEAD_DIM_SITES:
            kw = dict(iters=20, host_calls=50, d=d, profile=False)
            rows.append(check_attention(f"{site} d{d}", b, h, l, False,
                                        torch.bfloat16, gen, **kw))
            bwd_rows.append(check_attention_backward(
                f"{site} d{d}", b, h, l, False, torch.bfloat16, gen, **kw))
    return rows, bwd_rows


def wrapper_host_cost(gen):
    """The wrappers' host cost at the text site, bf16 [512, 8, 32] causal:
    host microseconds per call (calls issued without synchronising) beside
    the device microseconds per call (CUDA events), for K1 through
    ``fused_attention`` and its wrapper, and for K2's wrapper."""
    b, h, l, d = 512, 8, 32, 64
    qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                      generator=gen).to(torch.bfloat16)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, l, 3, h, d).unbind(2))
    g = torch.randn(b, l, h, d, device="cuda",
                    generator=gen).to(torch.bfloat16).transpose(1, 2)
    calls = {"fused_attention": lambda: fused_attention(q, k, v, True),
             "fused_attention_forward":
                 lambda: fa.fused_attention_forward(q, k, v, True),
             "fused_attention_backward":
                 lambda: fused_attention_backward(q, k, v, g, True)}
    row = {name: dict(host_us_per_call=host_us_per_call(fn, 500),
                      device_us_per_call=cuda_ms(fn, 200) * 1e3)
           for name, fn in calls.items()}
    emit(dict(phase="kernel_host_cost", site="text", shape=[b, h, l, d],
              causal=True, dtype=str(torch.bfloat16), **row))


# ---------------------------------------------------------------------------
# phase frames: R1 and the nvJPEG decoder
# ---------------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "hmmc_tpu_torch", "assets", "frames_fixture.npz")
RES = 224
BLOCK_FRAMES = 64 * 12          # one 64-clip eval video block, 12 frames
STORE_SIZE = (341, 256)         # the MSR-VTT store's frames (256 short side)
R1_SIZES = (STORE_SIZE, (320, 240), (256, 341), (640, 360), (1280, 720),
            (224, 224), (160, 120))
DECODE_MAX_ABS = 8
DECODE_MEAN_ABS = 0.25
DECODE_REASON = (
    "chroma upsampling and colour conversion are libjpeg's own (R1), but "
    "nvJPEG's IDCT is not libjpeg's integer IDCT: a few pixels differ by a "
    "few levels (on the H100: at most 3, mean 0.04 at full resolution); "
    "the limits sit above that")


def load_fixture():
    """The committed frames: JPEG blobs, PIL's RGB decodes and the JAX
    package's eval crops at 224 (hmmc_tpu_torch/assets/)."""
    z = np.load(FIXTURE)
    n = len(z["sizes"])
    return dict(sizes=[tuple(int(v) for v in s) for s in z["sizes"]],
                blobs=[z[f"blob_{i}"].tobytes() for i in range(n)],
                rgb=[z[f"rgb_{i}"] for i in range(n)],
                crop=[z[f"crop_{i}"] for i in range(n)],
                aug=[z[f"aug_{i}"] for i in range(n)],
                sampling=[str(s) for s in z["sampling"]],
                color=[str(c) for c in z["color"]])


def resize_bound(n, w, h, res):
    """Least time for R1 on ``n`` frames of ``w`` x ``h`` 4:2:0 planes:
    the source bytes the crop needs read once (the luma rows and columns
    the taps reach, and the chroma samples under them with the one
    neighbour each side that the fancy upsampling reads) and each output
    byte written once, against the resize taps' multiply-adds (3 channels;
    the colour conversion's and the upsampling's few per pixel, which
    tables or shifts could replace, are not counted), two int8 operations
    each at :data:`INT8_OPS_PER_S`: the taps are exact integers, which the
    tensor cores take as byte limbs. Returns (ms, what bounds it, bytes,
    multiply-adds)."""
    t = crop_tables(w, h, res)
    xs, xe = t.staged_cols
    ys, ye = int(t.y_first[0]), int(t.y_first[-1] + t.y_count[-1])

    def chroma(lo, hi, n_luma):          # chroma samples luma [lo, hi) reads
        last = (n_luma + 1) // 2 - 1
        return min((hi - 1) // 2 + 1, last) - max(lo // 2 - 1, 0) + 1

    src = (ye - ys) * (xe - xs) + 2 * chroma(ys, ye, h) * chroma(xs, xe, w)
    nbytes = n * (src + res * res * 3)
    mads = 3 * n * ((ye - ys) * int(t.x_count.sum())
                    + res * int(t.y_count.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * mads / INT8_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, mads)


def unaligned_frames(gen, w, h):
    """One random frame's RGB and 4:2:0 planes at aligned and at odd bases
    and pitches (:func:`aligned_and_odd_layouts`)."""
    def u8(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                             generator=gen)

    return aligned_and_odd_layouts(u8(h, w, 3), u8(h, w),
                                   u8(-(-h // 2), -(-w // 2)),
                                   u8(-(-h // 2), -(-w // 2)))


def random_frames(gen, n, w, h, fmt, color="ycc", pitch_align=1):
    """``n`` random frames of one size on the card: RGB [H, W, 3] views of
    one tensor, or YccFrames of random planes (gray, or three planes at any
    sampling R1 takes holding ``color``: YCbCr, RGB as coded, or with a
    fourth plane CMYK or YCCK). Rows are padded to a multiple of
    ``pitch_align`` bytes: jpeg.PITCH_ALIGN lays planes out as the decoder
    does (16-byte aligned bases and pitches), 1 packs them (odd pitches at
    odd widths)."""
    def u8(n, rows, cols):
        pitch = -(-cols // pitch_align) * pitch_align
        return torch.randint(0, 256, (n, rows, pitch), dtype=torch.uint8,
                             device="cuda", generator=gen)[:, :, :cols]

    if fmt == "rgb":
        return list(u8(n, h, 3 * w).unflatten(2, (w, 3)).unbind(0))
    ys = u8(n, h, w)
    if fmt == "gray":
        return [YccFrame(y) for y in ys.unbind(0)]
    hf, vf = SAMPLING[FORMATS[fmt]]
    cw, ch = -(-w // hf), -(-h // vf)
    cb, cr = u8(n, ch, cw), u8(n, ch, cw)
    ks = u8(n, h, w).unbind(0) if color in ("cmyk", "ycck") else [None] * n
    return [YccFrame(*p, k, color) for p, k in zip(
        zip(ys.unbind(0), cb.unbind(0), cr.unbind(0)), ks)]


def r1_plain(frames, res=RES):
    """R1's plain version over frames of one size."""
    rgb = torch.stack([ycc_to_rgb_reference(f) if isinstance(f, YccFrame)
                       else f for f in frames])
    return resize_crop_reference(rgb, res)


def check_resize_crop(gen, res=RES, block=BLOCK_FRAMES, others=96):
    """R1 at ``res`` against its plain version at every size of the sweep
    (the path's ``block`` frames of 4:2:0 planes at 341x256, ``others``
    frames elsewhere, RGB and 4:2:0), bitwise, and two launches bitwise
    equal; one launch over mixed sizes, every other sampling (at an odd
    161x121), grayscale and padded slots; at the path's size the kernel,
    plain and library times and the bound."""
    rows, timed = [], None
    mixed, mixed_ref = [], []
    for w, h in R1_SIZES:
        for fmt in ("ycc420", "rgb"):
            path = (w, h) == STORE_SIZE and fmt == "ycc420"
            n = block if path else others
            # planes as the decoder lays them out, RGB rows packed
            frames = random_frames(gen, n, w, h, fmt, pitch_align=(
                jpeg.PITCH_ALIGN if fmt != "rgb" else 1))
            out = resize_crop(frames, res)
            again = resize_crop(frames, res)
            ref = r1_plain(frames, res)
            torch.cuda.synchronize()
            row = dict(phase="frames", check="resize_crop", size=[w, h],
                       format=fmt, frames=n, res=res,
                       bitwise_equal=bool(torch.equal(out, ref)),
                       bitwise_repeat=bool(torch.equal(out, again)),
                       max_abs_err=float((out.int() - ref.int()).abs().max()))
            mixed += [frames[0], None]
            mixed_ref += [ref[0], torch.zeros_like(ref[0])]
            if path:
                nw, nh = output_size(w, h, res)
                left, top = (nw - res) // 2, (nh - res) // 2
                xf = torch.stack([ycc_to_rgb_reference(f) for f in frames]
                                 ).permute(0, 3, 1, 2).float()

                def library():
                    return F.interpolate(
                        xf, size=(nh, nw), mode="bicubic", antialias=True,
                        align_corners=False)[:, :, top:top + res,
                                             left:left + res]

                batch = plane_batch(frames)
                dev = torch.device("cuda", torch.cuda.current_device())
                bound_ms, bound_by, nbytes, ops = resize_bound(n, w, h, res)
                ms = cuda_ms(lambda: resize_crop(frames, res), 20)
                launch_w, library_w = [], []
                row.update(
                    ms=ms, launch_ms=cuda_ms(lambda: launch(batch, res, dev),
                                             20, windows=3,
                                             per_window=launch_w),
                    launch_ms_windows=launch_w,
                    launch_host_us=host_us_per_call(
                        lambda: launch(batch, res, dev), 20),
                    kernel_device_ms=kernel_device_ms(
                        lambda: launch(batch, res, dev)),
                    plain_ms=cuda_ms(lambda: r1_plain(frames, res), 3,
                                     warmup=1),
                    library_ms=cuda_ms(library, 10, windows=3,
                                       per_window=library_w),
                    library_ms_windows=library_w,
                    library="F.interpolate(bicubic, antialias=True) on the "
                            "float RGB frames, then the crop",
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                    int_multiply_adds=ops, launch=dict(
                        resize_crop.last_launch))
                row["share_of_bound"] = bound_ms / (
                    row["kernel_device_ms"]
                    if isinstance(row["kernel_device_ms"], float) else ms)
                # the same frames with packed rows (odd pitches: stage 0's
                # skewed staging and per-pixel conversion)
                packed = [YccFrame(*(p.contiguous() for p in (f.y, f.cb,
                                                             f.cr)))
                          for f in frames]
                pbatch = plane_batch(packed)
                row["kernel_device_ms_packed_rows"] = kernel_device_ms(
                    lambda: launch(pbatch, res, dev))
                row["packed_rows_bitwise_equal"] = bool(torch.equal(
                    resize_crop(packed, res), ref))
                del xf, packed, pbatch
                timed = row
            emit(row)
            rows.append(row)
            del frames, out, again, ref
    for fmt in ("ycc444", "ycc422", "ycc440", "ycc411", "ycc410", "gray"):
        frames = random_frames(gen, 2, 161, 121, fmt)
        mixed += frames
        mixed_ref += list(r1_plain(frames, res).unbind(0))
    for color in ("rgb", "cmyk", "ycck"):      # planes that are not YCbCr
        for fmt in ("ycc444", "ycc420"):
            frames = random_frames(gen, 2, 161, 121, fmt, color)
            mixed += frames
            mixed_ref += list(r1_plain(frames, res).unbind(0))
    for w, h in (STORE_SIZE, (161, 121)):     # any base and pitch
        for f in unaligned_frames(gen, w, h):
            mixed.append(f)
            mixed_ref.append(r1_plain([f], res)[0])
    out = resize_crop(mixed, res)
    torch.cuda.synchronize()
    ok_mixed = bool(torch.equal(out, torch.stack(mixed_ref)))
    emit(dict(phase="frames", check="resize_crop mixed sizes, formats, "
              "padded slots, aligned and unaligned bases and pitches in one "
              "launch", frames=len(mixed), res=res, bitwise_equal=ok_mixed,
              **resize_crop.last_launch))
    bad = [r for r in rows if not (r["bitwise_equal"] and r["bitwise_repeat"]
                                   and r.get("packed_rows_bitwise_equal",
                                             True))]
    if bad or not ok_mixed:
        raise AssertionError(f"resize_crop disagrees with its plain version: "
                             f"{bad}, mixed {ok_mixed}")
    return timed


def check_decoder(smi):
    """nvJPEG on the card against the fixture's PIL decodes: libjpeg's RGB
    from the decoded planes (R1's plain stage 0) against PIL's, and the
    eval crops against the JAX package's; R1 on the decoded planes against
    its plain version and R1 on PIL's pixels against PIL's crops (both
    bitwise); a batch with padded and corrupt slots; decode + R1 of one
    768-frame block."""
    fx = load_fixture()
    dev = torch.device("cuda", torch.cuda.current_device())
    dec = jpeg._decoder(dev)
    jpeg.reset_counters()
    batch, buf = dec.decode_planes(fx["blobs"])
    frames = jpeg.frame_views(batch, buf)
    crops = jpeg.decode_frames(fx["blobs"], RES, dev)
    plain = torch.cat([resize_crop_reference(ycc_to_rgb_reference(f)[None],
                                             RES) if f is not None
                       else torch.zeros((1, RES, RES, 3), dtype=torch.uint8,
                                        device=dev) for f in frames])
    pil_r1 = resize_crop([torch.from_numpy(a).to(dev) for a in fx["rgb"]],
                         RES)
    torch.cuda.synchronize()
    routes = dict(jpeg.decode_frames.routes)
    formats = dict(jpeg.decode_frames.formats)
    colors = dict(jpeg.decode_frames.colors)
    formats_ok = ([f.fmt for f in frames] == [FORMATS[f"ycc{s}"]
                                              for s in fx["sampling"]]
                  and [getattr(f, "color", None) for f in frames]
                  == fx["color"])
    # a frame nvJPEG failed on is a padded slot: 255 levels off everywhere
    full = [(ycc_to_rgb_reference(f).int().cpu()
             - torch.from_numpy(a).int()).abs() if f is not None
            else torch.full(a.shape, 255, dtype=torch.int32)
            for f, a in zip(frames, fx["rgb"])]
    crop = (crops.int().cpu() - torch.from_numpy(np.stack(fx["crop"])).int()
            ).abs()
    # the frames whose planes are not YCbCr (RGB-coded, CMYK, YCCK), each
    # against PIL within the fixture's tolerance, and the routes of a
    # batch of four YCbCr frames and that one
    for i, color in enumerate(fx["color"]):
        if color == "ycc":
            continue
        jpeg.reset_counters()
        dec.decode_planes(fx["blobs"][:4] + [fx["blobs"][i]])
        emit(dict(phase="frames", check=f"nvjpeg decoder, {color} JPEG",
                  routes_in_a_batch_of_ycc=dict(jpeg.decode_frames.routes),
                  size=list(fx["sizes"][i]), sampling=fx["sampling"][i],
                  color_as_coded=getattr(frames[i], "color", None),
                  full_res_max_abs_diff=float(full[i].max()),
                  full_res_mean_abs_diff=float(full[i].float().mean()),
                  crop_max_abs_diff=float(crop[i].max()),
                  crop_mean_abs_diff=float(crop[i].float().mean()),
                  max_abs_tolerance=DECODE_MAX_ABS,
                  mean_abs_tolerance=DECODE_MEAN_ABS,
                  ok=bool(float(full[i].max()) <= DECODE_MAX_ABS
                          and float(full[i].float().mean())
                          <= DECODE_MEAN_ABS), card=smi))
    r1_equal = bool(torch.equal(pil_r1.cpu(),
                                torch.from_numpy(np.stack(fx["crop"]))))
    r1_planes_equal = bool(torch.equal(crops, plain))
    # a batch with padded slots and a corrupt blob: zeros there, the rest
    # as in the dense decode
    blobs = [fx["blobs"][0], None, fx["blobs"][1], b"not a jpeg", None]
    fails_before = jpeg.decode_frames.decode_failures
    padded = jpeg.decode_frames(blobs, RES, dev)
    torch.cuda.synchronize()
    padded_ok = (bool(torch.equal(padded[0], crops[0]))
                 and bool(torch.equal(padded[2], crops[1]))
                 and int(padded[[1, 3, 4]].abs().sum()) == 0
                 and jpeg.decode_frames.decode_failures == fails_before + 1)
    # one eval block: 768 frames cycled from the fixture's 341x256 frames
    store = [b for b, s in zip(fx["blobs"], fx["sizes"]) if s == STORE_SIZE]
    block = [store[i % len(store)] for i in range(BLOCK_FRAMES)]

    def host_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3

    jpeg.reset_counters()
    block_ms = host_ms(lambda: jpeg.decode_frames(block, RES, dev))
    decode_ms = host_ms(lambda: dec.decode_planes(block))
    block_batch, block_buf = dec.decode_planes(block)
    r1_ms = cuda_ms(lambda: launch(block_batch, RES, dev), 10)
    row = dict(phase="frames", check="nvjpeg decoder",
               hardware_backend=dec.hardware, routes_fixture=routes,
               formats_fixture=formats, colors_fixture=colors,
               fixture_sampling=fx["sampling"], fixture_color=fx["color"],
               formats_as_encoded=formats_ok,
               routes_block_runs=dict(jpeg.decode_frames.routes),
               full_res_max_abs_diff=max(float(d.max()) for d in full),
               full_res_mean_abs_diff=float(
                   sum(float(d.float().sum()) for d in full)
                   / sum(d.numel() for d in full)),
               full_res_per_frame_max=[float(d.max()) for d in full],
               full_res_per_frame_mean=[float(d.float().mean())
                                        for d in full],
               crop_max_abs_diff=float(crop.max()),
               crop_mean_abs_diff=float(crop.float().mean()),
               max_abs_tolerance=DECODE_MAX_ABS,
               mean_abs_tolerance=DECODE_MEAN_ABS, reason=DECODE_REASON,
               r1_on_decoded_planes_bitwise_equal_plain=r1_planes_equal,
               r1_on_pil_pixels_bitwise_equal_pil=r1_equal,
               padded_and_corrupt_slots_ok=padded_ok,
               block_frames=BLOCK_FRAMES, block_decode_r1_ms=block_ms,
               block_frames_per_s=BLOCK_FRAMES / block_ms * 1e3,
               block_decode_ms=decode_ms, block_r1_ms=r1_ms,
               block_compressed_bytes=sum(len(b) for b in block),
               block_decoded_bytes=BLOCK_FRAMES * RES * RES * 3, card=smi)
    # D's bound: the bitstream read once and the planes written once
    planes = sum(int(block_batch.h[i]) * int(block_batch.w[i])
                 + 2 * -(-int(block_batch.h[i]) // 2)
                 * -(-int(block_batch.w[i]) // 2)
                 for i in range(BLOCK_FRAMES))
    row.update(decode_bound_bytes=row["block_compressed_bytes"] + planes,
               decode_bound_ms=(row["block_compressed_bytes"] + planes)
               / HBM_BYTES_PER_S * 1e3, decode_bound_by="bytes")
    emit(row)
    if not (r1_equal and r1_planes_equal and padded_ok and formats_ok
            and row["full_res_max_abs_diff"] <= DECODE_MAX_ABS
            and row["full_res_mean_abs_diff"] <= DECODE_MEAN_ABS
            and row["crop_mean_abs_diff"] <= DECODE_MEAN_ABS):
        raise AssertionError(f"nvJPEG decode disagrees with PIL: {row}")
    return row


# ---------------------------------------------------------------------------
# phase frames (R1 at 336): ViT-L/14@336px's eval decode
# ---------------------------------------------------------------------------

TOWER_RES = 336                 # ViT-L/14@336px's input
TOWER_EVAL_CLIPS = 32           # the towers CLI run's eval clips
TOWER_BLOCK_FRAMES = TOWER_EVAL_CLIPS * 12   # its one decode of the eval


def check_decoder_at(smi, res=TOWER_RES, phase="frames"):
    """The fixture through nvJPEG + R1 at ``res`` (336: ViT-L/14@336px's
    decode; 288, 384, 448: RN50x4's, RN50x16's, RN50x64's; each up-scales
    the store's frames) against PIL's crops: R1's plain version on PIL's
    decode, which is PIL's bicubic resize and crop bit for bit (the CPU
    tests hold it so at each), with the kernel on PIL's pixels bitwise
    that; max and mean abs difference."""
    fx = load_fixture()
    dev = torch.device("cuda", torch.cuda.current_device())
    pil = torch.cat([resize_crop_reference(torch.from_numpy(a)[None].to(dev),
                                           res) for a in fx["rgb"]])
    pil_r1 = resize_crop([torch.from_numpy(a).to(dev) for a in fx["rgb"]],
                         res)
    card = jpeg.decode_frames(fx["blobs"], res, dev)
    torch.cuda.synchronize()
    diff = (card.int() - pil.int()).abs()
    row = dict(phase=phase, check=f"nvjpeg + resize_crop at {res} against "
               "PIL's crops (R1's plain version on PIL's decode)",
               frames=len(fx["blobs"]), res=res,
               r1_on_pil_pixels_bitwise_equal_plain=bool(
                   torch.equal(pil_r1, pil)),
               crop_max_abs_diff=float(diff.max()),
               crop_mean_abs_diff=float(diff.float().mean()),
               per_frame_max=[float(d.max()) for d in diff],
               max_abs_tolerance=DECODE_MAX_ABS,
               mean_abs_tolerance=DECODE_MEAN_ABS, reason=DECODE_REASON,
               card=smi)
    emit(row)
    if (not row["r1_on_pil_pixels_bitwise_equal_plain"]
            or row["crop_max_abs_diff"] > DECODE_MAX_ABS
            or row["crop_mean_abs_diff"] > DECODE_MEAN_ABS):
        raise AssertionError(f"nvJPEG + R1 at {res} disagrees with PIL: "
                             f"{row}")


# ---------------------------------------------------------------------------
# phase frames (R2): the aug decode's INTER_AREA resize and crop
# ---------------------------------------------------------------------------

AUG = 256                       # the pretrain's decode size (224 * 8 // 7)
PRETRAIN_BLOCK = 64 * 12        # one pretrain micro-batch's frames
R2_SIZES = (STORE_SIZE, (256, 341), (512, 512), (768, 768), (640, 360),
            (1280, 720), (160, 120), (320, 240))
# odd sizes for the other samplings and colours: up-scale, area at a
# non-integer factor, area at integer factors (2 x 2)
R2_ODD_SIZES = ((161, 121), (515, 387), (514, 512))


def area_bound(n, w, h):
    """Least time for R2 on ``n`` frames of ``w`` x ``h`` 4:2:0 planes: the
    source window's planes read once (as :func:`resize_bound` counts them)
    and the crop written once, against the resize's multiply-adds (3
    channels) at the integer rate, or as two fp32 operations each on the
    area path (no FMA). Returns (ms, what bounds it, bytes, ops)."""
    t = r2.area_tables(w, h, AUG)
    xs, xe = t.cols
    ys, ye = t.rows(0, AUG)

    def chroma(lo, hi, n_luma):
        last = (n_luma + 1) // 2 - 1
        return min((hi - 1) // 2 + 1, last) - max(lo // 2 - 1, 0) + 1

    src = (ye - ys) * (xe - xs) + 2 * chroma(ys, ye, h) * chroma(xs, xe, w)
    nbytes = n * (src + AUG * AUG * 3)
    mads = 3 * n * ((ye - ys) * int(t.x_count.sum())
                    + AUG * int(t.y_count.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * mads / PEAK_FLOPS[torch.float32] if t.mode == "area"
             else mads / IMAD_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, mads)


def r2_plain(frames):
    """R2's plain version over frames of one size."""
    rgb = torch.stack([ycc_to_rgb_reference(f, cmyk="cv2")
                       if isinstance(f, YccFrame) else f for f in frames])
    return r2.resize_area_reference(rgb, AUG)


def check_resize_area(gen):
    """R2 against its plain version, bitwise: every path of cv2's
    INTER_AREA (copy at the store's 341x256 and 256x341, integer factors,
    area at non-integer factors, up-scale) as 4:2:0 planes and as RGB, the
    path's 768-frame block at 341x256; two launches bitwise equal; one
    launch over the other samplings, grayscale, RGB-coded, CMYK and YCCK
    planes at odd sizes of each path, and padded slots. At the path's size,
    and at 640x360 (area) and 160x120 (up-scale), the kernel, plain and
    library times and the bound."""
    rows, timed = [], {}
    mixed, mixed_ref = [], []
    for w, h in R2_SIZES:
        for fmt in ("ycc420", "rgb"):
            path = (w, h) == STORE_SIZE and fmt == "ycc420"
            n = PRETRAIN_BLOCK if path else 48
            frames = random_frames(gen, n, w, h, fmt, pitch_align=(
                jpeg.PITCH_ALIGN if fmt != "rgb" else 1))
            out = r2.resize_area(frames, AUG)
            again = r2.resize_area(frames, AUG)
            ref = r2_plain(frames)
            torch.cuda.synchronize()
            row = dict(phase="frames", check="resize_area", size=[w, h],
                       format=fmt, frames=n,
                       mode=r2.area_tables(w, h, AUG).mode,
                       bitwise_equal=bool(torch.equal(out, ref)),
                       bitwise_repeat=bool(torch.equal(out, again)),
                       max_abs_err=float((out.int() - ref.int()).abs().max()))
            mixed += [frames[0], None]
            mixed_ref += [ref[0], torch.zeros_like(ref[0])]
            if fmt == "ycc420" and (w, h) in (STORE_SIZE, (640, 360),
                                              (160, 120)):
                nw, nh = r2.output_size(w, h, AUG)
                left, top = (nw - AUG) // 2, (nh - AUG) // 2
                xf = torch.stack([ycc_to_rgb_reference(f, cmyk="cv2")
                                  for f in frames]).permute(0, 3, 1, 2).float()

                def library():
                    return F.interpolate(
                        xf, size=(nh, nw), mode="area")[
                            :, :, top:top + AUG, left:left + AUG]

                batch = plane_batch(frames)
                dev = torch.device("cuda", torch.cuda.current_device())
                bound_ms, bound_by, nbytes, ops = area_bound(n, w, h)
                ms = cuda_ms(lambda: r2.resize_area(frames, AUG), 20)
                launch_w, library_w = [], []
                row.update(
                    ms=ms, launch_ms=cuda_ms(
                        lambda: r2.launch(batch, AUG, dev), 20, windows=3,
                        per_window=launch_w),
                    launch_ms_windows=launch_w,
                    launch_host_us=host_us_per_call(
                        lambda: r2.launch(batch, AUG, dev), 20),
                    kernel_device_ms=kernel_device_ms(
                        lambda: r2.launch(batch, AUG, dev)),
                    plain_ms=cuda_ms(lambda: r2_plain(frames), 3, warmup=1),
                    library_ms=cuda_ms(library, 10, windows=3,
                                       per_window=library_w),
                    library_ms_windows=library_w,
                    library="F.interpolate(mode='area') on the float RGB "
                            "frames, then the crop (adaptive average "
                            "pooling: cv2's area cells only at integer "
                            "factors)",
                    bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                    multiply_adds=ops, launch=dict(
                        r2.resize_area.last_launch))
                kms = row["kernel_device_ms"]
                row["share_of_bound"] = bound_ms / (
                    kms if isinstance(kms, float) else ms)
                packed = [YccFrame(*(p.contiguous() for p in (f.y, f.cb,
                                                             f.cr)))
                          for f in frames]
                pbatch = plane_batch(packed)
                row["kernel_device_ms_packed_rows"] = kernel_device_ms(
                    lambda: r2.launch(pbatch, AUG, dev))
                row["packed_rows_bitwise_equal"] = bool(torch.equal(
                    r2.resize_area(packed, AUG), ref))
                del xf, packed, pbatch
                timed[row["mode"] if not path else "path"] = row
            emit(row)
            rows.append(row)
            del frames, out, again, ref
    for w, h in R2_ODD_SIZES:
        for fmt in ("ycc444", "ycc422", "ycc440", "ycc411", "ycc410",
                    "gray"):
            frames = random_frames(gen, 1, w, h, fmt)
            mixed += frames
            mixed_ref += list(r2_plain(frames).unbind(0))
        for color in ("rgb", "cmyk", "ycck"):
            for fmt in ("ycc444", "ycc420"):
                frames = random_frames(gen, 1, w, h, fmt, color)
                mixed += frames
                mixed_ref += list(r2_plain(frames).unbind(0))
    # any base and pitch, on the copy path (one with odd crop offsets), the
    # area path and the up-scale
    for w, h in (STORE_SIZE, (343, 259), (515, 387), (161, 121)):
        for f in unaligned_frames(gen, w, h):
            mixed.append(f)
            mixed_ref.append(r2_plain([f])[0])
    out = r2.resize_area(mixed, AUG)
    torch.cuda.synchronize()
    ok_mixed = bool(torch.equal(out, torch.stack(mixed_ref)))
    emit(dict(phase="frames", check="resize_area mixed sizes, paths, "
              "formats, colours, padded slots, aligned and unaligned bases "
              "and pitches in one launch", frames=len(mixed),
              bitwise_equal=ok_mixed, **r2.resize_area.last_launch))
    bad = [r for r in rows if not (r["bitwise_equal"] and r["bitwise_repeat"]
                                   and r.get("packed_rows_bitwise_equal",
                                             True))]
    if bad or not ok_mixed:
        raise AssertionError(f"resize_area disagrees with its plain version: "
                             f"{bad}, mixed {ok_mixed}")
    return timed


def check_aug_decoder(smi):
    """nvJPEG + R2 on the card against the fixture's cv2 aug crops (every
    frame: YCbCr at five samplings, RGB-coded, CMYK, YCCK, and each of
    cv2's paths), and R2 on those decoded planes against its plain
    version, bitwise; decode + R2 of one pretrain micro-batch's 768 frames
    at 341x256 (ms, frames/s)."""
    fx = load_fixture()
    dev = torch.device("cuda", torch.cuda.current_device())
    got = jpeg.decode_frames(fx["blobs"], AUG, dev, mode="aug")
    # R2 on these decoded planes (every fixture size and layout) against
    # its plain version on the same planes
    planes, buf = jpeg._decoder(dev).decode_planes(fx["blobs"])
    views = jpeg.frame_views(planes, buf)
    on_planes = r2.launch(planes, AUG, dev)
    plain_planes = torch.stack([r2_plain([f])[0] for f in views])
    r2_planes_equal = bool(torch.equal(on_planes, plain_planes))
    torch.cuda.synchronize()
    diffs = [(got[i].int().cpu() - torch.from_numpy(fx["aug"][i]).int()
              ).abs() for i in range(len(fx["blobs"]))]
    store = [b for b, s in zip(fx["blobs"], fx["sizes"]) if s == STORE_SIZE]
    block = [store[i % len(store)] for i in range(PRETRAIN_BLOCK)]
    jpeg.decode_frames(block, AUG, dev, mode="aug")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        jpeg.decode_frames(block, AUG, dev, mode="aug")
    torch.cuda.synchronize()
    block_ms = (time.perf_counter() - t0) / 3 * 1e3
    row = dict(phase="frames", check="nvjpeg + resize_area against cv2",
               sizes=fx["sizes"], sampling=fx["sampling"], color=fx["color"],
               modes=[r2.area_tables(w, h, AUG).mode for w, h in fx["sizes"]],
               per_frame_max=[float(d.max()) for d in diffs],
               per_frame_mean=[float(d.float().mean()) for d in diffs],
               max_abs_diff=max(float(d.max()) for d in diffs),
               mean_abs_diff=float(sum(float(d.float().sum()) for d in diffs)
                                   / sum(d.numel() for d in diffs)),
               r2_on_decoded_planes_bitwise_equal_plain=r2_planes_equal,
               max_abs_tolerance=DECODE_MAX_ABS,
               mean_abs_tolerance=DECODE_MEAN_ABS,
               reason=DECODE_REASON.replace("R1", "R2's stage 0"),
               block_frames=PRETRAIN_BLOCK, block_decode_r2_ms=block_ms,
               block_frames_per_s=PRETRAIN_BLOCK / block_ms * 1e3, card=smi)
    emit(row)
    if not (r2_planes_equal and row["max_abs_diff"] <= DECODE_MAX_ABS
            and max(row["per_frame_mean"]) <= DECODE_MEAN_ABS):
        raise AssertionError(f"nvJPEG + R2 disagrees with cv2: {row}")
    return row


# ---------------------------------------------------------------------------
# phase pretrain: the MoCo pretrain step at full width
# ---------------------------------------------------------------------------

PRETRAIN_STEPS = 6
PRETRAIN_REF_LOSS_ATOL = 1e-3
PRETRAIN_REF_GRAD_REL = 1e-3
PRETRAIN_REF_FLOOR = 1e-4
PRETRAIN_REF_REASON = (
    "fp32 with TF32 off on both sides, the same weights, data, masks and "
    "queues: K1 / K2 against the plain attention on the CPU sum in another "
    "order; each gradient within 1e-3 of its largest magnitude, or of 1e-4 "
    "of the model's largest gradient where that is more (the biases ahead "
    "of a BatchNorm, and v_projector's output bias ahead of the "
    "predictor's, have a gradient of 0 in exact arithmetic and fp32 "
    "rounding noise near 1e-9; of the others the smallest peaks at about "
    "5e-4 of the largest). The CPU run takes the card's decisions at "
    "the query projector's and predictor's ReLUs: each follows a BatchNorm "
    "over 12 rows, and a unit whose normalised input lies within the "
    "forward's rounding (~2e-5) of 0 takes the other side on the other "
    "device (about one of 49,152 a run), which moves that unit's gradient "
    "whole and, through the frame features, every tower upstream")


def pretrain_launch_prediction(arch, cross, n_accum):
    """K1 and K2 launches of one pretrain step: per micro-batch the query
    side's ViT, temporal, title and MLM towers (K1, and K2 in their
    backward) and the key side's ViT, temporal and title towers (K1
    only)."""
    vit, text, temp = (arch.vision_layers, arch.transformer_layers,
                       cross.temporal_hidden_layers)
    query = vit + temp + text + text
    key = vit + temp + text
    return dict(k1=(query + key) * n_accum, k2=query * n_accum)


def pretrain_task(seed, **kw):
    return TaskConfig(seed=seed, do_pretrain=True, dataset="vatex",
                      batch_size=256, gradient_accumulation_steps=4,
                      epochs=1, n_display=1, **kw)


def pretrain_titles(n, max_words, seed):
    tok = ClipTokenizer()
    rng = np.random.default_rng(seed)
    return np.stack([encode_text(tok, " ".join(rng.choice(
        WORDS, size=rng.integers(5, 14))), max_words)[0] for _ in range(n)])


def key_gap(state):
    """||params_k - params|| over the paired parameters."""
    keys, queries = state.pairs
    return math.sqrt(sum(float((k - q.detach()).float().square().sum())
                         for k, q in zip(keys, queries)))


def pretrain_phase(seed, smi):
    """The full-width BirdPretrainModel (ViT-B/32, cross-base, vocab 49408,
    projector and predictor of inner width 4096, 1024 negatives, momentum
    0.99, temperature 0.07, bf16 compute) on synthetic uint8 frames at 256
    through simclr_augment, 6 steps of 256 in 4 micro-batches: losses,
    device ms per step (CUDA events), clips/s, peak memory, ptr, the key
    towers' gap, K1 / K2 launches against the prediction; then a card-vs-CPU
    check of one micro-batch at a small depth."""
    task = pretrain_task(seed)
    cross = CrossConfig()
    arch = ClipArch.by_name(cross.pretrained_clip_name)
    tok = ClipTokenizer()
    b, f, n_accum = task.batch_size, task.max_frames, \
        task.gradient_accumulation_steps
    t0 = time.perf_counter()
    model = build_model(task, cross, pretrain=True,
                        vocab_size=tok.vocab_size)
    state = runner.pretrain_state(task, model, PRETRAIN_STEPS)
    build_s = time.perf_counter() - t0
    step_fn = make_pretrain_step(
        cross, tok.mask_token_id, tok.pad_token_id, tok.cls_token_id,
        temperature=task.contrast_temperature,
        momentum=task.contrast_momentum, n_accum=n_accum)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    frames = torch.randint(0, 256, (b * f, AUG, AUG, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)
    titles = torch.from_numpy(pretrain_titles(b, task.max_words, seed)).to(
        "cuda").long()
    res = arch.image_resolution
    rows, ptrs, gaps = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for s in range(PRETRAIN_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        video = image_ops.simclr_augment(
            runner.stream(seed, runner.AUG_STREAM, s, "cuda"), frames,
            out=res).view(b, f, res, res, 3)
        aug_end = torch.cuda.Event(enable_timing=True)
        aug_end.record()
        keys, queries = state.pairs
        before = [q.detach().clone() for q in queries]
        gap0 = math.sqrt(sum(float((k - q).float().square().sum())
                             for k, q in zip(keys, before)))
        state, metrics = step_fn(
            state, {"video": video, "title_ids": titles},
            runner.stream(seed, runner.STEP_STREAM, s, "cuda"))
        end.record()
        torch.cuda.synchronize()
        gap_ema = math.sqrt(sum(float((k - q).float().square().sum())
                                for k, q in zip(keys, before)))
        del before
        ptrs.append(state.queues.ptr)
        gaps.append(dict(before=gap0, after_ema=gap_ema,
                         predicted=gap0 * task.contrast_momentum ** n_accum,
                         after_step=key_gap(state)))
        rows.append(dict({k: float(v) for k, v in metrics.items()},
                         step_ms=start.elapsed_time(end),
                         augment_ms=start.elapsed_time(aug_end)))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profile = profile_pretrain_step(state, step_fn, frames, titles, seed,
                                    res, rows[-1]["step_ms"])
    predicted = pretrain_launch_prediction(arch, cross, n_accum)
    predicted = {k: v * PRETRAIN_STEPS for k, v in predicted.items()}
    warm = [r["step_ms"] for r in rows[1:]]
    # each EMA rounds every key parameter once: a floor of n_accum fp32
    # half-ulps of the parameters' norm under the 1e-3 relative match
    floor = n_accum * 2.0 ** -24 * math.sqrt(sum(
        float(q.detach().float().square().sum()) for q in state.pairs[1]))
    gap_ok = all(abs(g["after_ema"] - g["predicted"])
                 <= 1e-3 * g["predicted"] + floor for g in gaps)
    finite = all(math.isfinite(v) for r in rows for v in r.values())
    ptr_ok = ptrs == [(b * (s + 1)) % task.contrast_num_negative
                      for s in range(PRETRAIN_STEPS)]
    row = dict(phase="pretrain", model="ViT-B/32 BirdPretrainModel",
               steps=PRETRAIN_STEPS, batch_size=b, micro_batch=b // n_accum,
               frames=f, aug_size=AUG, resolution=res,
               negatives=task.contrast_num_negative,
               momentum=task.contrast_momentum,
               temperature=task.contrast_temperature,
               compute_dtype=task.compute_dtype, model_build_s=build_s,
               per_step=rows, ptr=ptrs, key_gap=gaps, key_gap_as_ema=gap_ok,
               key_gap_rounding_floor=floor,
               step_ms_warm_mean=sum(warm) / len(warm),
               clips_per_s=b / (sum(warm) / len(warm)) * 1e3,
               max_memory_allocated=peak, launches=counts,
               predicted_launches=predicted, finite=finite, card=smi)
    emit(row)
    emit(dict(phase="pretrain_profile", what="one warm pretrain step with "
              "its SimCLR augmentation", card=smi, **profile))
    del state, model, frames, video
    torch.cuda.empty_cache()
    if not (finite and ptr_ok and gap_ok and counts["k1"] == predicted["k1"]
            and counts["k2"] == predicted["k2"]):
        raise AssertionError(f"pretrain phase failed: {row}")
    pretrain_reference_check(seed)
    return dict(k1=counts["k1"], k2=counts["k2"], row=row)


def profile_pretrain_step(state, step_fn, frames, titles, seed, res,
                          step_ms):
    """Where the device time of one warm pretrain step goes (the
    augmentation, the EMA and key forwards, BertAdam, the rest: the query
    forwards, losses and backward); the idle share also against
    ``step_ms``, the last unprofiled step's time by CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    b, f = titles.shape[0], frames.shape[0] // titles.shape[0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        video = image_ops.simclr_augment(
            runner.stream(seed, runner.AUG_STREAM, PRETRAIN_STEPS, "cuda"),
            frames, out=res).view(b, f, res, res, 3)
        step_fn(state, {"video": video, "title_ids": titles},
                runner.stream(seed, runner.STEP_STREAM, PRETRAIN_STEPS,
                              "cuda"))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = device_time_by_kind(prof, wall_ms, ranges=(
        "simclr_augment", "pretrain_step.keys", "pretrain_step.optimizer"))
    busy = kinds["device_busy_ms"]
    return dict(step_device_ms_unprofiled=step_ms,
                device_idle_share_unprofiled=(
                    1 - busy / step_ms if isinstance(busy, float)
                    else "not measured"), **kinds)


def pretrain_reference_check(seed):
    """One fp32 pretrain micro-batch at ViT-B/32's widths and 2 layers per
    tower (4 clips of 3 frames, 16 negatives): the kernels on the card
    against the plain attention on the CPU, the same weights, frames,
    titles, masks and queues, TF32 off. The four losses and every
    gradient."""
    cross = CrossConfig(temporal_hidden_layers=1)
    arch = dataclasses.replace(ClipArch.by_name("ViT-B/32"),
                               vision_layers=2, transformer_layers=2)
    tok = ClipTokenizer()
    task = TaskConfig(seed=seed, do_pretrain=True, compute_dtype="float32",
                      max_frames=3, contrast_num_negative=16, batch_size=4)
    rng = np.random.default_rng(seed + 13)
    video = torch.from_numpy(rng.normal(size=(4, 3, 224, 224, 3)).astype(
        np.float32))
    titles = torch.from_numpy(pretrain_titles(4, task.max_words, seed)).long()
    dec = [{"title": sample_mask_decisions(
        torch.Generator().manual_seed(seed), titles.shape, tok.vocab_size)}]
    runs, relu_masks = {}, {}
    # "cpu_free" keeps its own ReLU decisions: the gradients it gives show
    # what one unit on the other side does
    for where, switch in (("card", "on"), ("cpu", "off"),
                          ("cpu_free", "off")):
        t = task.replace(use_fused_attention=switch)
        model = build_model(t, cross, arch=arch, device="cpu", pretrain=True,
                            vocab_size=tok.vocab_size).to(
            "cuda" if where == "card" else "cpu")
        state = runner.pretrain_state(t, model, 10)
        step = make_pretrain_step(cross, tok.mask_token_id, tok.pad_token_id,
                                  tok.cls_token_id)
        dev = next(model.parameters()).device
        d = [{"title": type(dec[0]["title"])(
            **{k: v.to(dev) for k, v in vars(dec[0]["title"]).items()})}]
        keep = {n: p for n, p in model.named_parameters()}
        state.optimizer.step = lambda: None        # gradients only
        flips, hooks = [], []
        for name, mod in model.named_modules():
            if where == "cpu_free" or not (
                    isinstance(mod, torch.nn.ReLU) and name.startswith(
                        ("v_projector.", "v_predictor."))):
                continue

            def hook(m, inp, out, name=name):
                if where == "card":
                    relu_masks[name] = (out > 0).cpu()
                    return None
                mask = relu_masks[name]
                flips.append(int((mask != (out > 0)).sum()))
                return inp[0] * mask.to(inp[0].dtype)

            hooks.append(mod.register_forward_hook(hook))
        _, metrics = step(state, {"video": video.to(dev),
                                  "title_ids": titles.to(dev)}, decisions=d)
        for h in hooks:
            h.remove()
        runs[where] = dict(
            relu_flips=sum(flips),
            losses={k: float(v) for k, v in metrics.items()},
            grads={n: p.grad.detach().float().cpu()
                   for n, p in keep.items() if p.grad is not None})
        del model, state
    torch.cuda.empty_cache()
    loss_diff = max(abs(runs["card"]["losses"][k] - runs["cpu"]["losses"][k])
                    for k in ("loss", "loss_FAM", "loss_VTM", "loss_FTM",
                              "loss_MLM"))
    top = max(float(g.abs().max()) for g in runs["cpu"]["grads"].values())

    def rel_to(ref):
        return {n: float((g - runs[ref]["grads"][n]).abs().max()
                         / max(float(runs[ref]["grads"][n].abs().max()),
                               PRETRAIN_REF_FLOOR * top))
                for n, g in runs["card"]["grads"].items()}

    rel = rel_to("cpu")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    free = sorted(rel_to("cpu_free").items(), key=lambda kv: -kv[1])[:3]
    ok = (set(runs["card"]["grads"]) == set(runs["cpu"]["grads"])
          and loss_diff <= PRETRAIN_REF_LOSS_ATOL
          and worst[0][1] <= PRETRAIN_REF_GRAD_REL)
    emit(dict(phase="pretrain_reference", what="one fp32 pretrain "
              "micro-batch, ViT-B/32 widths, 2 layers a tower, 4 clips",
              losses=runs["card"]["losses"], cpu_losses=runs["cpu"]["losses"],
              loss_max_abs_diff=loss_diff, loss_atol=PRETRAIN_REF_LOSS_ATOL,
              grads=len(rel), worst_grad_rel=worst,
              grad_floor=PRETRAIN_REF_FLOOR * top,
              relu_units_taken_from_card=runs["cpu"]["relu_flips"],
              worst_grad_rel_cpu_own_relu=free,
              grad_rel=PRETRAIN_REF_GRAD_REL, reason=PRETRAIN_REF_REASON,
              ok=ok))
    if not ok:
        raise AssertionError(f"pretrain card vs CPU: losses {loss_diff}, "
                             f"gradients {worst}")


# ---------------------------------------------------------------------------
# phase cli_pretrain: --do_pretrain --dataset vatex through the CLI
# ---------------------------------------------------------------------------

PRETRAIN_VIDEOS = 256        # train_list.txt; 2 captions each: 2 steps


def build_vatex_layout(root, seed):
    """``root/vatex``: a FramePack of PRETRAIN_VIDEOS videos x
    CLI_STORED_FRAMES frames cycled from the fixture's three-plane frames
    (every size, sampling and R2 path but the four-plane CMYK and YCCK,
    which nvJPEG's batched decode refuses), ``vatex_data.json`` with 2
    English captions per video and ``train_list.txt``."""
    fx = load_fixture()
    blobs = [b for b, c in zip(fx["blobs"], fx["color"])
             if c in ("ycc", "rgb")]
    vx = os.path.join(root, "vatex")
    os.makedirs(vx)
    vids = [f"vatex{i}" for i in range(PRETRAIN_VIDEOS)]
    with FramePackWriter(os.path.join(vx, "frames.fpk")) as w:
        for i, vid in enumerate(vids):
            w.add_video(vid, [blobs[(i + j) % len(blobs)]
                              for j in range(CLI_STORED_FRAMES)])
    rng = np.random.default_rng(seed)
    with open(os.path.join(vx, "vatex_data.json"), "w") as fh:
        json.dump({v: {"enCap": [" ".join(rng.choice(
            WORDS, size=rng.integers(5, 14))) for _ in range(2)]}
            for v in vids}, fh)
    with open(os.path.join(vx, "train_list.txt"), "w") as fh:
        fh.write("\n".join(vids) + "\n")
    return len(blobs)


def cli_pretrain_phase(root, seed, smi):
    """``runner.main(cli.get_args(["--do_pretrain", "--dataset", "vatex",
    ...]))`` at full width over ``root``'s VATEX layout, 2 steps of 256 in 4
    micro-batches, then the epoch-end eval on the MSR-VTT layout cli built
    in ``root``. R2, decoder, K1, K2 and R1 launches against their
    predictions, decode routes, wall time per step, the checkpoint's keys;
    ``pytorch_model.bin.0`` must load as a fine-tune's ``--init_model``."""
    cross = CrossConfig()
    arch = ClipArch.by_name(cross.pretrained_clip_name)
    distinct = build_vatex_layout(root, seed)
    out = os.path.join(root, "out_pretrain")
    argv = ["--do_pretrain", "--dataset", "vatex", "--language", "english",
            "--use_temp", "--use_frame_fea", "--data_dir", root,
            "--output_dir", out, "--batch_size", "256",
            "--gradient_accumulation_steps", "4", "--batch_size_val", "512",
            "--epochs", "1", "--n_display", "1", "--num_thread_reader", "4",
            "--seed", str(seed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe() as probe:
        run = runner.main(cli.get_args(argv=argv))
    run_s = time.perf_counter() - t0
    counts = launch_counts()
    steps = len(run.displayed)
    pred = pretrain_launch_prediction(arch, cross, 4)
    eval_k1 = ((arch.vision_layers + cross.temporal_hidden_layers)
               * math.ceil(CLI_CLIPS / 64)
               + arch.transformer_layers * math.ceil(CLI_CLIPS / 512))
    eval_decodes = math.ceil(CLI_CLIPS / 512)
    expected = dict(k1=pred["k1"] * steps + eval_k1,
                    k2=pred["k2"] * steps, r1=eval_decodes,
                    r2=steps, decoder=steps + eval_decodes)
    ckpt = os.path.join(out, "pytorch_model.bin.0")
    sd = ckpt_io.load_torch_state_dict(ckpt)
    ft_task = TaskConfig(do_train=True, seed=seed)
    ft = build_model(ft_task, cross, init_model_path=ckpt)
    loaded = all(torch.equal(v.cpu(), sd[k])
                 for k, v in ft.state_dict().items())
    del ft
    torch.cuda.empty_cache()
    losses = [{k: r[k] for k in runner.LOSS_NAMES} for r in run.displayed]
    finite = all(math.isfinite(v) for r in losses for v in r.values())
    row = dict(phase="cli_pretrain", model="ViT-B/32 BirdPretrainModel",
               videos=PRETRAIN_VIDEOS, distinct_frames=distinct, steps=steps,
               losses=losses, ptr=[r["ptr"] for r in run.displayed],
               wall_s_per_step=[r["wall_s"] for r in run.displayed],
               run_s=run_s, eval_wall_ms=probe.calls[0]["wall_ms"]
               if probe.calls else "not measured",
               epoch_metrics=run.epoch_metrics, launches=counts,
               expected_launches=expected,
               routes=dict(jpeg.decode_frames.routes),
               formats=dict(jpeg.decode_frames.formats),
               colors=dict(jpeg.decode_frames.colors),
               decode_failures=jpeg.decode_frames.decode_failures,
               checkpoint_keys=len(sd),
               checkpoint_queue_keys=sorted(k for k in sd
                                            if k.startswith("queue_")),
               finetune_init_model_loads=loaded,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               card=smi)
    emit(row)
    del run
    torch.cuda.empty_cache()
    if not (finite and steps == 2 and counts == expected and loaded
            and row["decode_failures"] == 0 and run_s > 0
            and len(row["checkpoint_queue_keys"]) == 6):
        raise AssertionError(f"cli pretrain phase failed: {row}")
    return dict(k1=counts["k1"], k2=counts["k2"], r1=counts["r1"],
                r2=counts["r2"])


# ---------------------------------------------------------------------------
# phase 4: the eval slice
# ---------------------------------------------------------------------------

class SyntheticClips:
    """Loader batches shaped like the eval datasets' after decode: uint8
    frames [n, F, H, W, 3] drawn per batch from a numpy seed (never all
    held at once), and captions from a fixed word list through the port's
    tokenizer. Iterating again replays the same data."""

    def __init__(self, clips, batch, frames, res, max_words, seed):
        self.clips, self.batch = clips, batch
        self.frames, self.res, self.seed = frames, res, seed
        tok = ClipTokenizer()
        rng = np.random.default_rng(seed)
        captions = [" ".join(rng.choice(WORDS, size=rng.integers(5, 14)))
                    for _ in range(clips)]
        enc = [encode_text(tok, c, max_words) for c in captions]
        self.ids = np.stack([e[0] for e in enc])
        self.mask = np.stack([e[1] for e in enc])
        self.gen_seconds = 0.0

    def __iter__(self):
        rng = np.random.default_rng(self.seed + 1)
        for s in range(0, self.clips, self.batch):
            n = min(self.batch, self.clips - s)
            t0 = time.perf_counter()
            video = rng.integers(0, 256, size=(
                n, self.frames, self.res, self.res, 3), dtype=np.uint8)
            self.gen_seconds += time.perf_counter() - t0
            yield {"query_ids": self.ids[s:s + n],
                   "query_mask": self.mask[s:s + n], "video": video}


def run_eval(model, task, loader):
    """Evaluator.run's body, keeping the similarity matrix."""
    ev = Evaluator(model, task)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    loader.gen_seconds = 0.0
    t0 = time.perf_counter()
    q, v, f, multi, cut_off = ev.cache_features(loader)
    t_cache = time.perf_counter() - t0
    sim = ev.similarity(q, v, f)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = fused_attention.launches
    bwd_launches = fused_attention_backward.launches
    metrics = logging_rank(sim, multi, cut_off)
    return dict(ev=ev, q=q, v=v, f=f, sim=sim, metrics=metrics,
                launches=launches, bwd_launches=bwd_launches,
                cache_s=t_cache, total_s=t_total,
                data_gen_s=loader.gen_seconds,
                max_memory_allocated=torch.cuda.max_memory_allocated())


def device_throughput(model, task, arch, ev):
    """Device time of one full video block and one full text block (CUDA
    events over warm calls, inputs already on the card)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    res = arch.image_resolution
    video = torch.randint(0, 256, (ev.video_block, task.max_frames, res, res, 3),
                          device="cuda", generator=g, dtype=torch.uint8)
    ids = torch.randint(1, 49000, (ev.text_block, task.max_words),
                        device="cuda", generator=g)
    ids[:, -1] = 49407

    def enc_video():
        model.encode_video(image_ops.normalize(image_ops.to_float(video)))

    with torch.inference_mode():
        v_ms = cuda_ms(enc_video, iters=5, warmup=2)
        t_ms = cuda_ms(lambda: model.encode_text(ids), iters=5, warmup=2)
    return dict(video_block=ev.video_block, video_block_ms=v_ms,
                encode_clips_per_s=ev.video_block / v_ms * 1e3,
                text_block=ev.text_block, text_block_ms=t_ms,
                queries_per_s=ev.text_block / t_ms * 1e3)


KERNEL_KINDS = {"nvjpeg": ("nvjpeg",),
                "R1 resize_crop": ("resize_crop_kernel",),
                "R2 resize_area": ("resize_area_kernel",),
                "K1 fused_attention_fwd": ("attention_fwd_",),
                "K2 fused_attention_bwd": ("attention_bwd_",),
                "conv": ("cudnn", "fprop", "dgrad", "wgrad", "conv"),
                "gemm": ("gemm", "nvjet", "xmma", "cutlass", "cublas"),
                "memcpy": ("memcpy", "memset")}


def device_time_by_kind(prof, wall_ms, ranges=()):
    """Device kernel time of a torch.profiler run, summed by name and by
    kind, and the device's idle share of ``wall_ms`` (one stream, so kernel
    times add up). Each name in ``ranges`` is a ``record_function`` range
    whose kernels' device time is reported as its own kind and taken out
    of ``other``."""
    kernels = []
    for e in prof.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        # record_function ranges (ours, and Optimizer.step's) also show on
        # the device's timeline as user annotations: spans, not kernels
        if (ms > 0 and e.device_type.name == "CUDA"
                and not getattr(e, "is_user_annotation", False)):
            kernels.append((e.key, ms, e.count))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    by_kind = {k: 0.0 for k in list(KERNEL_KINDS) + ["other"]}
    for name, ms, _ in kernels:
        low = name.lower()
        kind = next((k for k, keys in KERNEL_KINDS.items()
                     if any(x in low for x in keys)), "other")
        by_kind[kind] += ms
    for rng in ranges:
        ms = sum(e.device_time_total for e in prof.events()
                 if e.name == rng and e.device_type.name == "CPU") / 1e3
        by_kind[rng] = ms if ms > 0 else "not measured"
        if ms > 0:
            by_kind["other"] -= ms
    return dict(wall_ms=wall_ms,
                device_busy_ms=busy_ms if kernels else "not measured",
                device_idle_share=(1 - busy_ms / wall_ms) if kernels
                else "not measured",
                device_ms_by_kind=by_kind,
                top_kernels=[dict(name=n[:90], ms=ms, count=c)
                             for n, ms, c in kernels[:12]])


def profile_eval(model, task, arch, seed, clips=128):
    """Where the device time of the eval goes: torch.profiler over
    cache_features + similarity on ``clips`` synthetic clips (warm)."""
    from torch.profiler import ProfilerActivity, profile

    loader = SyntheticClips(clips, 64, task.max_frames, arch.image_resolution,
                            task.max_words, seed)
    ev = Evaluator(model, task)
    ev.cache_features(loader)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        q, v, f, _, _ = ev.cache_features(loader)
        ev.similarity(q, v, f)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    row = dict(phase="profile", clips=clips,
               **device_time_by_kind(prof, wall_ms))
    emit(row)
    return row


def reference_check(task, cross, arch, seed, phase="reference"):
    """fp32 model with the kernel on the card against the same weights on
    the CPU (plain attention), on two clips and four captions."""
    task32 = task.replace(compute_dtype="float32")
    gpu = build_model(task32, cross, arch=arch, device="cuda")
    cpu = build_model(task32.replace(use_fused_attention="off"), cross,
                      arch=arch, device="cpu")
    loader = SyntheticClips(4, 4, task.max_frames, arch.image_resolution,
                            task.max_words, seed)
    batch = next(iter(loader))
    out = {}
    with torch.inference_mode():
        for name, model, dev in (("gpu", gpu, "cuda"), ("cpu", cpu, "cpu")):
            video = image_ops.normalize(image_ops.to_float(
                torch.from_numpy(batch["video"][:2]).to(dev)))
            v, f = model.encode_video(video)
            q = model.encode_text(torch.from_numpy(batch["query_ids"]).long().to(dev))
            out[name] = [t.float().cpu() for t in (q, v, f)]
    errs = [float((a - b).abs().max()) for a, b in zip(out["gpu"], out["cpu"])]
    row = dict(phase=phase, what="fp32 encode_text / encode_video "
               "(video feature, frame output): card (kernel) vs CPU (plain)",
               arch=dataclasses.asdict(arch),
               max_abs_err=errs, atol=REFERENCE_ATOL,
               reason=REFERENCE_REASON, ok=max(errs) <= REFERENCE_ATOL)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"card output disagrees with the CPU: {row}")


# ---------------------------------------------------------------------------
# phase 5: the fine-tune slice
# ---------------------------------------------------------------------------

class RepeatedBatch:
    """One host batch served ``steps`` times, one optimizer step each. When
    the runner has taken the last one (before its epoch-end eval starts),
    the kernels' launch counts, the wall time since the first batch and
    the peak device memory are read."""

    def __init__(self, batch, steps):
        self.batch, self.steps = batch, steps
        self.read = None

    def __len__(self):
        return self.steps

    def __iter__(self):
        t0 = time.perf_counter()
        for _ in range(self.steps):
            yield self.batch
        torch.cuda.synchronize()
        self.read = dict(
            launches=fused_attention.launches,
            bwd_launches=fused_attention_backward.launches,
            wall_s=time.perf_counter() - t0,
            max_memory_allocated=torch.cuda.max_memory_allocated())


def train_task(seed, switch="on"):
    """Batch 256 as 4 micro-batches of 64 (the eval's video block), one
    epoch of TRAIN_STEPS steps, a log line per step; every optimizer field
    at the JAX package's default."""
    return TaskConfig(seed=seed, batch_size=256, gradient_accumulation_steps=4,
                      epochs=1, n_display=1, use_fused_attention=switch)


def run_train(task, cross, arch, batch, eval_loader):
    """runner.finetune over TRAIN_STEPS copies of ``batch``; counts are
    set to 0 just before and read at the end of the steps and after the
    epoch-end eval."""
    loader = RepeatedBatch(batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    t0 = time.perf_counter()
    run = runner.finetune(task, cross, loader, eval_loader, arch=arch)
    total_s = time.perf_counter() - t0
    steps = loader.read
    return dict(run=run, steps=steps, total_s=total_s,
                eval_launches=fused_attention.launches - steps["launches"],
                eval_bwd_launches=(fused_attention_backward.launches
                                   - steps["bwd_launches"]),
                losses=[r["loss"] for r in run.displayed],
                grad_norms=[r["grad_norm"] for r in run.displayed])


def step_device_ms(run, cross, task, batch, iters=3):
    """Device ms of one optimizer step (CUDA events over warm steps on a
    batch already on the card), continuing the run's state."""
    step = make_finetune_step(cross, use_frame_fea=task.use_frame_fea,
                              n_accum=task.gradient_accumulation_steps)
    dev_batch = runner.prepare_finetune_batch(batch, "cuda")
    state = run.state
    return cuda_ms(lambda: step(state, dev_batch), iters=iters,
                   warmup=1), step, dev_batch


def profile_train_step(state, step, dev_batch, step_ms,
                       phase="train_profile"):
    """Where the device time of one warm optimizer step goes. The profiler
    slows the host, so the idle share is also given against ``step_ms``,
    the step's time by CUDA events without the profiler; and BertAdam's
    step alone is timed by CUDA events (kernels and the gaps between
    them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, dev_batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = device_time_by_kind(prof, wall_ms,
                                ranges=("finetune_step.optimizer",))
    busy = kinds["device_busy_ms"]
    row = dict(phase=phase, what="one warm optimizer step",
               step_device_ms_unprofiled=step_ms,
               device_idle_share_unprofiled=(
                   1 - busy / step_ms if isinstance(busy, float)
                   else "not measured"),
               optimizer_step_ms=cuda_ms(state.optimizer.step, iters=3,
                                         warmup=1),
               **kinds)
    emit(row)
    return row


def grad_reference_check(cross, arch, seed, phase="train_reference"):
    """One fp32 fine-tune step on 2 clips and 2 captions at ``arch``'s
    widths: the kernels on the card against the plain attention on the
    CPU, same weights and data, TF32 off. Loss and every parameter's
    gradient."""
    task = TaskConfig(seed=seed, compute_dtype="float32", batch_size=2)
    batch = next(iter(SyntheticClips(2, 2, task.max_frames,
                                     arch.image_resolution, task.max_words,
                                     seed + 7)))
    runs = {}
    for name, dev, switch in (("card", "cuda", "on"), ("cpu", "cpu", "off")):
        model = build_model(task.replace(use_fused_attention=switch), cross,
                            arch=arch, device=dev)
        state = FinetuneState(model, build_optimizer(
            model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
            coef_lr=task.coef_lr, weight_decay=task.weight_decay,
            warmup_proportion=task.warmup_proportion, t_total=1))
        before = fused_attention_backward.launches
        _, metrics = make_finetune_step(cross)(
            state, runner.prepare_finetune_batch(batch, dev))
        runs[name] = dict(
            loss=float(metrics["loss"]),
            bwd_launches=fused_attention_backward.launches - before,
            grads={n: p.grad.float().cpu() for n, p in
                   model.named_parameters() if p.grad is not None})
        del model, state
    rel = {}
    for n, ref in runs["cpu"]["grads"].items():
        scale = float(ref.abs().max())
        err = float((runs["card"]["grads"][n] - ref).abs().max())
        rel[n] = err / scale if scale > 0 else err
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    loss_diff = abs(runs["card"]["loss"] - runs["cpu"]["loss"])
    ok = (set(runs["card"]["grads"]) == set(runs["cpu"]["grads"])
          and runs["card"]["bwd_launches"] > 0
          and loss_diff <= GRAD_REFERENCE_LOSS_ATOL
          and max(rel.values()) <= GRAD_REFERENCE_REL)
    row = dict(phase=phase, what="one fp32 fine-tune step, 2 "
               "clips: card (kernels) vs CPU (plain attention)",
               arch=dataclasses.asdict(arch),
               temporal=[cross.temporal_hidden_size,
                         cross.temporal_hidden_layers,
                         cross.temporal_attention_heads],
               loss_card=runs["card"]["loss"], loss_cpu=runs["cpu"]["loss"],
               loss_abs_diff=loss_diff, loss_atol=GRAD_REFERENCE_LOSS_ATOL,
               params_compared=len(rel),
               grad_max_rel_diff=max(rel.values()),
               grad_rel_tolerance=GRAD_REFERENCE_REL,
               worst_params=[dict(name=n, rel_diff=r) for n, r in worst],
               card_bwd_launches=runs["card"]["bwd_launches"],
               reason=GRAD_REFERENCE_REASON, ok=ok)
    emit(row)
    if not ok:
        raise AssertionError(f"card gradients disagree with the CPU: {row}")


def train_slice(cross, arch, seed, smi):
    """Phase 5; returns the K1 / K2 launch counts of the steps."""
    task = train_task(seed)
    batch = next(iter(SyntheticClips(task.batch_size, task.batch_size,
                                     task.max_frames, arch.image_resolution,
                                     task.max_words, seed + 3)))
    eval_loader = SyntheticClips(256, 64, task.max_frames,
                                 arch.image_resolution, task.max_words,
                                 seed + 5)
    layers = (arch.vision_layers + arch.transformer_layers
              + cross.temporal_hidden_layers)
    expected = layers * task.gradient_accumulation_steps * TRAIN_STEPS
    on = run_train(task, cross, arch, batch, eval_loader)
    run = on["run"]
    ev = Evaluator(run.state.model, task)
    expected_eval = ((arch.vision_layers + cross.temporal_hidden_layers)
                     * math.ceil(256 / ev.video_block)
                     + arch.transformer_layers * math.ceil(256 / ev.text_block))
    step_ms, step, dev_batch = step_device_ms(run, cross, task, batch)
    losses = on["losses"]
    finite = all(math.isfinite(x) for x in losses + on["grad_norms"]) and \
        all(math.isfinite(x) for x in run.best_metrics.values())
    run_displayed = run.displayed
    row = dict(phase="train", model="ViT-B/32 BirdModel", steps=TRAIN_STEPS,
               batch_size=task.batch_size,
               micro_batch=task.micro_batch_size,
               frames=task.max_frames, compute_dtype=task.compute_dtype,
               lr=task.lr, text_lr=task.text_lr, coef_lr=task.coef_lr,
               weight_decay=task.weight_decay,
               warmup_proportion=task.warmup_proportion,
               losses=losses, grad_norms=on["grad_norms"],
               lrs=[r["lr"] for r in run.displayed],
               last_below_first=losses[-1] < losses[0], finite=finite,
               k1_launches=on["steps"]["launches"],
               k2_launches=on["steps"]["bwd_launches"],
               expected_launches=expected,
               eval_k1_launches=on["eval_launches"],
               eval_expected_k1_launches=expected_eval,
               eval_k2_launches=on["eval_bwd_launches"],
               eval_metrics=run.best_metrics,
               step_device_ms=step_ms,
               trained_clips_per_s=task.batch_size / step_ms * 1e3,
               steps_wall_s=on["steps"]["wall_s"],
               wall_clips_per_s=(task.batch_size * TRAIN_STEPS
                                 / on["steps"]["wall_s"]),
               run_s=on["total_s"],
               max_memory_allocated=on["steps"]["max_memory_allocated"],
               card=smi)
    emit(row)
    if not finite or not losses[-1] < losses[0]:
        raise AssertionError(f"train slice: losses {losses}, grad norms "
                             f"{on['grad_norms']}, finite {finite}")
    if not (on["steps"]["launches"] == on["steps"]["bwd_launches"]
            == expected and on["eval_launches"] == expected_eval
            and on["eval_bwd_launches"] == 0):
        raise AssertionError(f"train slice launches: {row}")
    profile_train_step(run.state, step, dev_batch, step_ms)
    del run, on["run"], step, dev_batch, ev
    torch.cuda.empty_cache()

    off_task = train_task(seed, switch="off")
    off = run_train(off_task, cross, arch, batch, eval_loader)
    off_ms, _, _ = step_device_ms(off["run"], cross, off_task, batch)
    diffs = [abs(a - b) for a, b in zip(off["losses"], losses)]
    launches = dict(k1=fused_attention.launches,
                    k2=fused_attention_backward.launches)
    emit(dict(phase="train_switch_off", launches=launches,
              losses=off["losses"], loss_abs_diff_vs_on=diffs,
              atol=TRAIN_LOSS_ON_OFF_ATOL, reason=TRAIN_LOSS_ON_OFF_REASON,
              step_device_ms=off_ms, step_device_ms_on=step_ms,
              max_memory_allocated=off["steps"]["max_memory_allocated"],
              card=smi))
    if launches != dict(k1=0, k2=0) or max(diffs) > TRAIN_LOSS_ON_OFF_ATOL:
        raise AssertionError(f"train switch off: launches {launches}, loss "
                             f"diffs {diffs} > {TRAIN_LOSS_ON_OFF_ATOL}")
    del off
    torch.cuda.empty_cache()
    grad_reference_check(cross, arch, seed)
    return dict(k1=row["k1_launches"], k2=row["k2_launches"],
                eval_k1=row["eval_k1_launches"],
                first_steps=[dict(loss=r["loss"], grad_norm=r["grad_norm"])
                             for r in run_displayed[:DDP_STEPS]])


# ---------------------------------------------------------------------------
# phase cli: the port's CLI over a FramePack
# ---------------------------------------------------------------------------

CLI_CLIPS = 1000            # MSR-VTT 1k-A test split
CLI_TRAIN_VIDEOS = 256      # 2 captions each: 512 samples, 2 steps of 256
CLI_STORED_FRAMES = 30      # tools/video2framepack.py's default
CLI_STEPS = 2
# The schedule gives step 0 lr 0 (warmup), so both displayed losses are the
# initial weights' and the run makes one update: BertAdam's first, about
# 4 lr per weight (no bias correction), which overshoots on random weights
# (as the train phase's third loss shows). The loss must fall along it: at
# a hundredth of the update, below the loss at the start.
CLI_UPDATE_FRACTIONS = (0.0, 0.01, 1.0)


def build_cli_layout(root, seed, clips=CLI_CLIPS,
                     train_videos=CLI_TRAIN_VIDEOS):
    """A FramePack of ``clips`` videos x CLI_STORED_FRAMES frames cycled
    from the fixture's 341x256 JPEGs (video i, frame j: fixture frame
    (i + j) mod 8), and an MSR-VTT layout: a ``clips``-row JSFUSION test
    CSV, a ``train_videos``-video train CSV, 2 captions per video."""
    fx = load_fixture()
    store = [b for b, s in zip(fx["blobs"], fx["sizes"]) if s == STORE_SIZE]
    t0 = time.perf_counter()
    vids = [f"video{i}" for i in range(clips)]
    with FramePackWriter(os.path.join(root, "frames.fpk")) as w:
        for i, vid in enumerate(vids):
            w.add_video(vid, [store[(i + j) % len(store)]
                              for j in range(CLI_STORED_FRAMES)])
    rng = np.random.default_rng(seed)

    def sentence():
        return " ".join(rng.choice(WORDS, size=rng.integers(5, 14)))

    m = os.path.join(root, "msrvtt")
    os.makedirs(m)
    with open(os.path.join(m, "MSRVTT_JSFUSION_test.1k.csv"), "w") as f:
        f.write("key,vid_key,video_id,sentence\n")
        for i, vid in enumerate(vids):
            f.write(f"ret{i},msr{i},{vid},{sentence()}\n")
    with open(os.path.join(m, "MSRVTT_train.9k.csv"), "w") as f:
        f.write("video_id\n" + "\n".join(vids[:train_videos]) + "\n")
    with open(os.path.join(m, "MSRVTT_data.json"), "w") as f:
        json.dump({"sentences": [{"video_id": v, "caption": sentence()}
                                 for v in vids for _ in range(2)]}, f)
    return dict(store=store, crops=[c for c, s in zip(fx["crop"],
                                                      fx["sizes"])
                                    if s == STORE_SIZE],
                seconds=time.perf_counter() - t0,
                pack_bytes=os.path.getsize(os.path.join(root, "frames.fpk")))


def cli_argv(data_dir, out, extra):
    return ["--do_train", "--do_eval", "--dataset", "msrvtt",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--data_dir", data_dir, "--output_dir", out,
            "--batch_size", "256", "--gradient_accumulation_steps", "4",
            "--batch_size_val", "512", "--epochs", "1", "--n_display", "1",
            "--num_thread_reader", "4", *extra]


def launch_counts():
    return dict(k1=fused_attention.launches,
                k2=fused_attention_backward.launches,
                r1=resize_crop.launches, r2=r2.resize_area.launches,
                decoder=jpeg.decode_frames.launches)


def reset_launch_counts():
    reset_attention_counts()
    resize_crop.launches = r2.resize_area.launches = 0
    jpeg.reset_counters()


class EvalProbe:
    """Wraps ``Evaluator.run`` over one ``runner.main`` call: the wall time
    of each eval, the decode counters it moved, and with ``profile`` a
    torch.profiler breakdown of its device time by kernel name, and the
    host time of the ``record_function`` ranges of nvJPEG and R1."""

    def __init__(self, profile=False):
        self.profile, self.calls = profile, []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.orig = orig = Evaluator.run
        probe = self

        def run(ev, loader, dataset=None, log=None):
            torch.cuda.synchronize()
            before = dict(launch_counts(),
                          h2d_bytes=jpeg.decode_frames.h2d_bytes)
            t0 = time.perf_counter()
            if probe.profile:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = orig(ev, loader, dataset, log)
                    torch.cuda.synchronize()
            else:
                out = orig(ev, loader, dataset, log)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = dict(launch_counts(),
                         h2d_bytes=jpeg.decode_frames.h2d_bytes)
            call = dict(wall_ms=wall_ms, metrics=out,
                        moved={k: after[k] - before[k] for k in after})
            if probe.profile:
                call["profile"] = device_time_by_kind(prof, wall_ms)
                call["host_ms"] = {
                    r: sum(e.cpu_time_total for e in prof.events()
                           if e.name == r) / 1e3
                    for r in ("nvjpeg_decode", "resize_crop")}
            probe.calls.append(call)
            return out

        Evaluator.run = run
        return self

    def __exit__(self, *exc):
        Evaluator.run = self.orig


def fixture_video_loader(eval_loader, dataset, crops):
    """The eval loader's batches with their ``video_blobs`` replaced by the
    fixture's PIL crops of the same frames, as host uint8 ``video``."""
    stored = dataset.source.stored_frames("video0")
    idx = sample_frame_indices(stored, dataset.max_frames, "uniform")

    class Loader:
        def __iter__(self):
            for batch in eval_loader:
                clips = [int(dataset.data[int(i)]["video_id"][len("video"):])
                         for i in batch["idx"]]
                video = np.stack([np.stack([crops[(c + j) % len(crops)]
                                            for j in idx]) for c in clips])
                out = {k: v for k, v in batch.items() if k != "video_blobs"}
                out["video"] = video
                yield out

    return Loader()


def loss_along_update(task, cross, ckpt, tok, arch):
    """The mean fine-tune loss over the run's train batches (epoch 0's, as
    the run drew them; fp32, TF32 off) at w0 + t (w1 - w0) for t in
    CLI_UPDATE_FRACTIONS: w0 the seeded initial weights, w1 the saved
    ``pytorch_model.bin.0``."""
    task32 = task.replace(compute_dtype="float32")
    w0 = build_model(task32, cross).state_dict()
    model = build_model(task32, cross, init_model_path=ckpt)
    w1 = {k: v.clone() for k, v in model.state_dict().items()}
    train_loader, _ = get_factory("msrvtt", "train")(task, tok)
    train_loader.set_epoch(0)
    batches = [runner.prepare_finetune_batch(b, "cuda", arch.image_resolution)
               for b in train_loader]
    out = {}
    with torch.no_grad():
        for t in CLI_UPDATE_FRACTIONS:
            model.load_state_dict({k: w0[k] + t * (w1[k] - w0[k])
                                   for k in w1})
            parts = []
            for batch in batches:
                for mb in split_microbatches(
                        batch, task.gradient_accumulation_steps):
                    q = model.encode_text(mb["query_ids"])
                    v, f = model.encode_video(mb["video"])
                    parts.append(float(finetune_retrieval_loss(
                        q, v, f, model.logit_scale(),
                        cross.weight_VTM_finetune,
                        cross.weight_FTM_finetune)["loss"]))
            out[t] = sum(parts) / len(parts)
    return out


def cli_phase(root, seed, smi, cross_model="cross-base"):
    """Phase cli: ``runner.main(cli.get_args([...]))`` fine-tunes the
    full-width ViT-B/32 from a FramePack (2 steps of 256 in 4 micro-batches,
    then the epoch-end eval on 1000 clips, ``pytorch_model.bin.0``); then
    ``--do_eval --init_model`` that file, which must give the same
    metrics. Launches of K1, K2, R1 and the decoder are counted over each
    run against the predictions; the reload eval is profiled; the trained
    model's sims from the card decode are held against those from the
    fixture's PIL crops of the same frames. The FramePack, the layout and
    ``pytorch_model.bin.0`` stay under ``root`` for the serve phase."""
    cross = load_cross_config(cross_model)
    arch = ClipArch.by_name(cross.pretrained_clip_name)
    layout = build_cli_layout(root, seed)
    out = os.path.join(root, "out")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe() as train_probe:
        run = runner.main(cli.get_args(argv=cli_argv(
            root, out, ["--seed", str(seed),
                        "--cross_model", cross_model])))
    train_s = time.perf_counter() - t0
    train_counts = launch_counts()
    train_peak = torch.cuda.max_memory_allocated()
    train_failures = jpeg.decode_frames.decode_failures
    ckpt = os.path.join(out, "pytorch_model.bin.0")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe(profile=True) as eval_probe:
        metrics = runner.main(cli.get_args(argv=cli_argv(
            root, os.path.join(root, "out_eval"),
            ["--seed", str(seed), "--cross_model", cross_model,
             "--init_model", ckpt])[1:]))
    eval_s = time.perf_counter() - t0
    eval_counts = launch_counts()
    eval_peak = torch.cuda.max_memory_allocated()
    eval_failures = jpeg.decode_frames.decode_failures

    # the same clips through the card decode and through PIL's crops
    task = cli.to_task_config(cli.get_args(argv=cli_argv(
        root, out, ["--cross_model", cross_model])))
    task = task.replace(image_resolution=arch.image_resolution)
    tok = ClipTokenizer()
    model = build_model(task, cross, init_model_path=ckpt)
    ev = Evaluator(model, task)
    loader, dataset = get_factory("msrvtt", "test")(task, tok)
    sims = {}
    for name, ld in (("card_decode", loader), ("pil_crops",
                     fixture_video_loader(loader, dataset,
                                          layout["crops"]))):
        q, v, f, _, _ = ev.cache_features(ld)
        sims[name] = ev.similarity(q, v, f)
    sim_diff = float(np.abs(sims["card_decode"] - sims["pil_crops"]).max())
    r1 = {k: logging_rank(s, False, [])["R1"] for k, s in sims.items()}
    del model, ev, loader
    torch.cuda.empty_cache()
    along = loss_along_update(task, cross, ckpt, tok, arch)
    torch.cuda.empty_cache()

    layers_step = (arch.vision_layers + arch.transformer_layers
                   + cross.temporal_hidden_layers) * 4
    eval_k1 = ((arch.vision_layers + cross.temporal_hidden_layers)
               * math.ceil(CLI_CLIPS / 64)
               + arch.transformer_layers * math.ceil(CLI_CLIPS / 512))
    eval_decodes = math.ceil(CLI_CLIPS / 512)
    expected_train = dict(k1=layers_step * CLI_STEPS + eval_k1,
                          k2=layers_step * CLI_STEPS,
                          r1=CLI_STEPS + eval_decodes, r2=0,
                          decoder=CLI_STEPS + eval_decodes)
    expected_eval = dict(k1=eval_k1, k2=0, r1=eval_decodes, r2=0,
                         decoder=eval_decodes)
    losses = [r["loss"] for r in run.displayed]
    finite = all(math.isfinite(x) for x in losses + list(along.values())) \
        and all(math.isfinite(x) for x in metrics.values())
    start, small = along[0.0], along[CLI_UPDATE_FRACTIONS[1]]
    ev_call = eval_probe.calls[0]
    blocks = math.ceil(CLI_CLIPS / 64)
    kinds = ev_call["profile"]["device_ms_by_kind"]

    def per_block(ms):
        return ms / blocks if isinstance(ms, float) else "not measured"

    row = dict(
        phase="cli", model="ViT-B/32 BirdModel", clips=CLI_CLIPS,
        train_videos=CLI_TRAIN_VIDEOS, steps=CLI_STEPS,
        layout_s=layout["seconds"], pack_bytes=layout["pack_bytes"],
        train_run_s=train_s, eval_run_s=eval_s,
        losses=losses,
        fp32_loss_along_update={str(t): x for t, x in along.items()},
        falling=small < start, finite=finite,
        step_s=[r["step_s"] for r in run.displayed],
        data_s=[r["data_s"] for r in run.displayed],
        epoch_metrics=run.best_metrics, reload_metrics=metrics,
        reload_equal=metrics == run.best_metrics,
        train_launches=train_counts, expected_train_launches=expected_train,
        eval_launches=eval_counts, expected_eval_launches=expected_eval,
        decode_failures=train_failures + eval_failures,
        routes=dict(jpeg.decode_frames.routes),
        epoch_eval_wall_ms=train_probe.calls[0]["wall_ms"],
        eval_wall_ms=ev_call["wall_ms"],
        eval_device_busy_ms=ev_call["profile"]["device_busy_ms"],
        eval_device_idle_share=ev_call["profile"]["device_idle_share"],
        eval_device_ms_by_kind=kinds,
        eval_top_kernels=ev_call["profile"]["top_kernels"],
        per_block=dict(
            blocks=blocks,
            decode_device_ms=per_block(kinds["nvjpeg"]),
            r1_device_ms=per_block(kinds["R1 resize_crop"]),
            decode_host_ms=ev_call["host_ms"]["nvjpeg_decode"] / blocks,
            r1_host_ms=ev_call["host_ms"]["resize_crop"] / blocks,
            h2d_compressed_bytes=ev_call["moved"]["h2d_bytes"] / blocks,
            h2d_bytes_if_decoded_on_host=64 * 12 * RES * RES * 3),
        max_memory_allocated=dict(train=train_peak, eval=eval_peak),
        sims_card_vs_pil_max_abs_diff=sim_diff, atol=SIM_ON_OFF_ATOL,
        r1_card_decode=r1["card_decode"], r1_pil_crops=r1["pil_crops"],
        card=smi)
    emit(row)
    ok = (finite and row["falling"] and row["reload_equal"]
          and train_counts == expected_train and eval_counts == expected_eval
          and row["decode_failures"] == 0 and sim_diff <= SIM_ON_OFF_ATOL)
    if not ok:
        raise AssertionError(f"cli phase failed: {row}")
    return dict(k1=train_counts["k1"] + eval_counts["k1"],
                k2=train_counts["k2"] + eval_counts["k2"],
                r1=train_counts["r1"] + eval_counts["r1"],
                ckpt=ckpt, eval_metrics=metrics)


# ---------------------------------------------------------------------------
# phase serve: CLIP archive, feature banks, the retrieval service
# ---------------------------------------------------------------------------

SERVE_QUERIES = 200
INDEX_VIDEOS = 1_000_000
INDEX_QUERIES = 50
INDEX_CHUNK = 50_000
# the bank's features are the eval's, so the card's similarity over them
# gives the --do_eval metrics exactly; numpy's (retrieve.similarity_from_
# bank) sums in another order, and the cycled fixture (8 distinct videos)
# and random weights leave exact and near ties: one query of 1000 may move
# (t2v and v2t alike)
EXTRACT_NUMPY_METRIC_ATOL = {"R1": 0.1, "R5": 0.1, "R10": 0.1, "MR": 0.5,
                             "MeanR": 0.05}
# int8 logits carry ~1e-2 x the logit scale of error (two absmax-127
# roundings) against near ties: 1 point is 10 queries of 1000
INT8_METRIC_ATOL = {"R1": 1.0, "R5": 1.0, "R10": 1.0, "MR": 2.0,
                    "MeanR": 5.0}
# --device_rank ranks int8 values: its reference is the same composition
# in fp32 over the dequantized bank and query, which the s8 x s8 -> s32
# product computes exactly (summed here in another order). Against the
# fp32 bank its top-1 also moves where two videos are nearer than the
# int8 rounding: that agreement is reported, and each returned score is
# held within the JAX package's own int8 bound of its fp32 score
# (tests/test_cli_smoke.py:690-697)
DEVICE_TOP1_AGREEMENT = 0.99
SCORE_ATOL = 1e-4     # host ranking against similarity_from_bank, fp32


def clip_archive(path, seed, name="ViT-B/32", script=True):
    """A seeded full-width CLIP state dict of tower ``name`` under OpenAI's
    names, written as OpenAI ships it: fp16 weights in a TorchScript
    archive (``torch.jit.save`` of a scripted module whose parameters carry
    the names), with its three integer entries; or, without ``script``, the
    same dict pickled (``torch.save``). A ModifiedResNet's BatchNorm
    buffers are among the entries, its running means drawn N(0, 0.05) and
    its variances 1 + |N(0, 0.05)|. Returns the state dict (floats in
    fp16)."""
    arch = ClipArch.by_name(name)
    g = torch.Generator().manual_seed(seed)
    donor = build_model(TaskConfig(compute_dtype="float32"), CrossConfig(),
                        arch=arch, device="cpu", generator=g)
    for k, v in donor.state_dict().items():
        if k.endswith("running_mean"):
            v.normal_(0.0, 0.05, generator=g)
        elif k.endswith("running_var"):
            v.normal_(0.0, 0.05, generator=g).abs_().add_(1.0)
    sd = {}
    for k, v in donor.state_dict().items():
        for prefix in ("visual_encoder.", "text_encoder."):
            if k.startswith(prefix) and not k.startswith(
                    "visual_encoder.temporal") and not k.startswith(
                    "visual_encoder.frame_position"):
                sd[k[len(prefix):]] = (v.half() if v.is_floating_point()
                                       else v)
    if not script:
        torch.save(dict(sd, input_resolution=torch.tensor(
            arch.image_resolution), context_length=torch.tensor(
            arch.context_length), vocab_size=torch.tensor(arch.vocab_size)),
            path)
        return sd
    root = torch.nn.Module()
    for k, v in sd.items():
        *parts, name = k.split(".")
        m = root
        for part in parts:
            if not hasattr(m, part):
                m.add_module(part, torch.nn.Module())
            m = getattr(m, part)
        if v.is_floating_point():
            m.register_parameter(name, torch.nn.Parameter(
                v, requires_grad=False))
        else:
            m.register_buffer(name, v)
    for name, value in (("input_resolution", arch.image_resolution),
                        ("context_length", arch.context_length),
                        ("vocab_size", arch.vocab_size)):
        root.register_buffer(name, torch.tensor(value))
    torch.jit.save(torch.jit.script(root), path)
    return sd


class Capture:
    """Records the models ``runner.build_model`` returns in one run, and
    the seconds each build took."""

    def __enter__(self):
        self.orig, self.models, self.seconds = runner.build_model, [], []

        def build(*a, **kw):
            t0 = time.perf_counter()
            self.models.append(self.orig(*a, **kw))
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return self.models[-1]

        runner.build_model = build
        return self

    def __exit__(self, *exc):
        runner.build_model = self.orig


class CacheProbe:
    """Times ``Evaluator.cache_features`` (the extract's body); with
    ``profile`` also its device busy time and idle share (torch.profiler,
    whose teardown then adds seconds to the run around it)."""

    def __init__(self, profile):
        self.profile = profile

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.orig = orig = Evaluator.cache_features
        probe = self
        self.calls = []

        def cache(ev, loader, dataset=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if not probe.profile:
                out = orig(ev, loader, dataset)
                torch.cuda.synchronize()
                probe.calls.append(dict(
                    wall_ms=(time.perf_counter() - t0) * 1e3))
                return out
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = orig(ev, loader, dataset)
                torch.cuda.synchronize()
            probe.calls.append(device_time_by_kind(
                prof, (time.perf_counter() - t0) * 1e3))
            return out

        Evaluator.cache_features = cache
        return self

    def __exit__(self, *exc):
        Evaluator.cache_features = self.orig


def percentiles(ms):
    return dict(p50_ms=float(np.percentile(ms, 50)),
                p99_ms=float(np.percentile(ms, 99)),
                mean_ms=float(np.mean(ms)), n=len(ms))


def query_breakdown(svc, texts, n=50):
    """Where a served query's time goes: per query the host tokenizer, the
    text tower at batch 1 (synchronized) and the ranking, on the service's
    own objects; and one search under torch.profiler (device busy and idle
    share, by kind)."""
    from torch.profiler import ProfilerActivity, profile

    parts = {"tokenize": [], "text_tower": [], "rank": []}
    with torch.inference_mode():
        for text in texts[:n]:
            t0 = time.perf_counter()
            ids, _ = encode_text(svc.tokenizer, text, svc.task.max_words)
            t1 = time.perf_counter()
            q = svc.model.encode_text(torch.from_numpy(ids[None]).long()
                                      .cuda())
            q = q / q.norm(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if svc._bank_dev is not None:
                svc.rank_on_device(q, 5)
            else:
                sim = svc.score(q[0].cpu().numpy())
                np.argsort(-sim)[:5]
            t3 = time.perf_counter()
            for k, a, b in (("tokenize", t0, t1), ("text_tower", t1, t2),
                            ("rank", t2, t3)):
                parts[k].append((b - a) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.search(texts[0])
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_row = device_time_by_kind(prof, wall_ms)
    return dict({k: percentiles(v) for k, v in parts.items()},
                one_search_profiled={k: prof_row[k] for k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "device_ms_by_kind")})


def metric_diff(a, b):
    return {k: abs(float(a[k]) - float(b[k])) for k in a}


def index_scale(dsvc, texts, gen, smi):
    """--device_rank at index scale: a synthetic normalized bank of
    INDEX_VIDEOS x 12 frames x 512 on the card, int8 (with per-row scales)
    and fp32; per-query latency of the service's search over the int8
    bank, and of its ranking alone against the same composition in fp32
    with torch.matmul."""
    d, frames_n = dsvc.video.shape[1], dsvc.task.max_frames
    v, chunk = INDEX_VIDEOS, INDEX_CHUNK
    t0 = time.perf_counter()
    vq = torch.empty((v, d), dtype=torch.int8, device="cuda")
    fq = torch.empty((v, frames_n, d), dtype=torch.int8, device="cuda")
    vs = torch.empty(v, device="cuda")
    fs = torch.empty((v, frames_n), device="cuda")
    v32 = torch.empty((v, d), device="cuda")
    f32 = torch.empty((v, frames_n, d), device="cuda")
    for s0 in range(0, v, chunk):
        x = torch.randn((min(chunk, v - s0), frames_n + 1, d), device="cuda",
                        generator=gen)
        x = x / x.norm(dim=-1, keepdim=True)
        e = s0 + x.shape[0]
        v32[s0:e], f32[s0:e] = x[:, 0], x[:, 1:]
        vq[s0:e], vs[s0:e] = quant.quantize_rows(x[:, 0])
        fq[s0:e], fs[s0:e] = quant.quantize_rows(x[:, 1:])
        del x
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    small = (dsvc._bank_dev, dsvc.video_ids)
    # the service ranks whatever bank it holds on the card
    dsvc._bank_dev = {"video": (vq, vs), "frames": (fq, fs)}
    dsvc.video_ids = [f"synthetic{i}" for i in range(v)]
    scale, top = dsvc.scale, dsvc.top_frames

    def fp32_rank(q):
        sim = scale * (q @ v32.T)
        fl = scale * (f32.view(-1, d) @ q.T).view(1, v, frames_n)
        sim = sim + fl.topk(top, dim=-1).values.mean(-1)
        s_, i_ = torch.topk(sim[0], 5)
        return s_.cpu().numpy(), i_.cpu().numpy()

    def host_ms(fn, arg):
        t = time.perf_counter()
        out = fn(arg)
        return (time.perf_counter() - t) * 1e3, out

    search_ms, rank_ms, fp32_ms, agree = [], [], [], 0
    with torch.inference_mode():
        dsvc.search(texts[0])
        for text in texts[:INDEX_QUERIES]:
            search_ms.append(host_ms(lambda t: dsvc.search(t, 5), text)[0])
            ids, _ = encode_text(dsvc.tokenizer, text, dsvc.task.max_words)
            q = dsvc.model.encode_text(
                torch.from_numpy(ids[None]).long().cuda())
            q = q / q.norm(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            ms, (_, i8) = host_ms(lambda x: dsvc.rank_on_device(x, 5), q)
            rank_ms.append(ms)
            ms, (_, i32) = host_ms(fp32_rank, q)
            fp32_ms.append(ms)
            agree += int(i8[0] == i32[0])
    dsvc._bank_dev, dsvc.video_ids = small
    row = dict(phase="serve", check="index scale, --device_rank",
               videos=v, frames=frames_n, dim=d,
               int8_bank_bytes=int(vq.numel() + fq.numel()
                                   + 4 * (vs.numel() + fs.numel())),
               fp32_bank_bytes=int(4 * (v32.numel() + f32.numel())),
               bank_build_s=build_s,
               search_int8=percentiles(search_ms),
               rank_int8=percentiles(rank_ms),
               rank_fp32_matmul=percentiles(fp32_ms),
               top1_int8_equals_fp32=agree / INDEX_QUERIES,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               card=smi)
    del vq, fq, vs, fs, v32, f32
    torch.cuda.empty_cache()
    emit(row)
    return row


def serve_phase(root, ckpt, eval_metrics, seed, smi):
    """Phase serve, over the cli phase's FramePack and checkpoint:
    ``--do_params --clip_model`` on a seeded full-width CLIP archive (the
    arch read from its shapes, every overlaid weight checked); ``--do_extract``
    over the 1000-clip split, float and ``--quantize_bank int8`` (metrics
    from the bank against the cli phase's ``--do_eval``); the
    RetrievalService answering SERVE_QUERIES test captions with host and
    device ranking (latency, K1 launches, top-5 and top-1 checks), one HTTP
    round trip; --device_rank at index scale."""
    import threading
    import urllib.request

    from hmmc_tpu_torch import retrieve, serve
    from hmmc_tpu_torch.data.datasets import read_csv
    from hmmc_tpu_torch.train import checkpoint

    counts = {"k1": 0, "r1": 0, "decoder": 0}

    def add_counts():
        for k in counts:
            counts[k] += launch_counts()[k]

    build_dir = os.path.join(kernel_build.BUILD_DIR, "serve")
    os.makedirs(build_dir, exist_ok=True)
    clip_path = os.path.join(build_dir, "ViT-B-32-seeded.pt")
    t0 = time.perf_counter()
    clip_sd = clip_archive(clip_path, seed + 1000)
    archive_s = time.perf_counter() - t0

    # 1. --clip_model, through --do_params
    base = cli_argv(root, os.path.join(root, "out_params"),
                    ["--seed", str(seed)])[2:]
    with Capture() as cap:
        t0 = time.perf_counter()
        params = runner.main(cli.get_args(argv=["--do_params",
                                                "--clip_model", clip_path]
                                          + base))
        params_s = time.perf_counter() - t0
    model = cap.models[0]
    own = model.state_dict()
    overlay = checkpoint.clip_to_port({k: v.float() for k, v in
                                       clip_sd.items()}, "english")
    overlay_equal = all(torch.equal(own[k].cpu(), v.reshape(own[k].shape))
                        for k, v in overlay.items())
    arch_ok = model.arch == ClipArch.by_name("ViT-B/32")
    by_name = sum(p.numel() for p in build_model(
        TaskConfig(compute_dtype="float32"), CrossConfig(),
        device="cpu").parameters())
    row = dict(phase="serve", check="--clip_model (TorchScript, fp16)",
               archive_bytes=os.path.getsize(clip_path),
               archive_write_s=archive_s, do_params_s=params_s,
               arch_equals_vit_b32=arch_ok, overlaid=len(overlay),
               overlay_equals_file=overlay_equal, params=params["params"],
               params_by_name=by_name,
               forward_flops_batch1=params["flops"], card=smi)
    emit(row)
    del cap, model, own
    torch.cuda.empty_cache()
    if not (arch_ok and overlay_equal and len(overlay) == len(clip_sd)
            and params["params"] == by_name):
        raise AssertionError(f"--clip_model check failed: {row}")

    # 2. --do_extract, float (profiled) and int8 (timed bare)
    banks = {}
    reset_launch_counts()
    for name, extra in (("float", []), ("int8", ["--quantize_bank",
                                                 "int8"])):
        argv = ["--do_extract"] + cli_argv(
            root, os.path.join(root, f"out_extract_{name}"),
            ["--seed", str(seed), "--init_model", ckpt] + extra)[2:]
        with CacheProbe(profile=name == "float") as probe, Capture() as cap:
            t0 = time.perf_counter()
            path = runner.main(cli.get_args(argv=argv))
            wall = time.perf_counter() - t0
        banks[name] = dict(path=path, bank=dict(np.load(path)), wall_s=wall,
                           cache=probe.calls[0], build_s=cap.seconds[0])
        del cap
    extract_counts = launch_counts()
    add_counts()
    failures = jpeg.decode_frames.decode_failures

    # 3. the service, host and device ranking
    texts = [r["sentence"] for r in read_csv(os.path.join(
        root, "msrvtt", "MSRVTT_JSFUSION_test.1k.csv"))][:SERVE_QUERIES]
    sargs = cli.get_args(argv=cli_argv(
        root, os.path.join(root, "out_serve"),
        ["--seed", str(seed), "--init_model", ckpt])[1:])
    sargs.features = banks["float"]["path"]
    services, runs = {}, {}
    for mode in ("host", "device"):
        sargs.device_rank = mode == "device"
        reset_launch_counts()
        t0 = time.perf_counter()
        svc = serve.RetrievalService(sargs)
        build_s = time.perf_counter() - t0
        warm_k1 = launch_counts()["k1"]
        ms, results = [], []
        for text in texts:
            t0 = time.perf_counter()
            results.append(svc.search(text, topk=5))
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[mode] = dict(build_s=build_s, warmup_k1=warm_k1,
                          k1=launch_counts()["k1"], results=results,
                          latency=percentiles(ms))
        runs[mode]["breakdown"] = query_breakdown(svc, texts)
        add_counts()
        services[mode] = svc
    host = services["host"]

    # the bank's features are the eval's: the card's similarity over them
    # gives --do_eval's metrics; numpy's within the stated tolerance
    bank = banks["float"]["bank"]
    ev = Evaluator(host.model, host.task)
    card_metrics = logging_rank(ev.similarity(bank["query"], bank["video"],
                                              bank["frames"]), False, [])
    numpy_metrics = retrieve.bank_metrics(bank)
    int8_metrics = retrieve.bank_metrics(banks["int8"]["bank"])
    numpy_diff = metric_diff(numpy_metrics, eval_metrics)
    int8_diff = metric_diff(int8_metrics, numpy_metrics)

    # each served top-5 against similarity_from_bank for that query (the
    # service's own batch-1 query vector); tie-aware: the scores at each
    # rank agree
    top5_ok, dev_agree, bank_query_agree, q_diff = 0, 0, 0, 0.0
    dev_agree_fp32, dev_score_err = 0, 0.0
    bank_q = retrieve._norm(bank["query"])
    index = {vid: i for i, vid in enumerate(host.video_ids)}
    deq_video = quant.dequantize_np(*quant.quantize_rows_np(host.video))
    deq_frames = quant.dequantize_np(*quant.quantize_rows_np(host.frames))
    int8_bound = (6.0 * host.scale * np.sqrt(host.video.shape[1]) / 254.0)

    def int8_reference(q):
        qd = quant.dequantize_np(*quant.quantize_rows_np(q))[0]
        fl = np.sort(host.scale * (deq_frames @ qd), axis=-1)
        return (host.scale * (deq_video @ qd)
                + fl[:, -host.top_frames:].mean(axis=-1))

    with torch.inference_mode():
        for i, text in enumerate(texts):
            ids, _ = encode_text(host.tokenizer, text, host.task.max_words)
            q = host.model.encode_text(torch.from_numpy(ids[None]).long()
                                       .cuda())
            q = (q / q.norm(dim=-1, keepdim=True)).cpu().numpy()
            q_diff = max(q_diff, float(np.abs(q[0] - bank_q[i]).max()))
            # row 0: the served query vector; row 1: the bank's own
            ref, row_b = retrieve.similarity_from_bank(dict(
                bank, query=np.concatenate([q, bank["query"][i:i + 1]])))
            best = np.sort(ref)[::-1][:5]
            got = [index[r["video_id"]] for r in runs["host"]["results"][i]
                   ["results"]]
            top5_ok += int(np.abs(ref[got] - best).max() <= SCORE_ATOL)
            served = runs["device"]["results"][i]["results"]
            dev = index[served[0]["video_id"]]
            ref8 = int8_reference(q)
            dev_agree += int(ref8[dev] >= ref8.max() - SCORE_ATOL)
            dev_agree_fp32 += int(ref[dev] >= best[0] - SCORE_ATOL)
            dev_score_err = max(dev_score_err, max(
                abs(r["score"] - float(ref[index[r["video_id"]]]))
                for r in served))
            bank_query_agree += int(row_b[got[0]] >= row_b.max() - SCORE_ATOL)

    # one POST /search round trip
    httpd = serve.make_server(host, 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    reset_launch_counts()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/search",
            data=json.dumps({"text": texts[0], "topk": 5}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as r:
            http_out = json.loads(r.read())
        http_ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    http_k1 = launch_counts()["k1"]
    add_counts()
    http_ok = ([r["video_id"] for r in http_out["results"]]
               == [r["video_id"] for r in runs["host"]["results"][0]
                   ["results"]])

    arch, cross = ClipArch.by_name("ViT-B/32"), CrossConfig()
    layers = arch.transformer_layers
    eval_k1 = ((arch.vision_layers + cross.temporal_hidden_layers)
               * math.ceil(CLI_CLIPS / 64)
               + layers * math.ceil(CLI_CLIPS / 512))
    expected = dict(extract_k1=2 * eval_k1,
                    extract_r1=2 * math.ceil(CLI_CLIPS / 512),
                    service_k1=layers * (SERVE_QUERIES + 1),
                    warmup_k1=layers, http_k1=layers)
    measured = dict(extract_k1=extract_counts["k1"],
                    extract_r1=extract_counts["r1"],
                    service_k1=runs["host"]["k1"], warmup_k1=runs["host"]
                    ["warmup_k1"], http_k1=http_k1)
    row = dict(
        phase="serve", model="ViT-B/32 BirdModel", clips=CLI_CLIPS,
        extract={name: dict(profiled=name == "float", wall_s=b["wall_s"],
                            clips_per_s=CLI_CLIPS / b["wall_s"],
                            build_model_s=b["build_s"],
                            cache_features_wall_ms=b["cache"]["wall_ms"],
                            cache_features_clips_per_s=CLI_CLIPS
                            / b["cache"]["wall_ms"] * 1e3,
                            device_busy_ms=b["cache"].get("device_busy_ms"),
                            device_idle_share=b["cache"].get(
                                "device_idle_share"),
                            device_ms_by_kind=b["cache"].get(
                                "device_ms_by_kind"),
                            bank_bytes=os.path.getsize(b["path"]))
                 for name, b in banks.items()},
        eval_metrics=eval_metrics, bank_card_metrics=card_metrics,
        bank_numpy_metrics=numpy_metrics, bank_int8_metrics=int8_metrics,
        numpy_vs_eval_diff=numpy_diff,
        numpy_atol=EXTRACT_NUMPY_METRIC_ATOL, int8_vs_float_diff=int8_diff,
        int8_atol=INT8_METRIC_ATOL, decode_failures=failures,
        latency={m: r["latency"] for m, r in runs.items()},
        latency_breakdown={m: r["breakdown"] for m, r in runs.items()},
        service_build_s={m: r["build_s"] for m, r in runs.items()},
        host_top5_match=top5_ok / len(texts),
        device_top1_agreement_int8_reference=dev_agree / len(texts),
        device_top1_required=DEVICE_TOP1_AGREEMENT,
        device_top1_agreement_fp32=dev_agree_fp32 / len(texts),
        device_score_max_abs_diff_vs_fp32=dev_score_err,
        device_score_bound=int8_bound,
        batch1_query_max_abs_diff_vs_bank=q_diff,
        host_top1_agreement_with_bank_query=bank_query_agree / len(texts),
        http_round_trip_ms=http_ms, http_equal=http_ok,
        launches=measured, expected_launches=expected, card=smi)
    emit(row)
    ok = (card_metrics == eval_metrics
          and all(numpy_diff[k] <= EXTRACT_NUMPY_METRIC_ATOL[
              k.removeprefix("v2t_")] for k in numpy_diff)
          and all(int8_diff[k] <= INT8_METRIC_ATOL[k.removeprefix("v2t_")]
                  for k in int8_diff)
          and top5_ok == len(texts)
          and dev_agree >= DEVICE_TOP1_AGREEMENT * len(texts)
          and dev_score_err <= int8_bound
          and http_ok and measured == expected
          and runs["device"]["k1"] == expected["service_k1"]
          and failures == 0)
    if not ok:
        raise AssertionError(f"serve phase failed: {row}")

    # 4. --device_rank at index scale
    reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    index_scale(services["device"], texts, gen, smi)
    add_counts()
    del services, host, ev
    torch.cuda.empty_cache()
    return counts



# ---------------------------------------------------------------------------
# phase ddp: data parallelism over ranks and train-state checkpoints
# ---------------------------------------------------------------------------

DDP_STEPS = 2
DDP_SPAWN_TIMEOUT_S = 420
# the fp32 check: ViT-B/32's widths at 2 layers a tower, 16 clips in 2
# micro-batches (4 rows a rank each), 1024 negatives
DDP_FP32_BATCH = 16
DDP_FP32_ATOL = 1e-5
DDP_FP32_REASON = (
    "fp32 with TF32 off: world 2 sums two partial gradients in one "
    "all-reduce and takes the BatchNorm sums over ranks, where world 1 sums "
    "every row at once; the last fp32 bits differ, and an Adam step turns "
    "that into at most a few ulps of lr. Losses, parameters and queues "
    "within 1e-5 absolute; the grad norm (~220, a square root of a sum over "
    "every gradient) within 1e-5 of itself, as fp32 sums of that size keep "
    "~7 digits")
DDP_BF16_LOSS_ATOL = TRAIN_LOSS_ON_OFF_ATOL
DDP_BF16_GRAD_REL = 0.05
DDP_BF16_PARAM_ATOL = 8e-4       # 8 lr: one update, its sign flipped
DDP_BF16_QUEUE_ATOL = 0.05
DDP_BF16_REASON = (
    "bf16 compute: each rank runs micro-batches of 32 clips where world 1 "
    "runs 64, so the products tile and round otherwise (bf16 keeps 8 bits; "
    "phase train's kernel-on-vs-off losses differ by up to 0.1 the same "
    "way); the parameters have taken one update (step 0's is multiplied by "
    "0), BertAdam's first, about 4 lr a weight, so a near-zero gradient "
    "whose sign differs moves a weight by at most 8 lr = 8e-4; the queues "
    "hold unit keys from the bf16 key towers")
RESUME_CLIPS = 128            # the resume runs' epoch-end eval


def ddp_args(**kw):
    base = dict(tp_size=1, sp_size=1, dp_size=0, dcn_dp_size=1,
                multihost=False)
    return argparse.Namespace(**dict(base, **kw))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


DDP_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
           "MASTER_ADDR", "MASTER_PORT")


def ddp_env(rank, world, port, local_rank):
    return dict(RANK=str(rank), LOCAL_RANK=str(local_rank),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _cpu_state(sd):
    return {k: v.detach().float().cpu() for k, v in sd.items()}


def max_diff(got, want):
    """The largest |got - want| over matching tensors (on got's device)."""
    worst = 0.0
    for k, ref in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        t = got[k]
        worst = max(worst, float((t.detach().float()
                                  - ref.detach().to(t.device).float()
                                  ).abs().max()))
    return worst


def ddp_finetune(seed, fp32=False, host=None, host_dir=None):
    """Phase ddp's fine-tune steps on this process's rank (or alone
    without a process group): the ViT-B/32 BirdModel from the seed (fp32:
    its widths at 2 layers a tower), BertAdam, DDP_STEPS steps of phase
    train's global batch (256 clips in 4 micro-batches, or 16 in 2), this
    rank's rows. Returns per-step loss, grad norm and ms, the launches,
    the peak memory and the state."""
    arch = ClipArch.by_name("ViT-B/32")
    if fp32:
        arch = dataclasses.replace(arch, vision_layers=2,
                                   transformer_layers=2)
        cross = CrossConfig(temporal_hidden_layers=2)
        task = TaskConfig(seed=seed, compute_dtype="float32",
                          batch_size=DDP_FP32_BATCH,
                          gradient_accumulation_steps=2)
    else:
        cross, task = CrossConfig(), train_task(seed)
    if host is None and host_dir and not fp32:
        host = {k: np.load(os.path.join(host_dir, f"{k}.npy"), mmap_mode="r")
                for k in ("query_ids", "query_mask", "video")}
    if host is None:
        host = next(iter(SyntheticClips(
            task.batch_size, task.batch_size, task.max_frames,
            arch.image_resolution, task.max_words, seed + 3)))
    rows = rank_rows(task.batch_size, task.gradient_accumulation_steps,
                     distributed.rank(), distributed.world_size())
    model = build_model(task, cross, arch=arch)
    distributed.broadcast_module(model)
    state = FinetuneState(model, runner._optimizer(task, model, 10))
    step = make_finetune_step(cross, n_accum=task.gradient_accumulation_steps)
    batch = runner.prepare_finetune_batch(
        {k: v[rows] for k, v in host.items()}, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = []
    for _ in range(DDP_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out.append(dict(loss=float(m["loss"]),
                        grad_norm=float(m["grad_norm"]),
                        step_ms=(time.perf_counter() - t0) * 1e3))
    return dict(steps=out, launches=launch_counts(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                state=state, host=host)


def ddp_pretrain(seed, fp32=False):
    """Phase ddp's pretrain steps on this process's rank: the
    BirdPretrainModel from the seed (fp32: ViT-B/32's widths at 2 layers a
    tower), 1024 negatives, DDP_STEPS steps of 256 clips in 4
    micro-batches (16 in 2) of synthetic uint8 frames at 256, augmented
    with the global batch's draws at this rank's rows."""
    tok = ClipTokenizer()
    arch = ClipArch.by_name("ViT-B/32")
    if fp32:
        arch = dataclasses.replace(arch, vision_layers=2,
                                   transformer_layers=2)
        cross = CrossConfig(temporal_hidden_layers=2)
        task = pretrain_task(seed, compute_dtype="float32").replace(
            batch_size=DDP_FP32_BATCH, gradient_accumulation_steps=2)
    else:
        cross, task = CrossConfig(), pretrain_task(seed)
    b, f, n_accum = task.batch_size, task.max_frames, \
        task.gradient_accumulation_steps
    model = build_model(task, cross, arch=arch, pretrain=True,
                        vocab_size=tok.vocab_size)
    state = runner.pretrain_state(task, model, 10)
    for module in (state.model, state.towers):
        distributed.broadcast_module(module)
    distributed.broadcast_([getattr(state.queues, n)
                            for n in MoCoQueues.NAMES])
    step_fn = make_pretrain_step(
        cross, tok.mask_token_id, tok.pad_token_id, tok.cls_token_id,
        temperature=task.contrast_temperature,
        momentum=task.contrast_momentum, n_accum=n_accum)
    rows = rank_rows(b, n_accum, distributed.rank(),
                     distributed.world_size())
    positions = torch.from_numpy(
        (rows[:, None] * f + np.arange(f)).reshape(-1)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    frames = torch.randint(0, 256, (b * f, AUG, AUG, 3), dtype=torch.uint8,
                           device="cuda", generator=gen)[positions]
    titles = torch.from_numpy(pretrain_titles(b, task.max_words, seed)[
        rows]).cuda().long()
    res = arch.image_resolution
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = []
    for s in range(DDP_STEPS):
        t0 = time.perf_counter()
        video = image_ops.simclr_augment(
            runner.stream(seed, runner.AUG_STREAM, s, "cuda"), frames,
            out=res, positions=positions, total=b * f).view(
            len(rows), f, res, res, 3)
        state, m = step_fn(state, {"video": video, "title_ids": titles},
                           runner.stream(seed, runner.STEP_STREAM, s,
                                         "cuda"))
        torch.cuda.synchronize()
        out.append(dict({k: float(v) for k, v in m.items()},
                        ptr=state.queues.ptr,
                        step_ms=(time.perf_counter() - t0) * 1e3))
    return dict(steps=out, launches=launch_counts(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                state=state)


def _pretrain_tensors(state):
    q = state.queues
    return dict(model=state.model.state_dict(),
                towers=state.towers.state_dict(),
                queues={n: getattr(q, n) for n in MoCoQueues.NAMES})


def _worker_compare(kind, run, ref_path):
    """This rank's run against world 1's saved tensors."""
    ref = torch.load(ref_path, map_location="cpu", weights_only=True)
    row = dict(steps=run["steps"], launches=run["launches"],
               max_memory_allocated=run["max_memory_allocated"])
    if kind == "finetune":
        row["param_max_abs_diff"] = max_diff(
            dict(run["state"].model.named_parameters()), ref["params"])
    else:
        got = _pretrain_tensors(run["state"])
        for part in ("model", "towers", "queues"):
            row[f"{part}_max_abs_diff"] = max_diff(got[part], ref[part])
    return row


def ddp_worker(spec_path):
    """One rank of phase ddp's groups (``chip_smoke.py --ddp_worker
    SPEC``): join the group the environment names over the spec's
    backend, run the spec's scenarios, write what they give."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    world = int(os.environ["WORLD_SIZE"])
    device, _ = distributed.init_distributed(ddp_args(dp_size=world),
                                             device, spec["backend"])
    seed = spec["seed"]
    out = dict(rank=distributed.rank(), device=str(device),
               backend=spec["backend"], world=distributed.world_size())
    for name in spec["scenarios"]:
        t0 = time.perf_counter()
        if name == "eval":
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            metrics = runner.main(cli.get_args(argv=spec["eval_argv"]),
                                  device=device)
            out[name] = dict(metrics=metrics, launches=launch_counts(),
                             max_memory_allocated=(
                                 torch.cuda.max_memory_allocated()))
        else:
            kind, fp32 = name.split("_")[0], name.endswith("fp32")
            kw = dict(host_dir=spec["host_dir"]) if kind == "finetune" else {}
            run = (ddp_finetune if kind == "finetune" else ddp_pretrain)(
                seed, fp32=fp32, **kw)
            out[name] = _worker_compare(kind, run, spec["refs"][name])
            del run
        out[name]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    reset_attention_counts()
    out["head_dim_launches"] = HEAD_DIM_LAUNCHES[PHASE[0]]
    with open(spec["out"] % distributed.rank(), "w") as fh:
        json.dump(out, fh)
    distributed.shutdown()


class DdpGroup:
    """``world`` ranks of this script's :func:`ddp_worker` on
    ``local_ranks``' cards, started at construction; :meth:`results`
    waits (at most DDP_SPAWN_TIMEOUT_S from the start) and kills every
    rank on failure or timeout."""

    def __init__(self, tmp, name, world, backend, scenarios, local_ranks,
                 **spec):
        self.name, self.world = name, world
        self.out = os.path.join(tmp, f"{name}_rank%d.json")
        path = os.path.join(tmp, f"{name}_spec.json")
        with open(path, "w") as fh:
            json.dump(dict(spec, backend=backend, scenarios=scenarios,
                           out=self.out), fh)
        port = free_port()
        env = {k: v for k, v in os.environ.items() if k not in DDP_ENV}
        self.procs, self.logs = [], []
        self.deadline = time.monotonic() + DDP_SPAWN_TIMEOUT_S
        for r in range(world):
            log = open(os.path.join(tmp, f"{name}_rank{r}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp_worker",
                 path],
                env=dict(env, **ddp_env(r, world, port, local_ranks[r])),
                stdout=log, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__))))

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
            for p in self.procs:
                p.wait(timeout=30)
        tails = []
        for r, log in enumerate(self.logs):
            log.seek(0)
            tails.append(f"rank {r} rc={self.procs[r].returncode}:\n"
                         + log.read()[-4000:])
            log.close()
        if any(p.returncode for p in self.procs):
            raise AssertionError(f"ddp group {self.name} failed:\n"
                                 + "\n".join(tails))
        results = []
        for r in range(self.world):
            with open(self.out % r) as fh:
                results.append(json.load(fh))
            for kernel, by_d in results[-1].pop("head_dim_launches").items():
                add_head_dim_launches("ddp_ranks", kernel, by_d)
        return results


def checkpoint_times(state, root):
    """The fine-tune state's save (sync; async: until ``save`` returns
    and until the write is done) and its resume (load and restore), by the
    host clock, on the full-width state."""
    from hmmc_tpu_torch.train import state_io

    d = os.path.join(root, "ddp_ckpt")
    meta = dict(epoch=0, batch_in_epoch=DDP_STEPS, steps_per_epoch=10,
                epoch_end=False)
    t0 = time.perf_counter()
    payload = state_io.snapshot(state)
    snap_ms = (time.perf_counter() - t0) * 1e3
    sync = state_io.CheckpointWriter(d)
    t0 = time.perf_counter()
    sync.save(state.step, payload, meta)
    sync_ms = snap_ms + (time.perf_counter() - t0) * 1e3
    del payload
    nbytes = os.path.getsize(state_io.state_path(d, state.step))
    writer = state_io.CheckpointWriter(d, async_save=True)
    t0 = time.perf_counter()
    writer.save(state.step + 1, state_io.snapshot(state), meta)
    async_return_ms = (time.perf_counter() - t0) * 1e3
    writer.close()
    async_done_ms = (time.perf_counter() - t0) * 1e3
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    t0 = time.perf_counter()
    state_io.restore(state, state_io.load_state(d, state.step))
    torch.cuda.synchronize()
    resume_ms = (time.perf_counter() - t0) * 1e3
    equal = all(torch.equal(p, before[n]) for n, p in
                state.model.named_parameters())
    shutil.rmtree(d)
    return dict(state_bytes=nbytes, snapshot_ms=snap_ms, save_sync_ms=sync_ms,
                save_async_return_ms=async_return_ms,
                save_async_done_ms=async_done_ms, resume_ms=resume_ms,
                restored_equal=equal)


def resume_layout(root):
    """Phase cli's FramePack and train split, with the first RESUME_CLIPS
    test clips (the resume runs' epoch-end eval)."""
    data = os.path.join(root, "ddp_data")
    m = os.path.join(data, "msrvtt")
    os.makedirs(m)
    os.symlink(os.path.join(root, "frames.fpk"),
               os.path.join(data, "frames.fpk"))
    for name in ("MSRVTT_train.9k.csv", "MSRVTT_data.json"):
        os.symlink(os.path.join(root, "msrvtt", name), os.path.join(m, name))
    with open(os.path.join(root, "msrvtt", "MSRVTT_JSFUSION_test.1k.csv")) \
            as src:
        lines = src.readlines()[:RESUME_CLIPS + 1]
    with open(os.path.join(m, "MSRVTT_JSFUSION_test.1k.csv"), "w") as dst:
        dst.writelines(lines)
    return data


def resume_check(root, seed, smi):
    """(v): through the CLI in this process, the fine-tune (2 steps of
    256, then the eval of RESUME_CLIPS clips) uncut twice, then cut by a
    SIGTERM after step 1 with ``--save_steps 1``, then ``--resume``d. The
    resumed run's parameters, losses and metrics against the uncut run's,
    within what the rerun of the uncut run gives."""
    import signal

    data = resume_layout(root)
    runs, walls = {}, {}
    make = runner.make_finetune_step

    def signalling(*a, **kw):
        fn = make(*a, **kw)

        def step(state, batch):
            state, metrics = fn(state, batch)
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, metrics

        return step

    reset_launch_counts()
    for name, extra in (("uncut", []), ("rerun", []),
                        ("cut", ["--save_steps", "1"]),
                        ("resumed", ["--resume"])):
        out = os.path.join(root, "ddp_resume",
                           "cut" if name in ("cut", "resumed") else name)
        if name == "cut":
            runner.make_finetune_step = signalling
        t0 = time.perf_counter()
        try:
            runs[name] = runner.main(cli.get_args(argv=cli_argv(
                data, out, ["--seed", str(seed), *extra])))
        finally:
            runner.make_finetune_step = make
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    counts = launch_counts()

    def params(run):
        return dict(run.state.model.named_parameters())

    def losses(run):
        return [r["loss"] for r in run.displayed]

    uncut = runs["uncut"]
    rerun_diff = max_diff(params(runs["rerun"]), params(uncut))
    resumed_diff = max_diff(params(runs["resumed"]), params(uncut))
    rerun_loss = max(abs(a - b) for a, b in zip(losses(runs["rerun"]),
                                                losses(uncut)))
    resumed_loss = abs(losses(runs["resumed"])[-1] - losses(uncut)[-1])
    row = dict(phase="ddp_resume", what="CLI fine-tune, 2 steps of 256 in 4 "
               f"micro-batches then the eval of {RESUME_CLIPS} clips: uncut, "
               "rerun, cut by SIGTERM after step 1 (--save_steps 1), "
               "--resume", steps=[r.state.step for r in runs.values()],
               displayed_steps={k: [r["step"] for r in v.displayed]
                                for k, v in runs.items()},
               losses={k: losses(v) for k, v in runs.items()},
               metrics={k: v.best_metrics for k, v in runs.items()},
               param_max_abs_diff_rerun=rerun_diff,
               param_max_abs_diff_resumed=resumed_diff,
               last_loss_abs_diff_rerun=rerun_loss,
               last_loss_abs_diff_resumed=resumed_loss,
               tolerance="the rerun's", wall_s=walls, launches=counts,
               card=smi)
    emit(row)
    ok = (runs["cut"].state.step == 1 and runs["resumed"].state.step == 2
          and [r["step"] for r in runs["resumed"].displayed] == [2]
          and resumed_diff <= rerun_diff and resumed_loss <= rerun_loss
          and runs["resumed"].best_metrics == uncut.best_metrics)
    shutil.rmtree(os.path.join(root, "ddp_resume"))
    shutil.rmtree(data)
    if not ok:
        raise AssertionError(f"ddp resume check failed: {row}")
    return counts


def ddp_phase(root, seed, smi, train_ref, eval_ref):
    """Phase ddp: (i) world 1 over NCCL through init_distributed, against
    the same steps without a process group and phase train's first two;
    the state's save and resume times; (ii) world 2 on the one card over
    gloo (fine-tune, pretrain, both again in fp32 at 2 layers a tower) and
    (iv) the sharded eval of phase cli's 1000 clips, in one 2-rank group,
    while this process runs (v), a CLI run cut by SIGTERM and resumed;
    (iii) world 2 over NCCL where a second card exists. Returns the
    launches by path."""
    tmp = os.path.join(root, "ddp")
    os.makedirs(tmp)
    refs, launches = {}, {}

    # (i) without a group, then world 1 over NCCL
    alone = ddp_finetune(seed)
    host = alone.pop("host")
    host_dir = os.path.join(tmp, "host_batch")
    os.makedirs(host_dir)
    for k, v in host.items():
        np.save(os.path.join(host_dir, f"{k}.npy"), v)
    alone_params = _cpu_state(dict(alone.pop("state").model
                                   .named_parameters()))
    torch.cuda.empty_cache()
    os.environ.update(ddp_env(0, 1, free_port(), 0))
    try:
        device, created = distributed.init_distributed(ddp_args(), "cuda")
        backend = torch.distributed.get_backend()
        one = ddp_finetune(seed, host=host)
        del host
        state = one.pop("state")
        one.pop("host")
        param_diff = max_diff(dict(state.model.named_parameters()),
                              alone_params)
        # the step's one added piece of device work: the flat all-reduce
        # of its gradients (one rank: the sum leaves them as they are)
        grads = [p.grad for p in state.model.parameters()
                 if p.grad is not None]
        grad_reduce_ms = cuda_ms(
            lambda: distributed.all_reduce_grads(grads), iters=5, warmup=1)
        del grads
        torch.save({"params": _cpu_state(dict(
            state.model.named_parameters()))},
            os.path.join(tmp, "ref_finetune.pt"))
        refs["finetune"] = os.path.join(tmp, "ref_finetune.pt")
        times = checkpoint_times(state, root)
        del state, alone_params
        torch.cuda.empty_cache()
        row = dict(phase="ddp_world1", backend=backend, device=str(device),
                   what="2 fine-tune steps, ViT-B/32, batch 256 in 4 "
                        "micro-batches, world 1 over NCCL against the same "
                        "steps without a process group",
                   nccl=one["steps"], no_group=alone["steps"],
                   phase_train_first_steps=train_ref,
                   param_max_abs_diff_vs_no_group=param_diff,
                   step_ms_nccl=[s["step_ms"] for s in one["steps"]],
                   step_ms_no_group=[s["step_ms"] for s in alone["steps"]],
                   grad_all_reduce_ms=grad_reduce_ms,
                   launches=one["launches"],
                   max_memory_allocated=one["max_memory_allocated"],
                   checkpoint=times, card=smi)
        emit(row)
        same = all(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
                   for a, b in zip(one["steps"], alone["steps"]))
        as_train = all(abs(s["loss"] - t["loss"]) <= 1e-6 * abs(t["loss"])
                       for s, t in zip(one["steps"], train_ref))
        if not (created and backend == "nccl" and same and as_train
                and param_diff == 0.0 and times["restored_equal"]):
            raise AssertionError(f"ddp world 1: {row}")
        launches["ddp_world1_finetune"] = one["launches"]
        for name, fp32 in (("pretrain", False), ("finetune_fp32", True),
                           ("pretrain_fp32", True)):
            kind = name.split("_")[0]
            run = (ddp_finetune if kind == "finetune" else ddp_pretrain)(
                seed, fp32=fp32)
            path = os.path.join(tmp, f"ref_{name}.pt")
            if kind == "finetune":
                torch.save({"params": _cpu_state(dict(
                    run["state"].model.named_parameters()))}, path)
            else:
                torch.save({k: _cpu_state(v) for k, v in
                            _pretrain_tensors(run["state"]).items()}, path)
            refs[name] = path
            run.pop("state")
            run.pop("host", None)
            refs[name + "_run"] = run
            launches[f"ddp_world1_{name}"] = run["launches"]
            torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
        for k in DDP_ENV:
            os.environ.pop(k, None)
    refs["finetune_run"] = one

    # (ii) + (iv): two ranks on the one card over gloo, while this process
    # takes (v) on the same card (neither is timed as a speed figure)
    scenarios = ["finetune", "pretrain", "finetune_fp32", "pretrain_fp32",
                 "eval"]
    eval_argv = cli_argv(root, os.path.join(root, "ddp_eval"),
                         ["--seed", str(seed), "--init_model",
                          eval_ref["ckpt"]])[1:]
    t0 = time.perf_counter()
    group = DdpGroup(tmp, "gloo", 2, "gloo", scenarios, [0, 0], seed=seed,
                     refs={k: v for k, v in refs.items()
                           if not k.endswith("_run")},
                     eval_argv=eval_argv, host_dir=host_dir)
    # (v) cut and resumed through the CLI
    launches["ddp_resume_cli"] = resume_check(root, seed, smi)
    two = group.results()
    group_s = time.perf_counter() - t0
    problems = []
    for name in scenarios[:-1]:
        ref_steps = refs[name + "_run"]["steps"]
        fp32 = name.endswith("fp32")
        for r in two:
            got = r[name]
            for a, b in zip(got["steps"], ref_steps):
                for k in ("loss", "loss_FAM", "loss_VTM", "loss_FTM",
                          "loss_MLM"):
                    if k in b and abs(a[k] - b[k]) > (
                            DDP_FP32_ATOL if fp32 else DDP_BF16_LOSS_ATOL):
                        problems.append((name, r["rank"], k, a[k], b[k]))
                g_tol = (DDP_FP32_ATOL if fp32 else DDP_BF16_GRAD_REL
                         ) * b["grad_norm"]
                if abs(a["grad_norm"] - b["grad_norm"]) > g_tol:
                    problems.append((name, r["rank"], "grad_norm"))
                if a.get("ptr") != b.get("ptr"):
                    problems.append((name, r["rank"], "ptr"))
            for k, v in got.items():
                if k.endswith("_max_abs_diff"):
                    tol = (DDP_FP32_ATOL if fp32 else DDP_BF16_QUEUE_ATOL
                           if k.startswith("queues") else DDP_BF16_PARAM_ATOL)
                    if v > tol:
                        problems.append((name, r["rank"], k, v, tol))
        launches[f"ddp_world2_gloo_{name}"] = [r[name]["launches"]
                                               for r in two]
    eval_rows = [r["eval"] for r in two]
    launches["ddp_world2_gloo_eval"] = [e["launches"] for e in eval_rows]
    eval_equal = all(e["metrics"] == eval_ref["eval_metrics"]
                     for e in eval_rows)
    row = dict(phase="ddp_world2_gloo", what="2 ranks on one card over gloo "
               "(a correctness run: gloo copies through the host, and phase "
               "ddp's resume check shares the card meanwhile, so its times "
               "are not a speed figure)", group_s=group_s,
               world1={k: refs[k + "_run"]["steps"] for k in scenarios[:-1]},
               ranks=two, eval_world1_metrics=eval_ref["eval_metrics"],
               eval_equal=eval_equal, fp32_atol=DDP_FP32_ATOL,
               fp32_reason=DDP_FP32_REASON,
               bf16_tolerances=dict(loss=DDP_BF16_LOSS_ATOL,
                                    grad_norm_rel=DDP_BF16_GRAD_REL,
                                    params=DDP_BF16_PARAM_ATOL,
                                    queues=DDP_BF16_QUEUE_ATOL),
               bf16_reason=DDP_BF16_REASON, problems=problems, card=smi)
    emit(row)
    if problems or not eval_equal:
        raise AssertionError(f"ddp world 2: {problems}, eval equal "
                             f"{eval_equal}")

    # (iii) two cards over NCCL
    if torch.cuda.device_count() >= 2:
        nccl = DdpGroup(tmp, "nccl", 2, "nccl", ["finetune"], [0, 1],
                        seed=seed, refs={"finetune": refs["finetune"]},
                        host_dir=host_dir).results()
        emit(dict(phase="ddp_world2_nccl", ranks=nccl, card=smi))
        launches["ddp_world2_nccl_finetune"] = [r["finetune"]["launches"]
                                                for r in nccl]
        for r in nccl:
            if r["finetune"]["param_max_abs_diff"] > DDP_BF16_PARAM_ATOL:
                raise AssertionError(f"ddp world 2 over NCCL: {r}")
    else:
        emit(dict(phase="ddp_world2_nccl", run=False,
                  reason=f"{torch.cuda.device_count()} card: NCCL takes "
                         "one rank a card", card=smi))

    shutil.rmtree(tmp)
    return launches


# ---------------------------------------------------------------------------
# phase towers: ViT-B/16, ViT-L/14 and ViT-L/14@336px (L = 197, 257, 577)
# through the tiled bodies of K1 and K2
# ---------------------------------------------------------------------------

# (tower, clips of 12 frames a micro-batch): the micro-batch sets the K1 /
# K2 sites' B * H; ~0.5 GB of bf16 activations a 336-px frame over 24
# layers gives 4 clips at ViT-L/14@336px
TOWERS = (("ViT-B/16", 16), ("ViT-L/14", 4), ("ViT-L/14@336px", 4))
TOWER_CLI = "ViT-L/14@336px"
TOWER_STEPS = 2
TOWER_N_ACCUM = 2
TOWER_TRAIN_VIDEOS = 8      # 2 captions each: 16 samples, 2 steps of 8
TOWER_QUERIES = 8           # served from the 768-wide bank


def tower_cross(name):
    """cross-base for tower ``name`` as published: the temporal transformer
    is as wide as the tower's embed_dim with cross-base's 8 heads (head_dim
    96 at ViT-L/14's 768, 64 at ViT-B/16's 512)."""
    arch = ClipArch.by_name(name)
    return dataclasses.replace(CrossConfig(), pretrained_clip_name=name,
                               temporal_hidden_size=arch.embed_dim)


def tower_launch_counts():
    """K1's and K2's launches by body and by head_dim ("k1_d96")."""
    out = {}
    for k, fn in (("k1", fused_attention), ("k2", fused_attention_backward)):
        for body in ("short", "tiled"):
            out[f"{k}_{body}"] = getattr(fn, f"{body}_launches")
        for d, n in fn.head_dim_launches.items():
            out[f"{k}_d{d}"] = n
    return out


def tower_head_dims(arch, cross):
    """(vision, text, temporal) head_dims of a tower under ``cross``."""
    return (arch.vision_width // arch.vision_heads,
            arch.transformer_width // arch.transformer_heads,
            cross.temporal_hidden_size // cross.temporal_attention_heads)


def by_head_dim(kernel, arch, cross, vision, text, temporal):
    """{"k1_d64": n, ...}: the predicted launches of ``kernel`` by head_dim
    for ``vision``, ``text`` and ``temporal`` blocks."""
    out = {f"{kernel}_d{d}": 0 for d in HEAD_DIMS}
    for d, n in zip(tower_head_dims(arch, cross), (vision, text, temporal)):
        out[f"{kernel}_d{d}"] += n
    return out


def tower_kernels(gen):
    """K1 and K2 against their plain versions at each tower's ViT site
    (its micro-batch's frames x heads, L = grid^2 + 1), bf16 and fp32.
    Run beside phase 3's kernel rows, early: the profiler's device times
    read "not measured" at the end of a run that has opened many profiler
    sessions."""
    rows, bwd_rows = [], []
    for name, clips in TOWERS:
        arch = ClipArch.by_name(name)
        b, h, l = clips * 12, arch.vision_heads, arch.grid_size ** 2 + 1
        for dtype in (torch.bfloat16, torch.float32):
            fast = dtype == torch.bfloat16
            rows.append(check_attention(
                f"tower {name}", b, h, l, False, dtype, gen,
                iters=20 if fast else 3, host_calls=50 if fast else 5))
            bwd_rows.append(check_attention_backward(
                f"tower {name}", b, h, l, False, dtype, gen,
                iters=20 if fast else 3, host_calls=50 if fast else 5))
    return rows, bwd_rows


def tower_step(name, clips, seed, smi):
    """One bf16 fine-tune step at full width (seeded weights, synthetic
    clips): TOWER_N_ACCUM micro-batches of ``clips``; launches per body
    against the block structure, finite loss, then a warm step's device ms
    and the peak memory."""
    arch, cross = ClipArch.by_name(name), tower_cross(name)
    task = TaskConfig(seed=seed, batch_size=clips * TOWER_N_ACCUM,
                      gradient_accumulation_steps=TOWER_N_ACCUM)
    model = build_model(task, cross, arch=arch)
    state = FinetuneState(model, build_optimizer(
        model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
        coef_lr=task.coef_lr, weight_decay=task.weight_decay,
        warmup_proportion=task.warmup_proportion, t_total=4))
    step = make_finetune_step(cross, n_accum=TOWER_N_ACCUM)
    host = next(iter(SyntheticClips(task.batch_size, task.batch_size,
                                    task.max_frames, arch.image_resolution,
                                    task.max_words, seed)))
    batch = runner.prepare_finetune_batch(host, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    first_s = time.perf_counter() - t0
    counts = tower_launch_counts()
    warm_ms = cuda_ms(lambda: step(state, batch), iters=1, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    layers = arch.vision_layers + arch.transformer_layers \
        + cross.temporal_hidden_layers
    expected = dict(k1_short=(layers - arch.vision_layers) * TOWER_N_ACCUM,
                    k1_tiled=arch.vision_layers * TOWER_N_ACCUM)
    expected.update(k2_short=expected["k1_short"],
                    k2_tiled=expected["k1_tiled"])
    for kernel in ("k1", "k2"):
        expected.update(by_head_dim(
            kernel, arch, cross, arch.vision_layers * TOWER_N_ACCUM,
            arch.transformer_layers * TOWER_N_ACCUM,
            cross.temporal_hidden_layers * TOWER_N_ACCUM))
    row = dict(phase="towers", what=f"one fine-tune step, {name}",
               seq_len=arch.grid_size ** 2 + 1,
               resolution=arch.image_resolution,
               clips=task.batch_size, n_accum=TOWER_N_ACCUM,
               temporal_heads=cross.temporal_attention_heads,
               head_dims=dict(zip(("vision", "text", "temporal"),
                                  tower_head_dims(arch, cross))), loss=loss,
               grad_norm=float(metrics["grad_norm"]),
               finite=math.isfinite(loss), first_step_s=first_s,
               warm_step_device_ms=warm_ms, max_memory_allocated=peak,
               launches=counts, expected_launches=expected, card=smi)
    emit(row)
    if not (row["finite"] and counts == expected):
        raise AssertionError(f"tower step failed: {row}")
    del model, state, batch
    torch.cuda.empty_cache()
    return counts, expected


def tower_cli_phase(root, seed, smi):
    """ViT-L/14@336px through the CLI: a seeded OpenAI-named state dict of
    its full shapes as --clip_model (the arch read back from the shapes),
    --do_train of TOWER_STEPS steps of 8 clips in micro-batches of 4 over a
    FramePack cycled from the fixture (12 frames decoded by nvJPEG + R1 at
    336), the epoch-end eval of TOWER_EVAL_CLIPS clips; then --do_eval
    --init_model of the saved file (profiled; the same metrics), and
    --do_extract of a 768-wide bank that the retrieval service answers
    queries from. Launches per body against the block structure."""
    arch, cross = ClipArch.by_name(TOWER_CLI), tower_cross(TOWER_CLI)
    os.makedirs(root)
    cross_path = os.path.join(root, "cross-vit-l14-336.json")
    with open(cross_path, "w") as f:
        json.dump(dataclasses.asdict(cross), f)
    layout = build_cli_layout(root, seed, TOWER_EVAL_CLIPS,
                              TOWER_TRAIN_VIDEOS)
    t0 = time.perf_counter()
    clip_path = os.path.join(root, "ViT-L-14-336px.pt")
    clip_sd = clip_archive(clip_path, seed, TOWER_CLI, script=False)
    archive_s = time.perf_counter() - t0
    from_shapes = ClipArch.from_state_dict(clip_sd) == arch
    del clip_sd
    out = os.path.join(root, "out")
    argv = ["--do_train", "--do_eval", "--dataset", "msrvtt",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--data_dir", root, "--output_dir", out,
            "--batch_size", str(TOWER_TRAIN_VIDEOS),
            "--gradient_accumulation_steps", str(TOWER_N_ACCUM),
            "--batch_size_val", str(TOWER_EVAL_CLIPS), "--epochs", "1",
            "--n_display", "1", "--num_thread_reader", "2",
            "--seed", str(seed), "--cross_model", cross_path]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe() as train_probe:
        run = runner.main(cli.get_args(argv=argv + ["--clip_model",
                                                    clip_path]))
    train_s = time.perf_counter() - t0
    train_counts = dict(launch_counts(), **tower_launch_counts())
    train_peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in run.displayed]
    step_s = [r["step_s"] for r in run.displayed]
    ckpt = os.path.join(out, "pytorch_model.bin.0")
    task = cli.to_task_config(cli.get_args(argv=argv))
    step_ms, _, _ = step_device_ms(run, cross, task, next(iter(SyntheticClips(
        TOWER_TRAIN_VIDEOS, TOWER_TRAIN_VIDEOS, task.max_frames,
        TOWER_RES, task.max_words, seed))), iters=2)
    del run
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe(profile=True) as eval_probe:
        metrics = runner.main(cli.get_args(argv=argv[1:] + [
            "--init_model", ckpt, "--output_dir",
            os.path.join(root, "out_eval")]))
    eval_s = time.perf_counter() - t0
    eval_counts = dict(launch_counts(), **tower_launch_counts())
    eval_peak = torch.cuda.max_memory_allocated()

    # --do_extract: a 768-wide bank, answered by the service
    reset_launch_counts()
    t0 = time.perf_counter()
    bank_path = runner.main(cli.get_args(argv=[
        "--do_extract"] + argv[2:] + ["--init_model", ckpt, "--output_dir",
                                      os.path.join(root, "out_extract")]))
    extract_s = time.perf_counter() - t0
    extract_counts = dict(launch_counts(), **tower_launch_counts())
    bank = dict(np.load(bank_path))
    from hmmc_tpu_torch import serve

    sargs = cli.get_args(argv=argv[1:] + ["--init_model", ckpt])
    sargs.features, sargs.device_rank = bank_path, False
    svc = serve.RetrievalService(sargs)
    captions = [" ".join(np.random.default_rng(seed + i).choice(WORDS, 8))
                for i in range(TOWER_QUERIES)]
    t0 = time.perf_counter()
    answers = [svc.search(c, topk=5) for c in captions]
    query_ms = (time.perf_counter() - t0) / TOWER_QUERIES * 1e3
    served = all(len(a["results"]) == 5 for a in answers)
    del svc
    torch.cuda.empty_cache()

    micro = TOWER_STEPS * TOWER_N_ACCUM
    blocks = math.ceil(TOWER_EVAL_CLIPS / 8)       # auto_video_block: 8
    text_blocks = math.ceil(TOWER_EVAL_CLIPS / 512)
    v, t, tmp = arch.vision_layers, arch.transformer_layers, \
        cross.temporal_hidden_layers
    eval_k1 = dict(k1_tiled=v * blocks, k1_short=tmp * blocks
                   + t * text_blocks)
    eval_d = by_head_dim("k1", arch, cross, v * blocks, t * text_blocks,
                         tmp * blocks)
    expected_eval = dict(k1=sum(eval_k1.values()), k2=0, r1=1, r2=0,
                         decoder=1, k2_short=0, k2_tiled=0, **eval_k1,
                         **eval_d, **by_head_dim("k2", arch, cross, 0, 0, 0))
    expected_train = dict(
        k1=(v + t + tmp) * micro + expected_eval["k1"],
        k2=(v + t + tmp) * micro, r1=TOWER_STEPS + 1, r2=0,
        decoder=TOWER_STEPS + 1,
        k1_tiled=v * micro + eval_k1["k1_tiled"],
        k1_short=(t + tmp) * micro + eval_k1["k1_short"],
        k2_tiled=v * micro, k2_short=(t + tmp) * micro,
        **by_head_dim("k2", arch, cross, v * micro, t * micro, tmp * micro))
    for key, n in by_head_dim("k1", arch, cross, v * micro, t * micro,
                              tmp * micro).items():
        expected_train[key] = n + eval_d[key]
    ev_call = eval_probe.calls[0]
    row = dict(
        phase="towers", what=f"{TOWER_CLI} BirdModel through the CLI",
        seq_len=arch.grid_size ** 2 + 1, resolution=TOWER_RES,
        vision=[arch.vision_width, v, arch.vision_heads],
        embed_dim=arch.embed_dim,
        temporal_heads=cross.temporal_attention_heads,
        head_dims=dict(zip(("vision", "text", "temporal"),
                           tower_head_dims(arch, cross))),
        clip_model_bytes=os.path.getsize(clip_path), archive_s=archive_s,
        arch_from_shapes_equal=from_shapes,
        train_clips=TOWER_TRAIN_VIDEOS * 2, steps=TOWER_STEPS,
        micro_batch_clips=TOWER_TRAIN_VIDEOS // TOWER_N_ACCUM,
        losses=losses, finite=all(math.isfinite(x) for x in losses),
        step_s=step_s, train_run_s=train_s, eval_run_s=eval_s,
        extract_run_s=extract_s, step_device_ms=step_ms,
        epoch_metrics=train_probe.calls[0]["metrics"],
        reload_metrics=metrics,
        reload_equal=metrics == train_probe.calls[0]["metrics"],
        eval_clips=TOWER_EVAL_CLIPS, eval_video_blocks=blocks,
        eval_wall_ms=ev_call["wall_ms"],
        eval_device_busy_ms=ev_call["profile"]["device_busy_ms"],
        eval_device_idle_share=ev_call["profile"]["device_idle_share"],
        eval_device_ms_by_kind=ev_call["profile"]["device_ms_by_kind"],
        max_memory_allocated=dict(train=train_peak, eval=eval_peak),
        train_launches=train_counts, expected_train_launches=expected_train,
        eval_launches=eval_counts, expected_eval_launches=expected_eval,
        extract_launches=extract_counts,
        bank_shapes={k: list(a.shape) for k, a in bank.items()},
        served_queries=TOWER_QUERIES, served_ok=served,
        query_ms_host_ranking=query_ms,
        decode_failures=jpeg.decode_frames.decode_failures,
        layout_s=layout["seconds"], card=smi)
    return row, ckpt


def towers_phase(root, seed, smi):
    """Phase towers (its kernel rows are tower_kernels'); returns each
    path's launches by body and by head_dim, and their predictions."""
    steps = {name: tower_step(name, clips, seed, smi)
             for name, clips in TOWERS if name != TOWER_CLI}
    row, _ = tower_cli_phase(root, seed, smi)
    train = row["train_launches"]
    emit(row)
    bank_ok = row["bank_shapes"].get("video", [0, 0])[-1] == 768
    ok = (row["arch_from_shapes_equal"] and row["reload_equal"]
          and row["served_ok"] and bank_ok and row["decode_failures"] == 0
          and row["finite"] and train == row["expected_train_launches"]
          and row["eval_launches"] == row["expected_eval_launches"]
          and row["extract_launches"] == row["expected_eval_launches"]
          and all(math.isfinite(x) for x in row["epoch_metrics"].values()))
    if not ok:
        raise AssertionError(f"towers CLI run failed: {row}")
    # the geometry at 2 layers a tower in fp32, card against CPU: the
    # L/14@336px forward, and a ViT-L/14 fine-tune step's losses and every
    # gradient, cross-base's temporal heads (head_dim 96) through K1 and K2
    arch = dataclasses.replace(ClipArch.by_name(TOWER_CLI), vision_layers=2,
                               transformer_layers=2)
    cross = dataclasses.replace(tower_cross(TOWER_CLI),
                                temporal_hidden_layers=2)
    reference_check(TaskConfig(seed=seed), cross, arch, seed,
                    phase="towers_reference")
    arch = dataclasses.replace(ClipArch.by_name("ViT-L/14"), vision_layers=2,
                               transformer_layers=2)
    cross = dataclasses.replace(tower_cross("ViT-L/14"),
                                temporal_hidden_layers=2)
    reset_attention_counts()
    grad_reference_check(cross, arch, seed,
                         phase="towers_train_reference")
    at96 = dict(k1=fused_attention.head_dim_launches[96],
                k2=fused_attention_backward.head_dim_launches[96])
    emit(dict(phase="towers_train_reference_head_dim", head_dims=dict(
        zip(("vision", "text", "temporal"), tower_head_dims(arch, cross))),
        launches_at_head_dim_96=at96, card=smi))
    if not (at96["k1"] > 0 and at96["k2"] > 0):
        raise AssertionError(f"the L/14 cross-base check ran no K1 / K2 at "
                             f"head_dim 96: {at96}")
    paths = {f"towers_step_{n}": c for n, (c, _) in steps.items()}
    predicted = {f"towers_step_{n}": e for n, (_, e) in steps.items()}
    keys = [k for k in train if k.startswith(("k1_", "k2_"))]
    paths["towers_cli_l14_336"] = {
        k: train[k] + row["eval_launches"][k] + row["extract_launches"][k]
        for k in keys}
    predicted["towers_cli_l14_336"] = {
        k: (row["expected_train_launches"][k]
            + 2 * row["expected_eval_launches"][k]) for k in keys}
    return paths, predicted


# ---------------------------------------------------------------------------
# phase resnet: CLIP's ModifiedResNet towers
# ---------------------------------------------------------------------------

RN_RESOLUTIONS = (288, 384, 448)     # RN50x4, RN50x16, RN50x64
RN_BLOCK_FRAMES = 96                 # R1's timed block at those (8 clips)
RN_CLI = "RN50"
RN_CLI_STEPS = 2
RN_N_ACCUM = 2
RN_TRAIN_VIDEOS = 8         # 2 captions each: 16 samples, 2 steps of 8
RN_EVAL_CLIPS = 32
RN_QUERIES = 8              # served from the 1024-wide bank
# (tower, clips of 12 frames a micro-batch) for one bf16 step of RN_N_ACCUM
# micro-batches: the steps' rows read peaks of 16.5, 17.1, 45.1 and 57.4 GB
# on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md §5)
RN_STEPS = (("RN101", 16), ("RN50x4", 8), ("RN50x16", 8), ("RN50x64", 4))
RN_REF_LOSS_ATOL = 1e-4
RN_REF_GRAD_REL = 1e-3
RN_REF_STATS_ATOL = 1e-5
RN_REF_REASON = (
    "TF32 off: cuDNN's and the CPU's convolutions and the batch statistics "
    "sum in other orders; the running statistics are ~1 and move by a tenth "
    "of the batch's a micro-batch. The tower's gradients are held in fp64: "
    "at random weights the train-mode BatchNorm's backward cancels most of "
    "the gradient that reaches it (the attention pool nearly averages the "
    "grid, so the gradient is nearly constant over each channel), which "
    "magnifies fp32 rounding anywhere downstream: the tower's fp32 "
    "gradients are up to a few % of their max off their own fp64 values on "
    "either device (the CPU's own fp32 error is reported beside the card's)")


def rn_cross(name):
    """cross-base for ResNet ``name``: the temporal transformer as wide as
    its embed_dim with cross-base's 8 heads (head_dim 128 at RN50 and
    RN50x64, 64 at RN101, 80 at RN50x4, 96 at RN50x16)."""
    arch = ClipArch.by_name(name)
    return dataclasses.replace(CrossConfig(), pretrained_clip_name=name,
                               temporal_hidden_size=arch.embed_dim)


def rn_head_dims(arch, cross):
    """(text, temporal) head_dims of a ModifiedResNet model; its tower
    runs no K1 / K2 (the attention pool's one query takes the plain
    attention)."""
    return (arch.transformer_width // arch.transformer_heads,
            arch.embed_dim // cross.temporal_attention_heads)


def rn_launches(arch, cross, text, video, text_bwd=0, video_bwd=0):
    """The predicted K1 / K2 launches by body and head_dim of a
    ModifiedResNet model over ``text`` text-tower and ``video``
    visual-encoder forwards (and the backwards of as many): a launch a
    text layer (L = 32, causal) and a temporal layer (L = 12), all on the
    short bodies."""
    t, tmp = arch.transformer_layers, cross.temporal_hidden_layers
    d_text, d_temporal = rn_head_dims(arch, cross)
    out = {}
    for kernel, n_text, n_video in (("k1", text, video),
                                    ("k2", text_bwd, video_bwd)):
        out.update({f"{kernel}_short": t * n_text + tmp * n_video,
                    f"{kernel}_tiled": 0})
        out.update({f"{kernel}_d{d}": 0 for d in HEAD_DIMS})
        out[f"{kernel}_d{d_text}"] += t * n_text
        out[f"{kernel}_d{d_temporal}"] += tmp * n_video
    return out


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def rn_step(name, clips, seed, smi):
    """One bf16 fine-tune step at full width and resolution (seeded
    weights, synthetic clips, train-mode BatchNorm) in RN_N_ACCUM
    micro-batches of ``clips``, then an eval forward of the same clips
    (both encoders, running statistics): launches by body and head_dim
    against the prediction, finite outputs, the warm step's device ms, the
    forward's, and peak memory of each."""
    arch, cross = ClipArch.by_name(name), rn_cross(name)
    task = TaskConfig(seed=seed, batch_size=clips * RN_N_ACCUM,
                      gradient_accumulation_steps=RN_N_ACCUM)
    t0 = time.perf_counter()
    model = build_model(task, cross, arch=arch)
    build_s = time.perf_counter() - t0
    state = FinetuneState(model, build_optimizer(
        model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
        coef_lr=task.coef_lr, weight_decay=task.weight_decay,
        warmup_proportion=task.warmup_proportion, t_total=4))
    step = make_finetune_step(cross, n_accum=RN_N_ACCUM)
    host = next(iter(SyntheticClips(task.batch_size, task.batch_size,
                                    task.max_frames, arch.image_resolution,
                                    task.max_words, seed)))
    batch = runner.prepare_finetune_batch(host, "cuda",
                                          arch.image_resolution)
    stats0 = model.visual_encoder.visual.bn1.running_var.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    first_s = time.perf_counter() - t0
    step_counts = tower_launch_counts()
    moved = not torch.equal(stats0,
                            model.visual_encoder.visual.bn1.running_var)
    warm_ms = cuda_ms(lambda: step(state, batch), iters=1, warmup=1)
    train_peak = torch.cuda.max_memory_allocated()
    state.optimizer.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    reset_attention_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        v, f = model.encode_video(batch["video"])
        q = model.encode_text(batch["query_ids"])
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
    eval_counts = tower_launch_counts()
    eval_peak = torch.cuda.max_memory_allocated()
    finite = (math.isfinite(loss) and bool(torch.isfinite(v).all())
              and bool(torch.isfinite(f).all())
              and bool(torch.isfinite(q).all()))
    expected_step = rn_launches(arch, cross, RN_N_ACCUM, RN_N_ACCUM,
                                RN_N_ACCUM, RN_N_ACCUM)
    expected_eval = rn_launches(arch, cross, 1, 1)
    row = dict(phase="resnet", what=f"one fine-tune step and an eval "
               f"forward, {name}", resolution=arch.image_resolution,
               vision=[arch.vision_width, list(arch.vision_layers)],
               embed_dim=arch.embed_dim, clips=task.batch_size,
               n_accum=RN_N_ACCUM, frames=task.max_frames,
               head_dims=dict(zip(("text", "temporal"),
                                  rn_head_dims(arch, cross))),
               model_build_s=build_s, loss=loss,
               grad_norm=float(metrics["grad_norm"]),
               running_stats_moved=moved, finite=finite,
               first_step_s=first_s, warm_step_device_ms=warm_ms,
               eval_forward_ms=eval_ms,
               max_memory_allocated=dict(train=train_peak, eval=eval_peak),
               step_launches=step_counts, expected_step_launches=expected_step,
               eval_launches=eval_counts, expected_eval_launches=expected_eval,
               card=smi)
    emit(row)
    if not (finite and moved and step_counts == expected_step
            and eval_counts == expected_eval):
        raise AssertionError(f"ResNet step failed: {row}")
    del model, state, batch, v, f, q
    torch.cuda.empty_cache()
    return (add_counts(step_counts, eval_counts),
            add_counts(expected_step, expected_eval))


def rn_cli_phase(root, seed, smi):
    """RN50 through the CLI: a seeded OpenAI-named RN50 state dict (fp16,
    its running statistics drawn away from their init) as --clip_model,
    the arch read back from its shapes; --do_train of RN_CLI_STEPS steps of
    8 clips in micro-batches of 4 over a FramePack cycled from the fixture
    (12 frames decoded by nvJPEG + R1 at 224), the epoch-end eval of
    RN_EVAL_CLIPS clips; --do_eval --init_model of the saved file
    (profiled; the same metrics), --do_extract of a 1024-wide bank, and
    RN_QUERIES queries that the retrieval service answers from it.
    Launches of K1, K2 (by body and head_dim), R1 and the decoder against
    the prediction."""
    arch, cross = ClipArch.by_name(RN_CLI), rn_cross(RN_CLI)
    os.makedirs(root)
    cross_path = os.path.join(root, "cross-rn50.json")
    with open(cross_path, "w") as f:
        json.dump(dataclasses.asdict(cross), f)
    layout = build_cli_layout(root, seed, RN_EVAL_CLIPS, RN_TRAIN_VIDEOS)
    t0 = time.perf_counter()
    clip_path = os.path.join(root, "RN50.pt")
    clip_sd = clip_archive(clip_path, seed, RN_CLI, script=False)
    archive_s = time.perf_counter() - t0
    from_shapes = ClipArch.from_state_dict(clip_sd) == arch
    argv = ["--do_train", "--do_eval", "--dataset", "msrvtt",
            "--language", "english", "--use_temp", "--use_frame_fea",
            "--data_dir", root, "--output_dir", os.path.join(root, "out"),
            "--batch_size", str(RN_TRAIN_VIDEOS),
            "--gradient_accumulation_steps", str(RN_N_ACCUM),
            "--batch_size_val", str(RN_EVAL_CLIPS), "--epochs", "1",
            "--n_display", "1", "--num_thread_reader", "2",
            "--seed", str(seed), "--cross_model", cross_path]
    task = cli.to_task_config(cli.get_args(argv=argv))
    loaded = build_model(task, cross, device="cpu",
                         clip_model_path=clip_path).state_dict()
    stats_loaded = all(
        torch.equal(loaded["visual_encoder." + k].cpu(), v.float())
        for k, v in clip_sd.items() if "running_" in k)
    del loaded, clip_sd
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe() as train_probe:
        run = runner.main(cli.get_args(argv=argv + ["--clip_model",
                                                    clip_path]))
    train_s = time.perf_counter() - t0
    train_counts = dict(launch_counts(), **tower_launch_counts())
    train_peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in run.displayed]
    step_s = [r["step_s"] for r in run.displayed]
    ckpt = os.path.join(root, "out", "pytorch_model.bin.0")
    step_ms, step, dev_batch = step_device_ms(
        run, cross, task, next(iter(SyntheticClips(
            RN_TRAIN_VIDEOS, RN_TRAIN_VIDEOS, task.max_frames,
            arch.image_resolution, task.max_words, seed))), iters=2)
    profile = profile_train_step(run.state, step, dev_batch, step_ms,
                                 phase="resnet_profile")
    del run, step, dev_batch
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with EvalProbe(profile=True) as eval_probe:
        metrics = runner.main(cli.get_args(argv=argv[1:] + [
            "--init_model", ckpt, "--output_dir",
            os.path.join(root, "out_eval")]))
    eval_s = time.perf_counter() - t0
    eval_counts = dict(launch_counts(), **tower_launch_counts())
    eval_peak = torch.cuda.max_memory_allocated()

    reset_launch_counts()
    t0 = time.perf_counter()
    bank_path = runner.main(cli.get_args(argv=[
        "--do_extract"] + argv[2:] + ["--init_model", ckpt, "--output_dir",
                                      os.path.join(root, "out_extract")]))
    extract_s = time.perf_counter() - t0
    bank = dict(np.load(bank_path))
    from hmmc_tpu_torch import serve

    sargs = cli.get_args(argv=argv[1:] + ["--init_model", ckpt])
    sargs.features, sargs.device_rank = bank_path, False
    svc = serve.RetrievalService(sargs)
    captions = [" ".join(np.random.default_rng(seed + i).choice(WORDS, 8))
                for i in range(RN_QUERIES)]
    t0 = time.perf_counter()
    answers = [svc.search(c, topk=5) for c in captions]
    query_ms = (time.perf_counter() - t0) / RN_QUERIES * 1e3
    extract_counts = dict(launch_counts(), **tower_launch_counts())
    served = all(len(a["results"]) == 5 for a in answers)
    del svc
    torch.cuda.empty_cache()

    micro = RN_CLI_STEPS * RN_N_ACCUM
    text_blocks = math.ceil(RN_EVAL_CLIPS / 512)
    video_blocks = math.ceil(RN_EVAL_CLIPS / 64)    # auto_video_block: 64
    decodes = 1                # one eval batch of RN_EVAL_CLIPS clips
    eval_k = rn_launches(arch, cross, text_blocks, video_blocks)
    expected_eval = dict(eval_k, k1=eval_k["k1_short"], k2=0, r1=decodes,
                         r2=0, decoder=decodes)
    train_k = add_counts(eval_k, rn_launches(arch, cross, micro, micro,
                                             micro, micro))
    expected_train = dict(train_k, k1=train_k["k1_short"],
                          k2=train_k["k2_short"], r1=RN_CLI_STEPS + decodes,
                          r2=0, decoder=RN_CLI_STEPS + decodes)
    # the extract, then the service's warm-up query and RN_QUERIES more
    serve_k = add_counts(eval_k, rn_launches(arch, cross, RN_QUERIES + 1, 0))
    expected_extract = dict(serve_k, k1=serve_k["k1_short"], k2=0,
                            r1=decodes, r2=0, decoder=decodes)
    ev_call = eval_probe.calls[0]
    row = dict(
        phase="resnet", what=f"{RN_CLI} BirdModel through the CLI",
        resolution=arch.image_resolution,
        vision=[arch.vision_width, list(arch.vision_layers)],
        embed_dim=arch.embed_dim,
        temporal_heads=cross.temporal_attention_heads,
        head_dims=dict(zip(("text", "temporal"), rn_head_dims(arch, cross))),
        clip_model_bytes=os.path.getsize(clip_path), archive_s=archive_s,
        arch_from_shapes_equal=from_shapes,
        running_stats_loaded_from_file=stats_loaded,
        train_clips=RN_TRAIN_VIDEOS * 2, steps=RN_CLI_STEPS,
        micro_batch_clips=RN_TRAIN_VIDEOS // RN_N_ACCUM,
        losses=losses, finite=all(math.isfinite(x) for x in losses),
        step_s=step_s,
        train_run_s=train_s, eval_run_s=eval_s, extract_run_s=extract_s,
        step_device_ms=step_ms,
        step_device_ms_by_kind=profile["device_ms_by_kind"],
        epoch_metrics=train_probe.calls[0]["metrics"],
        reload_metrics=metrics,
        reload_equal=metrics == train_probe.calls[0]["metrics"],
        eval_clips=RN_EVAL_CLIPS, eval_video_blocks=video_blocks,
        eval_wall_ms=ev_call["wall_ms"],
        eval_device_busy_ms=ev_call["profile"]["device_busy_ms"],
        eval_device_idle_share=ev_call["profile"]["device_idle_share"],
        eval_device_ms_by_kind=ev_call["profile"]["device_ms_by_kind"],
        r1_launches_at_224=dict(train=train_counts["r1"],
                                eval=eval_counts["r1"],
                                extract=extract_counts["r1"]),
        max_memory_allocated=dict(train=train_peak, eval=eval_peak),
        train_launches=train_counts, expected_train_launches=expected_train,
        eval_launches=eval_counts, expected_eval_launches=expected_eval,
        extract_and_query_launches=extract_counts,
        expected_extract_and_query_launches=expected_extract,
        bank_shapes={k: list(a.shape) for k, a in bank.items()},
        served_queries=RN_QUERIES, served_ok=served,
        query_ms_host_ranking=query_ms,
        decode_failures=jpeg.decode_frames.decode_failures,
        layout_s=layout["seconds"], card=smi)
    emit(row)
    ok = (from_shapes and stats_loaded and row["finite"]
          and row["reload_equal"] and served and row["decode_failures"] == 0
          and row["bank_shapes"].get("video", [0, 0])[-1] == arch.embed_dim
          and train_counts == expected_train
          and eval_counts == expected_eval
          and extract_counts == expected_extract
          and all(math.isfinite(x) for x in metrics.values()))
    if not ok:
        raise AssertionError(f"ResNet CLI run failed: {row}")
    keys = [k for k in train_counts if k.startswith(("k1_", "k2_"))]
    return ({k: train_counts[k] + eval_counts[k] + extract_counts[k]
             for k in keys},
            {k: expected_train[k] + expected_eval[k] + expected_extract[k]
             for k in keys},
            train_counts["r1"] + eval_counts["r1"] + extract_counts["r1"])


def fp64(model):
    """``model`` in fp64, its compute dtype too (the attention logits stay
    fp32 or wider, as the attention op computes them)."""
    model = model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def rn_reference_check(seed):
    """The RN50-width tower cut to (1, 1, 1, 1) blocks, card against CPU,
    TF32 off, the same inputs on both (the fixture's crops, normalised on
    the CPU). (1) One fp32 fine-tune step in RN_N_ACCUM micro-batches of 2
    clips, the text and temporal transformers cut to 2 layers (cross-base's
    8 temporal heads: head_dim 128), the kernels on the card and the plain
    attention on the CPU: the loss, the running statistics after the step
    and every gradient outside the tower; the tower's gradients reported
    beside the CPU's own fp32 error against its fp64 step. (2) The tower
    alone in fp64 (cuDNN's fp64 convolutions), train mode, over the step's
    first micro-batch's frames under a seeded gradient of its output: the
    output, every gradient and the running statistics."""
    arch = dataclasses.replace(ClipArch.by_name(RN_CLI),
                               vision_layers=(1, 1, 1, 1),
                               transformer_layers=2)
    cross = dataclasses.replace(rn_cross(RN_CLI), temporal_hidden_layers=2)
    task = TaskConfig(seed=seed, compute_dtype="float32",
                      batch_size=2 * RN_N_ACCUM,
                      gradient_accumulation_steps=RN_N_ACCUM)
    host = next(iter(SyntheticClips(task.batch_size, task.batch_size,
                                    task.max_frames, arch.image_resolution,
                                    task.max_words, seed + 9)))
    crops = load_fixture()["crop"]
    host["video"] = np.stack([np.stack([
        crops[(3 * c + j) % len(crops)] for j in range(task.max_frames)])
        for c in range(task.batch_size)])
    batch = runner.prepare_finetune_batch(host, "cpu")
    tower = "visual_encoder.visual."

    def step(dev, switch, wide=False):
        model = build_model(task.replace(use_fused_attention=switch), cross,
                            arch=arch, device=dev)
        mb = {k: v.to(dev) for k, v in batch.items()}
        if wide:
            model = fp64(model)
            mb["video"] = mb["video"].double()
        state = FinetuneState(model, build_optimizer(
            model.named_parameters(), lr=task.lr, text_lr=task.text_lr,
            coef_lr=task.coef_lr, weight_decay=task.weight_decay,
            warmup_proportion=task.warmup_proportion, t_total=1))
        before = (fused_attention.head_dim_launches[128],
                  fused_attention_backward.head_dim_launches[128])
        _, metrics = make_finetune_step(cross, n_accum=RN_N_ACCUM)(state, mb)
        return dict(
            loss=float(metrics["loss"]),
            d128=[fused_attention.head_dim_launches[128] - before[0],
                  fused_attention_backward.head_dim_launches[128]
                  - before[1]],
            grads={n: p.grad.double().cpu() for n, p in
                   model.named_parameters() if p.grad is not None},
            stats={k: v.double().cpu() for k, v in model.state_dict().items()
                   if "running_" in k})

    def tower_fp64(dev):
        g = torch.Generator().manual_seed(seed + 11)
        net = ModifiedResNet(arch.vision_layers, arch.embed_dim,
                             arch.vision_heads, arch.image_resolution,
                             arch.vision_width, torch.float64)
        net.reset_parameters(g)
        net = net.double().to(dev)
        frames = batch["video"][:2].flatten(0, 1).double()
        cot = torch.randn(len(frames), arch.embed_dim, generator=g,
                          dtype=torch.float64)
        out = net(frames.to(dev), True)
        (out * cot.to(dev)).sum().backward()
        return dict(out=out.detach().cpu(),
                    grads={n: p.grad.cpu() for n, p in net.named_parameters()},
                    stats={k: v.cpu() for k, v in net.state_dict().items()
                           if "running_" in k})

    card, cpu, cpu64 = (step("cuda", "on"), step("cpu", "off"),
                        step("cpu", "off", wide=True))
    card_t, cpu_t = tower_fp64("cuda"), tower_fp64("cpu")

    def grad_rel(got, want, names):
        """Each gradient's max abs difference over its max magnitude; the
        attention pool's key bias is left out (its gradient is 0 in exact
        arithmetic: a key bias moves a query's logits all alike)."""
        out = {}
        for n in names:
            if n.endswith("attnpool.k_proj.bias"):
                continue
            ref = want["grads"][n]
            scale = float(ref.abs().max())
            err = float((got["grads"][n] - ref).abs().max())
            out[n] = err / scale if scale > 0 else err
        return out

    def worst(rel):
        return [dict(name=n, rel_diff=r) for n, r in
                sorted(rel.items(), key=lambda kv: -kv[1])[:5]]

    def stats_diff(a, b):
        return max(float((a["stats"][k] - v).abs().max())
                   for k, v in b["stats"].items())

    names = sorted(cpu["grads"])
    outside = [n for n in names if not n.startswith(tower)]
    inside = [n for n in names if n.startswith(tower)]
    rel_out = grad_rel(card, cpu, outside)
    rel_in, own_in = grad_rel(card, cpu, inside), grad_rel(cpu, cpu64, inside)
    rel_t = grad_rel(card_t, cpu_t, sorted(cpu_t["grads"]))
    loss_diff = abs(card["loss"] - cpu["loss"])
    out_diff = float((card_t["out"] - cpu_t["out"]).abs().max())
    ok = (set(card["grads"]) == set(cpu["grads"]) and rel_out and rel_t
          and min(card["d128"]) > 0 and loss_diff <= RN_REF_LOSS_ATOL
          and stats_diff(card, cpu) <= RN_REF_STATS_ATOL
          and max(rel_out.values()) <= RN_REF_GRAD_REL
          and out_diff <= RN_REF_LOSS_ATOL
          and max(rel_t.values()) <= RN_REF_GRAD_REL
          and stats_diff(card_t, cpu_t) <= RN_REF_STATS_ATOL)
    row = dict(phase="resnet_reference", what="card against CPU: one fp32 "
               f"fine-tune step of {task.batch_size} clips in {RN_N_ACCUM} "
               "micro-batches (card: cuDNN and the kernels), and the tower "
               "alone in fp64 (card: cuDNN) under a seeded output gradient",
               arch=dataclasses.asdict(arch),
               temporal=[cross.temporal_hidden_size,
                         cross.temporal_hidden_layers,
                         cross.temporal_attention_heads],
               fp32_step=dict(
                   loss_card=card["loss"], loss_cpu=cpu["loss"],
                   loss_abs_diff=loss_diff,
                   running_stats_max_abs_diff=stats_diff(card, cpu),
                   grads_outside_tower=len(rel_out),
                   grad_max_rel_diff_outside_tower=max(rel_out.values()),
                   worst_outside_tower=worst(rel_out),
                   tower_grad_max_rel_diff_reported=max(rel_in.values()),
                   tower_worst=worst(rel_in),
                   cpu_fp32_vs_fp64_tower_grad_max_rel_diff=max(
                       own_in.values()),
                   cpu_fp32_vs_fp64_tower_worst=worst(own_in),
                   card_launches_at_head_dim_128=card["d128"]),
               fp64_tower=dict(
                   frames=2 * task.max_frames, output_max_abs_diff=out_diff,
                   grads=len(rel_t), grad_max_rel_diff=max(rel_t.values()),
                   worst=worst(rel_t),
                   running_stats_max_abs_diff=stats_diff(card_t, cpu_t)),
               loss_atol=RN_REF_LOSS_ATOL, grad_rel_tolerance=RN_REF_GRAD_REL,
               running_stats_atol=RN_REF_STATS_ATOL,
               reason=RN_REF_REASON, ok=ok)
    emit(row)
    if not ok:
        raise AssertionError(f"ResNet card step disagrees with the CPU: "
                             f"{row}")


def resnet_phase(root, seed, smi):
    """Phase resnet; returns each path's K1 / K2 launches by body and
    head_dim, their predictions, and R1's launches on the RN50 CLI path."""
    for res in RN_RESOLUTIONS:
        check_decoder_at(smi, res, phase="resnet")
    paths, predicted = {}, {}
    counts, expected, r1 = rn_cli_phase(root, seed, smi)
    paths["resnet_cli_rn50"], predicted["resnet_cli_rn50"] = counts, expected
    for name, clips in RN_STEPS:
        key = f"resnet_step_{name}"
        paths[key], predicted[key] = rn_step(name, clips, seed, smi)
    reset_attention_counts()
    rn_reference_check(seed)
    at = {f"{k}_d{d}": sum(c[f"{k}_d{d}"] for c in paths.values())
          for k in ("k1", "k2") for d in HEAD_DIMS}
    emit(dict(phase="resnet_head_dims", launches_by_head_dim=at,
              predicted={k: sum(c[k] for c in predicted.values())
                         for k in at}, card=smi))
    if not all(at[f"{k}_d{d}"] > 0 for k in ("k1", "k2") for d in (80, 128)):
        raise AssertionError(f"the ResNet paths ran no K1 / K2 at head_dim "
                             f"80 or 128: {at}")
    return paths, predicted, r1


def launches_of(by_path, kernel):
    """One kernel's launches over phase ddp's paths (a list per group
    holds each rank's counts)."""
    return {path: (sum(c[kernel] for c in v) if isinstance(v, list)
                   else v[kernel]) for path, v in by_path.items()}


def kernels_phase(gen):
    """Phase 3: K1 at the eval path's shapes (64-clip video block,
    512-query text block) and the serve path's (one query), K2 at the
    fine-tune path's (a 64-clip micro-batch), each also at the longest
    sequence it takes."""
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention("vit", 64 * 12, 12, 50, False, dtype, gen))
        rows.append(check_attention("text", 512, 8, 32, True, dtype, gen))
        rows.append(check_attention("temporal", 64, 8, 12, False, dtype, gen))
    # the serve path: one query's text tower, batch 1
    rows.append(check_attention("text_query", 1, 8, 32, True,
                                torch.bfloat16, gen))
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, l, causal in ((8, 8, 77, True), (8, 12, 128, False)):
            check_attention("extra", b, h, l, causal, dtype, gen)
    bwd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        bwd_rows.append(check_attention_backward("vit", 64 * 12, 12, 50,
                                                 False, dtype, gen))
        bwd_rows.append(check_attention_backward("text", 64, 8, 32, True,
                                                 dtype, gen))
        bwd_rows.append(check_attention_backward("temporal", 64, 8, 12,
                                                 False, dtype, gen))
    for dtype in (torch.bfloat16, torch.float32):
        check_attention_backward("extra", 8, 12,
                                 short_max_len_backward(dtype, 64), False,
                                 dtype, gen)
    wrapper_host_cost(gen)
    return rows, bwd_rows


def eval_phase(args, smi):
    """Phase 4; returns K1's launches over the eval."""
    task = TaskConfig(seed=args.seed)                # bf16, kernel on
    cross = CrossConfig()                            # ViT-B/32, temporal 4x8
    arch = ClipArch.by_name(cross.pretrained_clip_name)
    loader = SyntheticClips(args.clips, 64, task.max_frames,
                            arch.image_resolution, task.max_words, args.seed)
    t0 = time.perf_counter()
    model = build_model(task, cross)
    build_s = time.perf_counter() - t0
    on = run_eval(model, task, loader)
    ev = on["ev"]
    video_blocks = math.ceil(args.clips / ev.video_block)
    text_blocks = math.ceil(args.clips / ev.text_block)
    expected = (arch.vision_layers * video_blocks
                + arch.transformer_layers * text_blocks
                + cross.temporal_hidden_layers * video_blocks)
    sim = on["sim"]
    metrics = on["metrics"]
    finite = (bool(np.isfinite(sim).all()) and sim.shape == (args.clips,) * 2
              and all(math.isfinite(x) for x in metrics.values()))
    emit(dict(phase="slice", model="ViT-B/32 BirdModel", clips=args.clips,
              frames=task.max_frames, resolution=arch.image_resolution,
              max_words=task.max_words, compute_dtype=task.compute_dtype,
              use_fused_attention=task.use_fused_attention,
              video_block=ev.video_block, text_block=ev.text_block,
              metrics=metrics, chance_r1=100.0 / args.clips,
              launches=on["launches"], expected_launches=expected,
              bwd_launches=on["bwd_launches"],
              model_build_s=build_s, eval_s=on["total_s"],
              cache_features_s=on["cache_s"],
              synthetic_data_s=on["data_gen_s"],
              eval_clips_per_s=args.clips / on["total_s"],
              max_memory_allocated=on["max_memory_allocated"],
              sim_shape=list(sim.shape), finite=finite, card=smi))
    if (on["launches"] == 0 or on["launches"] != expected
            or on["bwd_launches"] != 0):
        raise AssertionError(f"kernel launches {on['launches']} != expected "
                             f"{expected}, or backward launches "
                             f"{on['bwd_launches']} in the eval")
    if not finite:
        raise AssertionError("non-finite or mis-shaped eval output")
    emit(dict(phase="throughput", card=smi,
              **device_throughput(model, task, arch, ev)))
    profile_eval(model, task, arch, args.seed)
    del model, ev
    torch.cuda.empty_cache()

    off_task = task.replace(use_fused_attention="off")
    off_model = build_model(off_task, cross)
    off = run_eval(off_model, off_task, loader)
    sim_diff = float(np.abs(off["sim"] - sim).max())
    emit(dict(phase="switch_off", launches=off["launches"],
              metrics=off["metrics"], eval_s=off["total_s"],
              max_memory_allocated=off["max_memory_allocated"],
              sim_max_abs_diff_vs_on=sim_diff, atol=SIM_ON_OFF_ATOL,
              reason=SIM_ON_OFF_REASON,
              card=smi, **device_throughput(off_model, off_task, arch,
                                            off["ev"])))
    if off["launches"] != 0 or sim_diff > SIM_ON_OFF_ATOL:
        raise AssertionError(f"switch off: launches {off['launches']}, sim "
                             f"diff {sim_diff} > {SIM_ON_OFF_ATOL}")
    del off_model, off
    reference_check(task, cross, arch, args.seed)
    torch.cuda.empty_cache()
    return on["launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=1000,
                    help="eval clips (MSR-VTT's 1k-A test split has 1000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ddp_worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ddp_worker:               # one rank of phase ddp's groups
        ddp_worker(args.ddp_worker)
        return 0

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(dict(phase="device", nvidia_smi=smi, torch_device=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, python=sys.version.split()[0],
              allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
              allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
              jpeg=jpeg_toolkit()))

    # 2. build
    t0 = time.perf_counter()
    info = kernel_build.build(kernel_build.kernel_sources())
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels={n: dict(seconds=i["seconds"], cached=i["cached"],
                               functions=ptxas_by_function(i["ptxas"]))
                       for n, i in info.items()}))
    tiled_resources = tiled_kernel_resources(info)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    start_phase("kernels")
    rows, bwd_rows = kernels_phase(gen)
    tower_rows, tower_bwd_rows = tower_kernels(gen)     # phase towers
    hd_rows, hd_bwd_rows = head_dim_kernels(gen)
    head_dim_sweep(gen)
    start_phase("frames")
    r1_row = check_resize_crop(gen)
    check_decoder(smi)
    r2_rows = check_resize_area(gen)
    check_aug_decoder(smi)
    check_resize_crop(gen, TOWER_RES, TOWER_BLOCK_FRAMES, 16)   # R1 at 336
    check_decoder_at(smi)
    for res in RN_RESOLUTIONS:              # the ResNets' up-scaled decodes
        check_resize_crop(gen, res, RN_BLOCK_FRAMES, 8)
    start_phase("eval")
    eval_k1 = eval_phase(args, smi)
    start_phase("train")
    train = train_slice(CrossConfig(), ClipArch.by_name("ViT-B/32"),
                        args.seed, smi)
    start_phase("pretrain")
    pretrain = pretrain_phase(args.seed, smi)
    with tempfile.TemporaryDirectory(prefix="hmmc_cli_") as root:
        start_phase("cli")
        cli_counts = cli_phase(root, args.seed, smi)
        start_phase("serve")
        serve_counts = serve_phase(root, cli_counts["ckpt"],
                                   cli_counts["eval_metrics"], args.seed,
                                   smi)
        start_phase("cli_pretrain")
        cli_pre = cli_pretrain_phase(root, args.seed, smi)
        start_phase("ddp")
        ddp = ddp_phase(root, args.seed, smi, train["first_steps"],
                        cli_counts)
        start_phase("towers")
        tower_paths, tower_predicted = towers_phase(
            os.path.join(root, "towers"), args.seed, smi)
        start_phase("resnet")
        rn_paths, rn_predicted, rn_r1 = resnet_phase(
            os.path.join(root, "resnet"), args.seed, smi)
    start_phase("result")
    tower_paths.update(rn_paths)
    tower_predicted.update(rn_predicted)
    rows += tower_rows + hd_rows
    bwd_rows += tower_bwd_rows + hd_bwd_rows

    # result
    def head_dim_launches(kernel):
        """Every launch of the run by phase and head_dim beside the
        prediction: the ViT-B/32 phases run head_dim 64 only, the towers'
        and the ResNets' paths as their block structure gives (phase
        kernels' checks and the reference checks and warm steps of phases
        towers and resnet are measured, not predicted)."""
        by_phase = {ph: t[kernel] for ph, t in HEAD_DIM_LAUNCHES.items()
                    if kernel in t and any(t[kernel].values())}
        predicted = {ph: {d: sum(c.values()) if d == 64 else 0
                          for d in HEAD_DIMS}
                     for ph, c in by_phase.items()
                     if ph not in ("kernels", "towers", "resnet")}
        predicted.update({
            p: {d: c[f"{kernel}_d{d}"] for d in HEAD_DIMS}
            for p, c in tower_predicted.items()})
        measured_paths = {
            p: {d: c[f"{kernel}_d{d}"] for d in HEAD_DIMS}
            for p, c in tower_paths.items()}
        return dict(by_phase=by_phase, tower_paths=measured_paths,
                    predicted=predicted)

    def kernel_row(name, replaces, rows, launches, by_path, by_body):
        tiled_kernels = [r for r in tiled_resources
                         if r["kernel"] in TILED_KERNELS[name]]
        vit = next(r for r in rows if r["site"] == "vit"
                   and r["dtype"] == str(torch.bfloat16))
        main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
        kernel = "k2" if name.endswith("bwd") else "k1"
        return dict(
            name=name, route="cuda", source=f"hmmc_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches, launches_by_path=by_path,
            tiled_launches_by_path=by_body,
            head_dims_checked=sorted({r["head_dim"] for r in rows}),
            tiled_kernels=tiled_kernels,
            launches_by_head_dim=head_dim_launches(kernel),
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=vit["ms"], plain_ms=vit["plain_ms"], bound_ms=vit["bound_ms"],
            bound_by=vit["bound_by"], library_ms=vit["library_ms"],
            timed_at=f"vit site, bf16, {vit['shape']}",
            sites=[{k: r[k] for k in ("site", "shape", "causal", "dtype",
                                      "head_dim", "body", "max_abs_err", "ms",
                                      "kernel_device_ms", "host_us_per_call",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "share_of_bound")}
                   for r in rows])

    k1_paths = {"eval": eval_k1, "finetune_steps": train["k1"],
                "finetune_epoch_eval": train["eval_k1"],
                "cli_finetune_and_evals": cli_counts["k1"],
                "serve_extract_and_queries": serve_counts["k1"],
                "pretrain_steps": pretrain["k1"],
                "cli_pretrain_and_eval": cli_pre["k1"]}
    k2_paths = {"finetune_steps": train["k2"],
                "cli_finetune": cli_counts["k2"],
                "pretrain_steps": pretrain["k2"],
                "cli_pretrain": cli_pre["k2"]}
    # phase ddp's paths; a 2-rank group's entry sums its ranks' launches
    k1_paths.update(launches_of(ddp, "k1"))
    k2_paths.update(launches_of(ddp, "k2"))
    # phases towers (the only paths with L > 128, where the tiled bodies
    # run) and resnet (head_dims 80, 96 and 128 at the temporal site)
    for kernel, paths in (("k1", k1_paths), ("k2", k2_paths)):
        paths.update({p: c[f"{kernel}_short"] + c[f"{kernel}_tiled"]
                      for p, c in tower_paths.items()})
    tiled = {k: {p: c[f"{k}_tiled"] for p, c in tower_paths.items()}
             for k in ("k1", "k2")}
    r1_ddp = {k: v for k, v in launches_of(ddp, "r1").items() if v}
    r2_row = r2_rows["path"]
    print(smi, flush=True)
    emit({"kernels": [
        kernel_row("fused_attention_fwd", "hmmc_tpu/ops/pallas_attention.py:48",
                   rows, sum(k1_paths.values()), k1_paths, tiled["k1"]),
        kernel_row("fused_attention_bwd",
                   "hmmc_tpu/ops/pallas_attention.py:130", bwd_rows,
                   sum(k2_paths.values()), k2_paths, tiled["k2"]),
        dict(name="resize_crop", route="cuda",
             source="hmmc_tpu_torch/csrc/resize_crop.cu",
             replaces="hmmc_tpu/data/datasets.py:36 (_decode_eval's PIL "
                      "bicubic resize and centre crop: a host PIL step, "
                      "not a Pallas kernel)",
             launches=(cli_counts["r1"] + serve_counts["r1"] + cli_pre["r1"]
                       + sum(r1_ddp.values()) + rn_r1),
             launches_by_path={"cli_finetune_and_evals": cli_counts["r1"],
                               "serve_extract": serve_counts["r1"],
                               "cli_pretrain_eval": cli_pre["r1"],
                               **r1_ddp, "resnet_cli_rn50": rn_r1},
             max_abs_err=r1_row["max_abs_err"], ms=r1_row["launch_ms"],
             kernel_device_ms=r1_row["kernel_device_ms"],
             wrapper_from_frame_list_ms=r1_row["ms"],
             plain_ms=r1_row["plain_ms"], bound_ms=r1_row["bound_ms"],
             bound_by=r1_row["bound_by"], library_ms=r1_row["library_ms"],
             timed_at=f"{BLOCK_FRAMES} frames {STORE_SIZE[0]}x"
                      f"{STORE_SIZE[1]} -> {RES}, 4:2:0 planes, one launch "
                      f"as the decode path makes it"),
        dict(name="resize_area", route="cuda",
             source="hmmc_tpu_torch/csrc/resize_area.cu",
             replaces="hmmc_tpu/data/datasets.py:64 (_decode_aug's cv2 "
                      "INTER_AREA resize and centre crop: a host cv2 step, "
                      "not a Pallas kernel)",
             launches=cli_pre["r2"],
             launches_by_path={"cli_pretrain_steps": cli_pre["r2"]},
             max_abs_err=r2_row["max_abs_err"], ms=r2_row["launch_ms"],
             kernel_device_ms=r2_row["kernel_device_ms"],
             wrapper_from_frame_list_ms=r2_row["ms"],
             plain_ms=r2_row["plain_ms"], bound_ms=r2_row["bound_ms"],
             bound_by=r2_row["bound_by"], library_ms=r2_row["library_ms"],
             timed_at=f"{PRETRAIN_BLOCK} frames {STORE_SIZE[0]}x"
                      f"{STORE_SIZE[1]} -> {AUG} (cv2's copy path), 4:2:0 "
                      "planes, one launch",
             other_paths={m: {k: r2_rows[m][k] for k in (
                 "size", "launch_ms", "launch_ms_windows", "launch_host_us",
                 "kernel_device_ms", "plain_ms", "library_ms",
                 "library_ms_windows", "bound_ms", "bound_by")}
                 for m in ("area", "linear") if m in r2_rows})]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
