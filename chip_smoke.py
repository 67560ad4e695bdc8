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
            equal;
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
5. train    the same model fine-tuned through runner.run_finetune: batch 256
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
6. result   the nvidia-smi line as it prints it, the kernel table as one
            JSON line, then ``{"ok": true, "device": {...}}`` as the last.

Every line before those is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from hmmc_tpu_torch import runner
from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig
from hmmc_tpu_torch.data.text import encode_text
from hmmc_tpu_torch.evaluation import Evaluator
from hmmc_tpu_torch.factory import build_model
from hmmc_tpu_torch.metrics import logging_rank
from hmmc_tpu_torch.ops import fused_attention as fa
from hmmc_tpu_torch.ops import image_ops, kernel_build
from hmmc_tpu_torch.ops.fused_attention import (
    MAX_LEN_BWD, MAX_LEN_BWD_FP32, fused_attention, fused_attention_backward,
    fused_attention_backward_reference, fused_attention_reference,
    kernel_bwd_smem_bytes, kernel_smem_bytes)
from hmmc_tpu_torch.tokenization import ClipTokenizer
from hmmc_tpu_torch.train.optimization import build_optimizer
from hmmc_tpu_torch.train.trainer import FinetuneState, make_finetune_step

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_attention(site, b, h, l, causal, dtype, gen):
    """The main path's layout: head views of a packed qkv projection."""
    d = 64
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
    smem = kernel_smem_bytes(l, dtype)
    iters = 50
    ms = cuda_ms(lambda: fused_attention(q, k, v, causal), iters)
    host_us = host_us_per_call(lambda: fused_attention(q, k, v, causal))
    plain_ms = cuda_ms(lambda: fused_attention_reference(q, k, v, causal), iters)
    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

    library_ms = cuda_ms(library, iters)
    kernel_only_ms = kernel_device_ms(lambda: fused_attention(q, k, v, causal))
    library_kernels_ms = kernel_device_ms(library)
    bound_ms, bound_by, nbytes, flops = attention_bound(b, h, l, d, causal,
                                                        dtype)
    row = dict(phase="kernel", kernel="fused_attention_fwd", site=site,
               shape=[b, h, l, d], causal=causal, dtype=str(dtype),
               max_abs_err=float(diff.max()), tolerance=tol,
               bitwise_repeat=bitwise_repeat, ok=ok,
               ms=ms, host_us_per_call=host_us, plain_ms=plain_ms,
               library_ms=library_ms, kernel_device_ms=kernel_only_ms,
               library_kernels_device_ms=library_kernels_ms,
               library="torch.nn.functional.scaled_dot_product_attention",
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, share_of_bound=bound_ms / ms,
               ctas=math.ceil(b * h / fa.kernel_heads_per_cta(dtype)),
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


def check_attention_backward(site, b, h, l, causal, dtype, gen):
    """K2 on the fine-tune path's layout: q, k, v head views of a packed
    qkv projection, the output gradient the transposed view of a
    [B, L, H, 64] tensor (as the merge of heads hands it back)."""
    d = 64
    qkv = torch.randn(b, l, 3 * h * d, device="cuda", generator=gen).to(dtype)
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, l, 3, h, d).unbind(2))
    g = torch.randn(b, l, h, d, device="cuda", generator=gen).to(dtype)
    g = g.transpose(1, 2)
    got = fused_attention_backward(q, k, v, g, causal)
    again = fused_attention_backward(q, k, v, g, causal)
    torch.cuda.synchronize()
    bitwise_repeat = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    ref = fused_attention_backward_reference(q, k, v, g, causal)
    tol = BWD_TOLERANCE[dtype]
    errs, ok = [], bitwise_repeat
    for a, r in zip(got, ref):
        diff = (a.float() - r.float()).abs()
        errs.append(float(diff.max()))
        ok &= bool((diff <= tol["atol"] + tol["rtol"] * r.float().abs()).all())
    iters = 30
    ms = cuda_ms(lambda: fused_attention_backward(q, k, v, g, causal), iters)
    host_us = host_us_per_call(
        lambda: fused_attention_backward(q, k, v, g, causal))
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
    kernel_only_ms = kernel_device_ms(
        lambda: fused_attention_backward(q, k, v, g, causal))
    library_kernels_ms = kernel_device_ms(library)
    del out, leaf, library
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound(b, h, l, d, causal,
                                                            dtype)
    row = dict(phase="kernel", kernel="fused_attention_bwd", site=site,
               shape=[b, h, l, d], causal=causal, dtype=str(dtype),
               max_abs_err=max(errs), max_abs_err_dq_dk_dv=errs,
               tolerance=tol, bitwise_repeat=bitwise_repeat, ok=ok, ms=ms,
               host_us_per_call=host_us, plain_ms=plain_ms,
               library_ms=library_ms, kernel_device_ms=kernel_only_ms,
               library_kernels_device_ms=library_kernels_ms,
               library="scaled_dot_product_attention backward "
                       "(torch.autograd.grad after one forward)",
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
               flops=flops, share_of_bound=bound_ms / ms,
               ctas=b * h,
               dynamic_smem_bytes_per_cta=kernel_bwd_smem_bytes(l, dtype))
    emit(row)
    if not ok:
        raise AssertionError(f"fused attention backward kernel disagrees "
                             f"with its plain version: {row}")
    return row


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
    fused_attention.launches = fused_attention_backward.launches = 0
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


KERNEL_KINDS = {"K1 fused_attention_fwd": ("attention_fwd_",),
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


def reference_check(task, cross, arch, seed):
    """fp32 model with the kernel on the card against the same weights on
    the CPU (plain attention), on two clips and four captions."""
    task32 = task.replace(compute_dtype="float32")
    gpu = build_model(task32, cross, device="cuda")
    cpu = build_model(task32.replace(use_fused_attention="off"), cross,
                      device="cpu")
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
    row = dict(phase="reference", what="fp32 encode_text / encode_video "
               "(video feature, frame output): card (kernel) vs CPU (plain)",
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
    """runner.run_finetune over TRAIN_STEPS copies of ``batch``; counts are
    set to 0 just before and read at the end of the steps and after the
    epoch-end eval."""
    loader = RepeatedBatch(batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_attention.launches = fused_attention_backward.launches = 0
    t0 = time.perf_counter()
    run = runner.run_finetune(task, cross, loader, eval_loader, arch=arch)
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


def profile_train_step(state, step, dev_batch, step_ms):
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
    row = dict(phase="train_profile", what="one warm optimizer step",
               step_device_ms_unprofiled=step_ms,
               device_idle_share_unprofiled=(
                   1 - busy / step_ms if isinstance(busy, float)
                   else "not measured"),
               optimizer_step_ms=cuda_ms(state.optimizer.step, iters=3,
                                         warmup=1),
               **kinds)
    emit(row)
    return row


def grad_reference_check(cross, arch, seed):
    """One fp32 fine-tune step on 2 clips and 2 captions at full width:
    the kernels on the card against the plain attention on the CPU, same
    weights and data, TF32 off. Loss and every parameter's gradient."""
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
    row = dict(phase="train_reference", what="one fp32 fine-tune step, 2 "
               "clips: card (kernels) vs CPU (plain attention)",
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
                eval_k1=row["eval_k1_launches"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clips", type=int, default=1000,
                    help="eval clips (MSR-VTT's 1k-A test split has 1000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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
              allow_tf32_cudnn=torch.backends.cudnn.allow_tf32))

    # 2. build
    t0 = time.perf_counter()
    info = kernel_build.build(kernel_build.kernel_sources())
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              kernels={n: dict(seconds=i["seconds"], cached=i["cached"],
                               functions=ptxas_by_function(i["ptxas"]))
                       for n, i in info.items()}))

    # 3. kernels at the eval path's shapes (64-clip video block, 512-query
    #    text block)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        rows.append(check_attention("vit", 64 * 12, 12, 50, False, dtype, gen))
        rows.append(check_attention("text", 512, 8, 32, True, dtype, gen))
        rows.append(check_attention("temporal", 64, 8, 12, False, dtype, gen))
    # lengths the kernel also takes, beyond the main path
    for dtype in (torch.bfloat16, torch.float32):
        for b, h, l, causal in ((8, 8, 77, True), (8, 12, 128, False)):
            check_attention("extra", b, h, l, causal, dtype, gen)
    # K2 at the fine-tune path's shapes (a 64-clip micro-batch), and at the
    # longest sequence it takes
    bwd_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        bwd_rows.append(check_attention_backward("vit", 64 * 12, 12, 50,
                                                 False, dtype, gen))
        bwd_rows.append(check_attention_backward("text", 64, 8, 32, True,
                                                 dtype, gen))
        bwd_rows.append(check_attention_backward("temporal", 64, 8, 12,
                                                 False, dtype, gen))
    check_attention_backward("extra", 8, 12, MAX_LEN_BWD, False,
                             torch.bfloat16, gen)
    check_attention_backward("extra", 8, 12, MAX_LEN_BWD_FP32, False,
                             torch.float32, gen)
    wrapper_host_cost(gen)

    # 4. the eval slice
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

    # 5. the fine-tune slice
    train = train_slice(cross, arch, args.seed, smi)

    # 6. result
    def kernel_row(name, replaces, rows, launches, by_path):
        vit = next(r for r in rows if r["site"] == "vit"
                   and r["dtype"] == str(torch.bfloat16))
        main_rows = [r for r in rows if r["dtype"] == str(torch.bfloat16)]
        return dict(
            name=name, route="cuda", source=f"hmmc_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches, launches_by_path=by_path,
            max_abs_err=max(r["max_abs_err"] for r in main_rows),
            ms=vit["ms"], plain_ms=vit["plain_ms"], bound_ms=vit["bound_ms"],
            bound_by=vit["bound_by"], library_ms=vit["library_ms"],
            timed_at=f"vit site, bf16, {vit['shape']}",
            sites=[{k: r[k] for k in ("site", "shape", "causal", "dtype",
                                      "max_abs_err", "ms", "host_us_per_call",
                                      "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
                   for r in rows])

    k1_paths = {"eval": on["launches"], "finetune_steps": train["k1"],
                "finetune_epoch_eval": train["eval_k1"]}
    print(smi, flush=True)
    emit({"kernels": [
        kernel_row("fused_attention_fwd", "hmmc_tpu/ops/pallas_attention.py:48",
                   rows, sum(k1_paths.values()), k1_paths),
        kernel_row("fused_attention_bwd",
                   "hmmc_tpu/ops/pallas_attention.py:130", bwd_rows,
                   train["k2"], {"finetune_steps": train["k2"]})]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
