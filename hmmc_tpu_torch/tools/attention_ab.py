"""K1 and K2 of this checkout against another checkout's on one card, in
turns (other, this, this, other), each turn in a process of its own.

Sites (bf16, non-causal, ``chip_smoke``'s checks, each against its plain
version): the ViT-B/32 site [768, 12, 50] (both short bodies), the
towers' sites [192, 12, 197], [48, 16, 257] and [48, 16, 577], and
[48, 8, 577, D] at every head_dim (the tiled bodies). At each: K1 for
inference (no statistics), K1 with the statistics it saves for K2's tiled
pair (this checkout's ``k1_stats_ms``), and K2 alone after one K1, by CUDA
events and the profiler's device time, beside K2's bound and SDPA's
backward. Each checkout's registers and spills per compiled kernel
(``nvcc -Xptxas -v``, from its first build). Then, in this checkout alone,
the device time of each kernel K2 launches (its rows and keys passes) at
[48, 16, 577, 64] and [48, 8, 577, 128].

Run on a CUDA card, from the repository's root, with the other checkout
unpacked into an ignored directory (``git archive <commit>``)::

    python3 hmmc_tpu_torch/tools/attention_ab.py --other DIR [--repeats 1]

Prints one JSON row a turn, one row a site with each checkout's mean over
its turns (and each turn's ms) and this checkout's K2 over the other's,
and one row a kernel of the split. A one-off measurement, not part of
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# (site, B, H, L, D)
SITES = ([("vit", 768, 12, 50, 64), ("vit_b16", 192, 12, 197, 64),
          ("vit_l14", 48, 16, 257, 64), ("vit_l14_336", 48, 16, 577, 64)]
         + [(f"long d{d}", 48, 8, 577, d) for d in (64, 80, 96, 128)])
KEYS = ("k1_ms", "k1_device_ms", "k1_stats_ms", "k2_ms", "k2_device_ms")

TURN = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hmmc_tpu_torch.ops import kernel_build
info = kernel_build.build(["fused_attention_fwd", "fused_attention_bwd"])
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
rows = []
for _ in range(REPEATS):
    for site, b, h, l, d in SITES:
        kw = dict(iters=20, host_calls=50, d=d)
        k1 = cs.check_attention(site, b, h, l, False, torch.bfloat16, gen,
                                **kw)
        k2 = cs.check_attention_backward(site, b, h, l, False,
                                         torch.bfloat16, gen, **kw)
        rows.append(dict(
            site=site, k1_ms=k1["ms"], k1_device_ms=k1["kernel_device_ms"],
            k1_stats_ms=k2.get("k1_stats_ms"), k2_ms=k2["ms"],
            k2_device_ms=k2["kernel_device_ms"],
            k2_host_us=k2["host_us_per_call"], k2_err=k2["max_abs_err"],
            k2_bound_ms=k2["bound_ms"], k2_bound_by=k2["bound_by"],
            sdpa_bwd_ms=k2["library_ms"],
            sdpa_bwd_device_ms=k2["library_kernels_device_ms"]))
print("TURN " + json.dumps(dict(rows=rows, ptxas={
    n: cs.ptxas_by_function(i["ptxas"]) for n, i in info.items()
    if not i["cached"]})), flush=True)
'''

SPLIT = r'''
import json, sys, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, ".")
from hmmc_tpu_torch.ops import fused_attention as fa
gen = torch.Generator(device="cuda").manual_seed(0)
for b, h, l, d in ((48, 16, 577, 64), (48, 8, 577, 128)):
    qkv = torch.randn(b, l, 3 * h * d, device="cuda",
                      generator=gen).bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.view(b, l, 3, h, d).unbind(2))
    g = torch.randn(b, l, h, d, device="cuda",
                    generator=gen).bfloat16().transpose(1, 2)
    o, lse = fa.fused_attention_forward(q, k, v, with_stats=True)
    def k2():
        return fa.fused_attention_backward(q, k, v, g, o=o, lse=lse)
    k2()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k2()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        print(json.dumps(dict(check="attention k2 split", shape=[b, h, l, d],
                              kernel=e.key[:120], count=e.count,
                              device_ms_per_call=us / 1e3 / 10)), flush=True)
'''


def run(code, cwd):
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=1500)
    if proc.returncode:
        raise RuntimeError(f"run in {cwd} failed (rc {proc.returncode}):\n"
                           + proc.stderr[-4000:])
    return proc.stdout


def turn(cwd, repeats):
    out = run(TURN.replace("REPEATS", str(repeats))
              .replace("SITES", repr(SITES)), cwd)
    line = [ln for ln in out.splitlines() if ln.startswith("TURN ")]
    if not line:
        raise RuntimeError(f"turn in {cwd} printed no result")
    return json.loads(line[0][5:])


def mean(vals):
    vals = [v for v in vals if isinstance(v, float)]
    return sum(vals) / len(vals) if vals else "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--repeats", type=int, default=1,
                    help="passes over the sites within a turn")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    smi = chip_smoke.nvidia_smi_line()
    other = os.path.abspath(args.other)
    turns = {"this": [], "other": []}
    for who in ("other", "this", "this", "other"):
        t = turn(ROOT if who == "this" else other, args.repeats)
        turns[who].append(t)
        print(json.dumps(dict(check="attention a/b turn", who=who,
                              checkout=ROOT if who == "this" else other,
                              **t, card=smi)), flush=True)
    for site, b, h, l, d in SITES:
        per = {who: [r for t in ts for r in t["rows"] if r["site"] == site]
               for who, ts in turns.items()}
        summary = {who: {k: mean([r[k] for r in rs]) for k in KEYS}
                   for who, rs in per.items()}
        this, oth = summary["this"]["k2_ms"], summary["other"]["k2_ms"]
        last = per["this"][-1]
        print(json.dumps(dict(
            check="attention a/b", site=site, shape=[b, h, l, d],
            dtype="bf16", mean=summary,
            turns={who: {k: [r[k] for r in rs] for k in KEYS}
                   for who, rs in per.items()},
            k2_this_over_other=(this / oth if isinstance(this, float)
                                and isinstance(oth, float)
                                else "not measured"),
            k2_bound_ms=last["k2_bound_ms"], k2_bound_by=last["k2_bound_by"],
            sdpa_bwd_ms=mean([r["sdpa_bwd_ms"] for r in per["this"]]),
            sdpa_bwd_device_ms=mean([r["sdpa_bwd_device_ms"]
                                     for r in per["this"]]),
            k2_max_abs_err=max(r["k2_err"] for r in per["this"]),
            card=smi)), flush=True)
    print(run(SPLIT, ROOT), end="", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
