"""K1 and K2 of this checkout against another checkout's on one card, in
turns (other, this, this, other), each in a process of its own: the
ViT-B/32 site (bf16 [768, 12, 50], the short bodies at head_dim 64) by
``chip_smoke.check_attention`` / ``check_attention_backward`` (CUDA events
and the profiler's device time), and each checkout's registers and spills
per compiled kernel (``nvcc -Xptxas -v``, from its first build). Then, in
this checkout alone, K1 and K2 at every head_dim at ``chip_smoke``'s
HEAD_DIM_SITES with the profiler's device time, which ``chip_smoke.py``
leaves out of those rows (a fresh process: no earlier profiler session).

Run on a CUDA card, from the repository's root, with the other checkout
unpacked into an ignored directory (``git archive <commit>``)::

    python3 hmmc_tpu_torch/tools/attention_ab.py --other DIR [--repeats 2]

Prints one JSON row a turn, a summary row (the mean ms of each
checkout's turns and this checkout's over the other's) and one row a
(kernel, head_dim, site). It is a one-off
measurement and not part of ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TURN = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from hmmc_tpu_torch.ops import kernel_build
info = kernel_build.build(["fused_attention_fwd", "fused_attention_bwd"])
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
runs = []
for _ in range(REPEATS):
    k1 = cs.check_attention("vit", 768, 12, 50, False, torch.bfloat16, gen)
    k2 = cs.check_attention_backward("vit", 768, 12, 50, False,
                                     torch.bfloat16, gen)
    runs.append(dict(k1_ms=k1["ms"], k1_device_ms=k1["kernel_device_ms"],
                     k2_ms=k2["ms"], k2_device_ms=k2["kernel_device_ms"]))
print("TURN " + json.dumps(dict(runs=runs, ptxas={
    n: cs.ptxas_by_function(i["ptxas"]) for n, i in info.items()
    if not i["cached"]})), flush=True)
'''

HEAD_DIM_ROWS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
for d in cs.HEAD_DIMS:
    for site, b, h, l in cs.HEAD_DIM_SITES:
        for check in (cs.check_attention, cs.check_attention_backward):
            check(f"{site} d{d}", b, h, l, False, torch.bfloat16, gen,
                  iters=20, host_calls=50, d=d)
'''


def turn(cwd, repeats):
    proc = subprocess.run(
        [sys.executable, "-c", TURN.replace("REPEATS", str(repeats))],
        cwd=cwd, capture_output=True, text=True, timeout=900)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    if proc.returncode or not line:
        raise RuntimeError(f"turn in {cwd} failed (rc {proc.returncode}):\n"
                           + proc.stderr[-4000:])
    return json.loads(line[0][5:])


def mean(turns, key):
    vals = [r[key] for t in turns for r in t["runs"]
            if isinstance(r[key], float)]
    return sum(vals) / len(vals) if vals else "not measured"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other checkout's root directory")
    ap.add_argument("--repeats", type=int, default=2)
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
    summary = {who: {k: mean(ts, k) for k in ("k1_ms", "k1_device_ms",
                                                "k2_ms", "k2_device_ms")}
               for who, ts in turns.items()}
    ratio = {k: (summary["this"][k] / summary["other"][k]
                 if isinstance(summary["this"][k], float)
                 and isinstance(summary["other"][k], float)
                 else "not measured") for k in summary["this"]}
    print(json.dumps(dict(check="attention a/b", site="vit",
                          shape=[768, 12, 50, 64], dtype="bf16",
                          mean=summary, this_over_other=ratio, card=smi)),
          flush=True)
    proc = subprocess.run([sys.executable, "-c", HEAD_DIM_ROWS], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout, end="", flush=True)
    if proc.returncode:
        raise RuntimeError(f"head_dim rows failed:\n{proc.stderr[-4000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
