"""K1's and K2's tiled bodies against their short ones at the short
bodies' sites: whether one body could serve every length.

The tiled-only variants are copies of ``csrc/fused_attention_fwd.cu`` and
``csrc/fused_attention_bwd.cu`` whose short-body limits are cut to 0 by
text (``CUTS``), built with the kernels' own nvcc flags into the ignored
``hmmc_tpu_torch/build/bodies/``; the wrappers of
``hmmc_tpu_torch/ops/fused_attention.py`` then launch them in place of the
built libraries. An edit of a cut line makes this script fail with the
text it did not find: adjust ``CUTS`` with it. It is a one-off measurement
and not part of ``chip_smoke.py``.

Run on a CUDA card, from the repository's root::

    python3 hmmc_tpu_torch/tools/attention_bodies.py [--seed 0]

Prints one JSON row a site and kernel (bf16, the main path's layout: head
views of a packed qkv projection): device ms by the profiler in turns
(short, tiled, tiled, short) and their means, and how far the two bodies'
outputs lie apart (bitwise equal or the max abs difference).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from chip_smoke import emit, kernel_device_ms  # noqa: E402
from hmmc_tpu_torch.ops import fused_attention as fa  # noqa: E402
from hmmc_tpu_torch.ops import kernel_build  # noqa: E402

CUTS = {name: (("constexpr int kMaxLen = 128;",
                "constexpr int kMaxLen = 0;"),)
        for name in ("fused_attention_fwd", "fused_attention_bwd")}
# (site, B, H, L, causal, backward): the short bodies' main-path sites
SITES = (("vit", 768, 12, 50, False, False),
         ("vit", 768, 12, 50, False, True),
         ("text", 512, 8, 32, True, False),
         ("text", 64, 8, 32, True, True),
         ("temporal", 64, 8, 12, False, False),
         ("temporal", 64, 8, 12, False, True),
         ("longest", 8, 12, 128, False, False),
         ("longest", 8, 12, 128, False, True))


def tiled_only_libraries():
    """The two tiled-only variants, built and loaded, with the built
    libraries' argument types."""
    where = kernel_build.BUILD_DIR / "bodies"
    where.mkdir(parents=True, exist_ok=True)
    shutil.copy(kernel_build.CSRC_DIR / "attention_mma.cuh", where)
    procs = {}
    for name, cuts in CUTS.items():
        src = (kernel_build.CSRC_DIR / f"{name}.cu").read_text()
        for old, new in cuts:
            if old not in src:
                raise AssertionError(f"{name}: {old!r} is not in the "
                                     "kernel's source")
            src = src.replace(old, new)
        (where / f"{name}_tiled.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o",
             str(where / f"lib{name}_tiled.so"),
             str(where / f"{name}_tiled.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name} tiled-only variant: nvcc failed:\n{out}")
        libs[name] = ctypes.CDLL(str(where / f"lib{name}_tiled.so"))
    for name, built in (("fused_attention_fwd", fa._library()),
                        ("fused_attention_bwd", fa._library_bwd())):
        for fn in dir(built):
            if fn.startswith("hmmc_"):
                getattr(libs[name], fn).argtypes = getattr(built, fn).argtypes
                getattr(libs[name], fn).restype = getattr(built, fn).restype
    return libs["fused_attention_fwd"], libs["fused_attention_bwd"]


def compare(seed, smi):
    short = (fa._library, fa._library_bwd)
    tiled_fwd, tiled_bwd = tiled_only_libraries()
    tiled = (lambda: tiled_fwd, lambda: tiled_bwd)

    def use(libs):
        fa._library, fa._library_bwd = libs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    try:
        for site, b, h, l, causal, backward in SITES:
            d = 64   # the ViT and text towers' head_dim
            x = torch.randn(b, l, 3 * h * d, device="cuda",
                            generator=gen).to(torch.bfloat16)
            q, k, v = (t.transpose(1, 2) for t in
                       x.view(b, l, 3, h, d).unbind(2))
            g = torch.randn(b, l, h, d, device="cuda",
                            generator=gen).to(torch.bfloat16).transpose(1, 2)

            def call():
                if backward:
                    return fa.fused_attention_backward(q, k, v, g, causal)
                return (fa.fused_attention_forward(q, k, v, causal),)

            outs, ms = {}, {"short": [], "tiled": []}
            for body in ("short", "tiled", "tiled", "short"):
                use(short if body == "short" else tiled)
                outs[body] = call()
                ms[body].append(kernel_device_ms(call, 20))
            use(short)
            torch.cuda.synchronize()
            diff = max(float((a.float() - t.float()).abs().max())
                       for a, t in zip(outs["short"], outs["tiled"]))
            mean = {k: sum(t) / len(t) for k, t in ms.items()}
            row = dict(check="attention bodies", site=site,
                       kernel="K2" if backward else "K1",
                       shape=[b, h, l, d], causal=causal, dtype="bf16",
                       ms=ms, mean_ms=mean,
                       tiled_over_short=mean["tiled"] / mean["short"],
                       bitwise_equal=all(torch.equal(a, t) for a, t in
                                         zip(outs["short"], outs["tiled"])),
                       max_abs_diff=diff, card=smi)
            emit(row)
            rows.append(row)
    finally:
        use(short)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_bodies: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    kernel_build.build(list(CUTS))
    compare(args.seed, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
