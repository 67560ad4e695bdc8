"""Where the frame kernels' time goes: R1 (``csrc/resize_crop.cu``) and R2
(``csrc/resize_area.cu``) each timed against throwaway variants of its own
source with parts cut out, at their main paths' 768 frames of 341x256 4:2:0
planes laid out as nvJPEG leaves them.

The variants are copies of the kernel sources with call sites cut by text
(``SPLITS``), built with the kernels' own nvcc flags into the ignored
``hmmc_tpu_torch/build/split/``; nothing in the kernels is a switch. The
cuts match the sources' exact wording, so an edit of a cut call site makes
this script fail with the text it did not find: adjust ``SPLITS`` with it.
It is a one-off measurement and not part of ``chip_smoke.py``.

Run on a CUDA card, from the repository's root::

    python3 hmmc_tpu_torch/tools/frames_split.py [--seed 0]

Prints one JSON row a kernel: device ms by the profiler in turns (kernel,
variants, variants reversed, kernel) and their means; for R1 the taps (the
kernel less its ``no_taps`` variant), the conversion and the rest; for R2
the conversion, the stores and the staging.
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
from chip_smoke import (AUG, BLOCK_FRAMES, RES, STORE_SIZE, emit,  # noqa: E402
                        kernel_device_ms, random_frames)
from hmmc_tpu_torch.data import jpeg  # noqa: E402
from hmmc_tpu_torch.ops import kernel_build  # noqa: E402
from hmmc_tpu_torch.ops import resize_area as r2  # noqa: E402
from hmmc_tpu_torch.ops import resize_crop as rc  # noqa: E402
from hmmc_tpu_torch.ops.resize_crop import plane_batch  # noqa: E402

# R1: its two tensor-core passes (the taps), then everything but staging
# and the stores; R2: its conversion, then everything but staging.
_R1_TAPS = (("hpass(P, g, k, k.origin", "if (false) hpass(P, g, k, k.origin"),
            ("vpass(P, g, k, i, ring, tile, strip_cols);", ""))
_R2_CONVERT = (("hmmc_planes::convert<true>(",
                "if (false) hmmc_planes::convert<true>("),)
SPLITS = {
    "resize_crop": {"no_taps": _R1_TAPS,
                    "staging_and_stores": _R1_TAPS + (
                        ("hmmc_planes::convert<false>(",
                         "if (false) hmmc_planes::convert<false>("),)},
    "resize_area": {"no_conversion": _R2_CONVERT,
                    "staging_only": _R2_CONVERT + (
                        ("hmmc_planes::store_rows(out + tr.r0",
                         "if (false) hmmc_planes::store_rows(out + tr.r0"),)},
}


def kernel_split(gen, smi):
    """Where R1's and R2's time goes at their paths' 768 frames (planes as
    the decoder lays them out): each kernel against its SPLITS variants on
    one descriptor, device ms by the profiler in turns (kernel, variants,
    variants reversed, kernel). R1's taps are the kernel less its no_taps
    variant."""
    where = kernel_build.BUILD_DIR / "split"
    where.mkdir(parents=True, exist_ok=True)
    shutil.copy(kernel_build.CSRC_DIR / "jpeg_planes.cuh", where)
    procs = {}
    for name, variants in SPLITS.items():
        src0 = (kernel_build.CSRC_DIR / f"{name}.cu").read_text()
        for v, cuts in variants.items():
            src = src0
            for old, new in cuts:
                if old not in src:
                    raise AssertionError(f"split {name}/{v}: {old!r} is not "
                                         "in the kernel's source")
                src = src.replace(old, new)
            (where / f"{name}_{v}.cu").write_text(src)
            procs[name, v] = subprocess.Popen(
                [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o",
                 str(where / f"lib{name}_{v}.so"),
                 str(where / f"{name}_{v}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"split variant {key}: nvcc failed:\n{out}")
    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    frames = random_frames(gen, BLOCK_FRAMES, *STORE_SIZE, "ycc420",
                           pitch_align=jpeg.PITCH_ALIGN)
    batch = plane_batch(frames)
    rows = []
    for name, mod, size in (("resize_crop", rc, RES),
                            ("resize_area", r2, AUG)):
        libs = {"kernel": mod._library()}
        for v in SPLITS[name]:
            libs[v] = ctypes.CDLL(str(where / f"lib{name}_{v}.so"))
        fn = f"hmmc_{name}"
        for lib in libs.values():
            getattr(lib, fn).argtypes = getattr(libs["kernel"], fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        head, tabs, items, plan = mod.descriptor(batch, size, dev,
                                                 mod.persistent_ctas)
        host, desc = rc.upload(head, batch.rows, dev)
        out = torch.empty((BLOCK_FRAMES, size, size, 3), dtype=torch.uint8,
                          device=dev)

        def run(lib):
            grid = ctypes.c_int()
            err = getattr(lib, fn)(desc.data_ptr(), host.data_ptr(), items,
                                   plan.smem, out.data_ptr(), stream,
                                   ctypes.byref(grid))
            if err != 0:
                raise RuntimeError(f"split launch failed: CUDA error {err}")

        order = list(libs)
        ms = {v: [] for v in libs}
        for v in order + order[::-1]:
            ms[v].append(kernel_device_ms(lambda: run(libs[v]), 20))
        mean = {v: sum(t) / len(t) for v, t in ms.items()}
        row = dict(phase="frames", check=f"{name} split", frames=BLOCK_FRAMES,
                   size=list(STORE_SIZE), out=size, ms=ms, mean_ms=mean,
                   items=items, smem=plan.smem, card=smi)
        if name == "resize_crop":
            row.update(taps_ms=mean["kernel"] - mean["no_taps"],
                       taps_share=1 - mean["no_taps"] / mean["kernel"],
                       conversion_ms=mean["no_taps"]
                       - mean["staging_and_stores"])
        else:
            row.update(conversion_ms=mean["kernel"] - mean["no_conversion"],
                       stores_ms=mean["no_conversion"] - mean["staging_only"])
        emit(row)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("frames_split: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    kernel_build.build(["resize_crop", "resize_area"])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernel_split(gen, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
