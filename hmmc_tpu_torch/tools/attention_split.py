"""Where the tiled K1 and K2 spend their time: each body's kernels timed
apart, and throwaway variants of the final sources at the towers' sites.

Variants are copies of ``csrc/fused_attention_fwd.cu`` and
``csrc/fused_attention_bwd.cu`` with lines cut by text (``VARIANTS``),
built with the kernels' own nvcc flags into the ignored
``hmmc_tpu_torch/build/split_attention/``; the wrappers of
``hmmc_tpu_torch/ops/fused_attention.py`` launch them in place of the
built libraries. ``mask_all`` masks every KV tile, as the first tiled
version did, where the kernels mask only the tiles that hold a masked pair
(the causal diagonal, the ragged last tile); ``k2_3ctas`` and ``k2_4ctas``
cap K2's tiled kernels' registers for 3 or 4 CTAs an SM. An edit of a cut
line makes this script fail with the text it did not find: adjust
``VARIANTS`` with it. It is a one-off measurement and not part of
``chip_smoke.py``.

Run on a CUDA card, from the repository's root::

    python3 hmmc_tpu_torch/tools/attention_split.py [--seed 0]

Prints one JSON row a site (bf16, the main path's layout): device ms by
the profiler per kernel name, in turns (kernel, variants, variants
reversed, kernel), their means, and whether each variant's output is
bitwise the kernel's.
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
from chip_smoke import emit  # noqa: E402
from hmmc_tpu_torch.ops import fused_attention as fa  # noqa: E402
from hmmc_tpu_torch.ops import kernel_build  # noqa: E402

FWD, BWD = "fused_attention_fwd", "fused_attention_bwd"
_ROWS = "__launch_bounds__(kWarpsBwd * 32)\nattention_bwd_rows_kernel"
_KEYS = "__launch_bounds__(kWarpsBwd * 32)\nattention_bwd_keys_kernel"


def _cap(ctas):
    return tuple((old, old.replace("32)", f"32, {ctas})"))
                 for old in (_ROWS, _KEYS))


VARIANTS = {
    "mask_all": {
        FWD: (("if (diag || k0 + kTileRows > len) mask_tile(",
               "mask_tile("),),
        BWD: (("if (diag || k0 + kTileRows > len) {", "if (true) {"),
              ("const bool edge = diag || q0 + kTileRows > len || "
               "k0 + kTileRows > len;", "const bool edge = true;"))},
    "k2_3ctas": {BWD: _cap(3)},
    "k2_4ctas": {BWD: _cap(4)},
}
# (B, H, L, causal): the towers' ViT sites (a micro-batch's frames x heads)
SITES = ((192, 12, 197, False), (48, 16, 257, False), (48, 16, 577, False),
         (48, 16, 577, True))


def variant_libraries():
    """{variant: {source: CDLL}}, built and loaded, with the built
    libraries' argument types."""
    where = kernel_build.BUILD_DIR / "split_attention"
    where.mkdir(parents=True, exist_ok=True)
    shutil.copy(kernel_build.CSRC_DIR / "attention_mma.cuh", where)
    procs = {}
    for v, by_source in VARIANTS.items():
        for name, cuts in by_source.items():
            src = (kernel_build.CSRC_DIR / f"{name}.cu").read_text()
            for old, new in cuts:
                if old not in src:
                    raise AssertionError(f"{v}/{name}: {old!r} is not in "
                                         "the kernel's source")
                src = src.replace(old, new)
            (where / f"{name}_{v}.cu").write_text(src)
            procs[v, name] = subprocess.Popen(
                [kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS, "-o",
                 str(where / f"lib{name}_{v}.so"),
                 str(where / f"{name}_{v}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {FWD: fa._library(), BWD: fa._library_bwd()}
    libs = {}
    for (v, name), proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{v}/{name}: nvcc failed:\n{out}")
        lib = ctypes.CDLL(str(where / f"lib{name}_{v}.so"))
        for fn in dir(built[name]):
            if fn.startswith("hmmc_"):
                getattr(lib, fn).argtypes = getattr(built[name], fn).argtypes
                getattr(lib, fn).restype = getattr(built[name], fn).restype
        libs.setdefault(v, {})[name] = lib
    return libs


def per_kernel_ms(fn, iters=20):
    """Device ms per call of each kernel name a call launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type.name == "CUDA" and us > 0:
            name = e.key.replace("(anonymous namespace)::", "").split(
                "(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + us / 1e3 / iters
    return out


def split(seed, smi):
    libs = variant_libraries()
    kernel = (fa._library, fa._library_bwd)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    try:
        for b, h, l, causal in SITES:
            d = 64   # the ViT towers' head_dim
            x = torch.randn(b, l, 3 * h * d, device="cuda",
                            generator=gen).to(torch.bfloat16)
            q, k, v = (t.transpose(1, 2) for t in
                       x.view(b, l, 3, h, d).unbind(2))
            g = torch.randn(b, l, h, d, device="cuda",
                            generator=gen).to(torch.bfloat16).transpose(1, 2)

            def call():
                return (fa.fused_attention_forward(q, k, v, causal),
                        *fa.fused_attention_backward(q, k, v, g, causal))

            order = ["kernel", *VARIANTS]
            ms, outs = {n: [] for n in order}, {}
            for n in order + order[::-1]:
                by = libs.get(n, {})
                fa._library = (lambda lib=by.get(FWD): lib) if FWD in by \
                    else kernel[0]
                fa._library_bwd = (lambda lib=by.get(BWD): lib) \
                    if BWD in by else kernel[1]
                outs[n] = call()
                ms[n].append(per_kernel_ms(call))
            fa._library, fa._library_bwd = kernel
            mean = {n: {kn: sum(t[kn] for t in runs) / len(runs)
                        for kn in runs[0]} for n, runs in ms.items()}
            row = dict(check="attention split", shape=[b, h, l, d],
                       causal=causal, dtype="bf16", mean_ms=mean, ms=ms,
                       bitwise_equal_kernel={
                           n: all(torch.equal(a, c) for a, c in
                                  zip(outs[n], outs["kernel"]))
                           for n in VARIANTS}, card=smi)
            emit(row)
            rows.append(row)
    finally:
        fa._library, fa._library_bwd = kernel
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_split: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    kernel_build.build([FWD, BWD])
    split(args.seed, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
