"""Build the port's CUDA kernels with ``nvcc`` into shared libraries.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes
``build/lib<name>-<hash>.so`` inside this package (``.gitignore`` lists the
directory), compiled for Hopper (``sm_90a``) at first use and loaded with
:mod:`ctypes`. The hash covers the source, the shared headers
(``csrc/*.cuh``), the flags and the compiler path, so an edited source or
header is rebuilt and an unchanged one is reused. Nothing here
runs at import time: the CPU tests import every module on machines without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    root that ``torch.utils.cpp_extension`` detects."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from hmmc_tpu_torch/csrc at first use")


def _target(name: str, nvcc: str) -> Path:
    """The library's path, keyed by the source, every header in ``csrc/``
    (a source may include any of them), the flags and the compiler."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: List[str]) -> Dict[str, dict]:
    """Compile ``csrc/<name>.cu`` for every name, one ``nvcc`` process per
    source, all started together. Returns per name: ``path``, ``seconds``
    (wall time of that compile; 0 when reused), ``cached`` and ``ptxas``
    (the ``-Xptxas -v`` register / shared-memory / spill lines). Raises
    with the compiler's output if any compile fails."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    info: Dict[str, dict] = {}
    for name in names:
        target = _target(name, nvcc)
        if target.exists():
            info[name] = {"path": str(target), "seconds": 0.0,
                          "cached": True, "ptxas": []}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in jobs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc={proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent build never sees
        info[name] = {              # a half-written library
            "path": str(target), "seconds": seconds, "cached": False,
            "ptxas": [ln.strip() for ln in out.splitlines()
                      if "ptxas info" in ln or "spill" in ln]}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it."""
    return ctypes.CDLL(build([name])[name]["path"])


def kernel_sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
