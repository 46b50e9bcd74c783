"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with
a plain C interface, ``_build/<name>_<hash>.so``, keyed by the source's
content hash (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC -split-compile=0``).  ``build_all`` starts one nvcc per
source at once, so a fresh checkout builds everything in the time of the
slowest file.  A failed build raises: no kernel falls back to its plain
version on the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
SOURCES = ("selective_scan_fwd", "selective_scan_bwd", "dwconv3d",
           "mamba_step", "moe_combine")
# -split-compile=0: nvcc optimises a source's kernels on every core (each
# source instantiates its kernels for every d_state family)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / spill report) of builds in this process
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source on the machine with the card")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return src, os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def build_all(names=SOURCES) -> float:
    """Compile every missing library in parallel; returns wall seconds."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _, so = _target(name)
        if not os.path.exists(so):
            build_all((name,))
        lib = ctypes.CDLL(so)
        _LIBS[name] = lib
    return lib
