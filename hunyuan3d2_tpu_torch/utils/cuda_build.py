"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel source under ``hunyuan3d2_tpu_torch/csrc/`` has a plain C
interface. At first use it is compiled for Hopper (``sm_90a``) into a
shared library under ``build/hunyuan3d2_tpu_torch/`` at the repository root,
keyed by a hash of the source, every header in ``csrc/`` and the flags, and
loaded with ``ctypes``.
Nothing here runs when a module is imported, and nothing falls back: a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "hunyuan3d2_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    """Path of the shared library for ``csrc/<name>.cu`` at the current hash
    of its source, of every ``csrc/*.cuh`` header (any of them may be
    included) and of the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp path, final
    path) or None when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    with open(out + ".log", "w") as fh:
        fh.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build(names) -> dict:
    """Build every named source at once (one nvcc each, all started together)
    and return {name: nvcc log} for those that were built now."""
    jobs = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, j) for n, j in jobs.items() if j is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _LIBS[name] = lib
        return lib
