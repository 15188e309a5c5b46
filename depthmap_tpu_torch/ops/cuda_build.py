"""Build the hand-written CUDA kernels of ``csrc/`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by nvcc
into ``_build/<name>-<hash>.so`` (the hash covers the source and the
flags), then loaded with ctypes.  Nothing is built at import time: the
first call of ``load(name)`` compiles, later calls reuse the loaded
library.  PyTorch's headers are not included, so a build takes seconds.
ptxas reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); ``build_logs`` keeps the report of each build this
process ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (sm_90a)")
    return path


def load(name: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile (once per source hash) and load csrc/<name>.cu."""
    if name in _loaded:
        return _loaded[name]
    src = os.path.join(CSRC, f"{name}.cu")
    flags = list(ARCH_FLAGS) + list(BASE_FLAGS) + list(extra_flags)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # compile to a private name, then publish atomically: a concurrent
        # process never loads a half-written library
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([nvcc_path(), *flags, "-o", tmp, src],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        build_logs[name] = proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    build_seconds[name] = time.perf_counter() - t0
    _loaded[name] = lib
    return lib
