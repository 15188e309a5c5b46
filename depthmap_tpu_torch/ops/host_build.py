"""Build the host (CPU) kernels of ``csrc/`` with g++ and load them.

Each ``csrc/<name>.cpp`` has a plain C interface and is compiled into
``_build/<name>-<hash>.so`` by ``cuda_build.build`` (the hash covers the
source and the flags), then loaded with ctypes, as ``ops/cuda_build.py``
does with nvcc for the card's kernels.  Nothing is built at import time;
a failed build raises.  The flags turn FMA contraction off and do not
tune for the building CPU, so the f64 arithmetic is the source's, byte for
byte, on any x86-64 host.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from typing import Dict

from depthmap_tpu_torch.ops.cuda_build import CSRC, build

FLAGS = ("-std=c++17", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load csrc/<name>.cpp."""
    if name not in _loaded:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: csrc/{name}.cpp is built "
                               "with g++")
        out, _ = build(os.path.join(CSRC, f"{name}.cpp"), gxx, FLAGS)
        _loaded[name] = ctypes.CDLL(out)
    return _loaded[name]
