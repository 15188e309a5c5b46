"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
dense rates without sparsity, at each part's full power limit): tensor
rates by dtype in operations per second and memory bandwidth in bytes
per second.  A card whose name matches no entry has no peaks, and the
metrics that need them are left out of its results."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    # H100 SXM5 80 GB, 700 W
    "H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                       "tf32": 495e12, "float32": 67e12, "hbm_bps": 3.35e12},
    # H100 PCIe 80 GB, 350 W
    "H100 PCIe": {"bfloat16": 756e12, "float16": 756e12, "tf32": 378e12,
                  "float32": 51e12, "hbm_bps": 2.0e12},
}


def for_card(name: str) -> Optional[dict]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    return None
