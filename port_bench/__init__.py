"""The benchmark of depthmap_tpu_torch: see run.py."""
