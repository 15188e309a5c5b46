"""Model construction: id/name -> (torch module, preprocess cfg, output
semantics).  Port of ``depthmap_tpu/models/build.py`` for the model types
this port has: 1 (dpt_beit_large_512), 2 (dpt_beit_large_384), 11 (Depth
Anything v1) and 12-14 (Depth Anything v2 small / base / large)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch.nn as nn

from depthmap_tpu_torch.pipeline.preprocess import (HALF_MEAN, HALF_STD,
                                                    IMAGENET_MEAN,
                                                    IMAGENET_STD,
                                                    PreprocessCfg)
from depthmap_tpu_torch.registry import MODELS, resolve_model_type

# where each model type not ported yet stands in ROADMAP.md
_ROADMAP = {
    0: "Queue 1 item 10 (LeReS + Boost)",
    3: "Queue 1 item 8 (rest of the MiDaS/DPT zoo)",
    4: "Queue 1 item 8 (rest of the MiDaS/DPT zoo)",
    5: "Queue 1 item 8 (rest of the MiDaS/DPT zoo)",
    6: "Queue 1 item 8 (rest of the MiDaS/DPT zoo)",
    7: "Queue 1 item 9 (ZoeDepth)",
    8: "Queue 1 item 9 (ZoeDepth)",
    9: "Queue 1 item 9 (ZoeDepth)",
    10: "Queue 1 item 12 (Marigold)",
}


@dataclass
class ModelBundle:
    spec: Any
    module: nn.Module                # NCHW in, (N, h', w') raw map out
    preprocess: PreprocessCfg
    # how the raw net output is resized back to the input resolution
    upsample_mode: str = "bicubic"
    upsample_align_corners: bool = False
    predicts_depth: bool = False     # True => funnel negates before normalize


def build_model(model_type) -> ModelBundle:
    mt = resolve_model_type(model_type)
    spec = MODELS[mt]
    if mt in (1, 2):  # DPT BEiT-L
        from depthmap_tpu_torch.models.dpt import build_dpt
        return ModelBundle(
            spec=spec, module=build_dpt(spec.variant),
            preprocess=PreprocessCfg(resize_mode="minimal",
                                     mean=HALF_MEAN, std=HALF_STD,
                                     swap_channels=True),
            upsample_mode="bicubic", upsample_align_corners=False)
    if mt in (11, 12, 13, 14):  # Depth Anything v1 / v2
        from depthmap_tpu_torch.models import depth_anything as da
        module = da.build_depth_anything_v1() if mt == 11 else \
            da.build_depth_anything_v2(spec.variant)
        # swap_channels: the reference DA2 path swaps twice (the funnel
        # hands BGR floats, the v2 estimator converts them back to RGB, its
        # image2tensor swaps again), so the net sees BGR; kept for
        # whole-pipeline parity with the reference
        return ModelBundle(
            spec=spec, module=module,
            preprocess=PreprocessCfg(resize_mode="lower_bound",
                                     mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                     multiple_of=14, swap_channels=True),
            upsample_mode="bilinear", upsample_align_corners=mt != 11)
    raise NotImplementedError(
        f"model {spec.name} (type {mt}) is not ported yet: ROADMAP.md "
        f"{_ROADMAP[mt]}")
