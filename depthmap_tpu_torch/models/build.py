"""Model construction: id/name -> (torch module, preprocess cfg, output
semantics).  Port of ``depthmap_tpu/models/build.py`` for the model types
this port has: 0 (LeReS res101), 1-4 (the DPT models: BEiT-L 512 / 384,
ViT-L 384, the ViT-B + ResNet-50 hybrid), 5-6 (midas_v21,
midas_v21_small), 7-9 (ZoeDepth n / k / nk), 10 (Marigold v1: the
diffusion pipeline as one module, ``models/marigold/pipeline.py``), 11
(Depth Anything v1) and 12-14 (Depth Anything v2 small / base / large).

Every module takes NCHW input and offers ``grid_inputs(input_hw, dtype)``
(what it computes from its parameters for an input size, passed to its
forward as keywords) and ``head_to_f32()``.  A ``prep_in_model`` module
(ZoeDepth) takes the image in [0, 1] with ``net_size``, resizes and
normalizes it itself, returns the map at the input size, and offers
``net_input_size`` and ``core_to(dtype)``.  ``selective_core`` names the
JAX package's policy for running such a model's core in another dtype
than its head (``pipeline.depth.precision`` reads it).  A
``host_pipeline`` module (Marigold) is a whole pipeline run per image: it
takes one (H, W, 3) image in [0, 1] as a numpy array with its processing
resolution and knobs and returns the map at that resolution, names its
own dtype (``pipeline_dtype()``) and loads its own weights
(``load_weights(weights_dir, seed)``).  ``boost_preprocess`` is the
preprocess Boost feeds a model where it is not the model's own."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

import torch.nn as nn

from depthmap_tpu_torch.pipeline.preprocess import (HALF_MEAN, HALF_STD,
                                                    IMAGENET_MEAN,
                                                    IMAGENET_STD,
                                                    INTER_LINEAR,
                                                    PreprocessCfg)
from depthmap_tpu_torch.registry import MODELS, resolve_model_type

@dataclass
class ModelBundle:
    spec: Any
    module: nn.Module                # NCHW in, (N, h', w') raw map out
    preprocess: PreprocessCfg
    # how the raw net output is resized back to the input resolution
    upsample_mode: str = "bicubic"
    upsample_align_corners: bool = False
    predicts_depth: bool = False     # True => funnel negates before normalize
    prep_in_model: bool = False      # resize/normalize happen inside the net
    # ZoeDepth's selective precision: "zoe_core_env" (the core in
    # DEPTHMAP_ZOE_CORE_DTYPE, bf16 by default) or "knk_head_f32" (bf16
    # core, f32 head unless DEPTHMAP_ZOE_KNK_HEAD_F32=0); None: one dtype
    selective_core: Optional[str] = None
    # a per-image pipeline on the host (Marigold): its own dtype and
    # loader, its convolutions never tiled, a batch run image by image
    host_pipeline: bool = False
    # what Boost feeds the net, where it differs from ``preprocess``
    boost_preprocess: Optional[PreprocessCfg] = None


def is_host_pipeline(model_type) -> bool:
    """Whether ``build_model(model_type)`` gives a host pipeline, known
    without building it (the funnel and the predictor cache pass and key
    the pipeline's knobs by it)."""
    return MODELS[resolve_model_type(model_type)].family == "marigold"


def build_model(model_type) -> ModelBundle:
    mt = resolve_model_type(model_type)
    spec = MODELS[mt]
    if mt in (5, 6):  # midas_v21, midas_v21_small
        from depthmap_tpu_torch.models import midas_net
        module = midas_net.build_midas_v21() if mt == 5 else \
            midas_net.build_midas_v21_small()
        return ModelBundle(
            spec=spec, module=module,
            preprocess=PreprocessCfg(resize_mode="upper_bound",
                                     mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                     swap_channels=True),
            upsample_mode="bicubic", upsample_align_corners=False)
    if mt in (1, 2, 3, 4):  # DPT: BEiT-L, ViT-L, the hybrid
        from depthmap_tpu_torch.models.dpt import build_dpt
        prep = PreprocessCfg(resize_mode="minimal", mean=HALF_MEAN,
                             std=HALF_STD, swap_channels=True)
        # the reference's Boost routes every MiDaS-family net, the DPTs
        # too, through estimatemidasBoost: ImageNet statistics and
        # upper_bound resizing (midas_v21's own), not the DPTs' own
        return ModelBundle(
            spec=spec, module=build_dpt(spec.variant), preprocess=prep,
            upsample_mode="bicubic", upsample_align_corners=False,
            boost_preprocess=replace(prep, resize_mode="upper_bound",
                                     mean=IMAGENET_MEAN, std=IMAGENET_STD))
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
    if mt in (7, 8, 9):  # ZoeDepth: preprocessing inside the model
        from depthmap_tpu_torch.models.zoedepth import build_zoedepth
        return ModelBundle(
            spec=spec, module=build_zoedepth(spec.variant),
            preprocess=PreprocessCfg(resize_mode="none", swap_channels=True),
            upsample_mode="bilinear", upsample_align_corners=True,
            predicts_depth=True, prep_in_model=True,
            selective_core="zoe_core_env" if mt == 7 else "knk_head_f32")
    if mt == 0:  # LeReS res101: RGB, squashed, bilinear
        from depthmap_tpu_torch.models.leres import build_leres
        return ModelBundle(
            spec=spec, module=build_leres(),
            preprocess=PreprocessCfg(resize_mode="squash",
                                     mean=IMAGENET_MEAN, std=IMAGENET_STD,
                                     interpolation=INTER_LINEAR),
            upsample_mode="bicubic", upsample_align_corners=False,
            predicts_depth=True)
    if mt == 10:  # Marigold: the pipeline resizes and normalizes itself
        from depthmap_tpu_torch.models.marigold.pipeline import \
            build_marigold
        return ModelBundle(
            spec=spec, module=build_marigold(),
            preprocess=PreprocessCfg(resize_mode="lower_bound"),
            predicts_depth=True, host_pipeline=True)
    raise KeyError(f"model type {mt} is not in the zoo")
