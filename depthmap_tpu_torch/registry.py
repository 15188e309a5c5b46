"""Model registry: the 15 depth models of the reference zoo.

Restated from ``depthmap_tpu/registry.py`` (held equal by
tests/test_torch_port_funnel.py).  The integer ids and string names are the
public API.  Only types 1 and 2 (the BEiT-L DPT models) build in this port
so far; see models/build.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelSpec:
    id: int
    name: str                      # canonical short name (API string)
    ui_name: str                   # name shown in the reference UI dropdown
    family: str
    default_net_size: Tuple[int, int]   # (width, height)
    # True when the raw model output is *depth* (near=small) rather than
    # disparity (near=large); the funnel negates it so near is always large.
    predicts_depth: bool
    resize_multiple_of: int = 32   # net-size constraint for the preprocess resize
    variant: Optional[str] = None  # family-internal variant key


_SPECS = [
    ModelSpec(0, "res101", "res101", "leres", (448, 448), True, 32),
    ModelSpec(1, "dpt_beit_large_512", "dpt_beit_large_512 (midas 3.1)",
              "midas", (512, 512), False, 32, "beitl16_512"),
    ModelSpec(2, "dpt_beit_large_384", "dpt_beit_large_384 (midas 3.1)",
              "midas", (384, 384), False, 32, "beitl16_384"),
    ModelSpec(3, "dpt_large_384", "dpt_large_384 (midas 3.0)",
              "midas", (384, 384), False, 32, "vitl16_384"),
    ModelSpec(4, "dpt_hybrid_384", "dpt_hybrid_384 (midas 3.0)",
              "midas", (384, 384), False, 32, "vitb_rn50_384"),
    ModelSpec(5, "midas_v21", "midas_v21", "midas", (384, 384), False, 32,
              "resnext101"),
    ModelSpec(6, "midas_v21_small", "midas_v21_small", "midas", (256, 256),
              False, 32, "efficientnet_lite3"),
    ModelSpec(7, "zoedepth_n", "zoedepth_n (indoor)", "zoedepth", (512, 384),
              True, 32, "n"),
    ModelSpec(8, "zoedepth_k", "zoedepth_k (outdoor)", "zoedepth", (768, 384),
              True, 32, "k"),
    ModelSpec(9, "zoedepth_nk", "zoedepth_nk", "zoedepth", (512, 384), True,
              32, "nk"),
    ModelSpec(10, "marigold_v1", "Marigold v1", "marigold", (768, 768), True, 8),
    ModelSpec(11, "depth_anything", "Depth Anything", "depth_anything",
              (518, 518), False, 14, "vitl14"),
    ModelSpec(12, "depth_anything_v2_small", "Depth Anything v2 Small",
              "depth_anything_v2", (518, 518), False, 14, "vits"),
    ModelSpec(13, "depth_anything_v2_base", "Depth Anything v2 Base",
              "depth_anything_v2", (518, 518), False, 14, "vitb"),
    ModelSpec(14, "depth_anything_v2_large", "Depth Anything v2 Large",
              "depth_anything_v2", (518, 518), False, 14, "vitl"),
]

MODELS = {s.id: s for s in _SPECS}
MODELS_BY_NAME = {s.name: s for s in _SPECS}
_UI_NAME_TO_ID = {s.ui_name.lower(): s.id for s in _SPECS}


def resolve_model_type(model_type) -> int:
    """Accepts an int id, a canonical name, or a UI display name."""
    if isinstance(model_type, ModelSpec):
        return model_type.id
    if isinstance(model_type, int):
        if model_type not in MODELS:
            raise KeyError(f"Unknown model id {model_type}")
        return model_type
    s = str(model_type).strip()
    if s.isdigit():
        return resolve_model_type(int(s))
    low = s.lower()
    if low in MODELS_BY_NAME:
        return MODELS_BY_NAME[low].id
    if low in _UI_NAME_TO_ID:
        return _UI_NAME_TO_ID[low]
    raise KeyError(f"Unknown model type {model_type!r}")


def get_default_net_size(model_type) -> Tuple[int, int]:
    """(width, height) of the registry.  The JAX package's
    DEPTHMAP_REFERENCE_DEFAULTS switch for the ZoeDepth family is not
    carried over: ZoeDepth is not ported yet."""
    return MODELS[resolve_model_type(model_type)].default_net_size
