"""Canonical generation options.

Restated from ``depthmap_tpu/options.py`` (same fields, same defaults, same
silent-default ``from_dict`` semantics; held equal by
tests/test_torch_port_funnel.py).  ``compute_device`` picks the torch
device: "GPU" is ``cuda`` (and fails without CUDA), "CPU" is ``cpu``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class GenerationOptions:
    """All options consumed by the generation pipeline, with reference defaults."""

    compute_device: str = "GPU"  # "GPU" -> cuda, "CPU" -> cpu
    model_type: Any = "Depth Anything v2 Base"
    boost: bool = False
    net_size_match: bool = False
    net_width: int = 448
    net_height: int = 448
    tiling_mode: bool = False

    do_output_depth: bool = True
    output_depth_invert: bool = False
    output_depth_combine: bool = False
    output_depth_combine_axis: str = "Horizontal"
    do_output_depth_prediction: bool = False  # hidden option (video mode pass 1)

    clipdepth: bool = False
    clipdepth_mode: str = "Range"  # "Range" | "Outliers"
    clipdepth_far: float = 0.0
    clipdepth_near: float = 1.0

    gen_stereo: bool = False
    stereo_modes: List[str] = field(
        default_factory=lambda: ["left-right", "red-cyan-anaglyph"])
    stereo_divergence: float = 2.5
    stereo_separation: float = 0.0
    stereo_fill_algo: str = "polylines_sharp"
    stereo_offset_exponent: float = 1.0
    stereo_balance: float = 0.0

    gen_normalmap: bool = False
    normalmap_pre_blur: bool = False
    normalmap_pre_blur_kernel: int = 3
    normalmap_sobel: bool = True
    normalmap_sobel_kernel: int = 3
    normalmap_post_blur: bool = False
    normalmap_post_blur_kernel: int = 3
    normalmap_invert: bool = False

    gen_heatmap: bool = False

    gen_simple_mesh: bool = False
    simple_mesh_occlude: bool = True
    simple_mesh_spherical: bool = False

    gen_inpainted_mesh: bool = False
    gen_inpainted_mesh_demos: bool = False

    gen_rembg: bool = False
    save_background_removal_masks: bool = False
    pre_depth_background_removal: bool = False
    rembg_model: str = "u2net"

    @classmethod
    def field_names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    @classmethod
    def from_dict(cls, values) -> "GenerationOptions":
        """Build options from a dict; unknown keys are silently discarded and
        missing keys default."""
        if isinstance(values, GenerationOptions):
            return dataclasses.replace(values)
        lowered = {}
        for k, v in (values or {}).items():
            name = getattr(k, "name", k)
            lowered[str(name).lower()] = v
        known = set(cls.field_names())
        return cls(**{k: v for k, v in lowered.items() if k in known})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "GenerationOptions":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, item):
        return getattr(self, str(getattr(item, "name", item)).lower())
