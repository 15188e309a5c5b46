"""Input preprocessing on the predictor's device.

Port of ``depthmap_tpu/pipeline/preprocess.py``: the MiDaS ``Resize`` rule
(keep aspect ratio, lower_bound / upper_bound / minimal, constrain to a
multiple) is restated as is.  The config names its resize by cv2's
interpolation code, as the JAX package's does, and torch computes it:
INTER_CUBIC is torch's bicubic (a = -0.75, align_corners=False, no
antialias), INTER_LINEAR its bilinear (align_corners=False, no antialias),
each of which agrees with cv2's float resize to float rounding (at an exact
2x downscale cv2 switches INTER_LINEAR to INTER_AREA, the same 2 x 2 mean),
so no cv2 is needed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from depthmap_tpu_torch.ops.resize import interpolate

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_STD = (0.5, 0.5, 0.5)
# cv2's interpolation codes (cv2.INTER_LINEAR, cv2.INTER_CUBIC) -> torch mode
INTER_LINEAR, INTER_CUBIC = 1, 2
_TORCH_MODE = {INTER_LINEAR: "bilinear", INTER_CUBIC: "bicubic"}


def constrain_to_multiple_of(x: float, multiple_of: int, min_val: int = 0,
                             max_val: Optional[int] = None) -> int:
    y = int(np.round(x / multiple_of) * multiple_of)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple_of) * multiple_of)
    if y < min_val:
        y = int(np.ceil(x / multiple_of) * multiple_of)
    return y


def resize_get_size(in_width: int, in_height: int, width: int, height: int,
                    resize_method: str = "lower_bound",
                    keep_aspect_ratio: bool = True,
                    ensure_multiple_of: int = 1) -> Tuple[int, int]:
    """(new_width, new_height) per the MiDaS Resize.get_size rules."""
    scale_height = height / in_height
    scale_width = width / in_width

    if keep_aspect_ratio:
        if resize_method == "lower_bound":
            if scale_width > scale_height:
                scale_height = scale_width
            else:
                scale_width = scale_height
        elif resize_method == "upper_bound":
            if scale_width < scale_height:
                scale_height = scale_width
            else:
                scale_width = scale_height
        elif resize_method == "minimal":
            if abs(1 - scale_width) < abs(1 - scale_height):
                scale_height = scale_width
            else:
                scale_width = scale_height
        else:
            raise ValueError(f"resize_method {resize_method} not implemented")

    m = ensure_multiple_of
    if resize_method == "lower_bound":
        new_height = constrain_to_multiple_of(scale_height * in_height, m,
                                              min_val=height)
        new_width = constrain_to_multiple_of(scale_width * in_width, m,
                                             min_val=width)
    elif resize_method == "upper_bound":
        new_height = constrain_to_multiple_of(scale_height * in_height, m,
                                              max_val=height)
        new_width = constrain_to_multiple_of(scale_width * in_width, m,
                                             max_val=width)
    elif resize_method == "minimal":
        new_height = constrain_to_multiple_of(scale_height * in_height, m)
        new_width = constrain_to_multiple_of(scale_width * in_width, m)
    else:
        raise ValueError(f"resize_method {resize_method} not implemented")
    return new_width, new_height


@dataclass(frozen=True)
class PreprocessCfg:
    resize_mode: str = "upper_bound"  # lower_bound|upper_bound|minimal|squash
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    multiple_of: int = 32
    keep_aspect_ratio: bool = True
    interpolation: int = INTER_CUBIC
    # The reference hands channel-swapped (BGR) images to the MiDaS and
    # ZoeDepth nets (LeReS swaps back); replicated for output parity.
    swap_channels: bool = False


def net_input_size(in_w: int, in_h: int, net_w: int, net_h: int,
                   cfg: PreprocessCfg,
                   resize_mode: Optional[str] = None) -> Tuple[int, int]:
    """(new_w, new_h) the net sees for an in_w x in_h image."""
    mode = resize_mode or cfg.resize_mode
    if mode == "squash":
        return net_w, net_h
    return resize_get_size(in_w, in_h, net_w, net_h, mode,
                           cfg.keep_aspect_ratio, cfg.multiple_of)


def preprocess_images(imgs01: torch.Tensor, net_w: int, net_h: int,
                      cfg: PreprocessCfg,
                      resize_mode: Optional[str] = None) -> torch.Tensor:
    """imgs01: (N, H, W, 3) float RGB in [0, 1] on any device ->
    (N, 3, h', w') float32 NCHW, normalized, on the same device."""
    x = imgs01.to(torch.float32)
    if cfg.swap_channels:
        x = x.flip(-1)
    x = x.permute(0, 3, 1, 2)
    new_w, new_h = net_input_size(x.shape[3], x.shape[2], net_w, net_h, cfg,
                                  resize_mode)
    x = interpolate(x, (new_h, new_w), _TORCH_MODE[cfg.interpolation],
                    False)
    mean = torch.tensor(cfg.mean, dtype=torch.float32,
                        device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg.std, dtype=torch.float32,
                       device=x.device).view(1, 3, 1, 1)
    return ((x - mean) / std).contiguous()
