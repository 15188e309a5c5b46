"""16-bit depth conversion and clip/renormalize semantics (torch).

Port of ``depthmap_tpu/ops/numerics.py``; byte-exact against it
(tests/test_torch_port_numerics.py).  Every function works on a single
(H, W) map or on a stack (..., H, W): min, max and percentiles are taken per
map, so a batch finalizes each frame against its own range.
"""
from __future__ import annotations

import torch

_MAX16 = 65536.0
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _map_min_max(x: torch.Tensor):
    flat = x.flatten(-2)
    return (flat.amin(-1)[..., None, None], flat.amax(-1)[..., None, None])


def convert_to_i16(arr: torch.Tensor) -> torch.Tensor:
    """[0;1] float depth -> uint16 (round-down, overflow-safe):
    clip(arr * 65536 + 0.0001, 0, 65535.9) truncated.  The scale and the
    offset are two separate f32 ops (no FMA), and the truncation goes
    through int32 because torch.uint16 has few ops."""
    out = arr.to(torch.float32) * _MAX16
    out = out + 0.0001
    out = torch.clamp(out, 0.0, _MAX16 - 0.1)
    return out.to(torch.int32).to(torch.uint16)


def convert_i16_to_rgb(image: torch.Tensor, channels: int = 3) -> torch.Tensor:
    """uint16 single-channel -> uint8 RGB (each channel = value/256,
    truncated)."""
    c = (image.to(torch.int32).to(torch.float32) / 256.0).to(torch.uint8)
    return torch.stack([c] * channels, dim=-1)


def normalize01(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) per map; zeros when max == min."""
    x = x.to(torch.float32)
    lo, hi = _map_min_max(x)
    rng = hi - lo
    ok = rng > 0
    return torch.where(ok, (x - lo) / torch.where(ok, rng, 1.0),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def percentile(x: torch.Tensor, p: float) -> torch.Tensor:
    """jnp.percentile(x, p) with linear interpolation, per map, in f32.

    The arithmetic is the one XLA compiles jnp's formula to: the constant
    factors fold into q = p * (0.01 * (n - 1)), and the interpolation
    low*(1-w) + high*w runs as one fused multiply-add, emulated here in f64
    (the product of two f32 values is exact there).  torch.quantile is not
    used: it refuses inputs over 2^24 elements and interpolates with lerp."""
    f32 = torch.float32
    flat = torch.sort(x.flatten(-2), dim=-1).values
    n = flat.shape[-1]
    factor = torch.tensor(0.01, dtype=f32) * torch.tensor(float(n - 1),
                                                          dtype=f32)
    q = torch.tensor(p, dtype=f32) * factor
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1.0 - high_w
    lo_i = int(torch.clamp(low, 0, n - 1))
    hi_i = int(torch.clamp(high, 0, n - 1))
    lo_part = (flat[..., lo_i] * low_w.to(x.device)).double()
    out = flat[..., hi_i].double() * high_w.double().to(x.device) + lo_part
    return out.to(f32)[..., None, None]


def clip_depth(out: torch.Tensor, mode: str, far: float,
               near: float) -> torch.Tensor:
    """mode "Range": normalize to [0;1] then clip to [far, near].
    mode "Outliers": clip to the [far*100, near*100] percentiles.
    Always followed by a final normalize-to-[0;1]."""
    out = out.to(torch.float32)
    if mode == "Range":
        out = normalize01(out)
        out = torch.clamp(out, far, near)
    elif mode == "Outliers":
        fb = percentile(out, far * 100.0)
        nb = percentile(out, near * 100.0)
        out = torch.minimum(torch.maximum(out, fb), nb)
    else:
        raise ValueError(f"Unknown clipdepth mode {mode!r}")
    return normalize01(out)


def finalize_depth(raw: torch.Tensor, invert: bool = False,
                   clip: bool = False, clip_mode: str = "Range",
                   clip_far: float = 0.0,
                   clip_near: float = 1.0) -> torch.Tensor:
    """Post-prediction path of the funnel: optional negate, optional clip,
    normalize to [0;1]; a constant map becomes all-zero ("broken" map)."""
    out = raw.to(torch.float32)
    if invert:
        out = -out
    lo, hi = _map_min_max(out)
    broken = torch.abs(hi - lo) <= _F32_EPS
    if clip:
        out = clip_depth(out, clip_mode, clip_far, clip_near)
    else:
        out = normalize01(out)
    return torch.where(broken, torch.zeros((), dtype=out.dtype,
                                           device=out.device), out)


def finalize_i16(raw: torch.Tensor, invert: bool = False, clip: bool = False,
                 clip_mode: str = "Range", clip_far: float = 0.0,
                 clip_near: float = 1.0) -> torch.Tensor:
    """finalize_depth + convert_to_i16 on the raw map's device."""
    out = finalize_depth(raw, invert=invert, clip=clip, clip_mode=clip_mode,
                         clip_far=clip_far, clip_near=clip_near)
    return convert_to_i16(torch.clamp(out, 0.0, 1.0))


def invert_i16(img: torch.Tensor) -> torch.Tensor:
    """cv2.bitwise_not on uint16."""
    return (65535 - img.to(torch.int32)).to(torch.uint16)
