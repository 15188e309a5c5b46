"""Plain PyTorch pieces shared by the benchmark's references.

Everything here is written from the published descriptions (MiDaS 3.1's
``midas/transforms.py`` Resize, ``midas/blocks.py``, timm's ViT layers) in
ordinary ``torch`` operations.  It imports nothing of the program under
test.  The references run in float32 with TF32 off; the control of the
correctness check runs the same code with every matrix product's operands
rounded to float8 (e4m3, one scale per tensor), the precision step below
the bfloat16 that the configurations state.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # largest finite float8 e4m3fn value


def f32_matmuls() -> None:
    """Full float32 products on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Numerics:
    """How the reference rounds the operands of its products: ``"f32"``
    leaves them as they are, ``"bf16"`` rounds them to bfloat16, ``"fp8"``
    rounds each operand to float8 e4m3 with one scale per tensor (its
    largest magnitude maps to 448)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown numerics {mode!r}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).to(x.dtype)
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride,
                        padding=padding)

    def conv_transpose(self, x, w, b=None, stride=1):
        return F.conv_transpose2d(self.q(x), self.q(w), b, stride=stride)

    def attention(self, q, k, v, bias=None, block: int = 1024):
        """softmax(q kᵀ / sqrt(d) + bias) v over (B, H, N, D), the queries
        in blocks of ``block`` rows so that N = 10,765 fits; ``bias`` is
        a callable (q0, q1) -> the (H, q1 - q0, Nk) bias of those rows, or
        None."""
        scale = q.shape[-1] ** -0.5
        kq = self.q(k)
        vq = self.q(v)
        outs = []
        for q0 in range(0, q.shape[2], block):
            q1 = min(q0 + block, q.shape[2])
            s = torch.matmul(self.q(q[:, :, q0:q1] * scale),
                             kq.transpose(-1, -2))
            if bias is not None:
                s = s + bias(q0, q1)
            p = torch.softmax(s, dim=-1)
            outs.append(torch.matmul(self.q(p), vq))
        return torch.cat(outs, 2)


def gelu(x):
    """Exact (erf) GELU, as timm's and the DPT readout's nn.GELU()."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(x, w, b, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


# -- MiDaS's Resize (midas/transforms.py), keep_aspect_ratio=True ---------

def _constrain(x: float, multiple: int, min_val: int = 0,
               max_val: Optional[int] = None) -> int:
    y = int(np.round(x / multiple) * multiple)
    if max_val is not None and y > max_val:
        y = int(np.floor(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def resize_size(in_w: int, in_h: int, net_w: int, net_h: int, method: str,
                multiple: int) -> Tuple[int, int]:
    """(width, height) the net sees: MiDaS's Resize.get_size with
    keep_aspect_ratio on."""
    sh, sw = net_h / in_h, net_w / in_w
    if method == "lower_bound":
        sh = sw = max(sw, sh)
        return (_constrain(sw * in_w, multiple, min_val=net_w),
                _constrain(sh * in_h, multiple, min_val=net_h))
    if method == "upper_bound":
        sh = sw = min(sw, sh)
        return (_constrain(sw * in_w, multiple, max_val=net_w),
                _constrain(sh * in_h, multiple, max_val=net_h))
    if method == "minimal":
        if abs(1 - sw) < abs(1 - sh):
            sh = sw
        else:
            sw = sh
        return (_constrain(sw * in_w, multiple),
                _constrain(sh * in_h, multiple))
    raise ValueError(f"resize method {method!r}")


def net_input_size(cfg: dict, in_w: int, in_h: int, net_w: int,
                   net_h: int) -> Tuple[int, int]:
    """(height, width) of the net input for an in_w x in_h photo at the
    net size the user chose, by the configuration's ``preprocess``."""
    pre = cfg["preprocess"]
    w, h = resize_size(in_w, in_h, net_w, net_h, pre["resize"],
                       pre["multiple_of"])
    return h, w


def preprocess(cfg: dict, img_u8: np.ndarray, net_hw: Tuple[int, int],
               device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (1, 3, h, w) f32 net input: /255, channels
    reversed when the configuration says so (MiDaS and Depth Anything
    hand the net BGR), resized bicubic (a = -0.75, align_corners=False,
    the rule torch and the published resize share), normalized."""
    pre = cfg["preprocess"]
    x = torch.as_tensor(img_u8, device=device).to(torch.float32) / 255.0
    if pre["bgr"]:
        x = x.flip(-1)
    x = x.permute(2, 0, 1)[None]
    if tuple(x.shape[2:]) != tuple(net_hw):
        x = F.interpolate(x, size=tuple(net_hw), mode="bicubic",
                          align_corners=False)
    mean = torch.tensor(pre["mean"], device=device).view(1, 3, 1, 1)
    std = torch.tensor(pre["std"], device=device).view(1, 3, 1, 1)
    return (x - mean) / std


def upsample_to(pred: torch.Tensor, hw: Tuple[int, int], mode: str,
                align_corners: bool) -> torch.Tensor:
    """(h, w) raw map -> (H, W) at the photo's size."""
    if tuple(pred.shape) == tuple(hw):
        return pred
    return F.interpolate(pred[None, None], size=tuple(hw), mode=mode,
                         align_corners=align_corners)[0, 0]


def to_uint16(raw: torch.Tensor, invert: bool = False) -> np.ndarray:
    """The published finalize of a raw map: negated when the model
    predicts depth, normalized to [0, 1] by its own range (a flat map
    becomes all zero), then clip(x * 65536 + 0.0001, 0, 65535.9)
    truncated to uint16; in f32, each operation rounded once."""
    x = raw.to(torch.float32)
    if invert:
        x = -x
    lo, hi = x.min(), x.max()
    if float(torch.abs(hi - lo)) <= float(np.finfo(np.float32).eps):
        x = torch.zeros_like(x)
    else:
        x = (x - lo) / (hi - lo)
    x = torch.clamp(x, 0.0, 1.0) * 65536.0
    x = torch.clamp(x + 0.0001, 0.0, 65535.9)
    return x.to(torch.int32).cpu().numpy().astype(np.uint16)
