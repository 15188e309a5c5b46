"""LeReS (res101): ResNeXt101-32x8d encoder + FTB / FFM / AO decoder (NCHW).

Port of ``depthmap_tpu/models/leres.py`` in the reference checkpoint
layout (``res101.pth``'s ``depth_model`` dict, ``module.`` stripped): the
torchvision ResNeXt under ``depth_model.encoder_modules.encoder``, the
decoder under ``depth_model.decoder_modules`` (``conv`` the FTB on the
1/32 map, ``conv1``, ``ffm{2,1,0}.ftb{1,2}`` with ``conv1`` and
``conv_branch.{1,2,4}``, ``outconv.adapt_conv.{0,1,3}``).  Every upsample
is 2x bilinear with align_corners=True.  BatchNorm in eval mode, eps 1e-5.
No attention: nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from depthmap_tpu_torch.models.resnet import ResNeXtBackbone
from depthmap_tpu_torch.ops.resize import scale2x


class FTB(nn.Module):
    """Feature transform block: conv, then a residual ReLU-conv-BN-ReLU-conv
    branch.  The reference's branch starts with an in-place ReLU, which
    reaches the skip too: the sum adds relu(conv1(x)), not conv1(x)."""

    def __init__(self, inchannels: int, midchannels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(inchannels, midchannels, 3, 1, 1)
        self.conv_branch = nn.Sequential(
            nn.ReLU(), nn.Conv2d(midchannels, midchannels, 3, 1, 1),
            nn.BatchNorm2d(midchannels), nn.ReLU(),
            nn.Conv2d(midchannels, midchannels, 3, 1, 1))

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.relu(x + self.conv_branch(x))


class FFM(nn.Module):
    """Feature fusion: FTB(low) + high, FTB, 2x upsample."""

    def __init__(self, inchannels: int, midchannels: int, outchannels: int):
        super().__init__()
        self.ftb1 = FTB(inchannels, midchannels)
        self.ftb2 = FTB(midchannels, outchannels)

    def forward(self, low_x, high_x):
        x = self.ftb2(self.ftb1(low_x) + high_x)
        return scale2x(x, "bilinear", align_corners=True)


class AO(nn.Module):
    """Adaptive output: conv-BN-ReLU-conv to one channel, 2x upsample
    (``adapt_conv`` indices 2 and 4 are the ReLU and the upsample)."""

    def __init__(self, inchannels: int, outchannels: int = 1):
        super().__init__()
        self.adapt_conv = nn.Sequential(
            nn.Conv2d(inchannels, inchannels // 2, 3, 1, 1),
            nn.BatchNorm2d(inchannels // 2), nn.ReLU(),
            nn.Conv2d(inchannels // 2, outchannels, 3, 1, 1))

    def forward(self, x):
        return scale2x(self.adapt_conv(x), "bilinear", align_corners=True)


class Decoder(nn.Module):
    """The four encoder taps -> (B, 1, H, W)."""

    def __init__(self, inchannels=(256, 512, 1024, 2048),
                 midchannels=(256, 256, 256, 512)):
        super().__init__()
        m = midchannels
        self.conv = FTB(inchannels[3], m[3])
        self.conv1 = nn.Conv2d(m[3], m[2], 3, 1, 1)
        self.ffm2 = FFM(inchannels[2], m[2], m[2])
        self.ffm1 = FFM(inchannels[1], m[1], m[1])
        self.ffm0 = FFM(inchannels[0], m[0], m[0])
        self.outconv = AO(m[0], 1)

    def forward(self, feats):
        f4, f8, f16, f32 = feats
        x16 = scale2x(self.conv1(self.conv(f32)), "bilinear",
                      align_corners=True)
        x8 = self.ffm2(f16, x16)
        x4 = self.ffm1(f8, x8)
        x2 = self.ffm0(f4, x4)
        return self.outconv(x2)


class DepthModel(nn.Module):
    def __init__(self, **encoder_kw):
        super().__init__()
        self.encoder_modules = nn.Module()
        self.encoder_modules.encoder = ResNeXtBackbone(midas_layout=False,
                                                       **encoder_kw)
        self.decoder_modules = Decoder()

    def forward(self, x):
        return self.decoder_modules(self.encoder_modules.encoder(x))


class RelDepthModel(nn.Module):
    """LeReS relative depth: (B, 3, H, W) -> (B, H, W) raw depth (near =
    small; H, W multiples of 32)."""

    def __init__(self, **encoder_kw):
        super().__init__()
        self.depth_model = DepthModel(**encoder_kw)

    def grid_inputs(self, input_hw: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A conv model computes nothing per grid."""
        return {}

    def head_to_f32(self) -> None:
        """Nothing: type 0 runs in f32, and under a reduced
        DEPTHMAP_COMPUTE_DTYPE the whole net runs in it, as in the JAX
        package."""

    def forward(self, x):
        return self.depth_model(x)[:, 0]


def build_leres(**encoder_kw) -> RelDepthModel:
    """ResNeXt101-32x8d (``encoder_kw`` overrides its depths and groups)."""
    return RelDepthModel(**encoder_kw)
