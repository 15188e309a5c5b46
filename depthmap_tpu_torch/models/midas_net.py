"""midas_v21 and midas_v21_small (NCHW): the MiDaS v2.1 conv models.

Port of ``depthmap_tpu/models/midas_net.py`` (ResNeXt101-32x8d encoder,
classic fusion blocks, features 256) and
``depthmap_tpu/models/midas_small.py`` (EfficientNet-Lite3 encoder, the
expand scratch [64, 128, 256, 512] and custom fusion blocks with
align_corners=True) in the reference checkpoint layouts: the encoder
under ``pretrained``, the decoder under ``scratch``.  Both fuse by 2x,
upsample the head bilinearly with align_corners=False, and run the last
conv in f32.  No attention: nothing here launches a kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from depthmap_tpu_torch.models.midas_blocks import Scratch


class MidasConvNet(nn.Module):
    """An encoder with four taps and the MiDaS v2.1 decoder: (B, 3, H, W)
    -> (B, H, W) raw inverse depth, non-negative (H, W multiples of 32)."""

    def __init__(self, encoder: nn.Module, in_channels, features: int,
                 expand: bool, classic: bool):
        super().__init__()
        self.pretrained = encoder
        self.scratch = Scratch(in_channels, features, expand=expand,
                               classic=classic)

    def grid_inputs(self, input_hw: Tuple[int, int],
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
        """A conv model computes nothing per grid."""
        return {}

    def head_to_f32(self) -> None:
        self.scratch.head_to_f32()

    def forward(self, x):
        return self.scratch(self.pretrained(x), fuse_to_size=False,
                            head_align_corners=False)


def build_midas_v21(**encoder_kw) -> MidasConvNet:
    """ResNeXt101-32x8d (``encoder_kw`` overrides its depths and groups)."""
    from depthmap_tpu_torch.models.resnet import ResNeXtBackbone
    return MidasConvNet(ResNeXtBackbone(**encoder_kw), (256, 512, 1024, 2048),
                        256, expand=False, classic=True)


def build_midas_v21_small(**encoder_kw) -> MidasConvNet:
    """EfficientNet-Lite3 (``encoder_kw`` may give other stage configs)."""
    from depthmap_tpu_torch.models import efficientnet as eff
    enc = eff.EfficientNetLiteBackbone(**encoder_kw)
    cfgs = encoder_kw.get("cfgs", eff.LITE3)
    taps = tuple(cfgs[i].channels for i in (1, 2, 4, 6))
    return MidasConvNet(enc, taps, 64, expand=True, classic=False)
