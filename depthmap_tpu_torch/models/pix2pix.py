"""Pix2Pix merge net (BoostingMonocularDepth's 'unet_1024' generator).

Port of ``depthmap_tpu/models/pix2pix.py``: a 10-level U-Net (two depth
estimates in, one merged map out) with LeakyReLU(0.2) on the way down,
ReLU + ConvTranspose2d(k4, s2, p1) on the way up, eval BatchNorm at every
level but the outermost and tanh at the end.  It is built recursively, as
the reference builds it, so its ``state_dict`` keys are those of
``latest_net_G.pth`` (``model.model.0.weight``,
``model.model.1.model.2.running_var``, ...), the layout
``depthmap_tpu.models.convert.convert_pix2pix`` reads.  ``Pix2Pix4Depth``
adds the inference wrapper: both inputs min-max normalized to [-1, 1], the
output mapped to [0, 1].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

PIX2PIX_LEVELS = 10


class UnetSkipConnectionBlock(nn.Module):
    """One level: down conv, the inner levels, up conv; the input joins the
    output along the channels (but at the outermost level)."""

    def __init__(self, outer_nc: int, inner_nc: int,
                 input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None,
                 outermost: bool = False, innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        down = nn.Conv2d(input_nc, inner_nc, 4, 2, 1, bias=False)
        up_in = inner_nc if innermost else inner_nc * 2
        up = nn.ConvTranspose2d(up_in, outer_nc, 4, 2, 1, bias=outermost)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up,
                      nn.BatchNorm2d(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.BatchNorm2d(inner_nc),
                      submodule, nn.ReLU(), up, nn.BatchNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class UnetGenerator(nn.Module):
    """(N, input_nc, S, S) -> (N, output_nc, S, S) in [-1, 1], S a multiple
    of 2 ** num_downs."""

    def __init__(self, input_nc: int = 2, output_nc: int = 1,
                 num_downs: int = PIX2PIX_LEVELS, ngf: int = 64):
        super().__init__()
        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block)
        for mult in (4, 2, 1):
            block = UnetSkipConnectionBlock(ngf * mult, ngf * mult * 2,
                                            submodule=block)
        self.model = UnetSkipConnectionBlock(output_nc, ngf,
                                             input_nc=input_nc,
                                             submodule=block, outermost=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


def _minmax_pm1(d: torch.Tensor) -> torch.Tensor:
    lo = d.amin(dim=(1, 2), keepdim=True)
    hi = d.amax(dim=(1, 2), keepdim=True)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    return (d - lo) / span * 2.0 - 1.0


class Pix2Pix4Depth(UnetGenerator):
    """The merge: (N, S, S) outer and inner estimates -> (N, S, S) merged
    map in [0, 1]; the state dict is the generator's."""

    def forward(self, outer: torch.Tensor,
                inner: torch.Tensor) -> torch.Tensor:
        x = torch.stack([_minmax_pm1(outer), _minmax_pm1(inner)], 1)
        return (super().forward(x)[:, 0] + 1.0) / 2.0


def build_pix2pix(num_downs: int = PIX2PIX_LEVELS,
                  ngf: int = 64) -> Pix2Pix4Depth:
    return Pix2Pix4Depth(num_downs=num_downs, ngf=ngf).eval()
