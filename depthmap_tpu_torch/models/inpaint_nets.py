"""The 3D photo's inpainting nets: edge, depth and colour (torch, NCHW).

Port of ``depthmap_tpu/models/inpaint_nets.py`` in the key layout of the
reference checkpoints (``edge-model.pth``, ``depth-model.pth``,
``color-model.pth``) that ``depthmap_tpu/models/convert_inpaint.py``
reads:

* ``PartialConv`` (``conv.input_conv``, and the all-ones
  ``conv.mask_conv`` that the checkpoints store: the forward sums the mask
  over each window and all input channels with a ones kernel, as the JAX
  package does) renormalizes the masked convolution by the window's valid
  count and zeroes the holes;
* ``PCBActiv`` / ``PartialConvUNet``: the 7-level partial-conv U-Net with
  nearest upsampling, ``enc_{i}`` and ``dec_{i}`` (the colour net's first
  decoders are ``dec_1A`` ... ``dec_5A``), BatchNorm in eval;
* ``InpaintDepthNet`` (4 channels: depth, edge, context, mask -> depth)
  and ``InpaintColorNet`` (6: rgb, edge, context, mask -> sigmoid rgb);
* ``InpaintEdgeNet``: the reflect-padded encoder (``encoder_0.1``,
  ``encoder_{1,2}.0``), 8 resnet blocks of dilation 2
  (``middle.{i}.conv_block.{1,5}``), transposed-conv decoder with skips
  (``decoder_{0,1}.0``, ``decoder_2.1``), instance norm (biased variance,
  eps 1e-5) and a sigmoid out.  Its spectral norm is folded into plain
  weights when the checkpoint loads (``models/weights.py
  load_inpaint_nets``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_SAMPLES = {"down-7": (7, 2), "down-5": (5, 2), "down-3": (3, 2),
            "none-3": (3, 1)}


class PartialConv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 bias: bool = True):
        super().__init__()
        pad = kernel // 2
        self.input_conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad,
                                    bias=bias)
        self.mask_conv = nn.Conv2d(in_ch, out_ch, kernel, stride, pad,
                                   bias=False)
        self.mask_conv.requires_grad_(False)
        nn.init.ones_(self.mask_conv.weight)

    def forward(self, x, mask):
        conv = self.input_conv
        out = F.conv2d(x * mask, conv.weight, None, conv.stride,
                       conv.padding)
        in_ch, k = x.shape[1], conv.kernel_size[0]
        ones = torch.ones((1, in_ch, k, k), dtype=x.dtype, device=x.device)
        mask_sum = F.conv2d(mask, ones, None, conv.stride, conv.padding)
        holes = mask_sum == 0
        mask_sum = torch.where(holes, torch.ones_like(mask_sum), mask_sum)
        out = out * float(in_ch * k * k) / mask_sum
        if conv.bias is not None:
            out = out + conv.bias[None, :, None, None]
        out = torch.where(holes, torch.zeros_like(out), out)
        new_mask = torch.where(holes, 0.0, 1.0).to(out.dtype).expand_as(out)
        return out, new_mask


class PCBActiv(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, sample: str = "none-3",
                 bn: bool = True, activ=None, conv_bias: bool = False):
        super().__init__()
        k, s = _SAMPLES[sample]
        self.conv = PartialConv(in_ch, out_ch, k, s, bias=conv_bias)
        if bn:
            self.bn = nn.BatchNorm2d(out_ch)
        self.activ = activ

    def forward(self, x, mask):
        h, m = self.conv(x, mask)
        if hasattr(self, "bn"):
            h = self.bn(h)
        if self.activ == "relu":
            h = F.relu(h)
        elif self.activ == "leaky":
            h = F.leaky_relu(h, 0.2)
        return h, m


def _nearest_up2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class PartialConvUNet(nn.Module):
    """The depth and colour nets' 7-level partial-conv U-Net; its modules
    sit at the checkpoint's top level (``enc_1`` ... ``dec_7``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 layer_size: int = 7, first_bias: bool = True,
                 dec_names: Sequence[str] = ()):
        super().__init__()
        self.layer_size = layer_size
        specs = [(64, "down-7", False, first_bias),
                 (128, "down-5", True, first_bias and in_channels == 4),
                 (256, "down-5", True, False),
                 (512, "down-3", True, False)] + \
            [(512, "down-3", True, False)] * (layer_size - 4)
        ch = [in_channels]
        for i, (out, sample, bn, bias) in enumerate(specs):
            self.add_module(f"enc_{i + 1}", PCBActiv(
                ch[-1], out, sample, bn=bn, activ="relu", conv_bias=bias))
            ch.append(out)
        dec_ch = {7: 512, 6: 512, 5: 512, 4: 256, 3: 128, 2: 64,
                  1: out_channels}
        self.dec_names = [dec_names[i - 1] if dec_names else f"dec_{i}"
                          for i in range(1, layer_size + 1)]
        h = ch[-1]
        for i in range(layer_size, 0, -1):
            last = i == 1
            self.add_module(self.dec_names[i - 1], PCBActiv(
                h + ch[i - 1], dec_ch[i], "none-3", bn=not last,
                activ=None if last else "leaky", conv_bias=last))
            h = dec_ch[i]

    def forward(self, x, mask):
        feats = [(x, mask)]
        h, m = x, mask
        for i in range(1, self.layer_size + 1):
            h, m = getattr(self, f"enc_{i}")(h, m)
            feats.append((h, m))
        for i in range(self.layer_size, 0, -1):
            eh, em = feats[i - 1]
            h = torch.cat([_nearest_up2(h), eh], dim=1)
            m = torch.cat([_nearest_up2(m), em], dim=1)
            h, m = getattr(self, self.dec_names[i - 1])(h, m)
        return h


class InpaintDepthNet(PartialConvUNet):
    """(depth, edge, context, mask), each (N, 1, H, W) -> (N, 1, H, W)."""

    def __init__(self):
        super().__init__(4, 1, first_bias=True)

    def forward(self, depth, edge, context, mask):
        x = torch.cat([depth, edge, context, mask], dim=1)
        input_mask = (context + mask).clamp(0, 1).expand(-1, 4, -1, -1)
        return super().forward(x, input_mask)


class InpaintColorNet(PartialConvUNet):
    """(rgb (N, 3, H, W), edge, context, mask) -> sigmoid rgb."""

    def __init__(self):
        super().__init__(6, 3, first_bias=False, dec_names=(
            "dec_1A", "dec_2A", "dec_3A", "dec_4A", "dec_5A", "dec_6",
            "dec_7"))

    def forward(self, rgb, edge, context, mask):
        x = torch.cat([rgb, edge, context, mask], dim=1)
        input_mask = (context + mask).clamp(0, 1).expand(-1, 6, -1, -1)
        return torch.sigmoid(super().forward(x, input_mask))


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H and W: biased variance,
    eps 1e-5, no affine (the reference's InstanceNorm2d, no state)."""

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + 1e-5)



class EdgeResnetBlock(nn.Module):
    def __init__(self, dim: int = 256, dilation: int = 2):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(dilation),
            nn.Conv2d(dim, dim, 3, dilation=dilation, bias=False),
            InstanceNorm(), nn.LeakyReLU(0.2),
            nn.ReflectionPad2d(1),
            nn.Conv2d(dim, dim, 3, bias=False), InstanceNorm())

    def forward(self, x):
        return x + self.conv_block(x)


class InpaintEdgeNet(nn.Module):
    """(N, 7, H, W): rgb, disparity, edge, context, mask -> (N, 1, H, W)
    edge probability; H and W multiples of 4."""

    def __init__(self, residual_blocks: int = 8, in_channels: int = 7):
        super().__init__()
        self.encoder_0 = nn.Sequential(
            nn.ReflectionPad2d(3), nn.Conv2d(in_channels, 64, 7),
            InstanceNorm(), nn.ReLU())
        self.encoder_1 = nn.Sequential(nn.Conv2d(64, 128, 4, 2, 1),
                                       InstanceNorm(), nn.ReLU())
        self.encoder_2 = nn.Sequential(nn.Conv2d(128, 256, 4, 2, 1),
                                       InstanceNorm(), nn.ReLU())
        self.middle = nn.Sequential(*[EdgeResnetBlock(256, 2)
                                      for _ in range(residual_blocks)])
        self.decoder_0 = nn.Sequential(
            nn.ConvTranspose2d(512, 128, 4, 2, 1), InstanceNorm(), nn.ReLU())
        self.decoder_1 = nn.Sequential(
            nn.ConvTranspose2d(256, 64, 4, 2, 1), InstanceNorm(), nn.ReLU())
        self.decoder_2 = nn.Sequential(nn.ReflectionPad2d(3),
                                       nn.Conv2d(128, 1, 7))

    def forward(self, x):
        x1 = self.encoder_0(x)
        x2 = self.encoder_1(x1)
        x3 = self.encoder_2(x2)
        x4 = self.middle(x3)
        x5 = self.decoder_0(torch.cat([x4, x3], dim=1))
        x6 = self.decoder_1(torch.cat([x5, x2], dim=1))
        return torch.sigmoid(self.decoder_2(torch.cat([x6, x1], dim=1)))
