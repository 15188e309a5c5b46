"""Depth Anything v2 (DINOv2 encoder + DPT head), in plain PyTorch.

Written from the published model (github.com/DepthAnything/
Depth-Anything-V2, ``depth_anything_v2/dpt.py`` and its ``dinov2.py``):
DINOv2 ViT blocks (pre-norm, LayerNorm eps 1e-6, a plain qkv bias,
LayerScale ls1 / ls2, exact GELU), the position embeddings resized
bicubic by torch's ``scale_factor`` path with DINO's +0.1 offset
(``interpolate_pos_encoding``: scale ((gh + 0.1) / 37, (gw + 0.1) / 37),
no antialias), the final norm on every tapped block, and the DPT head
(1x1 projections, 4x / 2x transposed convolutions and a stride-2
convolution, the decoder of ``reference/dpt.py``, output at 14 gh x
14 gw).  Weights are read by the checkpoint's key names.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import common, dpt


class DinoDPT:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 numerics: common.Numerics):
        self.cfg = cfg
        self.w = weights
        self.nx = numerics

    def pos_embed(self, grid: Tuple[int, int]) -> torch.Tensor:
        pos = self.w["pretrained.pos_embed"]
        n = self.cfg["image_size"] // self.cfg["patch_size"]
        if tuple(grid) == (n, n):
            return pos
        c = pos.shape[-1]
        patch = pos[:, 1:].reshape(1, n, n, c).permute(0, 3, 1, 2)
        off = self.cfg["interpolate_offset"]
        patch = F.interpolate(patch, scale_factor=((grid[0] + off) / n,
                                                   (grid[1] + off) / n),
                              mode="bicubic", align_corners=False)
        if tuple(patch.shape[2:]) != tuple(grid):
            raise ValueError(f"pos-embed resize gave {patch.shape[2:]}")
        patch = patch.permute(0, 2, 3, 1).reshape(1, -1, c)
        return torch.cat([pos[:, :1], patch], 1)

    def _block(self, i: int, x):
        nx, w = self.nx, self.w
        p = f"pretrained.blocks.{i}."
        eps = self.cfg["layer_norm_eps"]
        b, n, c = x.shape
        heads = self.cfg["num_attention_heads"]
        h = common.layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"],
                              eps)
        qkv = nx.linear(h, w[p + "attn.qkv.weight"], w[p + "attn.qkv.bias"])
        qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        att = nx.attention(qkv[0], qkv[1], qkv[2])
        att = nx.linear(att.transpose(1, 2).reshape(b, n, c),
                        w[p + "attn.proj.weight"], w[p + "attn.proj.bias"])
        x = x + w[p + "ls1.gamma"] * att
        h = common.layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"],
                              eps)
        h = nx.linear(common.gelu(nx.linear(h, w[p + "mlp.fc1.weight"],
                                            w[p + "mlp.fc1.bias"])),
                      w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"])
        return x + w[p + "ls2.gamma"] * h

    @torch.no_grad()
    def raw(self, img_u8: np.ndarray, net_hw: Tuple[int, int]
            ) -> torch.Tensor:
        """(H, W, 3) uint8 photo -> (H, W) f32 raw map at its size."""
        cfg, nx, w = self.cfg, self.nx, self.w
        dev = w["pretrained.cls_token"].device
        x = common.preprocess(cfg, img_u8, net_hw, dev)
        ps = cfg["patch_size"]
        x = nx.conv(x, w["pretrained.patch_embed.proj.weight"],
                    w["pretrained.patch_embed.proj.bias"], stride=ps)
        grid = (x.shape[2], x.shape[3])
        tokens = x.flatten(2).transpose(1, 2)
        cls = w["pretrained.cls_token"].expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1) + self.pos_embed(grid)
        eps = cfg["layer_norm_eps"]
        layers = []
        for i in range(cfg["num_hidden_layers"]):
            tokens = self._block(i, tokens)
            if i in cfg["hooks"]:
                t = common.layer_norm(tokens, w["pretrained.norm.weight"],
                                      w["pretrained.norm.bias"], eps)[:, 1:]
                j = len(layers)
                h = t.transpose(1, 2).reshape(t.shape[0], -1, *grid)
                h = nx.conv(h, w[f"depth_head.projects.{j}.weight"],
                            w[f"depth_head.projects.{j}.bias"])
                r = f"depth_head.resize_layers.{j}."
                if j in (0, 1):
                    h = nx.conv_transpose(h, w[r + "weight"], w[r + "bias"],
                                          stride=4 if j == 0 else 2)
                elif j == 3:
                    h = nx.conv(h, w[r + "weight"], w[r + "bias"], stride=2,
                                padding=1)
                layers.append(h)
        p1 = dpt.fuse(nx, w, "depth_head.", layers)
        pred = dpt.depth_anything_output(nx, w, p1,
                                         (grid[0] * ps, grid[1] * ps))[0]
        up = cfg["upsample"]
        return common.upsample_to(pred, img_u8.shape[:2], up["mode"],
                                  up["align_corners"])


def build(cfg: dict, weights: Dict[str, torch.Tensor],
          numerics: common.Numerics) -> DinoDPT:
    return DinoDPT(cfg, weights, numerics)
