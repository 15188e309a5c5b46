"""MiDaS 3.1's DPT over BEiT (dpt_beit_large_512), in plain PyTorch.

Written from the published model: timm's BEiT blocks (pre-norm,
LayerNorm eps 1e-6, q and v biases with a zero k bias, layer scales
gamma_1 / gamma_2, exact GELU), MiDaS's ``backbones/beit.py`` (a
relative-position table per block, bilinearly resized to the token grid
in MiDaS's width-major layout with the three cls entries kept, and
indexed by timm's ``gen_relative_position_index``), the DPT reassemble
with the "project" readout, and the decoder of ``reference/dpt.py``.
Weights are read by the checkpoint's key names.  Departure: the bias is
built here per grid and per block from the table in f32; the published
code does the same in the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import common, dpt


def relative_position_index(wh: int, ww: int, device) -> torch.Tensor:
    """timm's gen_relative_position_index for a (wh, ww) window: (N, N),
    N = wh * ww + 1, the cls row, column and corner on the table's last
    three entries."""
    num = (2 * wh - 1) * (2 * ww - 1) + 3
    coords = torch.stack(torch.meshgrid(torch.arange(wh), torch.arange(ww),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    n = wh * ww + 1
    index = torch.zeros((n, n), dtype=torch.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num - 3
    index[0:, 0] = num - 2
    index[0, 0] = num - 1
    return index.to(device)


def resized_table(table: torch.Tensor, train: int,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """MiDaS's _get_rel_pos_bias: the (2t-1)^2 token entries laid out
    (1, H, old_width, old_height), bilinear (align_corners=False) to
    (2gh-1, 2gw-1), flattened back; the three cls entries appended."""
    old = 2 * train - 1
    nh, nw = 2 * grid[0] - 1, 2 * grid[1] - 1
    heads = table.shape[1]
    sub = table[:old * old].reshape(1, old, old, heads).permute(0, 3, 1, 2)
    if (nh, nw) != (old, old):
        sub = F.interpolate(sub, size=(nh, nw), mode="bilinear",
                            align_corners=False)
    sub = sub.permute(0, 2, 3, 1).reshape(nh * nw, heads)
    return torch.cat([sub, table[old * old:]], 0)


class BeitDPT:
    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 numerics: common.Numerics):
        self.cfg = cfg
        self.w = weights
        self.nx = numerics
        self._bias: Dict[Tuple[int, int], list] = {}

    def _biases(self, grid):
        """Each block's (H, N, N) bias at ``grid``, made once a grid."""
        if grid not in self._bias:
            cfg, w = self.cfg, self.w
            train = cfg["image_size"] // cfg["patch_size"]
            dev = w["pretrained.model.cls_token"].device
            index = relative_position_index(*grid, dev)
            out = []
            for i in range(cfg["num_hidden_layers"]):
                table = resized_table(
                    w[f"pretrained.model.blocks.{i}.attn."
                      "relative_position_bias_table"], train, grid)
                out.append(table[index.view(-1)].view(
                    index.shape[0], index.shape[1], -1).permute(2, 0, 1))
            self._bias = {grid: out}
        return self._bias[grid]

    def _block(self, i: int, x, bias):
        nx, w = self.nx, self.w
        p = f"pretrained.model.blocks.{i}."
        eps = self.cfg["layer_norm_eps"]
        b, n, c = x.shape
        heads = self.cfg["num_attention_heads"]
        h = common.layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"],
                              eps)
        qkv_bias = torch.cat([w[p + "attn.q_bias"],
                              torch.zeros_like(w[p + "attn.q_bias"]),
                              w[p + "attn.v_bias"]])
        qkv = nx.linear(h, w[p + "attn.qkv.weight"], qkv_bias)
        qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        att = nx.attention(qkv[0], qkv[1], qkv[2],
                           bias=lambda q0, q1: bias[:, q0:q1])
        att = nx.linear(att.transpose(1, 2).reshape(b, n, c),
                        w[p + "attn.proj.weight"], w[p + "attn.proj.bias"])
        x = x + w[p + "gamma_1"] * att
        h = common.layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"],
                              eps)
        h = nx.linear(common.gelu(nx.linear(h, w[p + "mlp.fc1.weight"],
                                            w[p + "mlp.fc1.bias"])),
                      w[p + "mlp.fc2.weight"], w[p + "mlp.fc2.bias"])
        return x + w[p + "gamma_2"] * h

    def _reassemble(self, level: int, tokens, grid):
        nx, w = self.nx, self.w
        p = f"pretrained.act_postprocess{level + 1}."
        toks = tokens[:, 1:]
        cls = tokens[:, :1].expand_as(toks)
        h = common.gelu(nx.linear(torch.cat([toks, cls], -1),
                                  w[p + "0.project.0.weight"],
                                  w[p + "0.project.0.bias"]))
        h = h.transpose(1, 2).reshape(h.shape[0], h.shape[2], *grid)
        h = nx.conv(h, w[p + "3.weight"], w[p + "3.bias"])
        if level in (0, 1):
            h = nx.conv_transpose(h, w[p + "4.weight"], w[p + "4.bias"],
                                  stride=4 if level == 0 else 2)
        elif level == 3:
            h = nx.conv(h, w[p + "4.weight"], w[p + "4.bias"], stride=2,
                        padding=1)
        return h

    @torch.no_grad()
    def raw(self, img_u8: np.ndarray, net_hw: Tuple[int, int]
            ) -> torch.Tensor:
        """(H, W, 3) uint8 photo -> (H, W) f32 raw map at its size."""
        cfg, nx, w = self.cfg, self.nx, self.w
        dev = w["pretrained.model.cls_token"].device
        x = common.preprocess(cfg, img_u8, net_hw, dev)
        ps = cfg["patch_size"]
        x = nx.conv(x, w["pretrained.model.patch_embed.proj.weight"],
                    w["pretrained.model.patch_embed.proj.bias"], stride=ps)
        grid = (x.shape[2], x.shape[3])
        tokens = x.flatten(2).transpose(1, 2)
        cls = w["pretrained.model.cls_token"].expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], 1)
        biases = self._biases(grid)
        taps = []
        for i in range(cfg["num_hidden_layers"]):
            tokens = self._block(i, tokens, biases[i])
            if i in cfg["hooks"]:
                taps.append(tokens)
        layers = [self._reassemble(j, t, grid) for j, t in enumerate(taps)]
        p1 = dpt.fuse(nx, w, "", layers)
        pred = dpt.midas_output(nx, w, p1)[0]
        up = cfg["upsample"]
        return common.upsample_to(pred, img_u8.shape[:2], up["mode"],
                                  up["align_corners"])


def build(cfg: dict, weights: Dict[str, torch.Tensor],
          numerics: common.Numerics) -> BeitDPT:
    return BeitDPT(cfg, weights, numerics)
