"""Weights for the DPT-BEiT and Depth Anything models: checkpoint
loading, the JAX package's parameters carried across, and seeded random
init.

The port's modules name their parameters in the reference checkpoint
layouts that ``depthmap_tpu.models.convert`` reads: ``convert_dpt_beit``
(``pretrained.model.blocks.{i}.attn.qkv.weight``,
``pretrained.act_postprocess{i}.{0.project.0,3,4}``,
``scratch.refinenet{i}...``) and ``convert_depth_anything``
(``pretrained.blocks.{i}.ls1.gamma``, ``depth_head.projects.{i}``,
``depth_head.scratch.output_conv2.{0,2}``...), so a reference checkpoint
loads with ``load_state_dict(strict=True)`` and needs no converter.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from depthmap_tpu_torch.models.beit import gen_relative_position_index

CHECKPOINT_FILES = {1: "dpt_beit_large_512.pt", 2: "dpt_beit_large_384.pt",
                    11: "depth_anything_vitl14.pth",
                    12: "depth_anything_v2_vits.pth",
                    13: "depth_anything_v2_vitb.pth",
                    14: "depth_anything_v2_vitl.pth"}

# keys of the timm classifier that the DPT hooks never reach
_HOOK_DEAD = ("pretrained.model.head.", "pretrained.model.fc_norm.",
              "pretrained.model.norm.")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _conv(k) -> torch.Tensor:
    """flax Conv kernel (kh, kw, I, O) -> torch (O, I, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _convt(k) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, I, O) -> torch (I, O, kh, kw),
    spatially un-flipped (inverse of convert.convt_w)."""
    a = np.transpose(np.asarray(k), (2, 3, 0, 1))
    return _t(a[:, :, ::-1, ::-1])


def _linear(k) -> torch.Tensor:
    """flax Dense kernel (I, O) -> torch (O, I)."""
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _put_conv(sd, name, entry, bias=True):
    sd[f"{name}.weight"] = _conv(entry["kernel"])
    if bias and "bias" in entry:
        sd[f"{name}.bias"] = _t(entry["bias"])


def _put_linear(sd, name, entry):
    sd[f"{name}.weight"] = _linear(entry["kernel"])
    if "bias" in entry:
        sd[f"{name}.bias"] = _t(entry["bias"])


def _put_ln(sd, name, entry):
    sd[f"{name}.weight"] = _t(entry["scale"])
    sd[f"{name}.bias"] = _t(entry["bias"])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> the port's state dict: DPT-BEiT
    variables through the inverse of ``convert_dpt_beit``, Depth Anything
    ones (a ``depth_head`` in the tree) through
    ``state_dict_from_jax_da``."""
    if "depth_head" in variables["params"]:
        return state_dict_from_jax_da(variables)
    return _state_dict_from_jax_beit(variables)


def _state_dict_from_jax_beit(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_dpt_beit``, including the zero ``k_bias``
    and the ``relative_position_index`` buffers the converter skips."""
    p = variables["params"]
    bb = p["backbone"]
    sd: Dict[str, torch.Tensor] = {}

    m = "pretrained.model"
    sd[f"{m}.cls_token"] = _t(bb["cls_token"])
    _put_conv(sd, f"{m}.patch_embed.proj", bb["patch_embed"]["proj"])
    depth = sum(1 for k in bb if k.startswith("block_"))
    for i in range(depth):
        blk = bb[f"block_{i}"]
        t = f"{m}.blocks.{i}"
        _put_ln(sd, f"{t}.norm1", blk["norm1"])
        sd[f"{t}.attn.qkv.weight"] = _linear(blk["attn"]["qkv"]["kernel"])
        sd[f"{t}.attn.q_bias"] = _t(blk["attn"]["q_bias"])
        sd[f"{t}.attn.v_bias"] = _t(blk["attn"]["v_bias"])
        sd[f"{t}.attn.k_bias"] = torch.zeros_like(sd[f"{t}.attn.q_bias"])
        table = _t(bb[f"rel_pos_bias_{i}"]["relative_position_bias_table"])
        sd[f"{t}.attn.relative_position_bias_table"] = table
        tw = (math.isqrt(table.shape[0] - 3) + 1) // 2
        sd[f"{t}.attn.relative_position_index"] = \
            gen_relative_position_index(tw, tw)
        _put_linear(sd, f"{t}.attn.proj", blk["attn"]["proj"])
        sd[f"{t}.gamma_1"] = _t(blk["gamma_1"])
        _put_ln(sd, f"{t}.norm2", blk["norm2"])
        _put_linear(sd, f"{t}.mlp.fc1", blk["mlp"]["fc1"])
        _put_linear(sd, f"{t}.mlp.fc2", blk["mlp"]["fc2"])
        sd[f"{t}.gamma_2"] = _t(blk["gamma_2"])
    for i in range(1, 5):
        e = p[f"reassemble{i}"]
        t = f"pretrained.act_postprocess{i}"
        _put_linear(sd, f"{t}.0.project.0", e["readout"]["project"])
        _put_conv(sd, f"{t}.3", e["proj"]["conv"])
        if i in (1, 2):
            sd[f"{t}.4.weight"] = _convt(e["resize"]["kernel"])
            sd[f"{t}.4.bias"] = _t(e["resize"]["bias"])
        elif i == 4:
            _put_conv(sd, f"{t}.4", e["resize"]["conv"])
    for i in range(1, 5):
        _put_conv(sd, f"scratch.layer{i}_rn",
                  p["scratch"][f"layer{i}_rn"]["conv"], bias=False)
        r = p[f"refinenet{i}"]
        t = f"scratch.refinenet{i}"
        _put_conv(sd, f"{t}.out_conv", r["out_conv"]["conv"])
        for unit in ("resConfUnit1", "resConfUnit2"):
            if unit in r:
                for conv in ("conv1", "conv2"):
                    _put_conv(sd, f"{t}.{unit}.{conv}", r[unit][conv]["conv"])
    for j, idx in ((1, 0), (2, 2), (3, 4)):
        _put_conv(sd, f"scratch.output_conv.{idx}",
                  p[f"head_conv{j}"]["conv"])
    return sd


def state_dict_from_jax_da(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_depth_anything``: JAX Depth Anything
    variables -> the port's state dict.  The two tensors inference never
    reads and the JAX tree lacks are filled with zeros: ``mask_token`` and
    refinenet4's ``resConfUnit1`` (taken from the tree where it has it)."""
    p = variables["params"]
    enc, head = p["pretrained"], p["depth_head"]
    sd: Dict[str, torch.Tensor] = {}
    sd["pretrained.cls_token"] = _t(enc["cls_token"])
    sd["pretrained.pos_embed"] = _t(enc["pos_embed"])
    sd["pretrained.mask_token"] = torch.zeros(
        1, sd["pretrained.cls_token"].shape[-1])
    _put_conv(sd, "pretrained.patch_embed.proj", enc["patch_embed"]["proj"])
    _put_ln(sd, "pretrained.norm", enc["norm"])
    depth = sum(1 for k in enc if k.startswith("block_"))
    for i in range(depth):
        blk = enc[f"block_{i}"]
        t = f"pretrained.blocks.{i}"
        _put_ln(sd, f"{t}.norm1", blk["norm1"])
        _put_linear(sd, f"{t}.attn.qkv", blk["attn"]["qkv"])
        _put_linear(sd, f"{t}.attn.proj", blk["attn"]["proj"])
        sd[f"{t}.ls1.gamma"] = _t(blk["gamma_1"])
        _put_ln(sd, f"{t}.norm2", blk["norm2"])
        _put_linear(sd, f"{t}.mlp.fc1", blk["mlp"]["fc1"])
        _put_linear(sd, f"{t}.mlp.fc2", blk["mlp"]["fc2"])
        sd[f"{t}.ls2.gamma"] = _t(blk["gamma_2"])
    h = "depth_head"
    for i in range(4):
        _put_conv(sd, f"{h}.projects.{i}", head[f"project{i}"]["conv"])
    for i in (0, 1):
        e = head[f"resize{i}"]
        sd[f"{h}.resize_layers.{i}.weight"] = _convt(e["kernel"])
        sd[f"{h}.resize_layers.{i}.bias"] = _t(e["bias"])
    _put_conv(sd, f"{h}.resize_layers.3", head["resize3"]["conv"])
    s = f"{h}.scratch"
    for i in range(1, 5):
        _put_conv(sd, f"{s}.layer{i}_rn",
                  head["scratch"][f"layer{i}_rn"]["conv"], bias=False)
        r = head[f"refinenet{i}"]
        t = f"{s}.refinenet{i}"
        _put_conv(sd, f"{t}.out_conv", r["out_conv"]["conv"])
        for unit in ("resConfUnit1", "resConfUnit2"):
            for conv in ("conv1", "conv2"):
                name = f"{t}.{unit}.{conv}"
                if unit in r:
                    _put_conv(sd, name, r[unit][conv]["conv"])
                else:   # refinenet4's dead unit
                    like = sd[f"{t}.out_conv.weight"]
                    sd[f"{name}.weight"] = torch.zeros(
                        like.shape[0], like.shape[0], 3, 3)
                    sd[f"{name}.bias"] = torch.zeros(like.shape[0])
    _put_conv(sd, f"{s}.output_conv1", head["output_conv1"]["conv"])
    _put_conv(sd, f"{s}.output_conv2.0", head["output_conv2_0"]["conv"])
    _put_conv(sd, f"{s}.output_conv2.2", head["output_conv2_2"]["conv"])
    return sd


def load_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference checkpoint with strict=True, after dropping the
    timm classifier keys the DPT hooks never reach."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(_HOOK_DEAD)}
    model.load_state_dict(sd, strict=True)


def find_checkpoint(model_type: int, weights_dir: str) -> Optional[str]:
    fn = CHECKPOINT_FILES.get(model_type)
    if fn is None:
        return None
    path = os.path.join(weights_dir, fn)
    return path if os.path.exists(path) else None


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init (nothing is downloaded): linear/conv weights
    normal with std 1/sqrt(fan_in) and zero biases, LayerNorm and
    LayerScale at 1, cls token and rel-pos tables normal(0, 0.02).  The
    numbers differ from the JAX package's init; tests carry weights across
    with state_dict_from_jax instead.  DINOv2's position embeddings and mask
    token are normal(0, 0.02) too, its LayerScale gammas 1."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0]
            else:
                fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("gamma_1", "gamma_2", "gamma"):
            prm.fill_(1.0)
        elif leaf in ("q_bias", "v_bias"):
            prm.zero_()
        elif leaf in ("cls_token", "relative_position_bias_table",
                      "pos_embed", "mask_token"):
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.02)
    return model
