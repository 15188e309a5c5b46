"""Weights of the ported models: checkpoint loading, the JAX package's
parameters carried across, and seeded random init.

The port's modules name their parameters in the reference checkpoint
layouts that ``depthmap_tpu.models.convert`` reads: ``convert_dpt_beit``
(``pretrained.model.blocks.{i}.attn.qkv.weight``,
``pretrained.act_postprocess{i}.{0.project.0,3,4}``,
``scratch.refinenet{i}...``), ``convert_dpt_vit``, ``convert_dpt_hybrid``
(``pretrained.model.patch_embed.backbone.stages.{s}.blocks.{b}...``),
``convert_midas_v21`` (``pretrained.layer1.{0,1,4}``...),
``convert_midas_small`` (``pretrained.layer1.3.0.conv_dw``...) and
``convert_depth_anything`` (``pretrained.blocks.{i}.ls1.gamma``,
``depth_head.projects.{i}``, ``depth_head.scratch.output_conv2.{0,2}``...),
so a reference checkpoint loads with ``load_state_dict(strict=True)`` and
needs no converter.  ``state_dict_from_jax`` is the inverse of each
converter, told apart by the JAX tree's own keys.
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
                    3: "dpt_large-midas-2f21e586.pt",
                    4: "dpt_hybrid-midas-501f0c75.pt",
                    5: "midas_v21-f6b98070.pt",
                    6: "midas_v21_small-70d6b9c8.pt",
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


def _put_bn(sd, name, params, stats):
    """flax BatchNorm {scale, bias} + {mean, var} -> nn.BatchNorm2d."""
    sd[f"{name}.weight"] = _t(params["scale"])
    sd[f"{name}.bias"] = _t(params["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _put_rcu(sd, name, entry):
    for conv in ("conv1", "conv2"):
        _put_conv(sd, f"{name}.{conv}", entry[conv]["conv"])


def _put_refinenets(sd, p, prefix: str, zero_rcu1: bool = False):
    """``refinenet{1..4}`` of a tree; a ``resConfUnit1`` the tree lacks
    (refinenet4's, which inference never calls) is filled with zeros when
    the port's module holds one (``zero_rcu1``)."""
    for i in range(1, 5):
        r = p[f"refinenet{i}"]
        t = f"{prefix}.refinenet{i}"
        if "out_conv" in r:
            _put_conv(sd, f"{t}.out_conv", r["out_conv"]["conv"])
        _put_rcu(sd, f"{t}.resConfUnit2", r["resConfUnit2"])
        if "resConfUnit1" in r:
            _put_rcu(sd, f"{t}.resConfUnit1", r["resConfUnit1"])
        elif zero_rcu1:
            for conv in ("conv1", "conv2"):
                like = f"{t}.resConfUnit2.{conv}"
                sd[f"{t}.resConfUnit1.{conv}.weight"] = torch.zeros_like(
                    sd[f"{like}.weight"])
                sd[f"{t}.resConfUnit1.{conv}.bias"] = torch.zeros_like(
                    sd[f"{like}.bias"])


def _put_midas_decoder(sd, p, zero_rcu1: bool = False):
    """The MiDaS/DPT ``scratch``: layer{i}_rn, the refinenets and the head
    (``head_conv{1,2,3}`` in the DPT tree, ``output_conv{1,2,3}`` in the
    v2.1 ones) at ``scratch.output_conv.{0,2,4}``."""
    for i in range(1, 5):
        _put_conv(sd, f"scratch.layer{i}_rn",
                  p["scratch"][f"layer{i}_rn"]["conv"], bias=False)
    _put_refinenets(sd, p, "scratch", zero_rcu1)
    head = "head_conv" if "head_conv1" in p else "output_conv"
    for j, idx in ((1, 0), (2, 2), (3, 4)):
        _put_conv(sd, f"scratch.output_conv.{idx}", p[f"{head}{j}"]["conv"])


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> the port's state dict, through the
    inverse of the converter that made that tree: Depth Anything (a
    ``depth_head``), the DPT models (a ``backbone``: the hybrid's holds a
    ResNet ``backbone``, ViT-L's a ``pos_embed``, BEiT's neither),
    midas_v21_small (an encoder ``stem``) and midas_v21."""
    p = variables["params"]
    if "depth_head" in p:
        return state_dict_from_jax_da(variables)
    if "backbone" in p:
        bb = p["backbone"]
        if "backbone" in bb:
            sd = _state_dict_from_jax_hybrid(bb)
        elif "pos_embed" in bb:
            sd = _vit_body(bb, "pretrained.model")
            _put_conv(sd, "pretrained.model.patch_embed.proj",
                      bb["patch_embed"]["proj"])
        else:
            sd = _beit_body(bb)
        _put_reassemble(sd, p)
        _put_midas_decoder(sd, p)
        return sd
    if "stem" in p["pretrained"]:
        return _state_dict_from_jax_small(variables)
    return _state_dict_from_jax_midas_v21(variables)


def _put_reassemble(sd, p):
    """``reassemble{i}`` -> ``pretrained.act_postprocess{i}`` (the
    hybrid's tree has only 3 and 4)."""
    for i in range(1, 5):
        if f"reassemble{i}" not in p:
            continue
        e = p[f"reassemble{i}"]
        t = f"pretrained.act_postprocess{i}"
        _put_linear(sd, f"{t}.0.project.0", e["readout"]["project"])
        _put_conv(sd, f"{t}.3", e["proj"]["conv"])
        if i in (1, 2):
            sd[f"{t}.4.weight"] = _convt(e["resize"]["kernel"])
            sd[f"{t}.4.bias"] = _t(e["resize"]["bias"])
        elif i == 4:
            _put_conv(sd, f"{t}.4", e["resize"]["conv"])


def _vit_body(bb, m: str) -> Dict[str, torch.Tensor]:
    """cls_token, pos_embed and the plain ViT blocks of ``convert_dpt_vit``
    / ``convert_dpt_hybrid``."""
    sd: Dict[str, torch.Tensor] = {}
    sd[f"{m}.cls_token"] = _t(bb["cls_token"])
    sd[f"{m}.pos_embed"] = _t(bb["pos_embed"])
    depth = sum(1 for k in bb if k.startswith("block_"))
    for i in range(depth):
        blk = bb[f"block_{i}"]
        t = f"{m}.blocks.{i}"
        _put_ln(sd, f"{t}.norm1", blk["norm1"])
        _put_linear(sd, f"{t}.attn.qkv", blk["attn"]["qkv"])
        _put_linear(sd, f"{t}.attn.proj", blk["attn"]["proj"])
        _put_ln(sd, f"{t}.norm2", blk["norm2"])
        _put_linear(sd, f"{t}.mlp.fc1", blk["mlp"]["fc1"])
        _put_linear(sd, f"{t}.mlp.fc2", blk["mlp"]["fc2"])
    return sd


def _state_dict_from_jax_hybrid(bb) -> Dict[str, torch.Tensor]:
    """The backbone half of the inverse of ``convert_dpt_hybrid``: the
    ResNetV2 stem and stages, the 1x1 patch projection, the ViT body."""
    m = "pretrained.model"
    sd = _vit_body(bb, m)
    rn = bb["backbone"]
    pe = f"{m}.patch_embed"
    sd[f"{pe}.proj.weight"] = _conv(bb["patch_proj"]["kernel"])
    sd[f"{pe}.proj.bias"] = _t(bb["patch_proj"]["bias"])

    def std_gn(conv, norm, entry_conv, entry_norm):
        sd[f"{conv}.weight"] = _conv(entry_conv["kernel"])
        sd[f"{norm}.weight"] = _t(entry_norm["gn"]["scale"])
        sd[f"{norm}.bias"] = _t(entry_norm["gn"]["bias"])
    b = f"{pe}.backbone"
    std_gn(f"{b}.stem.conv", f"{b}.stem.norm", rn["stem_conv"],
           rn["stem_norm"])
    for key, blk in rn.items():
        if not key.startswith("stage"):
            continue
        si, bi = key[len("stage"):].split("_b")
        t = f"{b}.stages.{si}.blocks.{bi}"
        for i in (1, 2, 3):
            std_gn(f"{t}.conv{i}", f"{t}.norm{i}", blk[f"conv{i}"],
                   blk[f"norm{i}"])
        if "downsample_conv" in blk:
            std_gn(f"{t}.downsample.conv", f"{t}.downsample.norm",
                   blk["downsample_conv"], blk["downsample_norm"])
    return sd


def _state_dict_from_jax_midas_v21(variables) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_midas_v21``; refinenet4's unused
    ``resConfUnit1`` (in the checkpoint, not in the JAX tree) is zeros."""
    p = variables["params"]
    enc, st = p["pretrained"], variables["batch_stats"]["pretrained"]
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "pretrained.layer1.0", enc["conv1"]["conv"], bias=False)
    _put_bn(sd, "pretrained.layer1.1", enc["bn1"]["bn"], st["bn1"]["bn"])
    prefix = {1: "pretrained.layer1.4", 2: "pretrained.layer2",
              3: "pretrained.layer3", 4: "pretrained.layer4"}
    for key, blk in enc.items():
        if not key.startswith("layer"):
            continue
        li, bi = key[len("layer"):].split("_")
        t = f"{prefix[int(li)]}.{bi}"
        for i in (1, 2, 3):
            _put_conv(sd, f"{t}.conv{i}", blk[f"conv{i}"]["conv"],
                      bias=False)
            _put_bn(sd, f"{t}.bn{i}", blk[f"bn{i}"]["bn"],
                    st[key][f"bn{i}"]["bn"])
        if "downsample_conv" in blk:
            _put_conv(sd, f"{t}.downsample.0",
                      blk["downsample_conv"]["conv"], bias=False)
            _put_bn(sd, f"{t}.downsample.1", blk["downsample_bn"]["bn"],
                    st[key]["downsample_bn"]["bn"])
    _put_midas_decoder(sd, p, zero_rcu1=True)
    return sd


# MiDaS's split of the EfficientNet stages: stage -> checkpoint prefix
_SMALL_STAGES = {0: "pretrained.layer1.3", 1: "pretrained.layer1.4",
                 2: "pretrained.layer2.0", 3: "pretrained.layer3.0",
                 4: "pretrained.layer3.1", 5: "pretrained.layer4.0",
                 6: "pretrained.layer4.1"}
# JAX ConvBnAct name -> (conv, bn) of the timm block
_SMALL_CBA = {"dw": ("conv_dw", "bn1"), "pw": ("conv_pw", "bn2"),
              "pw_exp": ("conv_pw", "bn1"), "pw_proj": ("conv_pwl", "bn3")}


def _state_dict_from_jax_small(variables) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_midas_small`` (an inverted residual's
    depthwise conv is ``conv_dw`` / ``bn2``)."""
    p = variables["params"]
    enc, st = p["pretrained"], variables["batch_stats"]["pretrained"]
    sd: Dict[str, torch.Tensor] = {}

    def cba(conv, bn, pe, se):
        _put_conv(sd, conv, pe["ConvSame_0"]["conv"], bias=False)
        _put_bn(sd, bn, pe["BatchNorm_0"]["bn"], se["BatchNorm_0"]["bn"])
    cba("pretrained.layer1.0", "pretrained.layer1.1", enc["stem"],
        st["stem"])
    for key, blk in enc.items():
        if key == "stem":
            continue
        si, bi = key[1:].split("_b")
        t = f"{_SMALL_STAGES[int(si)]}.{bi}"
        for part, entry in blk.items():
            conv, bn = _SMALL_CBA[part]
            if part == "dw" and "pw_exp" in blk:
                bn = "bn2"
            cba(f"{t}.{conv}", f"{t}.{bn}", entry, st[key][part])
    _put_midas_decoder(sd, p)
    return sd


def _beit_body(bb) -> Dict[str, torch.Tensor]:
    """The backbone half of the inverse of ``convert_dpt_beit``, including
    the zero ``k_bias`` and the ``relative_position_index`` buffers the
    converter skips."""
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
    _put_refinenets(sd, head, s, zero_rcu1=True)
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
    normal with std 1/sqrt(fan_in) and zero biases, LayerNorm, GroupNorm,
    BatchNorm (running mean 0, var 1) and LayerScale at 1, cls token and
    rel-pos tables normal(0, 0.02).  The
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
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
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
