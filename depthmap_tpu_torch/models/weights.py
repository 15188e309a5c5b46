"""Weights of the ported models: checkpoint loading, the JAX package's
parameters carried across, and seeded random init.

The port's modules name their parameters in the reference checkpoint
layouts that ``depthmap_tpu.models.convert`` reads: ``convert_dpt_beit``
(``pretrained.model.blocks.{i}.attn.qkv.weight``,
``pretrained.act_postprocess{i}.{0.project.0,3,4}``,
``scratch.refinenet{i}...``), ``convert_dpt_vit``, ``convert_dpt_hybrid``
(``pretrained.model.patch_embed.backbone.stages.{s}.blocks.{b}...``),
``convert_midas_v21`` (``pretrained.layer1.{0,1,4}``...),
``convert_midas_small`` (``pretrained.layer1.3.0.conv_dw``...),
``convert_depth_anything`` (``pretrained.blocks.{i}.ls1.gamma``,
``depth_head.projects.{i}``, ``depth_head.scratch.output_conv2.{0,2}``...),
``convert_zoedepth`` (``core.core.*`` the BEiT DPT, ``seed_projector._net.0``,
``attractors.{nyu,kitti}.{i}._net.2``, ``patch_transformer...``) and
``convert_leres`` (``depth_model.encoder_modules.encoder.layer1.0.conv1``,
``depth_model.decoder_modules.ffm2.ftb1.conv_branch.2``...), so a
reference checkpoint loads with ``load_state_dict(strict=True)`` and
needs no converter (ZoeDepth's keys under the ``model.`` of the
checkpoint's own wrapping, as ``load_checkpoint`` adds it).  ``state_dict_from_jax`` is the inverse of each
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

CHECKPOINT_FILES = {0: "res101.pth",
                    1: "dpt_beit_large_512.pt", 2: "dpt_beit_large_384.pt",
                    3: "dpt_large-midas-2f21e586.pt",
                    4: "dpt_hybrid-midas-501f0c75.pt",
                    5: "midas_v21-f6b98070.pt",
                    6: "midas_v21_small-70d6b9c8.pt",
                    7: "ZoeD_M12_N.pt", 8: "ZoeD_M12_K.pt",
                    9: "ZoeD_M12_NK.pt",
                    11: "depth_anything_vitl14.pth",
                    12: "depth_anything_v2_vits.pth",
                    13: "depth_anything_v2_vitb.pth",
                    14: "depth_anything_v2_vitl.pth"}

# key prefixes of a checkpoint that no forward reads: the timm classifier
# that the DPT hooks never reach (also under ZoeDepth's ``core.core.``),
# and ZoeDepth's LogBinomial constants (the port builds its table on the
# host)
_DEAD_KEYS = ("pretrained.model.head.", "pretrained.model.fc_norm.",
              "pretrained.model.norm.",
              "core.core.pretrained.model.head.",
              "core.core.pretrained.model.fc_norm.",
              "core.core.pretrained.model.norm.",
              "conditional_log_binomial.log_binomial_transform.",
              "conditional_log_binomial.nyu.log_binomial_transform.",
              "conditional_log_binomial.kitti.log_binomial_transform.")


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
    inverse of the converter that made that tree: the inpainting nets (an
    ``enc0`` or a ``unet``), ZoeDepth (a ``model``,
    held by the port's wrapper under ``model.``),
    LeReS (an ``encoder``), Depth Anything (a ``depth_head``), the DPT
    models (a ``backbone``: the hybrid's holds a ResNet ``backbone``,
    ViT-L's a ``pos_embed``, BEiT's neither), midas_v21_small (an encoder
    ``stem``) and midas_v21."""
    p = variables["params"]
    if "netG" in p:
        raise ValueError("a pix2pix tree: state_dict_from_jax_pix2pix "
                         "carries it")
    if "enc0" in p or "unet" in p:
        return state_dict_from_jax_inpaint(variables)
    if "model" in p:
        return {f"model.{k}": v
                for k, v in _state_dict_from_jax_zoe(p["model"]).items()}
    if "encoder" in p:
        return _state_dict_from_jax_leres(variables)
    if "depth_head" in p:
        return state_dict_from_jax_da(variables)
    if "backbone" in p:
        return _dpt_state_dict(p)
    if "stem" in p["pretrained"]:
        return _state_dict_from_jax_small(variables)
    return _state_dict_from_jax_midas_v21(variables)


def _dpt_state_dict(p) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_dpt_beit`` / ``_vit`` / ``_hybrid``."""
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


def _put_resnext(sd, enc, st, stem: str, bn1: str, layers: Dict[int, str]):
    """The ResNeXt of ``convert_midas_v21`` / ``convert_leres``: the stem
    conv and BatchNorm at ``stem`` / ``bn1``, block ``layer{l}_{b}`` at
    ``{layers[l]}.{b}``."""
    _put_conv(sd, stem, enc["conv1"]["conv"], bias=False)
    _put_bn(sd, bn1, enc["bn1"]["bn"], st["bn1"]["bn"])
    for key, blk in enc.items():
        if not key.startswith("layer"):
            continue
        li, bi = key[len("layer"):].split("_")
        t = f"{layers[int(li)]}.{bi}"
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


def _state_dict_from_jax_midas_v21(variables) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_midas_v21``; refinenet4's unused
    ``resConfUnit1`` (in the checkpoint, not in the JAX tree) is zeros."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _put_resnext(sd, p["pretrained"], variables["batch_stats"]["pretrained"],
                 "pretrained.layer1.0", "pretrained.layer1.1",
                 {1: "pretrained.layer1.4", 2: "pretrained.layer2",
                  3: "pretrained.layer3", 4: "pretrained.layer4"})
    _put_midas_decoder(sd, p, zero_rcu1=True)
    return sd


def _state_dict_from_jax_leres(variables) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_leres``: the torchvision ResNeXt, then the
    FTB / FFM / AO decoder with each BatchNorm's running stats."""
    p, st = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    e = "depth_model.encoder_modules.encoder"
    _put_resnext(sd, p["encoder"], st["encoder"], f"{e}.conv1", f"{e}.bn1",
                 {i: f"{e}.layer{i}" for i in range(1, 5)})
    d = "depth_model.decoder_modules"

    def ftb(t, pe, se):
        _put_conv(sd, f"{t}.conv1", pe["conv1"]["conv"])
        _put_conv(sd, f"{t}.conv_branch.1", pe["branch_conv1"]["conv"])
        _put_bn(sd, f"{t}.conv_branch.2", pe["branch_bn"]["bn"],
                se["branch_bn"]["bn"])
        _put_conv(sd, f"{t}.conv_branch.4", pe["branch_conv2"]["conv"])
    ftb(f"{d}.conv", p["conv_ftb"], st["conv_ftb"])
    _put_conv(sd, f"{d}.conv1", p["conv1"]["conv"])
    for name in ("ffm2", "ffm1", "ffm0"):
        for f in ("ftb1", "ftb2"):
            ftb(f"{d}.{name}.{f}", p[name][f], st[name][f])
    ao, ao_s = p["outconv"], st["outconv"]
    _put_conv(sd, f"{d}.outconv.adapt_conv.0", ao["conv1"]["conv"])
    _put_bn(sd, f"{d}.outconv.adapt_conv.1", ao["bn"]["bn"], ao_s["bn"]["bn"])
    _put_conv(sd, f"{d}.outconv.adapt_conv.3", ao["conv2"]["conv"])
    return sd


def _put_mlp2(sd, name, entry):
    """A ZoeDepth two-conv MLP: ``conv1`` / ``conv2`` -> ``_net.{0,2}``."""
    _put_conv(sd, f"{name}._net.0", entry["conv1"]["conv"])
    _put_conv(sd, f"{name}._net.2", entry["conv2"]["conv"])


def _put_patch_transformer(sd, prefix: str, pt) -> None:
    """The NK router's ``PatchTransformerEncoder`` (``l{i}_in_proj``... ->
    torch's encoder-layer names under ``{prefix}transformer_encoder``)."""
    _put_conv(sd, f"{prefix}embedding_convPxP", pt["embedding_conv"]["conv"])
    n_layers = sum(1 for k in pt if k.endswith("_in_proj"))
    for i in range(n_layers):
        t = f"{prefix}transformer_encoder.layers.{i}"
        sd[f"{t}.self_attn.in_proj_weight"] = _linear(
            pt[f"l{i}_in_proj"]["kernel"])
        sd[f"{t}.self_attn.in_proj_bias"] = _t(pt[f"l{i}_in_proj"]["bias"])
        _put_linear(sd, f"{t}.self_attn.out_proj", pt[f"l{i}_out_proj"])
        _put_linear(sd, f"{t}.linear1", pt[f"l{i}_linear1"])
        _put_linear(sd, f"{t}.linear2", pt[f"l{i}_linear2"])
        _put_ln(sd, f"{t}.norm1", pt[f"l{i}_norm1"])
        _put_ln(sd, f"{t}.norm2", pt[f"l{i}_norm2"])


def _state_dict_from_jax_zoe(m) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_zoedepth`` (n, k and nk, told apart by an
    NK tree's ``head_nyu``): the BEiT DPT under ``core.core.``, then the
    metric head in the reference's names."""
    sd = {f"core.core.{k}": v for k, v in _dpt_state_dict(m["core"]).items()}
    _put_conv(sd, "conv2", m["conv2"]["conv"])
    _put_mlp2(sd, "seed_projector", m["seed_projector"])
    for i in range(4):
        _put_mlp2(sd, f"projectors.{i}", m[f"projector_{i}"])

    def head(h, seed, attractors, clb, c):
        _put_mlp2(sd, seed, h["seed_bin_regressor"])
        for i in range(4):
            _put_mlp2(sd, f"{attractors}.{i}", h[f"attractor_{i}"])
        _put_conv(sd, f"{clb}.mlp.0", c["mlp_conv1"]["conv"])
        _put_conv(sd, f"{clb}.mlp.2", c["mlp_conv2"]["conv"])
    if "head_nyu" not in m:
        head(m["head"], "seed_bin_regressor", "attractors",
             "conditional_log_binomial", m["clb"])
        return sd
    for d in ("nyu", "kitti"):
        head(m[f"head_{d}"], f"seed_bin_regressors.{d}", f"attractors.{d}",
             f"conditional_log_binomial.{d}", m[f"clb_{d}"])
    _put_patch_transformer(sd, "patch_transformer.", m["patch_transformer"])
    _put_linear(sd, "mlp_classifier.0", m["mlp_classifier_0"])
    _put_linear(sd, "mlp_classifier.2", m["mlp_classifier_2"])
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


def state_dict_from_jax_pix2pix(variables: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_pix2pix``: the JAX Pix2Pix4Depth tree
    ({params, batch_stats} of ``netG``) -> the keys of latest_net_G.pth,
    the nested ``model.model.[...]`` of the recursive generator."""
    p = variables["params"]["netG"]
    st = variables["batch_stats"]["netG"]
    num_downs = sum(1 for k in p if k.startswith("down") and
                    k.endswith("_conv"))
    sd: Dict[str, torch.Tensor] = {}
    prefix = "model.model"
    for i in range(num_downs):
        outermost, innermost = i == 0, i == num_downs - 1
        down = f"{prefix}.{0 if outermost else 1}.weight"
        sd[down] = _conv(p[f"down{i}_conv"]["kernel"])
        if not (outermost or innermost):
            _put_bn(sd, f"{prefix}.2", p[f"down{i}_bn"]["bn"],
                    st[f"down{i}_bn"]["bn"])
        up = 5 if not (outermost or innermost) else 3
        sd[f"{prefix}.{up}.weight"] = _convt(p[f"up{i}_conv"]["kernel"])
        if outermost:
            sd[f"{prefix}.{up}.bias"] = _t(p[f"up{i}_conv"]["bias"])
        else:
            _put_bn(sd, f"{prefix}.{up + 1}", p[f"up{i}_bn"]["bn"],
                    st[f"up{i}_bn"]["bn"])
        if not innermost:
            prefix = f"{prefix}.{1 if outermost else 3}.model"
    return sd


def load_pix2pix(path: str) -> Dict[str, torch.Tensor]:
    """latest_net_G.pth as the merge net's state dict (``module.``
    stripped)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


# -- Marigold: diffusers' UNet2DConditionModel and AutoencoderKL ----------

def _put_resnet(sd, name, e):
    for part in ("norm1", "norm2"):
        _put_ln(sd, f"{name}.{part}", e[part])
    for part in ("conv1", "conv2"):
        _put_conv(sd, f"{name}.{part}", e[part])
    if "shortcut" in e:
        _put_conv(sd, f"{name}.conv_shortcut", e["shortcut"])
    if "time_emb_proj" in e:
        _put_linear(sd, f"{name}.time_emb_proj", e["time_emb_proj"])


def _put_transformer(sd, name, e):
    _put_ln(sd, f"{name}.norm", e["norm"])
    _put_linear(sd, f"{name}.proj_in", e["proj_in"])
    _put_linear(sd, f"{name}.proj_out", e["proj_out"])
    b, tb = e["block0"], f"{name}.transformer_blocks.0"
    for part in ("norm1", "norm2", "norm3"):
        _put_ln(sd, f"{tb}.{part}", b[part])
    for att in ("attn1", "attn2"):
        for lin in ("to_q", "to_k", "to_v"):
            _put_linear(sd, f"{tb}.{att}.{lin}", b[att][lin])
        _put_linear(sd, f"{tb}.{att}.to_out.0", b[att]["to_out"])
    _put_linear(sd, f"{tb}.ff.net.0.proj", b["ff_geglu"]["proj"])
    _put_linear(sd, f"{tb}.ff.net.2", b["ff_out"])


def state_dict_from_jax_unet(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_unet``: the JAX MarigoldUNet tree ->
    diffusers' UNet2DConditionModel keys."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "conv_in", p["conv_in"])
    _put_linear(sd, "time_embedding.linear_1", p["time_fc1"])
    _put_linear(sd, "time_embedding.linear_2", p["time_fc2"])
    _put_ln(sd, "conv_norm_out", p["norm_out"])
    _put_conv(sd, "conv_out", p["conv_out"])
    levels = sum(1 for k in p if k.startswith("down") and k.endswith("_res0"))
    for i in range(levels):
        for j in range(2):
            t = f"down_blocks.{i}"
            _put_resnet(sd, f"{t}.resnets.{j}", p[f"down{i}_res{j}"])
            if f"down{i}_attn{j}" in p:
                _put_transformer(sd, f"{t}.attentions.{j}",
                                 p[f"down{i}_attn{j}"])
        if f"down{i}_downsample" in p:
            _put_conv(sd, f"down_blocks.{i}.downsamplers.0.conv",
                      p[f"down{i}_downsample"])
    for j in range(2):
        _put_resnet(sd, f"mid_block.resnets.{j}", p[f"mid_res{j}"])
    _put_transformer(sd, "mid_block.attentions.0", p["mid_attn"])
    for k in range(levels):          # diffusers up_blocks.k == up{L-1-k}
        i, t = levels - 1 - k, f"up_blocks.{k}"
        for j in range(3):
            _put_resnet(sd, f"{t}.resnets.{j}", p[f"up{i}_res{j}"])
            if f"up{i}_attn{j}" in p:
                _put_transformer(sd, f"{t}.attentions.{j}",
                                 p[f"up{i}_attn{j}"])
        if f"up{i}_upsample" in p:
            _put_conv(sd, f"{t}.upsamplers.0.conv", p[f"up{i}_upsample"])
    return sd


def _put_vae_attn(sd, name, e):
    _put_ln(sd, f"{name}.group_norm", e["norm"])
    for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                         ("proj_out", "to_out.0")):
        _put_linear(sd, f"{name}.{theirs}", e[ours])


def state_dict_from_jax_vae(encoder: Mapping, decoder: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_vae``: the JAX Encoder and Decoder trees ->
    diffusers' AutoencoderKL keys."""
    e, d = encoder["params"], decoder["params"]
    sd: Dict[str, torch.Tensor] = {}
    for net, p in (("encoder", e), ("decoder", d)):
        _put_conv(sd, f"{net}.conv_in", p["conv_in"])
        _put_ln(sd, f"{net}.conv_norm_out", p["norm_out"])
        _put_conv(sd, f"{net}.conv_out", p["conv_out"])
        for j in (1, 2):
            _put_resnet(sd, f"{net}.mid_block.resnets.{j - 1}",
                        p[f"mid_block{j}"])
        _put_vae_attn(sd, f"{net}.mid_block.attentions.0", p["mid_attn"])
    _put_conv(sd, "quant_conv", e["quant_conv"])
    _put_conv(sd, "post_quant_conv", d["post_quant_conv"])
    levels = sum(1 for k in e if k.startswith("down") and
                 k.endswith("_block0"))
    for i in range(levels):
        t = f"encoder.down_blocks.{i}"
        for j in range(2):
            _put_resnet(sd, f"{t}.resnets.{j}", e[f"down{i}_block{j}"])
        if f"down{i}_downsample" in e:
            _put_conv(sd, f"{t}.downsamplers.0.conv",
                      e[f"down{i}_downsample"])
    for k in range(levels):
        i, t = levels - 1 - k, f"decoder.up_blocks.{k}"
        for j in range(3):
            _put_resnet(sd, f"{t}.resnets.{j}", d[f"up{i}_block{j}"])
        if f"up{i}_upsample" in d:
            _put_conv(sd, f"{t}.upsamplers.0.conv", d[f"up{i}_upsample"])
    return sd


def state_dict_from_jax_marigold(variables: Mapping
                                 ) -> Dict[str, torch.Tensor]:
    """The JAX MarigoldPipeline's variables ({encoder, decoder, unet,
    empty_text_embed}) -> the port's MarigoldPipeline state dict."""
    sd = {f"vae.{k}": v for k, v in state_dict_from_jax_vae(
        variables["encoder"], variables["decoder"]).items()}
    sd.update({f"unet.{k}": v for k, v in
               state_dict_from_jax_unet(variables["unet"]).items()})
    sd["empty_text_embed"] = _t(np.asarray(variables["empty_text_embed"],
                                           np.float32))
    return sd


# the VAE attention's older diffusers names, and its 1x1-conv weights
_OLD_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                 "proj_attn": "to_out.0"}


def _vae_new_names(sd: Mapping) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        head, _, leaf = k.rpartition(".")
        parent, _, last = head.rpartition(".")
        if ".attentions." in k and last in _OLD_VAE_ATTN:
            k = f"{parent}.{_OLD_VAE_ATTN[last]}.{leaf}"
            if v.dim() == 4:
                v = v[:, :, 0, 0]
        out[k] = v
    return out


def empty_text_embed(model_dir: str) -> np.ndarray:
    """(1, 77, 1024) empty-prompt embedding from the tree's CLIP text
    encoder (transformers' torch CLIPTextModel)."""
    from transformers import CLIPTextModel, CLIPTokenizer
    tok = CLIPTokenizer.from_pretrained(os.path.join(model_dir, "tokenizer"))
    te = CLIPTextModel.from_pretrained(os.path.join(model_dir,
                                                    "text_encoder")).eval()
    inputs = tok("", padding="max_length", max_length=77,
                 return_tensors="pt")
    with torch.no_grad():
        return te(**inputs).last_hidden_state.numpy()


def load_marigold_checkpoint(model_dir: str) -> Dict[str, torch.Tensor]:
    """A Marigold diffusers tree (``vae/``, ``unet/``, ``text_encoder/``,
    ``tokenizer/``) -> the port's MarigoldPipeline state dict.  The empty
    prompt's embedding is computed where the text encoder loads, else it
    is zeros, as in the JAX package."""
    def load_bin(sub):
        for fn in ("diffusion_pytorch_model.bin", "pytorch_model.bin"):
            path = os.path.join(model_dir, sub, fn)
            if os.path.exists(path):
                return torch.load(path, map_location="cpu",
                                  weights_only=True)
        raise FileNotFoundError(f"no torch weights under {model_dir}/{sub}")

    unet = load_bin("unet")
    sd = {f"vae.{k}": v for k, v in _vae_new_names(load_bin("vae")).items()}
    sd.update({f"unet.{k}": v for k, v in unet.items()})
    try:
        embed = empty_text_embed(model_dir)
    except Exception:   # the context's width: SD2's 1024
        width = unet["down_blocks.0.attentions.0.transformer_blocks.0."
                     "attn2.to_k.weight"].shape[1]
        embed = np.zeros((1, 77, width), np.float32)
    sd["empty_text_embed"] = _t(np.asarray(embed, np.float32))
    return sd


def load_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference checkpoint with strict=True.  ZoeDepth's state
    dict is under ``model`` and LeReS's under ``depth_model``; the port's
    modules hold them under that name, so their keys get it as a prefix
    where they lack it.  ``module.`` is stripped and the keys no forward
    reads (``_DEAD_KEYS``) are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    prefix = ""
    for wrap in ("model", "depth_model"):
        if isinstance(sd.get(wrap), dict):
            sd, prefix = sd[wrap], wrap + "."
            break
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    sd = {k if k.startswith(prefix) else prefix + k: v
          for k, v in sd.items() if not k.startswith(_DEAD_KEYS)}
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
    normal with std 1/sqrt(fan_in) (a transposed conv's fan-in: the taps
    that reach one output) and zero biases, LayerNorm, GroupNorm,
    BatchNorm (running mean 0, var 1) and LayerScale at 1, cls token and
    rel-pos tables normal(0, 0.02), the NK router's packed in-projection
    as a linear weight.  The numbers differ from the JAX package's init;
    tests carry weights across with state_dict_from_jax instead.  DINOv2's
    position embeddings and mask token are normal(0, 0.02) too, its
    LayerScale gammas 1."""
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                # the taps that reach one output: in x (k / stride)^2 (in
                # alone for the DPT heads' k = stride)
                fan_in = w.shape[0] * (w.shape[2] // mod.stride[0]) * (
                    w.shape[3] // mod.stride[1])
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
        elif leaf in ("q_bias", "v_bias", "in_proj_bias"):
            prm.zero_()
        elif leaf == "in_proj_weight":
            prm.copy_(torch.randn(prm.shape, generator=g)
                      / math.sqrt(prm.shape[1]))
        elif leaf in ("cls_token", "relative_position_bias_table",
                      "pos_embed", "mask_token"):
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.02)
    return model


# -- the 3D photo's inpainting nets (edge / depth / colour) ---------------

INPAINT_FILES = {"edge": ("edge-model.pth", "edge_model.pth"),
                 "depth": ("depth-model.pth", "depth_model.pth"),
                 "color": ("color-model.pth", "color_model.pth")}


def state_dict_from_jax_inpaint(variables: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The inverse of ``convert_inpaint.convert_edge_net`` (a tree with
    ``enc0``: the edge net, its spectral norm already folded) and of
    ``convert_pconv_unet`` (a ``unet`` tree: the depth net, or the colour
    net when it holds ``dec_1A``), with the mask convs' all-ones weights."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    if "enc0" in p:
        for jax_name, name in (("enc0", "encoder_0.1"),
                               ("enc1", "encoder_1.0"),
                               ("enc2", "encoder_2.0"),
                               ("dec2", "decoder_2.1")):
            _put_conv(sd, name, p[jax_name])
        for jax_name, name in (("dec0", "decoder_0.0"),
                               ("dec1", "decoder_1.0")):
            sd[f"{name}.weight"] = _convt(p[jax_name]["kernel"])
            sd[f"{name}.bias"] = _t(p[jax_name]["bias"])
        for i in range(sum(1 for k in p if k.startswith("res"))):
            for conv, idx in (("conv1", 1), ("conv2", 5)):
                _put_conv(sd, f"middle.{i}.conv_block.{idx}",
                          p[f"res{i}"][conv], bias=False)
        return sd
    unet, stats = p["unet"], variables.get("batch_stats", {}).get("unet", {})
    for name, entry in unet.items():
        conv = entry["conv"]
        w = _conv(conv["input_conv"]["kernel"])
        sd[f"{name}.conv.input_conv.weight"] = w
        sd[f"{name}.conv.mask_conv.weight"] = torch.ones_like(w)
        if "bias" in conv:
            sd[f"{name}.conv.input_conv.bias"] = _t(conv["bias"])
        if "bn" in entry:
            _put_bn(sd, f"{name}.bn", entry["bn"], stats[name]["bn"])
    return sd


def spectral_fold(w: np.ndarray, u: np.ndarray, v: Optional[np.ndarray],
                  transposed: bool) -> np.ndarray:
    """A spectral-norm conv's effective weight, as torch's eval-time
    ``compute_weight`` makes it and ``convert_inpaint.spectral_weight``
    restates it: weight_orig / sigma, sigma = u^T W v with the stored u and
    v, W the weight flattened over its dim 0 (dim 1 for a transposed
    conv); without a stored v, v = W^T u normalized."""
    dim = 1 if transposed else 0
    if w.shape[dim] != u.shape[0]:
        raise ValueError(f"spectral norm: weight {w.shape} against u "
                         f"{u.shape} over dim {dim}")
    wm = np.moveaxis(w, dim, 0).reshape(w.shape[dim], -1)
    if v is None:
        v = wm.T @ u
        v = v / max(np.linalg.norm(v), 1e-12)
    sigma = float(u @ (wm @ v))
    return w / sigma


def _fold_spectral(sd: Mapping, module: nn.Module) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``weight_orig`` / ``weight_u`` / ``weight_v`` triples
    folded into plain ``weight``s (``spectral_fold``; transposed where the
    module's layer is a ConvTranspose2d)."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if key.endswith((".weight_u", ".weight_v")):
            continue
        if not key.endswith(".weight_orig"):
            out[key] = val
            continue
        name = key[:-len(".weight_orig")]
        v = sd.get(name + ".weight_v")
        transposed = isinstance(module.get_submodule(name),
                                nn.ConvTranspose2d)
        out[name + ".weight"] = torch.from_numpy(np.ascontiguousarray(
            spectral_fold(val.numpy(), sd[name + ".weight_u"].numpy(),
                          None if v is None else v.numpy(), transposed)))
    return out


def load_inpaint_nets(weights_dir: str) -> Optional[Dict[str, nn.Module]]:
    """The three nets ({"edge", "depth", "color"}, on the host, in eval)
    with ``edge-model.pth``, ``depth-model.pth`` and ``color-model.pth``
    (or their underscore names) from ``weights_dir`` loaded strictly, the
    edge net's spectral norm folded.  None when none of the three files is
    there; FileNotFoundError when only some are."""
    from depthmap_tpu_torch.models.inpaint_nets import (InpaintColorNet,
                                                        InpaintDepthNet,
                                                        InpaintEdgeNet)
    paths = {}
    for key, names in INPAINT_FILES.items():
        paths[key] = next((p for p in (os.path.join(weights_dir, n)
                                       for n in names)
                           if os.path.exists(p)), None)
    if all(p is None for p in paths.values()):
        return None
    missing = [k for k, p in paths.items() if p is None]
    if missing:
        raise FileNotFoundError(
            f"3D-photo inpainting checkpoints missing in {weights_dir}: "
            f"{missing} (found {[k for k in paths if k not in missing]})")
    nets = {"edge": InpaintEdgeNet(), "depth": InpaintDepthNet(),
            "color": InpaintColorNet()}
    for key, path in paths.items():
        sd = torch.load(path, map_location="cpu", weights_only=True)
        nets[key].load_state_dict(_fold_spectral(sd, nets[key]), strict=True)
        nets[key].eval()
    return nets


def edge_net_with_spectral_norm(net: nn.Module) -> nn.Module:
    """The edge net as the reference wraps it: torch's spectral norm on
    every conv but the last (``decoder_2.1``), so its state dict holds the
    checkpoint's ``weight_orig`` / ``weight_u`` / ``weight_v``."""
    for name, mod in list(net.named_modules()):
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)) and \
                name != "decoder_2.1":
            nn.utils.spectral_norm(mod)
    return net


@torch.no_grad()
def save_random_inpaint_checkpoints(weights_dir: str, seed: int = 0) -> None:
    """Write seeded random-init ``edge-model.pth``, ``depth-model.pth`` and
    ``color-model.pth`` at full width in the reference checkpoints' key
    layout (the mask convs all ones; the edge net spectral-normed, its u
    and v from three power iterations) into ``weights_dir``."""
    from depthmap_tpu_torch.models.inpaint_nets import (InpaintColorNet,
                                                        InpaintDepthNet,
                                                        InpaintEdgeNet)
    os.makedirs(weights_dir, exist_ok=True)
    nets = {"edge": InpaintEdgeNet(), "depth": InpaintDepthNet(),
            "color": InpaintColorNet()}
    for i, net in enumerate(nets.values()):
        init_random_(net, seed + i)
        for name, prm in net.named_parameters():
            if ".mask_conv." in name:
                prm.fill_(1.0)
    with torch.random.fork_rng(devices=[]):    # spectral norm draws u, v
        torch.manual_seed(seed)
        edge = edge_net_with_spectral_norm(nets["edge"]).train()
        for _ in range(3):  # each training-mode forward: a power iteration
            edge(torch.zeros((1, 7, 16, 16)))
    for key, net in nets.items():
        torch.save(net.eval().state_dict(),
                   os.path.join(weights_dir, INPAINT_FILES[key][0]))
