"""Seeded weights for a model, made on its device.

The rule is frozen here so that the yardstick does not move with the
program: a linear or convolution weight is normal with std 1/sqrt(fan_in)
(a transposed convolution's fan-in counts the taps that reach one output:
in x (k / stride)^2), its bias 0; LayerNorm, GroupNorm and BatchNorm
weights 1 and biases 0; layer scales (``gamma``, ``gamma_1``,
``gamma_2``) 1; BEiT's q / v biases 0; class tokens, position
embeddings, mask tokens and relative-position tables normal with std
0.02.  Buffers (index tables, BEiT's zero k bias) stay as the module
builds them.  One departure from the program's own init: the parameters
a configuration lists under ``positive_weights`` (the last 1x1
convolution of the depth head) take the magnitude of their draw.  Its
input is a ReLU's, and with weights of either sign the map of a seed
whose 32 weights lean negative is dead but for a few pixels on most
photos (2 of 10 seeds of DA v2 Large), as no trained model's is: it
leaves nothing to compare and hands the stereo stage a flat map.

All normal draws come from one ``torch.randn`` on the device with a
generator seeded from the run's seed, in the order of
``named_parameters``; each parameter takes its slice, scaled, in its own
dtype.  ``make`` regenerates the same values from the same plan and seed,
so the reference gets the program's weights without either side holding
a second copy during the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch
import torch.nn as nn

ONES = ("gamma", "gamma_1", "gamma_2")
ZEROS = ("q_bias", "v_bias", "in_proj_bias")
SMALL = ("cls_token", "relative_position_bias_table", "pos_embed",
         "mask_token")
SMALL_STD = 0.02


class Leaf(NamedTuple):
    name: str
    shape: tuple
    dtype: torch.dtype
    std: float        # 0: constant ``fill``
    fill: float
    positive: bool = False   # the magnitude of the draw


def _fan_in(mod: nn.Module, w: torch.Tensor) -> int:
    if isinstance(mod, nn.ConvTranspose2d):
        return w.shape[0] * (w.shape[2] // mod.stride[0]) * (
            w.shape[3] // mod.stride[1])
    return w[0].numel()


def plan(module: nn.Module, positive=()) -> List[Leaf]:
    """Every parameter of ``module`` with its draw, by the rule above;
    the names in ``positive`` take the magnitude of theirs."""
    owner = {}
    for mname, mod in module.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    leaves = []
    for name, prm in module.named_parameters():
        mod, leaf = owner[name]
        std, fill = 0.0, 0.0
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)) and \
                leaf == "weight":
            std = 1.0 / math.sqrt(_fan_in(mod, prm))
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)) \
                and leaf == "weight":
            fill = 1.0
        elif leaf in ONES:
            fill = 1.0
        elif leaf == "in_proj_weight":
            std = 1.0 / math.sqrt(prm.shape[1])
        elif leaf in SMALL:
            std = SMALL_STD
        elif leaf == "bias" or leaf in ZEROS:
            fill = 0.0
        else:
            raise ValueError(f"no rule for parameter {name}")
        leaves.append(Leaf(name, tuple(prm.shape), prm.dtype, std, fill,
                           name in positive))
    missing = set(positive) - {l.name for l in leaves}
    if missing:
        raise KeyError(f"positive_weights names no parameter: {missing}")
    return leaves


def make(leaves: List[Leaf], seed: int, device,
         dtype=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} on ``device``, each in its leaf's dtype (or in
    ``dtype``, after rounding to the leaf's: the reference's f32 copy of
    the served values)."""
    total = sum(math.prod(l.shape) for l in leaves if l.std > 0)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    draws = torch.randn(total, generator=gen, device=device,
                        dtype=torch.float32)
    out, at = {}, 0
    for l in leaves:
        n = math.prod(l.shape)
        if l.std > 0:
            t = draws[at:at + n].view(l.shape)
            t = ((t.abs() if l.positive else t) * l.std).to(l.dtype)
            at += n
        else:
            t = torch.full(l.shape, l.fill, dtype=l.dtype, device=device)
        out[l.name] = t if dtype is None else t.to(dtype)
    return out


def load(module: nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Load ``params`` into ``module`` through its ``load_state_dict``
    (strict), its buffers as the module holds them."""
    state = module.state_dict()
    for name, t in params.items():
        if name not in state:
            raise KeyError(f"{name} is not in the module's state")
        state[name] = t
    module.load_state_dict(state, strict=True)
