"""The benchmark's own count of a model's work: operations of the
matrix products and convolutions, and the bytes an attention call must
move, from a configuration's published widths and a token grid.

Counts are 2 x multiply-adds.  Norms, activations, resizes and the
softmax are left out (a few percent of the total at these widths).  A
configuration's ``<name>_work.py`` composes these for its model.
"""
from __future__ import annotations

import math
from typing import List, Tuple

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def conv(out_hw: Tuple[int, int], cin: int, cout: int, k: int) -> float:
    """A k x k convolution's operations at an output of out_hw."""
    return 2.0 * out_hw[0] * out_hw[1] * cin * cout * k * k


def conv_transpose(in_hw: Tuple[int, int], cin: int, cout: int,
                   k: int) -> float:
    """A k x k transposed convolution: every input pixel meets k^2 taps."""
    return 2.0 * in_hw[0] * in_hw[1] * cin * cout * k * k


def vit_blocks(n: int, dim: int, depth: int, mlp: int) -> float:
    """Pre-norm transformer blocks over n tokens: qkv, the projection,
    the two MLP matrices and attention's 4 n^2 dim."""
    per = 2.0 * n * dim * (3 * dim + dim + 2 * mlp) + 4.0 * n * n * dim
    return depth * per


def attention_ops(n: int, dim: int, depth: int) -> float:
    """Attention's share of ``vit_blocks``: q kᵀ and p v."""
    return depth * 4.0 * n * n * dim


def reassemble(grid: Tuple[int, int], dim: int, chans, readout: bool
               ) -> float:
    """DPT's reassemble: the optional "project" readout (Linear 2C -> C
    on every patch token), the 1x1 projection to each level's channels,
    then 4x and 2x transposed convolutions (k = stride) and a stride-2
    3x3 convolution on the last level."""
    gh, gw = grid
    t = gh * gw
    total = 0.0
    if readout:
        total += len(chans) * 2.0 * t * 2 * dim * dim
    total += sum(conv(grid, dim, c, 1) for c in chans)
    total += conv_transpose(grid, chans[0], chans[0], 4)
    total += conv_transpose(grid, chans[1], chans[1], 2)
    total += conv(level_sizes(grid)[3], chans[3], chans[3], 3)
    return total


def level_sizes(grid: Tuple[int, int]):
    """The four reassembled maps' sizes: 4x, 2x, 1x and the stride-2
    convolution's ceil(g / 2)."""
    gh, gw = grid
    return [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw),
            (math.ceil(gh / 2), math.ceil(gw / 2))]


def decoder(grid: Tuple[int, int], chans, features: int,
            head_hw: Tuple[int, int]) -> float:
    """layer{i}_rn, the four fusion blocks (two 3x3 convolutions per
    residual unit, a 1x1 out_conv after each resize; refinenet4 has no
    skip unit) and the output head: 3x3 to F/2 at refinenet1's output,
    then, at ``head_hw``, 3x3 to 32 and 1x1 to 1."""
    lv = level_sizes(grid)
    f = features
    total = sum(conv(lv[i], c, f, 3) for i, c in enumerate(chans))
    out_sizes = [lv[1], lv[0], (2 * lv[0][0], 2 * lv[0][1])]
    # refinenet4 at lv[3] -> lv[2]; 3 at lv[2] -> lv[1]; 2 -> lv[0]; 1 -> 2x
    total += 2 * conv(lv[3], f, f, 3) + conv(lv[2], f, f, 1)
    for at, out in zip((lv[2], lv[1], lv[0]), out_sizes):
        total += 4 * conv(at, f, f, 3) + conv(out, f, f, 1)
    p1 = out_sizes[-1]
    total += conv(p1, f, f // 2, 3)
    total += conv(head_hw, f // 2, 32, 3) + conv(head_hw, 32, 1, 1)
    return total


def attention_call(batch: int, heads: int, n: int, head_dim: int,
                   dtype: str, bias_bytes: int = 0) -> dict:
    """One attention call's least work: operations 4 B H N^2 D, and the
    bytes of q, k, v and the output once, plus its bias as the model
    defines it."""
    elem = batch * heads * n * head_dim
    return {"ops": 4.0 * batch * heads * n * n * head_dim,
            "bytes": 4.0 * elem * DTYPE_BYTES[dtype] + bias_bytes}


def least_seconds(call: dict, peak_ops: float, peak_bps: float) -> float:
    """The larger of a call's operations over the peak rate and its bytes
    over the memory bandwidth."""
    return max(call["ops"] / peak_ops, call["bytes"] / peak_bps)


def calls_for(forwards: List[int], per_forward) -> List[dict]:
    """Every attention call of the forwards run (their batch sizes)."""
    return [c for b in forwards for c in per_forward(b)]
