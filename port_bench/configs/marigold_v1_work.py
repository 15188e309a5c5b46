"""marigold_v1's work per photo and per forward (the SD2 UNet's
denoising steps and the SD VAE's encode and decode), by the benchmark's
arithmetic (``port_bench/work.py``): convolutions and linears as 2 x
multiply-adds, each attention as 4 N Nk C (q kᵀ and p v).  One forward of
the predictor's module is one photo: ``ensemble_size`` members through
the encode, ``denoising_steps`` UNet evaluations and the decode.

Attention calls are K1's (the UNet's self-attention over the latent's
tokens and its cross-attention on the empty prompt's 77 rows); the VAE's
one-head attention is not K1's and counts only in the operations.  The
configuration's ``dtype`` names the peak the shares divide by (tf32);
the program computes in float32, so every call's bytes are f32's.
"""
from __future__ import annotations

import math

from port_bench import work

F32_BYTES = 4


def _half(hw):
    """A stride-2 3x3 convolution's output size (padding 1)."""
    return math.ceil(hw[0] / 2), math.ceil(hw[1] / 2)


def latent_hw(net_hw):
    return net_hw[0] // 8, net_hw[1] // 8


def unet_levels(cfg: dict, net_hw) -> list:
    """The UNet's levels, finest first: (height, width) of each."""
    hw = latent_hw(net_hw)
    out = []
    for _ in cfg["unet"]["block_out_channels"]:
        out.append(hw)
        hw = _half(hw)
    return out


def _linear(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def _resnet(hw, cin: int, cout: int, temb: int = 0) -> float:
    total = work.conv(hw, cin, cout, 3) + work.conv(hw, cout, cout, 3)
    if cin != cout:
        total += work.conv(hw, cin, cout, 1)
    if temb:
        total += _linear(1, temb, cout)
    return total


def _transformer(hw, ch: int, ctx_dim: int, ctx_len: int) -> float:
    n = hw[0] * hw[1]
    total = 2 * _linear(n, ch, ch)                     # proj_in, proj_out
    total += 4 * _linear(n, ch, ch)                    # attn1 q k v out
    total += 4.0 * n * n * ch                          # attn1
    total += 2 * _linear(n, ch, ch)                    # attn2 q, out
    total += 2 * _linear(ctx_len, ctx_dim, ch)         # attn2 k, v
    total += 4.0 * n * ctx_len * ch                    # attn2
    total += _linear(n, ch, 8 * ch) + _linear(n, 4 * ch, ch)   # GEGLU, out
    return total


def unet_flops(cfg: dict, net_hw) -> float:
    """One UNet evaluation of one latent."""
    u = cfg["unet"]
    chans = u["block_out_channels"]
    temb = u["time_embedding_dim"]
    ctx_dim, ctx_len = u["cross_attention_dim"], u["context_length"]
    layers = u["layers_per_block"]
    levels = unet_levels(cfg, net_hw)
    last = len(chans) - 1
    total = work.conv(levels[0], u["in_channels"], chans[0], 3)
    total += _linear(1, chans[0], temb) + _linear(1, temb, temb)
    skips, ch = [chans[0]], chans[0]
    for i, out in enumerate(chans):
        for _ in range(layers):
            total += _resnet(levels[i], ch, out, temb)
            if i < last:
                total += _transformer(levels[i], out, ctx_dim, ctx_len)
            ch = out
            skips.append(ch)
        if i < last:
            total += work.conv(levels[i + 1], ch, ch, 3)
            skips.append(ch)
    total += 2 * _resnet(levels[last], ch, ch, temb)
    total += _transformer(levels[last], ch, ctx_dim, ctx_len)
    for i in reversed(range(len(chans))):
        out = chans[i]
        for _ in range(layers + 1):
            total += _resnet(levels[i], ch + skips.pop(), out, temb)
            if i < last:
                total += _transformer(levels[i], out, ctx_dim, ctx_len)
            ch = out
        if i > 0:
            total += work.conv(levels[i - 1], ch, ch, 3)
    return total + work.conv(levels[0], ch, u["out_channels"], 3)


def _vae_mid(hw, ch: int) -> float:
    n = hw[0] * hw[1]
    return (2 * _resnet(hw, ch, ch) + 4 * _linear(n, ch, ch)
            + 4.0 * n * n * ch)


def vae_encode_flops(cfg: dict, net_hw) -> float:
    v = cfg["vae"]
    chans = v["block_out_channels"]
    lat = v["latent_channels"]
    hw = tuple(net_hw)
    total = work.conv(hw, 3, chans[0], 3)
    ch = chans[0]
    for i, out in enumerate(chans):
        for _ in range(v["layers_per_block"]):
            total += _resnet(hw, ch, out)
            ch = out
        if i < len(chans) - 1:
            hw = (hw[0] // 2, hw[1] // 2)      # (0, 1) pad, stride 2, k 3
            total += work.conv(hw, ch, ch, 3)
    total += _vae_mid(hw, ch)
    total += work.conv(hw, ch, 2 * lat, 3) + work.conv(hw, 2 * lat,
                                                       2 * lat, 1)
    return total


def vae_decode_flops(cfg: dict, net_hw) -> float:
    v = cfg["vae"]
    chans = v["block_out_channels"]
    lat = v["latent_channels"]
    hw = latent_hw(net_hw)
    ch = chans[-1]
    total = work.conv(hw, lat, lat, 1) + work.conv(hw, lat, ch, 3)
    total += _vae_mid(hw, ch)
    for i in reversed(range(len(chans))):
        out = chans[i]
        for _ in range(v["layers_per_block"] + 1):
            total += _resnet(hw, ch, out)
            ch = out
        if i > 0:
            hw = (2 * hw[0], 2 * hw[1])
            total += work.conv(hw, ch, ch, 3)
    return total + work.conv(hw, ch, 3, 3)


def flops_per_image(cfg: dict, net_hw) -> float:
    members = cfg["ensemble_size"]
    return members * (vae_encode_flops(cfg, net_hw)
                      + cfg["denoising_steps"] * unet_flops(cfg, net_hw)
                      + vae_decode_flops(cfg, net_hw))


def _call(batch: int, heads: int, n: int, nk: int, d: int) -> dict:
    """One K1 call: 4 B H N Nk D operations; q and the output (N rows),
    k and v (Nk rows) once, in f32."""
    return {"ops": 4.0 * batch * heads * n * nk * d,
            "bytes": 2.0 * batch * heads * (n + nk) * d * F32_BYTES}


def attention_per_forward(cfg: dict, net_hw, batch: int) -> list:
    """Every K1 call of one forward of ``batch`` photos: per UNet
    evaluation, each transformer's self-attention over its level's tokens
    and its cross-attention on the context's rows, in the order they
    run."""
    u = cfg["unet"]
    chans = u["block_out_channels"]
    d = u["attention_head_dim"]
    layers = u["layers_per_block"]
    levels = unet_levels(cfg, net_hw)
    last = len(chans) - 1
    b = batch * cfg["ensemble_size"]
    at = [i for i in range(last) for _ in range(layers)] + [last] + \
        [i for i in reversed(range(last)) for _ in range(layers + 1)]
    per_eval = []
    for i in at:
        n = levels[i][0] * levels[i][1]
        heads = chans[i] // d
        per_eval += [_call(b, heads, n, n, d),
                     _call(b, heads, n, u["context_length"], d)]
    return per_eval * cfg["denoising_steps"]
