"""depth_anything_v2_large's work per photo and per forward (DINOv2
ViT-L/14 + the Depth Anything v2 DPT head), by the benchmark's
arithmetic (``port_bench/work.py``)."""
from __future__ import annotations

from port_bench import work


def grid(cfg: dict, net_hw) -> tuple:
    ps = cfg["patch_size"]
    return net_hw[0] // ps, net_hw[1] // ps


def flops_per_image(cfg: dict, net_hw) -> float:
    """The patch embedding, the 24 blocks (attention at N = gh gw + 1),
    the 1x1 projections and resizes (no readout) and the decoder, whose
    head ends at 14 gh x 14 gw."""
    gh, gw = grid(cfg, net_hw)
    dim, ps = cfg["hidden_size"], cfg["patch_size"]
    chans = cfg["out_channels"]
    n = gh * gw + 1
    return (2.0 * gh * gw * dim * 3 * ps * ps
            + work.vit_blocks(n, dim, cfg["num_hidden_layers"],
                              cfg["intermediate_size"])
            + work.reassemble((gh, gw), dim, chans, readout=False)
            + work.decoder((gh, gw), chans, cfg["features"],
                           (ps * gh, ps * gw)))


def attention_per_forward(cfg: dict, net_hw, batch: int) -> list:
    """One bias-free call a block."""
    gh, gw = grid(cfg, net_hw)
    call = work.attention_call(batch, cfg["num_attention_heads"],
                               gh * gw + 1, cfg["head_dim"], cfg["dtype"])
    return [call] * cfg["num_hidden_layers"]
