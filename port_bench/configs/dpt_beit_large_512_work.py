"""dpt_beit_large_512's work per photo and per forward (BEiT-L/16 + the
MiDaS DPT head), by the benchmark's arithmetic (``port_bench/work.py``)."""
from __future__ import annotations

from port_bench import work


def grid(cfg: dict, net_hw) -> tuple:
    ps = cfg["patch_size"]
    return net_hw[0] // ps, net_hw[1] // ps


def flops_per_image(cfg: dict, net_hw) -> float:
    """The patch embedding, the 24 blocks (attention at N = gh gw + 1),
    the reassemble with the project readout and the decoder, whose head
    ends at 16 gh x 16 gw."""
    gh, gw = grid(cfg, net_hw)
    dim, ps = cfg["hidden_size"], cfg["patch_size"]
    chans = cfg["reassemble_channels"]
    n = gh * gw + 1
    return (2.0 * gh * gw * dim * 3 * ps * ps
            + work.vit_blocks(n, dim, cfg["num_hidden_layers"],
                              cfg["intermediate_size"])
            + work.reassemble((gh, gw), dim, chans, readout=True)
            + work.decoder((gh, gw), chans, cfg["features"],
                           (16 * gh, 16 * gw)))


def attention_per_forward(cfg: dict, net_hw, batch: int) -> list:
    """One call a block; its bias is the block's rel-pos table resized to
    the grid, (2gh - 1)(2gw - 1) + 3 entries a head, in the model's
    dtype."""
    gh, gw = grid(cfg, net_hw)
    heads = cfg["num_attention_heads"]
    entries = (2 * gh - 1) * (2 * gw - 1) + 3
    bias = entries * heads * work.DTYPE_BYTES[cfg["dtype"]]
    call = work.attention_call(batch, heads, gh * gw + 1, cfg["head_dim"],
                               cfg["dtype"], bias)
    return [call] * cfg["num_hidden_layers"]
