"""zoedepth_k's work per photo and per forward (the BEiT-L/16 384 DPT
core and the metric head, on the photo and its mirrored copy), by the
benchmark's arithmetic (``port_bench/work.py``).

``net_hw`` is what the harness reads, the photo as the module receives
it; the net input is ZoeDepth's own from it (``reference/zoedepth.py
net_input`` at the funnel's matched net), and every photo is two copies.
"""
from __future__ import annotations

from port_bench import work
from port_bench.reference.zoedepth import matched_net, net_input

COPIES = 2   # the photo and its mirror, one batch


def grid(cfg: dict, net_hw) -> tuple:
    h, w = net_input(tuple(net_hw), matched_net(tuple(net_hw)))
    ps = cfg["patch_size"]
    return h // ps, w // ps


def head_flops(cfg: dict, grid_hw) -> float:
    """The metric head at the levels of a (gh, gw) grid: conv2, the seed
    regressor and seed projector at the bottleneck (gh / 2), a projector
    and an attractor at each fusion output (gh .. 8 gh), and the
    log-binomial's MLP at the net input (16 gh)."""
    lv = work.level_sizes(grid_hw)
    f, emb = cfg["features"], cfg["bin_embedding_dim"]
    bins, mlp = cfg["n_bins"], cfg["projector_mlp_dim"]
    total = work.conv(lv[3], f, f, 1)
    total += work.conv(lv[3], f, cfg["seed_mlp_dim"], 1) + \
        work.conv(lv[3], cfg["seed_mlp_dim"], bins, 1)
    total += work.conv(lv[3], f, mlp, 1) + work.conv(lv[3], mlp, emb, 1)
    levels = [lv[2], lv[1], lv[0], (2 * lv[0][0], 2 * lv[0][1])]
    for hw, a in zip(levels, cfg["n_attractors"]):
        total += work.conv(hw, f, mlp, 1) + work.conv(hw, mlp, emb, 1)
        total += work.conv(hw, emb, cfg["attractor_mlp_dim"], 1) + \
            work.conv(hw, cfg["attractor_mlp_dim"], 2 * a, 1)
    full = (16 * grid_hw[0], 16 * grid_hw[1])
    cin = 32 + 1 + emb
    mid = cin // cfg["log_binomial_bottleneck_factor"]
    return total + work.conv(full, cin, mid, 1) + work.conv(full, mid, 4, 1)


def flops_per_image(cfg: dict, net_hw) -> float:
    """Both copies: the patch embedding, the 24 blocks (attention at N =
    gh gw + 1), the reassemble with the project readout, the decoder
    (its head at 16 gh x 16 gw) and the metric head."""
    gh, gw = grid(cfg, net_hw)
    dim, ps = cfg["hidden_size"], cfg["patch_size"]
    chans = cfg["reassemble_channels"]
    n = gh * gw + 1
    per_copy = (2.0 * gh * gw * dim * 3 * ps * ps
                + work.vit_blocks(n, dim, cfg["num_hidden_layers"],
                                  cfg["intermediate_size"])
                + work.reassemble((gh, gw), dim, chans, readout=True)
                + work.decoder((gh, gw), chans, cfg["features"],
                               (16 * gh, 16 * gw))
                + head_flops(cfg, (gh, gw)))
    return COPIES * per_copy


def attention_per_forward(cfg: dict, net_hw, batch: int) -> list:
    """One call a block over the forward's 2 x ``batch`` copies.  At N =
    8401 the bias streams (K1's table mode): the call reads the block's
    rel-pos table once, (2gh - 1)(2gw - 1) + 3 entries a head in f32,
    the table mode's input."""
    gh, gw = grid(cfg, net_hw)
    heads = cfg["num_attention_heads"]
    entries = (2 * gh - 1) * (2 * gw - 1) + 3
    call = work.attention_call(COPIES * batch, heads, gh * gw + 1,
                               cfg["head_dim"], cfg["dtype"],
                               entries * heads * 4)
    return [call] * cfg["num_hidden_layers"]
