"""Multi-head attention dispatch for the ViT backbones.

Port of ``depthmap_tpu/models/attention.py``: ``attention`` sends a CUDA
tensor to kernel K1 (ops/flash_attention.py) and a CPU tensor to its
plain version.  There is no fallback from the kernel to plain torch on the
card and no kill switch.

BEiT's streamed tier (``RelBiasSpec``): above the stream budget a block
hands attention its window-resized rel-pos table and the grid instead of
a materialized (1, H, N, N) bias.  ``attention_rel_streamed`` is the plain
version (the JAX function restated: the queries in chunks, each chunk's
(chunk, N) bias gathered from the table).  On the card without grad, K1's
table mode reads the bias from the table inside the kernel, in one launch
over all N queries; with grad, each chunk's bias is gathered in torch and
goes through ``FlashAttentionFunction``, so the table gets its gradient
through the gather.

Bias-free calls (DINOv2, Depth Anything) go to K1 too, at every length:
the JAX dispatch sends them to the Pallas kernel only from N = 2048 and
kv = 1024 and to XLA's attention below that, which is the same function.
K1 takes D = 64 only (every Depth Anything head has it); any other head
dimension raises on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from depthmap_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, bias_row_len, flash_attention,
    flash_attention_plain, flash_attention_rel, pad_bias_rows,
    pad_table_rows, rel_pos_index)


class RelBiasSpec(NamedTuple):
    """A block's relative-position bias as its table: ``table`` (num_rel
    + 3, H), already resized to the (gh, gw) window (models/beit.py
    ``rel_pos_table``)."""
    table: torch.Tensor
    gh: int
    gw: int


def gather_rel_bias(table: torch.Tensor, tq: torch.Tensor, n: int,
                    grid) -> torch.Tensor:
    """The (1, H, len(tq), n) bias of query tokens ``tq`` against all n
    tokens, gathered from the (num_rel + 3, H) table in its dtype, as the
    ``[..., :n]`` view of rows padded to ``bias_row_len(n)`` (K1's layout;
    pad columns read entry 0); indices clipped to the table, so padded
    queries (tq >= n) read inside it."""
    num_rel = (2 * grid[0] - 1) * (2 * grid[1] - 1)
    ld = bias_row_len(n)
    tk = torch.arange(ld, device=tq.device)
    idx = rel_pos_index(tq, tk.clamp(max=n - 1), grid)
    idx = idx.clamp(0, num_rel + 2)
    idx[:, n:] = 0
    h = table.shape[1]
    bias = table.t().index_select(1, idx.view(-1))
    return bias.view(1, h, len(tq), ld)[..., :n]


def attention_rel_streamed(q, k, v, spec: RelBiasSpec,
                           scale: Optional[float] = None,
                           chunk: int = 512) -> torch.Tensor:
    """Exact attention with the rel-pos bias resolved per query chunk, in
    plain torch (``depthmap_tpu/models/attention.py:36``): the table cast
    to q's dtype, the queries padded to a multiple of the chunk, each
    chunk's (chunk, N) index clipped to the table, its bias gathered and
    ``flash_attention_plain`` run on the chunk against every key."""
    b, h, n, d = q.shape
    if scale is None:
        scale = d ** -0.5
    grid = (int(spec.gh), int(spec.gw))
    chunk = min(chunk, -(-n // 128) * 128)
    nch = -(-n // chunk)
    qp = torch.nn.functional.pad(q, (0, 0, 0, nch * chunk - n))
    table = spec.table.to(q.dtype)
    outs = []
    for c in range(nch):
        tq = torch.arange(c * chunk, (c + 1) * chunk, device=q.device)
        bias = gather_rel_bias(table, tq, n, grid)
        outs.append(flash_attention_plain(
            qp[:, :, c * chunk:(c + 1) * chunk], k, v, bias, scale))
    return torch.cat(outs, 2)[:, :, :n]


def _attention_rel_grad(q, k, v, spec: RelBiasSpec, scale, chunk: int = 512):
    """The streamed tier with a gradient, on the card: per query chunk the
    JAX structure, a gather into K1's padded-row layout (the table's
    gradient goes back through it) and ``FlashAttentionFunction``."""
    n = q.shape[2]
    grid = (int(spec.gh), int(spec.gw))
    table = spec.table.to(q.dtype)
    outs = []
    for c0 in range(0, n, chunk):
        tq = torch.arange(c0, min(c0 + chunk, n), device=q.device)
        bias = gather_rel_bias(table, tq, n, grid)
        outs.append(FlashAttentionFunction.apply(
            q[:, :, c0:c0 + chunk].contiguous(), k, v, bias, float(scale)))
    return torch.cat(outs, 2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Union[None, torch.Tensor, RelBiasSpec] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, N, D); bias (1|B, H, N, Nk) or (H, N, Nk), passed
    as it is (the BEiT bias arrives in q's dtype and K1's padded-row
    layout, as the JAX package hoists it in the compute dtype); a bias in
    another dtype is cast into a padded-row copy.  A ``RelBiasSpec``: on
    the card K1's table mode (no grad) or the chunked gather into K1 (with
    grad); on the CPU ``attention_rel_streamed``."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if isinstance(bias, RelBiasSpec):
        if scale is None:
            scale = q.shape[-1] ** -0.5
        if not q.is_cuda:
            return attention_rel_streamed(q, k, v, bias, scale)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v, bias.table)):
            return _attention_rel_grad(q, k, v, bias, scale)
        table = pad_table_rows(bias.table, q.dtype)
        return flash_attention_rel(q, k, v, table, (bias.gh, bias.gw), scale)
    if bias is not None and bias.dtype != q.dtype:
        bias = pad_bias_rows(bias, q.dtype)
    return flash_attention(q, k, v, bias=bias, scale=scale)
