"""K1's table mode: the window of the rel-pos table each stage holds.

Per kv tile the kernel stages, beside K and V, the window of the head's
table row that the CTA's query tile needs against that kv tile
(``ops/flash_attention.py rel_window``), the tile's off() values
(``rel_off_table``) and the cls entries, and reads a score's entry at
window position (base - lo) - off.  These tests restate that read on the
CPU for every (query tile, kv tile) pair of a set of grids, at both
bodies' tiles (bf16: 64 query rows a CTA; f32: 128), and hold it to the
JAX package's ``gen_relative_position_index`` fed the same seeded numpy
table; they hold the window inside the bound the wrapper checks, the
bound inside the stage's slot up to the stated largest grid, and the
wrapper's refusal past it.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from depthmap_tpu.models import beit as jbeit
from depthmap_tpu_torch.ops import flash_attention as fa

# 4:3 and square grids of the BEiT paths (Boost at R_x 1024 / 1536, net
# 2048), small and thin ones, and grids whose N is under one tile
GRIDS = [(5, 7), (12, 16), (48, 64), (72, 96), (128, 128), (1, 300),
         (300, 1), (3, 200), (2, 3), (1, 1)]
# above this N the (N, N) index of gen_relative_position_index takes
# gigabytes: there the reads of the first and last query tiles are held
# to rel_pos_index (itself held to the JAX index on the smaller grids),
# and every pair's positions to the window's bounds
JAX_INDEX_MAX_N = 4000
DTYPES = [torch.bfloat16, torch.float32]
# the widest grid table mode takes, per body (the stage's bias slot: 16 KB
# in bf16, 32 KB in f32, of f32 table entries)
MAX_GW = {torch.bfloat16: 1946, torch.float32: 3962}


def _table_row(grid, seed=0):
    """A seeded (T,) table row with distinct entries, padded with zeros to
    16 bytes of f32 (a multiple of 4 entries), as int64."""
    gh, gw = grid
    t = (2 * gh - 1) * (2 * gw - 1) + 3
    row = np.random.default_rng(seed).permutation(t) + 1
    return torch.from_numpy(np.concatenate([row, np.zeros(-t % 4, int)]))


def _tile_reads(row, q_tile, grid, dtype):
    """What the kernel reads for query tile ``q_tile`` against every kv
    tile, restated: (values (QUERY_TILE, N padded to KEY_TILE), the
    window's (lo, count) per kv tile, the lowest and highest window
    position each kv tile reads)."""
    gh, gw = grid
    n = gh * gw + 1
    bq, bk = fa.QUERY_TILE[dtype], fa.KEY_TILE
    offs = fa.rel_off_table(grid).long() // 4
    n_kt = offs.numel() // bk
    lo, count = fa.rel_window(q_tile, torch.arange(n_kt), grid, dtype)
    e = fa.REL_ENTRIES_PER_16
    # the consumer's lo, from the CTA's first base() and the staged off()
    # of the tile's last key
    first = fa.rel_base(torch.tensor(max(q_tile * bq, 1)), grid)
    assert torch.equal((first - offs.view(n_kt, bk)[:, -1]) // e * e, lo)
    rows = torch.arange(q_tile * bq, (q_tile + 1) * bq)
    base = fa.rel_base(rows.clamp(max=n - 1), grid)
    pos = base[None, :, None] - offs.view(n_kt, 1, bk) - lo[:, None, None]
    lowest = base.min() - offs.view(n_kt, bk).max(1).values - lo
    highest = base.max() - offs.view(n_kt, bk).min(1).values - lo
    vals = row[(lo[:, None, None] + pos)].permute(1, 0, 2).reshape(bq, -1)
    # the cls entries, from the 16-byte span of the row that holds them
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    c0 = num_rel // e * e
    cls = row[c0:-(-(num_rel + 3) // e) * e][num_rel - c0:][:3]
    vals[:, 0] = cls[1]                # token -> cls (kv tile 0)
    if q_tile == 0:                     # cls -> token, cls -> cls
        vals[0] = cls[0]
        vals[0, 0] = cls[2]
    return vals, lo, count, lowest, highest


def _want(row, q_tile, grid, dtype):
    """table[index] for the query tile's rows below N against every key."""
    gh, gw = grid
    n = gh * gw + 1
    bq = fa.QUERY_TILE[dtype]
    r0, r1 = q_tile * bq, min((q_tile + 1) * bq, n)
    if n <= JAX_INDEX_MAX_N:
        idx = torch.from_numpy(
            np.asarray(jbeit.gen_relative_position_index(gh, gw))[r0:r1])
    else:
        idx = fa.rel_pos_index(torch.arange(r0, r1), torch.arange(n), grid)
    return row[idx.long()]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{h}x{w}" for h, w in GRIDS])
def test_window_reads_the_timm_index(grid, dtype):
    """Every (query tile, kv tile) pair: the window lies inside the padded
    row, is at most rel_window_bound entries (inside the slot), every
    position the tile reads lies inside it, and the restated read (the
    window at (base - lo) - off, cls rows and columns selected) gives
    table[gen_relative_position_index] on every row and column below N,
    ragged edge tiles included."""
    gh, gw = grid
    n = gh * gw + 1
    row = _table_row(grid)
    bound = fa.rel_window_bound(gw, dtype)
    assert bound <= fa.rel_window_capacity(dtype)
    n_qt = -(-n // fa.QUERY_TILE[dtype])
    check = range(n_qt) if n <= JAX_INDEX_MAX_N else {0, n_qt - 1}
    for i in range(n_qt):
        vals, lo, count, lowest, highest = _tile_reads(row, i, grid, dtype)
        assert (lo >= 0).all() and (lo + count <= row.numel()).all()
        assert (count <= bound).all(), (i, count.max().item(), bound)
        assert (lowest >= 0).all() and (highest < count).all(), i
        if i in check:
            want = _want(row, i, grid, dtype)
            assert torch.equal(vals[:want.shape[0], :n], want), i


@pytest.mark.parametrize("grid", GRIDS, ids=[f"{h}x{w}" for h, w in GRIDS])
def test_off_table_equals_rel_off(grid):
    """The per-grid off() table the wrapper builds: 4 (r (2gw - 1) + c) of
    each key token (the byte offset in the f32 window), N rounded up to a
    kv tile, cls as token 1 (0) and tokens past N as token N - 1; and
    base(t1) - off(t2) is the JAX index of every token pair."""
    gh, gw = grid
    n = gh * gw + 1
    table = fa.rel_off_table(grid)
    assert table.dtype == torch.int32 and table.numel() == -(-n // 64) * 64
    assert not (table % 4).any()
    got = table // 4
    p = np.clip(np.minimum(np.arange(got.numel()), n - 1) - 1, 0, None)
    np.testing.assert_array_equal(got.numpy(),
                                  p // gw * (2 * gw - 1) + p % gw)
    assert torch.equal(got.long(), fa.rel_off(
        torch.arange(got.numel()).clamp(max=n - 1), grid))
    if n <= JAX_INDEX_MAX_N:
        t = torch.arange(1, n)
        idx = fa.rel_base(t, grid)[:, None] - got[1:n].long()[None, :]
        np.testing.assert_array_equal(
            idx.numpy(), jbeit.gen_relative_position_index(gh, gw)[1:, 1:])


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_window_limit(dtype):
    """The widest grid table mode takes: the bound fits the slot up to
    MAX_GW and not past it, and admits the UI's net 2048 (gw 128) and gw
    = 1024; flash_attention_rel raises ValueError for gw = MAX_GW + 1 on
    the meta device, before any launch, and passes the window check at
    MAX_GW (then refuses the meta tensors for not being on the card)."""
    max_gw = MAX_GW[dtype]
    assert fa.rel_window_max_gw(dtype) == max_gw
    cap = fa.rel_window_capacity(dtype)
    assert fa.rel_window_bound(max_gw, dtype) <= cap
    assert fa.rel_window_bound(max_gw + 1, dtype) > cap
    for gw in (1, 128, 1024, max_gw):
        fa.check_rel_window((4, gw), dtype)

    def call(gw):
        n = gw + 1
        q = torch.empty(1, 1, n, 64, dtype=dtype, device="meta")
        table = fa.pad_table_rows(
            torch.empty(2 * gw + 2, 1, device="meta"), dtype)
        fa.flash_attention_rel(q, q, q, table, (1, gw))
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="window"):
        call(max_gw + 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(max_gw)
    assert fa.flash_attention_cuda.launches == before


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_table_rows_layout(dtype):
    """pad_table_rows gives the (H, T) f32 table, its values rounded to the
    dtype, in rows padded to 16 bytes, the padding zero, which
    table_row_stride takes; a contiguous table whose rows are not a
    multiple of 16 bytes raises."""
    g = torch.Generator().manual_seed(0)
    spec = torch.randn(38, 3, generator=g)         # T = 38 for (3, 4)
    got = fa.pad_table_rows(spec, dtype)
    assert got.shape == (3, 38) and got.dtype == torch.float32
    assert got.stride() == (40, 1)
    assert torch.equal(got, spec.t().to(dtype).float())
    assert fa.table_row_stride(got) == got.stride(0)
    assert not got.as_strided((3, got.stride(0)), got.stride())[:, 38:].any()
    with pytest.raises(ValueError, match="16 bytes"):
        fa.table_row_stride(spec.t().contiguous())
