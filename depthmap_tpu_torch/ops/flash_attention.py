"""Kernel K1: flash attention forward with an additive bias.

``flash_attention`` launches the hand-written CUDA kernel of
``csrc/flash_attention.cu`` (the port of the Pallas TPU kernel
depthmap_tpu/ops/flash_attention.py:168) for CUDA tensors, and runs
``flash_attention_plain`` for CPU tensors.  A CUDA tensor the kernel does
not take raises; nothing falls back to the plain version on the card.
Both of the kernel's bodies run on the tensor cores: bf16 as bf16, f32 in
split TF32 (each product as three TF32 passes, hi.hi + hi.lo + lo.hi, at
f32 accuracy), whose split K and V^T go to a scratch the wrapper
allocates.  ``round_to_tf32`` restates the kernel's rounding in plain
torch, for the checks that tell f32 from one TF32 pass.

A gradient goes through ``FlashAttentionFunction``: K1's forward, and a
backward in ordinary torch (``attention_grads``).  Without grad, or with
no input that requires it, the forward runs alone and saves nothing.

Table mode (``flash_attention_rel``): BEiT's relative-position bias read
by the kernel from the block's (H, T) table, T = (2gh-1)(2gw-1) + 3, at
the index ``rel_pos_index`` restates; no bias is materialized.  Each kv
tile's stage holds the window of the head's row that its query and key
tiles need (``rel_window``), the tile's off() values (from
``rel_off_table``) and the three cls entries; a grid whose window could
outgrow the stage's slot (``rel_window_bound``; gw above
``rel_window_max_gw``) raises ``ValueError``.  The table comes in f32
(the values of q's dtype, widened), in rows padded to 16 bytes
(``pad_table_rows``).  It takes CUDA tensors only, as
``flash_attention_cuda`` does; its plain version is ``models/attention.py
attention_rel_streamed``, where ``attention`` sends a ``RelBiasSpec`` on
CPU tensors.

The bias layout the kernel reads: rows padded to a multiple of
``BIAS_ROW_ALIGN`` elements (a 16-byte-aligned row for TMA, and one that
SDPA's efficient backend also takes without a copy), heads and batch packed
behind the rows, seen as the ``[..., :Nk]`` view.  ``models/beit.py``
gathers its bias straight into that layout; ``pad_bias_rows`` copies a
dense bias into it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from depthmap_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
BIAS_ROW_ALIGN = 16
# K1's tiles: the query rows of a CTA (bf16: one warpgroup of 64; f32:
# two) and the keys of a kv tile
QUERY_TILE = {torch.bfloat16: 64, torch.float32: 128}
KEY_TILE = 64
# table mode's use of a stage's bias slot (bf16: two 64 x 64 tiles in its
# REL instance; f32: two boxes of 128 rows of 32): 32 bytes for the cls
# entries, the kv tile's KEY_TILE int32 off() values, then the window of
# the f32 table
REL_SLOT_BYTES = {torch.bfloat16: 16384, torch.float32: 32768}
REL_WINDOW_AT = 32 + 4 * KEY_TILE
# f32 table entries per 16 bytes
REL_ENTRIES_PER_16 = 4


def bias_row_len(nk: int) -> int:
    """The padded row length (elements) of a bias with ``nk`` columns."""
    return -(-nk // BIAS_ROW_ALIGN) * BIAS_ROW_ALIGN


def pad_bias_rows(bias: torch.Tensor,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of ``bias`` (..., N, Nk) in rows padded to
    ``bias_row_len(Nk)`` elements (pad columns 0), as the ``[..., :Nk]``
    view, in ``dtype`` (default: the bias's own)."""
    nk = bias.shape[-1]
    buf = torch.zeros(*bias.shape[:-1], bias_row_len(nk),
                      dtype=dtype or bias.dtype, device=bias.device)
    view = buf[..., :nk]
    view.copy_(bias)
    return view


def bias_row_stride(bias: torch.Tensor) -> int:
    """The row stride (elements) of a (1|B, H, N, Nk) bias in the layout
    the kernel reads; ``ValueError`` on any other layout."""
    bb, h, n, nk = bias.shape
    ld = bias.stride(2) if n > 1 else bias_row_len(nk)
    want = (h * n * ld, n * ld, ld, 1)
    if ld % BIAS_ROW_ALIGN or ld < nk or any(
            size > 1 and st != w
            for size, st, w in zip(bias.shape, bias.stride(), want)):
        raise ValueError(
            f"bias of shape {tuple(bias.shape)} and strides "
            f"{tuple(bias.stride())}: the kernel reads rows padded to a "
            f"multiple of {BIAS_ROW_ALIGN} elements with heads and batch "
            "packed behind them (pad_bias_rows makes that layout)")
    return ld


def _normalize_bias(bias: Optional[torch.Tensor], b: int, h: int, n: int,
                    nk: int) -> Optional[torch.Tensor]:
    """(H, N, Nk) -> (1, H, N, Nk); checks the (1|B, H, N, Nk) shape."""
    if bias is None:
        return None
    if bias.dim() == 3:
        bias = bias[None]
    if bias.dim() != 4 or bias.shape[0] not in (1, b) or \
            tuple(bias.shape[1:]) != (h, n, nk):
        raise ValueError(f"bias shape {tuple(bias.shape)} is not "
                         f"(1|{b}, {h}, {n}, {nk})")
    return bias


def flash_attention_plain(q, k, v, bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain torch: scores and both products in
    f32 (a bf16 matmul would round the scores), p rounded to v's dtype
    before p.v, the sum of the unrounded p dividing afterwards, and a row
    whose sum is 0 giving 0.  Takes a dense or a padded-row bias."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, n, _ = q.shape
    bias = _normalize_bias(bias, b, h, n, k.shape[2])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return (acc * inv).to(q.dtype)


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) on its bits: to nearest,
    ties away from zero, as the kernel's ``cvt.rna.tf32.f32``; inf and nan
    pass through."""
    x = x.float()
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def rel_base(t: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """base() of query tokens ``t`` on a (gh, gw) grid (token t >= 1 at
    row r = (t-1) // gw, column c = (t-1) % gw): (r + gh - 1)(2gw - 1) + c
    + gw - 1; the cls token takes token 1's, as K1's table mode does
    before it selects the cls entries."""
    gh, gw = grid
    p = (t - 1).clamp(min=0)
    return (p // gw + gh - 1) * (2 * gw - 1) + p % gw + gw - 1


def rel_off(t: torch.Tensor, grid: Tuple[int, int]) -> torch.Tensor:
    """off() of key tokens ``t``: r (2gw - 1) + c, the cls token taking
    token 1's (0)."""
    gw = grid[1]
    p = (t - 1).clamp(min=0)
    return p // gw * (2 * gw - 1) + p % gw


def rel_pos_index(tq: torch.Tensor, tk: torch.Tensor,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """(len(tq), len(tk)) int64 index into a (num_rel + 3)-entry
    relative-position table of query tokens ``tq`` against key tokens
    ``tk`` on a (gh, gw) grid, as K1's table mode computes it:
    rel_base(tq) - rel_off(tk); cls -> token num_rel, token -> cls
    num_rel + 1, cls -> cls num_rel + 2 (the timm layout of
    ``models/beit.py gen_relative_position_index``)."""
    gh, gw = grid
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    idx = rel_base(tq, grid)[:, None] - rel_off(tk, grid)[None, :]
    q_cls, k_cls = (tq == 0)[:, None], (tk == 0)[None, :]
    idx = torch.where(k_cls, num_rel + 1, idx)
    return torch.where(q_cls, torch.where(k_cls, num_rel + 2, num_rel), idx)


def rel_window(q_tile, k_tile, grid: Tuple[int, int],
               dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The window of a head's table row that K1's table mode stages for
    query tile ``q_tile`` (QUERY_TILE[dtype] rows) against kv tile
    ``k_tile`` (KEY_TILE keys) on ``grid`` (ints or int tensors, which
    broadcast): (lo, count), its first entry and its length, both
    multiples of 16 bytes of the f32 table.  base() and off() rise with
    the token, so every index of the tile pair but the cls ones lies in
    [rel_base(qf) - rel_off(kl), rel_base(ql) - rel_off(kf)], qf / ql and
    kf / kl the first and last tokens of each tile (past N clamped to N -
    1, cls taking token 1's); the window widens that to 16-byte bounds.
    Tile (i, j) reads the entry of query token t1 and key token t2 at
    window position rel_base(t1) - rel_off(t2) - lo."""
    gh, gw = grid
    n = gh * gw + 1
    bq, e = QUERY_TILE[dtype], REL_ENTRIES_PER_16
    q0 = torch.as_tensor(q_tile) * bq
    k0 = torch.as_tensor(k_tile) * KEY_TILE
    lo = rel_base(q0.clamp(min=1), grid) - rel_off(
        (k0 + KEY_TILE - 1).clamp(max=n - 1), grid)
    hi = rel_base((q0 + bq - 1).clamp(max=n - 1), grid) - rel_off(
        k0.clamp(min=1), grid)
    lo = lo // e * e
    return lo, -(-(hi + 1) // e) * e - lo


def _tile_span(rows: int, gw: int) -> int:
    """The largest base() (or off()) spread over ``rows`` consecutive
    tokens of a grid gw wide: rows - 1 steps, and at most (gw + rows - 2)
    // gw row changes of gw - 1 more each."""
    return rows - 1 + (gw + rows - 2) // gw * (gw - 1)


def rel_window_bound(gw: int, dtype: torch.dtype) -> int:
    """The most entries ``rel_window`` can give on a grid gw wide (any gh):
    the query tile's spread, the kv tile's, one, and the widening to
    16-byte bounds at both ends."""
    return _tile_span(QUERY_TILE[dtype], gw) + _tile_span(KEY_TILE, gw) + \
        1 + 2 * (REL_ENTRIES_PER_16 - 1)


def rel_window_capacity(dtype: torch.dtype) -> int:
    """The entries a stage's bias slot holds after the cls entries and the
    off() values."""
    return (REL_SLOT_BYTES[dtype] - REL_WINDOW_AT) * REL_ENTRIES_PER_16 // 16


@functools.lru_cache(maxsize=None)
def rel_window_max_gw(dtype: torch.dtype) -> int:
    """The widest grid table mode takes in ``dtype``: the largest gw whose
    ``rel_window_bound`` fits ``rel_window_capacity`` (the bound rises with
    gw from gw = QUERY_TILE on)."""
    cap = rel_window_capacity(dtype)
    lo, hi = QUERY_TILE[dtype], 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if rel_window_bound(mid, dtype) <= cap \
            else (lo, mid - 1)
    return lo


def check_rel_window(grid: Tuple[int, int], dtype: torch.dtype) -> None:
    """``ValueError`` for a grid whose window could outgrow the stage's
    bias slot in ``dtype``."""
    if dtype in _DTYPES and \
            rel_window_bound(grid[1], dtype) > rel_window_capacity(dtype):
        raise ValueError(
            f"grid {tuple(grid)}: table mode's window of the rel-pos table "
            f"can reach {rel_window_bound(grid[1], dtype)} entries, over the "
            f"{rel_window_capacity(dtype)} a stage holds in {dtype}; it "
            f"takes gw <= {rel_window_max_gw(dtype)}")


def rel_off_table(grid: Tuple[int, int],
                  device: torch.device = torch.device("cpu")
                  ) -> torch.Tensor:
    """off() of every key token as K1's table mode stages it per kv tile,
    as the byte offset in the f32 window (4 off(): a score's address is
    its row's minus it, one subtraction): int32, N rounded up to KEY_TILE
    entries, the cls token taking token 1's, tokens past N token N -
    1's."""
    gh, gw = grid
    n = gh * gw + 1
    t = torch.arange(-(-n // KEY_TILE) * KEY_TILE).clamp(max=n - 1)
    return (4 * rel_off(t, grid)).to(device=device, dtype=torch.int32)


@functools.lru_cache(maxsize=16)
def _rel_off_table_on(gh: int, gw: int, device: str) -> torch.Tensor:
    return rel_off_table((gh, gw), torch.device(device))


def pad_table_rows(table: torch.Tensor,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A (T, H) rel-pos table (``RelBiasSpec``'s layout) as the (H, T)
    table table mode reads: its values rounded to ``dtype`` (q's; default:
    the table's own) and held in f32, which widens a bf16 value exactly,
    as the ``[:, :T]`` view of rows padded with zeros to a multiple of 16
    bytes."""
    t, h = table.shape
    e = REL_ENTRIES_PER_16
    buf = torch.zeros(h, -(-t // e) * e, dtype=torch.float32,
                      device=table.device)
    view = buf[:, :t]
    view.copy_(table.t().to(dtype or table.dtype))
    return view


def table_row_stride(table: torch.Tensor) -> int:
    """The row stride (elements) of an (H, T) f32 table in the layout
    table mode reads (rows padded to a multiple of 16 bytes, 16-byte
    aligned, the padding inside the storage); ``ValueError`` on any other
    layout."""
    h, t = table.shape
    e = REL_ENTRIES_PER_16
    padded = -(-t // e) * e
    ld = table.stride(0) if h > 1 else padded
    size = table.untyped_storage().nbytes() // table.element_size()
    if ld % e or ld < t or table.data_ptr() % 16 or \
            table.storage_offset() + (h - 1) * ld + padded > size:
        raise ValueError(
            f"table of shape {tuple(table.shape)} and strides "
            f"{tuple(table.stride())}: table mode reads rows padded to a "
            "multiple of 16 bytes (pad_table_rows makes that layout)")
    return ld


def _lib():
    lib = cuda_build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.flash_attention_forward.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
            ci, ci, ci, ctypes.c_float, ci, vp]
        lib.flash_attention_forward.restype = ci
        lib.flash_attention_workspace_bytes.argtypes = [ci, ci, ci, ci]
        lib.flash_attention_workspace_bytes.restype = sz
        lib.flash_attention_smem_bytes.argtypes = [ci, ci]
        lib.flash_attention_smem_bytes.restype = sz
        lib.flash_attention_error_string.argtypes = [ci]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B, H, N, 64), k/v: (B, H, Nk, 64),
    contiguous; bias (1|B, H, N, Nk) or (H, N, Nk) in the padded-row layout
    (``bias_row_stride``); all on one CUDA device, in one dtype (float32
    or bfloat16)."""
    return _launch(q, k, v, bias, None, None, scale)


def flash_attention_rel(q, k, v, table: torch.Tensor,
                        grid: Tuple[int, int],
                        scale: Optional[float] = None) -> torch.Tensor:
    """K1's table mode: softmax(q.k^T * scale + bias) . v with
    bias[h, t1, t2] = table[h, rel_pos_index(t1, t2, grid)].  q, k, v:
    (B, H, N, 64) with N = gh.gw + 1, gw at most
    ``rel_window_max_gw(q.dtype)`` (1946 in bf16, 3962 in f32); table
    (H, (2gh-1)(2gw-1)+3) in f32 holding values of q's dtype (bf16 ones
    widen exactly, and enter the kernel's fmaf as a materialized bias's
    do), in contiguous rows padded to a multiple of 16 bytes
    (``pad_table_rows``), shared across the batch; all on one CUDA
    device; anything else raises.

    Per kv tile the kernel stages, beside K and V, the window of the
    head's row that its query and kv tiles need (``rel_window``, at most
    ``rel_window_bound`` entries), the tile's 64 off() values (the per-grid
    ``rel_off_table``, built once a grid and device) and, with each
    stage's first fill, the three cls entries; a score's entry is
    window[(base - lo) - off], and only query tile 0 and kv tile 0 select
    cls entries.  A grid past the limit raises ``ValueError`` before any
    launch: nothing falls back to a gather or the plain version."""
    gh, gw = (int(g) for g in grid)
    b, h, n = q.shape[:3]
    t = (2 * gh - 1) * (2 * gw - 1) + 3
    if n != gh * gw + 1 or k.shape[2] != n:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: table "
                         f"mode takes N = Nk = gh.gw + 1 = {gh * gw + 1} "
                         f"for the grid {(gh, gw)}")
    if table.dim() != 2 or tuple(table.shape) != (h, t) or \
            table.stride(1) != 1 or (h > 1 and table.stride(0) < t):
        raise ValueError(f"table of shape {tuple(table.shape)} and strides "
                         f"{tuple(table.stride())}: table mode takes a "
                         f"({h}, {t}) table in contiguous rows")
    check_rel_window((gh, gw), q.dtype)
    return _launch(q, k, v, None, table, (gh, gw), scale)


def _launch(q, k, v, bias, table, grid, scale) -> torch.Tensor:
    tensors = [q, k, v] + [t for t in (bias, table) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v and bias must be on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors
                                     if t is not table) or \
            (table is not None and table.dtype != torch.float32):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: the kernel "
                        "takes one of float32 / bfloat16 for q, k, v and "
                        "the bias, and a float32 table")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, N, D)")
    b, h, n, d = q.shape
    nk = k.shape[2]
    if d != HEAD_DIM or tuple(k.shape) != (b, h, nk, d) or \
            v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: the kernel takes D = 64")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs contiguous q, k, v")
    bias = _normalize_bias(bias, b, h, n, nk)
    ldb = bias_row_stride(bias) if bias is not None else 0
    ldt = table_row_stride(table) if table is not None else 0
    offs = _rel_off_table_on(*grid, str(q.device)) if table is not None \
        else None
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_cuda needs 16-byte-aligned inputs")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lib = _lib()
    code = _DTYPES[q.dtype]
    ws_bytes = lib.flash_attention_workspace_bytes(b, h, nk, code)
    ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                     device=q.device) if ws_bytes else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            table.data_ptr() if table is not None else None,
            offs.data_ptr() if offs is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            b, h, n, nk, d, bias.shape[0] if bias is not None else 0,
            ldb, table.shape[1] if table is not None else 0, ldt,
            *(grid or (0, 0)), float(scale), code, stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_dtype[str(q.dtype)[6:]] += 1
    mode = "rel" if table is not None else "bias" if bias is not None \
        else "none"
    flash_attention_cuda.launches_by_mode[mode] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_dtype = {"float32": 0, "bfloat16": 0}
# each launch's mode: bias-free, a materialized bias, the rel-pos table
flash_attention_cuda.launches_by_mode = {"none": 0, "bias": 0, "rel": 0}


def reset_launches() -> None:
    """Set K1's launch counts, the total, each dtype's and each mode's, to
    0."""
    flash_attention_cuda.launches = 0
    for counts in (flash_attention_cuda.launches_by_dtype,
                   flash_attention_cuda.launches_by_mode):
        for key in counts:
            counts[key] = 0


def _forward(q, k, v, bias, scale) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, bias, scale)
    return flash_attention_plain(q, k, v, bias, scale)


def attention_grads(q, k, v, bias, out, dout, scale: float):
    """(dq, dk, dv, dbias) of softmax(q.k^T * scale + bias) . v in f32
    torch, from the forward's output: the scores and P recomputed with
    ``flash_attention_plain``'s zero-row rule, D = rowsum(dO * O),
    dS = P * (dO.v^T - D).  dbias is dS, summed over the batch for a bias
    shared as (1, H, N, Nk); None where ``bias`` is None."""
    b, h, n, _ = q.shape
    nb = _normalize_bias(bias, b, h, n, k.shape[2])
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if nb is not None:
        s = s + nb.float()
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m) & (m < 0), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    del s
    l = p.sum(-1, keepdim=True)
    p = p * torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    do = dout.float()
    d = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - d)
    dv = torch.matmul(p.transpose(-1, -2), do)
    del p
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dbias = None
    if bias is not None:
        if nb.shape[0] == 1 and b > 1:
            ds = ds.sum(0, keepdim=True)
        dbias = ds.reshape(bias.shape).to(bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


class FlashAttentionFunction(torch.autograd.Function):
    """K1 with a gradient.  The forward is ``flash_attention``'s (the
    kernel for CUDA tensors, the plain version for CPU ones); the backward
    is ``attention_grads`` in ordinary torch (cuBLAS products on the
    card), as the JAX package leaves its gradient to XLA's autodiff of the
    einsum attention: there is no backward Pallas kernel to port."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        out = _forward(q, k, v, bias, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out = ctx.saved_tensors
        grads = attention_grads(q, k, v, bias, out, dout, ctx.scale)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v on (B, H, N, D) tensors: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  With grad
    enabled and an input that requires grad, through
    ``FlashAttentionFunction`` (the same forward, inputs and output saved
    for the backward); otherwise the forward alone, which saves nothing."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return FlashAttentionFunction.apply(q, k, v, bias, float(scale))
    return _forward(q, k, v, bias, scale)
