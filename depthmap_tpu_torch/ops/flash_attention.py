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
by the kernel straight from the block's (H, T) table, T = (2gh-1)(2gw-1)
+ 3, at the index ``rel_pos_index`` restates; no bias is materialized.
It takes CUDA tensors only, as ``flash_attention_cuda`` does; its plain
version is ``models/attention.py attention_rel_streamed``, where
``attention`` sends a ``RelBiasSpec`` on CPU tensors.

The bias layout the kernel reads: rows padded to a multiple of
``BIAS_ROW_ALIGN`` elements (a 16-byte-aligned row for TMA, and one that
SDPA's efficient backend also takes without a copy), heads and batch packed
behind the rows, seen as the ``[..., :Nk]`` view.  ``models/beit.py``
gathers its bias straight into that layout; ``pad_bias_rows`` copies a
dense bias into it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from depthmap_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
BIAS_ROW_ALIGN = 16


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


def rel_pos_index(tq: torch.Tensor, tk: torch.Tensor,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """(len(tq), len(tk)) int64 index into a (num_rel + 3)-entry
    relative-position table of query tokens ``tq`` against key tokens
    ``tk`` on a (gh, gw) grid (token 0 the cls token, token t >= 1 at row
    (t-1) // gw, column (t-1) % gw), as K1's table mode computes it:
    base(tq) - off(tk), with base = (r + gh - 1)(2gw - 1) + c + gw - 1 and
    off = r (2gw - 1) + c; cls -> token num_rel, token -> cls num_rel + 1,
    cls -> cls num_rel + 2 (the timm layout of
    ``models/beit.py gen_relative_position_index``)."""
    gh, gw = grid
    num_rel = (2 * gh - 1) * (2 * gw - 1)
    pq, pk = (tq - 1).clamp(min=0), (tk - 1).clamp(min=0)
    base = (pq // gw + gh - 1) * (2 * gw - 1) + pq % gw + gw - 1
    off = pk // gw * (2 * gw - 1) + pk % gw
    idx = base[:, None] - off[None, :]
    q_cls, k_cls = (tq == 0)[:, None], (tk == 0)[None, :]
    idx = torch.where(k_cls, num_rel + 1, idx)
    return torch.where(q_cls, torch.where(k_cls, num_rel + 2, num_rel), idx)


def _lib():
    lib = cuda_build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, ci, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.flash_attention_forward.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci,
            ci, ctypes.c_float, ci, vp]
        lib.flash_attention_forward.restype = ci
        lib.flash_attention_workspace_bytes.argtypes = [ci, ci, ci, ci]
        lib.flash_attention_workspace_bytes.restype = sz
        lib.flash_attention_smem_bytes.argtypes = [ci]
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
    (B, H, N, 64) with N = gh.gw + 1; table (H, (2gh-1)(2gw-1)+3),
    contiguous, in q's dtype, shared across the batch, all on one CUDA
    device; anything else raises."""
    gh, gw = (int(g) for g in grid)
    b, h, n = q.shape[:3]
    t = (2 * gh - 1) * (2 * gw - 1) + 3
    if n != gh * gw + 1 or k.shape[2] != n:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: table "
                         f"mode takes N = Nk = gh.gw + 1 = {gh * gw + 1} "
                         f"for the grid {(gh, gw)}")
    if table.dim() != 2 or tuple(table.shape) != (h, t) or \
            not table.is_contiguous():
        raise ValueError(f"table of shape {tuple(table.shape)}: table "
                         f"mode takes a contiguous ({h}, {t}) table")
    return _launch(q, k, v, None, table, (gh, gw), scale)


def _launch(q, k, v, bias, table, grid, scale) -> torch.Tensor:
    tensors = [q, k, v] + [t for t in (bias, table) if t is not None]
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("q, k, v and bias must be on one device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"dtypes {[t.dtype for t in tensors]}: the kernel "
                        "takes one of float32 / bfloat16 for all inputs")
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
            table.data_ptr() if table is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            b, h, n, nk, d, bias.shape[0] if bias is not None else 0,
            ldb, table.shape[1] if table is not None else 0,
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
