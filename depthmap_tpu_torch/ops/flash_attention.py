"""Kernel K1: flash attention forward with an additive bias.

``flash_attention`` launches the hand-written CUDA kernel of
``csrc/flash_attention.cu`` (the port of the Pallas TPU kernel
depthmap_tpu/ops/flash_attention.py:168) for CUDA tensors, and runs
``flash_attention_plain`` for CPU tensors.  A CUDA tensor the kernel does
not take raises; nothing falls back to the plain version on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from depthmap_tpu_torch.ops import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64


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
    whose sum is 0 giving 0."""
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


def _lib():
    lib = cuda_build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.flash_attention_forward.argtypes = [
            vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, vp]
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, bias: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch the CUDA kernel.  q: (B, H, N, 64), k/v: (B, H, Nk, 64), bias
    (1|B, H, N, Nk) or (H, N, Nk); all contiguous, on one CUDA device, in
    one dtype (float32 or bfloat16)."""
    tensors = [q, k, v] + ([bias] if bias is not None else [])
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
    bias = _normalize_bias(bias, b, h, n, nk)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_cuda needs contiguous inputs")
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            b, h, n, nk, d, bias.shape[0] if bias is not None else 0,
            float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q.k^T * scale + bias) . v on (B, H, N, D) tensors: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, bias, scale)
    return flash_attention_plain(q, k, v, bias, scale)
