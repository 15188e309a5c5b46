"""Multi-head attention dispatch for the ViT backbones.

Port of ``depthmap_tpu/models/attention.py:135 attention``: a CUDA tensor
launches kernel K1 (ops/flash_attention.py), a CPU tensor runs its plain
version.  There is no fallback from the kernel to plain torch on the card
and no kill switch.  ``attention_rel_streamed`` / ``RelBiasSpec`` (the
chunked rel-pos bias for very long sequences) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from depthmap_tpu_torch.ops.flash_attention import (flash_attention,
                                                    pad_bias_rows)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, N, D); bias (1|B, H, N, Nk) or (H, N, Nk), passed
    as it is (the BEiT bias arrives in q's dtype and K1's padded-row
    layout, as the JAX package hoists it in the compute dtype); a bias in
    another dtype is cast into a padded-row copy."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if bias is not None and bias.dtype != q.dtype:
        bias = pad_bias_rows(bias, q.dtype)
    return flash_attention(q, k, v, bias=bias, scale=scale)
