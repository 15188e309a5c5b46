"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  This file imports no JAX; without the
package's conftest (which sets JAX up) it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

K1 bounds (max abs error against the plain version, which computes in f32):
f32 5e-3, the bound the JAX package holds its TPU kernel to; bf16 2e-2,
about two bf16 ulps of the largest outputs (the output and p are rounded
to bf16, and a different f32 summation order can flip either rounding).
K2 is byte-exact.
"""
from __future__ import annotations

import pytest
import torch

from depthmap_tpu_torch.ops import flash_attention as fa
from depthmap_tpu_torch.ops import polylines as P


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_shared_1025", "f32_batched_130",
                                  "f32_none_513", "bf16_none_cross"])
def test_flash_attention_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(0)
    dt, b, n, nk, bias_kind = {
        "bf16_shared_1025": (torch.bfloat16, 2, 1025, 1025, "shared"),
        "f32_batched_130": (torch.float32, 2, 130, 130, "batched"),
        "f32_none_513": (torch.float32, 1, 513, 513, None),
        "bf16_none_cross": (torch.bfloat16, 1, 77, 300, None),
    }[case]
    h, d = 16, 64
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dt)  # noqa: E731
    q, k, v = mk(b, h, n, d), mk(b, h, nk, d), mk(b, h, nk, d)
    bias = None
    if bias_kind:
        bias = mk(1 if bias_kind == "shared" else b, h, n, nk)
    got = fa.flash_attention_cuda(q, k, v, bias)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2e-2 if dt == torch.bfloat16 else 5e-3), err


@pytest.mark.cuda
@pytest.mark.parametrize("sharp", [True, False])
@pytest.mark.parametrize("div", [24.0, -48.0])
def test_polylines_kernel_byte_exact(sharp, div):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(1)
    img = torch.randint(0, 256, (64, 480, 3), generator=g,
                        dtype=torch.uint8).cuda()
    nd = torch.rand((64, 480), generator=g, dtype=torch.float64).cuda()
    got = P.polylines_cuda(img, nd, div, 0.0, 1.0, sharp)
    torch.cuda.synchronize()
    want = P.polylines_plain(img, nd, div, 0.0, 1.0, sharp)
    assert torch.equal(got, want)
