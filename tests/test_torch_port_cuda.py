"""The hand-written CUDA kernels against their plain versions, on a card.

Every test here carries the ``cuda`` marker and skips without a CUDA card
(the kernels have no CPU mode).  This file imports no JAX; without the
package's conftest (which sets JAX up) it runs on a machine that has only
the port's dependencies:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda

K1 bounds (max abs error against the plain version, which computes in f32;
the bf16 cases run the tensor-core body, the f32 ones the CUDA-core body):
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


# case: (dtype, B, N, Nk, bias: None / "shared" / "batched", scale)
K1_CASES = {
    "bf16_shared_1025": (torch.bfloat16, 4, 1025, 1025, "shared", None),
    "bf16_shared_1793": (torch.bfloat16, 1, 1793, 1793, "shared", None),
    "bf16_batched_65": (torch.bfloat16, 2, 65, 65, "batched", None),
    "bf16_shared_n1": (torch.bfloat16, 2, 1, 1, "shared", None),
    "bf16_none_cross": (torch.bfloat16, 1, 77, 300, None, None),
    "bf16_masked_row": (torch.bfloat16, 2, 130, 130, "shared", None),
    "bf16_scale": (torch.bfloat16, 2, 200, 200, "batched", 0.3),
    "f32_batched_130": (torch.float32, 2, 130, 130, "batched", None),
    "f32_shared_1025": (torch.float32, 1, 1025, 1025, "shared", None),
    "f32_none_513": (torch.float32, 1, 513, 513, None, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_flash_attention_kernel_matches_plain(case):
    """Each bias in the padded-row layout the kernel reads (pad_bias_rows);
    bf16 runs the tensor-core body, f32 the CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    g = torch.Generator(device="cpu").manual_seed(0)
    dt, b, n, nk, bias_kind, scale = K1_CASES[case]
    h, d = 16, 64
    mk = lambda *s: torch.randn(*s, generator=g).to("cuda", dt)  # noqa: E731
    q, k, v = mk(b, h, n, d), mk(b, h, nk, d), mk(b, h, nk, d)
    bias = None
    if bias_kind:
        bias = fa.pad_bias_rows(
            mk(1 if bias_kind == "shared" else b, h, n, nk))
    if case == "bf16_masked_row":
        bias[:, :, 5] = float("-inf")
    got = fa.flash_attention_cuda(q, k, v, bias, scale)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v, bias, scale)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2e-2 if dt == torch.bfloat16 else 5e-3), err
    if case == "bf16_masked_row":
        assert torch.count_nonzero(got[:, :, 5]) == 0


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_a_dense_bias():
    """A dense N = 1025 bias (rows of 2050 bytes) is refused, not copied."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q = torch.zeros(1, 16, 1025, 64, dtype=torch.bfloat16, device="cuda")
    bias = torch.zeros(1, 16, 1025, 1025, dtype=torch.bfloat16,
                       device="cuda")
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match="padded"):
        fa.flash_attention_cuda(q, q, q, bias)
    assert fa.flash_attention_cuda.launches == before


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
