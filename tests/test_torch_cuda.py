"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not reach (tile edges, unaligned token
counts, every epilogue variant).

Marked ``cuda``; each test skips on a machine without CUDA. This file
imports nothing of JAX, so on the card's machine (which has no JAX) run it
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
from federated_multi_modal_tpu_torch.ops.primitives import build_block_causal_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA and nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def _assert_close(got, ref, tol):
    """|got - ref| <= tol + tol * |ref|: bf16 results that may differ by a
    flipped rounding (one step is 2**-8 relative)."""
    d = (got.float() - ref.float()).abs()
    assert bool((d <= tol + tol * ref.float().abs()).all()), float(d.max())


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("T", [1, 30, 200, 512])
def test_attention_core(gen, T, masked):
    B, H = 3, 2
    qkv = _randn(gen, B, T, 3 * H * 64)
    mask = None
    if masked:
        mask = torch.where(torch.rand(T, T, generator=gen, device="cuda") < 0.2,
                           float("-inf"), 0.0)
        mask.fill_diagonal_(0.0)
    got = k_attn.attention_core_cuda(qkv, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_reference(qkv, H, mask), 2 ** -6)


def test_packed_attention_masked_counts_launches(gen):
    qkv = _randn(gen, 4, 120, 3 * 512)
    mask = build_block_causal_mask(5, 24, device="cuda")
    before = k_attn.packed_attention_masked.launches
    got = k_attn.packed_attention_masked(qkv, mask, 8)
    assert k_attn.packed_attention_masked.launches == before + 1
    _assert_close(got, k_attn.packed_attention_masked_reference(qkv, mask, 8), 2 ** -6)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_gelu",
                                      "bias_res_bf16", "bias_res_f32"])
@pytest.mark.parametrize("M,N,K", [(300, 136, 72), (128, 128, 32), (1, 8, 8),
                                   (1000, 2304, 768)])
def test_gemm_epilogue(gen, M, N, K, epilogue, out_dtype):
    a = _randn(gen, M, K)
    w = _randn(gen, K, N, scale=K ** -0.5)
    kw = {"out_dtype": out_dtype}
    if epilogue != "none":
        kw["bias"] = _randn(gen, N, dtype=torch.float32)
    kw["gelu"] = epilogue == "bias_gelu"
    if epilogue.startswith("bias_res"):
        kw["residual"] = _randn(gen, M, N, dtype=torch.bfloat16
                                if epilogue.endswith("bf16") else torch.float32)
    got = k_block.gemm_epilogue_cuda(a, w, **kw)
    torch.cuda.synchronize()
    ref = k_block.gemm_epilogue_reference(a, w, **kw)
    assert got.dtype == ref.dtype == out_dtype
    # fp32 outputs differ only by summation order: 1e-4 relative of K terms
    _assert_close(got, ref, 2 ** -7 if out_dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,D", [(37, 200), (8, 768), (101, 3072)])
def test_layernorm_rows(gen, rows, D, dtype):
    x = _randn(gen, rows, D, dtype=dtype, scale=3.0) + 1.0
    g = _randn(gen, D, dtype=torch.float32) * 0.1 + 1
    b = _randn(gen, D, dtype=torch.float32) * 0.1
    got = k_block.layernorm_rows_cuda(x, g, b, torch.bfloat16)
    torch.cuda.synchronize()
    _assert_close(got, k_block.layernorm_rows_reference(x, g, b, torch.bfloat16), 2 ** -7)


@pytest.mark.parametrize("T", [13, 199])
def test_fused_block_residual(gen, T):
    B, D, H = 2, 128, 2

    def lin(d_in, d_out):
        return _randn(gen, d_in, d_out, scale=d_in ** -0.5), _randn(gen, d_out, scale=0.1)

    w_qkv, b_qkv = lin(D, 3 * D)
    w_out, b_out = lin(D, D)
    w_fc, b_fc = lin(D, 4 * D)
    w_proj, b_proj = lin(4 * D, D)
    ones = torch.ones(D, device="cuda")
    zeros = torch.zeros(D, device="cuda")
    p = {"ln_1": {"scale": ones, "bias": zeros}, "ln_2": {"scale": ones, "bias": zeros},
         "attn": {"w_qkv": w_qkv, "b_qkv": b_qkv, "w_out": w_out, "b_out": b_out},
         "mlp": {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}}
    x = _randn(gen, B, T, D)
    before = k_block.fused_block_residual.launches
    got = k_block.fused_block_residual(x, p, H)
    assert k_block.fused_block_residual.launches == before + 1
    _assert_close(got, k_block.fused_block_residual_reference(x, p, H), 2 ** -5)


def test_kernels_refuse_what_they_do_not_take(gen):
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 8, 384, dtype=torch.float32), 2)
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 513, 384), 2)
    with pytest.raises(ValueError):
        k_block.gemm_epilogue_cuda(_randn(gen, 4, 12), _randn(gen, 12, 8))
