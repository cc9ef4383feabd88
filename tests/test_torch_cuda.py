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


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("T", [1, 7, 120, 199, 200, k_attn.MAX_TOKENS_BWD])
def test_attention_core_bwd(gen, T, masked):
    """d(QKV) against the plain backward. dS is rounded to bf16 before the
    dQ and dK sums, so a flipped rounding of one dS term moves an output by
    one bf16 step of that term, not of the sum: 2**-5 covers a few."""
    B, H = 2, 2
    qkv = _randn(gen, B, T, 3 * H * 64)
    g = _randn(gen, B, T, H * 64)
    mask = None
    if masked:
        mask = torch.where(torch.rand(T, T, generator=gen, device="cuda") < 0.2,
                           float("-inf"), 0.0)
        mask.fill_diagonal_(0.0)
    got = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_bwd_reference(qkv, g, H, mask), 2 ** -5)


def test_packed_attention_masked_backward_counts_launches(gen):
    qkv = _randn(gen, 4, 120, 3 * 512).requires_grad_(True)
    mask = build_block_causal_mask(5, 24, device="cuda")
    g = _randn(gen, 4, 120, 512)
    before = k_attn.packed_attention_masked_bwd.launches
    (got,) = torch.autograd.grad(k_attn.packed_attention_masked(qkv, mask, 8), qkv, g)
    assert k_attn.packed_attention_masked_bwd.launches == before + 1
    (ref,) = torch.autograd.grad(
        k_attn.packed_attention_masked_reference(qkv, mask, 8), qkv, g)
    _assert_close(got, ref, 2 ** -5)


@pytest.mark.parametrize("h_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(300, 136, 72), (1, 8, 8), (1000, 3072, 768)])
def test_gemm_nt_dgelu(gen, M, N, K, h_dtype):
    """``dout . W^T * QuickGELU'(h)`` (K3's and K4's dh) and the plain NT
    product (dxn2, da, dyln1), W stored (N, K)."""
    a = _randn(gen, M, K)
    w = _randn(gen, N, K, scale=K ** -0.5)
    h = _randn(gen, M, N, dtype=h_dtype, scale=2.0)
    got = k_block.gemm_epilogue_cuda(a, w, trans_w=True, dgelu_of=h)
    plain = k_block.gemm_epilogue_cuda(a, w, trans_w=True, out_dtype=torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, k_block.gemm_epilogue_reference(a, w, trans_w=True, dgelu_of=h),
                  2 ** -7)
    _assert_close(plain, k_block.gemm_epilogue_reference(
        a, w, trans_w=True, out_dtype=torch.float32), 1e-4)


@pytest.mark.parametrize("pre_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N,K", [(300, 136, 72), (1000, 3072, 768)])
def test_gemm_dual_write(gen, M, N, K, pre_dtype):
    """fc + b with QuickGELU that also writes the pre-activation h."""
    a = _randn(gen, M, K)
    w = _randn(gen, K, N, scale=K ** -0.5)
    b = _randn(gen, N, dtype=torch.float32)
    got, pre = k_block.gemm_epilogue_cuda(a, w, b, gelu=True, pre_dtype=pre_dtype)
    torch.cuda.synchronize()
    ref, ref_pre = k_block.gemm_epilogue_reference(a, w, b, gelu=True, pre_dtype=pre_dtype)
    assert pre.dtype == ref_pre.dtype == pre_dtype
    _assert_close(got, ref, 2 ** -7)
    _assert_close(pre, ref_pre, 2 ** -7 if pre_dtype == torch.bfloat16 else 1e-4)


@pytest.mark.parametrize("K,M,N", [(37, 8, 8), (1000, 136, 264), (102400, 768, 768),
                                   (5000, 768, 3072)])
def test_gemm_tn(gen, K, M, N):
    """``a^T . b`` over K rows (a weight gradient), split over blocks for a
    long K. fp32 results of K products: 1e-4 relative plus 1e-4 of the
    summed magnitudes' scale."""
    a = _randn(gen, K, M)
    b = _randn(gen, K, N)
    got = k_block.gemm_tn_cuda(a, b)
    torch.cuda.synchronize()
    ref = k_block.gemm_tn_reference(a, b)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    _assert_close(got, ref, 1e-4 * K ** 0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,N", [(1, 8), (300, 136), (102400, 768), (7, 2304 * 768)])
def test_column_sum(gen, rows, N, dtype):
    x = _randn(gen, rows, N, dtype=dtype)
    got = k_block.column_sum_cuda(x)
    torch.cuda.synchronize()
    _assert_close(got, k_block.column_sum_reference(x), 1e-5 * rows ** 0.5)


@pytest.mark.parametrize("x_dtype,res_dtype,out_dtype", [
    (torch.float32, torch.bfloat16, torch.float32),  # LN2's backward
    (torch.bfloat16, torch.float32, torch.bfloat16),  # LN1's backward
    (torch.bfloat16, torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("rows,D", [(1, 8), (37, 200), (513, 768), (300, 1024)])
def test_layernorm_bwd_rows(gen, rows, D, x_dtype, res_dtype, out_dtype):
    x = _randn(gen, rows, D, dtype=x_dtype, scale=3.0) + 1.0
    dxn = _randn(gen, rows, D, dtype=torch.float32)
    dres = _randn(gen, rows, D, dtype=res_dtype)
    gamma = _randn(gen, D, dtype=torch.float32) * 0.1 + 1
    got = k_block.layernorm_bwd_rows_cuda(x, dxn, dres, gamma, out_dtype, copy_bf16=True)
    torch.cuda.synchronize()
    ref = k_block.layernorm_bwd_rows_reference(x, dxn, dres, gamma, out_dtype, copy_bf16=True)
    for g, r, tol in zip(got, ref, (2 ** -7 if out_dtype == torch.bfloat16 else 1e-4,
                                    2 ** -7, 1e-4 * rows ** 0.5, 1e-4 * rows ** 0.5)):
        assert g.dtype == r.dtype
        _assert_close(g, r, tol)


def _block_params(gen, D, dtype, requires_grad):
    def lin(d_in, d_out):
        w = _randn(gen, d_in, d_out, dtype=dtype, scale=d_in ** -0.5)
        return w.requires_grad_(requires_grad), _randn(
            gen, d_out, dtype=dtype, scale=0.1).requires_grad_(requires_grad)

    def ln():
        return {"scale": (_randn(gen, D, dtype=torch.float32) * 0.1 + 1).requires_grad_(True),
                "bias": _randn(gen, D, dtype=torch.float32, scale=0.1).requires_grad_(True)}

    w_qkv, b_qkv = lin(D, 3 * D)
    w_out, b_out = lin(D, D)
    w_fc, b_fc = lin(D, 4 * D)
    w_proj, b_proj = lin(4 * D, D)
    return {"ln_1": ln(), "ln_2": ln(),
            "attn": {"w_qkv": w_qkv, "b_qkv": b_qkv, "w_out": w_out, "b_out": b_out},
            "mlp": {"w_fc": w_fc, "b_fc": b_fc, "w_proj": w_proj, "b_proj": b_proj}}


@pytest.mark.parametrize("wgrad", [False, True], ids=["K3", "K4"])
@pytest.mark.parametrize("T", [13, 200])
def test_fused_block_train(gen, T, wgrad):
    """Forward and every gradient of the train blocks against their plain
    versions: dx and the bf16 output at the block's 2**-5 (four bf16
    intermediates), the fp32 parameter gradients (sums over B*T rows of
    bf16 products) at 2**-5 relative plus 2**-5 of their largest value."""
    B, D, H = 3, 128, 2
    p = _block_params(gen, D, torch.float32 if wgrad else torch.bfloat16, wgrad)
    x = _randn(gen, B, T, D).requires_grad_(True)
    dy = _randn(gen, B, T, D)
    kernel = k_block.fused_block_train_dw if wgrad else k_block.fused_block_train
    plain = (k_block.fused_block_train_dw_reference if wgrad
             else k_block.fused_block_train_reference)
    leaves = [x] + [p[a][b] for a, b in k_block.BLOCK_LEAVES if p[a][b].requires_grad]
    before = (kernel.launches, kernel.backward_launches)
    out = kernel(x, p, H)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.backward_launches) == (before[0] + 1, before[1] + 1)
    ref_out = plain(x, p, H)
    ref = torch.autograd.grad(ref_out, leaves, dy)
    _assert_close(out, ref_out, 2 ** -5)
    _assert_close(got[0], ref[0], 2 ** -5)
    assert len(got) == (13 if wgrad else 5)
    for g, r, leaf in zip(got[1:], ref[1:], leaves[1:]):
        assert g.dtype == leaf.dtype
        scale = float(r.abs().max())
        d = (g.float() - r.float()).abs()
        assert bool((d <= 2 ** -5 * (scale + r.abs())).all()), float(d.max())


def test_fused_block_train_refuses_trainable_weights(gen):
    p = _block_params(gen, 128, torch.float32, True)
    with pytest.raises(ValueError, match="fused_block_train_dw"):
        k_block.fused_block_train(_randn(gen, 1, 8, 128), p, 2)


def test_kernels_refuse_what_they_do_not_take(gen):
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 8, 384, dtype=torch.float32), 2)
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 513, 384), 2)
    with pytest.raises(ValueError):
        k_block.gemm_epilogue_cuda(_randn(gen, 4, 12), _randn(gen, 12, 8))
    with pytest.raises(ValueError):
        k_attn.attention_core_bwd_cuda(
            _randn(gen, 1, k_attn.MAX_TOKENS_BWD + 1, 384),
            _randn(gen, 1, k_attn.MAX_TOKENS_BWD + 1, 128), 2)
    with pytest.raises(ValueError):
        k_block.gemm_tn_cuda(_randn(gen, 16, 12), _randn(gen, 16, 8))
    with pytest.raises(ValueError):
        k_block.layernorm_bwd_rows_cuda(
            _randn(gen, 2, 1032), _randn(gen, 2, 1032, dtype=torch.float32),
            _randn(gen, 2, 1032), torch.ones(1032, device="cuda"), torch.bfloat16)
