"""The port's CUDA kernels against their plain versions on the card, at
ragged shapes the main path does not reach (tile edges, unaligned token
counts, every epilogue variant).

Marked ``cuda``; each test skips on a machine without CUDA. This file
imports nothing of JAX, so on the card's machine (which has no JAX) run it
without the repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import math
import types

import pytest
import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
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


def _within_share_of_max(got, ref, share):
    """max |got - ref| <= share * max |ref|."""
    d = (got.float() - ref.float()).abs()
    return float(d.max()) <= share * float(ref.float().abs().max())


def _forward_mask(gen, T, masked):
    """The mask a forward case runs under: causal at T = 77 (zero-shot's
    rows), block-causal at T = 120 (five packed 24-token prompts, MaPLe's
    text rows), else a random fifth of the keys at -inf (the diagonal kept);
    None when not masked."""
    if not masked:
        return None
    if T == 77:
        return torch.triu(torch.full((T, T), float("-inf"), device="cuda"), diagonal=1)
    if T == 120:
        return build_block_causal_mask(5, 24, device="cuda")
    mask = torch.where(torch.rand(T, T, generator=gen, device="cuda") < 0.2,
                       float("-inf"), 0.0)
    mask.fill_diagonal_(0.0)
    return mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("T", [1, 30, 200, 512, 77, 120, 257, 600, 1030])
def test_attention_core(gen, T, masked):
    """The forward against its plain version at 2**-6, at T within one
    64-key tile, over ragged last tiles, one pass (T <= 256) and two, and
    past the 512 tokens the earlier kernel held in shared memory.

    From T = 257 on, the outputs fall toward the absolute part of that
    limit, so the output is also held to 2**-6 of its own largest value,
    and a planted fault must fail that check: the kernel with the last key
    tile's contribution dropped (``valid_T`` at the tile's first key)."""
    B, H = 2 if T > 512 else 3, 2
    qkv = _randn(gen, B, T, 3 * H * 64)
    mask = _forward_mask(gen, T, masked)
    got = k_attn.attention_core_cuda(qkv, H, mask)
    torch.cuda.synchronize()
    ref = k_attn.attention_core_reference(qkv, H, mask)
    _assert_close(got, ref, 2 ** -6)
    if T >= 257:
        assert _within_share_of_max(got, ref, 2 ** -6)
        fault = k_attn.attention_core_cuda(qkv, H, mask, valid_T=(T - 1) // 64 * 64)
        assert not _within_share_of_max(fault, ref, 2 ** -6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,valid_T", [(208, 200), (256, 200), (600, 577), (130, 1)])
def test_attention_core_valid_T(gen, T, valid_T, masked):
    """Keys at or past ``valid_T`` take no part (the microbench's pad208 and
    pad256 lines): every row, padded queries too, equals the plain version
    with those keys masked."""
    B, H = 2, 2
    qkv = _randn(gen, B, T, 3 * H * 64)
    mask = _forward_mask(gen, T, masked)
    if mask is not None:
        mask[:, 0] = 0.0  # every row keeps a key below valid_T
    cut = torch.zeros(T, T, device="cuda")
    cut[:, valid_T:] = float("-inf")
    got = k_attn.attention_core_cuda(qkv, H, mask, valid_T=valid_T)
    torch.cuda.synchronize()
    ref = k_attn.attention_core_reference(qkv, H, cut if mask is None else mask + cut)
    _assert_close(got, ref, 2 ** -6)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_attention_core_every_head_width(gen, hd, masked):
    """Every head width the forward takes (multiples of 8 up to 128, as the
    routing admits), at T = 200: one pass up to 64, two passes above."""
    B, T, H = 2, 200, 2
    qkv = _randn(gen, B, T, 3 * H * hd)
    mask = torch.triu(torch.full((T, T), float("-inf"), device="cuda"), 1) if masked else None
    got = k_attn.attention_core_cuda(qkv, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_reference(qkv, H, mask), 2 ** -6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("hd,T", [(32, 77), (32, 600), (128, 120), (128, 600)])
def test_attention_core_head_widths_32_128(gen, hd, T, masked):
    """Head widths 32 and 128 (four heads of 32, two of 128: whole 128-lane
    groups, as the JAX kernels pack them) at short and long T."""
    B, H = 2, 4 if hd == 32 else 2
    qkv = _randn(gen, B, T, 3 * H * hd)
    mask = _forward_mask(gen, T, masked)
    got = k_attn.attention_core_cuda(qkv, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_reference(qkv, H, mask), 2 ** -6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T", [40, 120, 200, 256])
def test_attention_core_one_pass_and_two(gen, T, masked):
    """Every variant of the kernel that takes the row, forced: one pass with
    2 or 4 key tiles in registers, and two passes, each against the plain
    version (the timing in chip_smoke.py compares them); and the variant
    the kernel chooses is one pass."""
    B, H = 3, 2
    qkv = _randn(gen, B, T, 3 * H * 64)
    mask = _forward_mask(gen, T, masked)
    ref = k_attn.attention_core_reference(qkv, H, mask)
    assert k_attn.attention_core_key_tiles(64, T) == (2 if T <= 128 else 4)
    for key_tiles in ((2, 4, 0) if T <= 128 else (4, 0)):
        got = k_attn._attention_core_cuda_forced(qkv, H, key_tiles, mask)
        torch.cuda.synchronize()
        _assert_close(got, ref, 2 ** -6)


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


def _each_within_share_of_max(got, ref, D, tol) -> bool:
    """Whether each of dQ, dK and dV (the packed thirds of d(QKV)) lies
    within ``tol`` of its own largest value."""
    return all(float((g.float() - r.float()).abs().max()) <= tol * float(r.float().abs().max())
               for g, r in zip(got.split(D, dim=-1), ref.split(D, dim=-1)))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("T", [1, 7, 120, 199, 200, 320, 384, 600])
def test_attention_core_bwd(gen, T, masked):
    """d(QKV) against the plain backward, at T within one 64-row tile, over
    ragged last tiles, and past the 320 tokens the earlier kernel held in
    shared memory. dS is rounded to bf16 before the dQ and dK sums, so a
    flipped rounding of one dS term moves an output by one bf16 step of
    that term, not of the sum: 2**-5 covers a few.

    From T = 320 on, the gradients fall toward the absolute part of that
    limit, so each of dQ, dK and dV is also held to 2**-5 of its own
    largest value, and a planted fault must fail that check: dK and dV of
    the last key tile scaled by exp(-1/8), as a log-sum-exp shifted by 1/8
    for that tile in the dK/dV pass would give."""
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
    ref = k_attn.attention_core_bwd_reference(qkv, g, H, mask)
    _assert_close(got, ref, 2 ** -5)
    if T >= 320:
        D = H * 64
        assert _each_within_share_of_max(got, ref, D, 2 ** -5)
        fault = got.clone()
        fault[:, (T - 1) // 64 * 64:, D:] *= math.exp(-1 / 8)
        assert not _each_within_share_of_max(fault, ref, D, 2 ** -5)


def _random_mask(gen, T):
    """A random fifth of the keys at -inf, the diagonal kept."""
    mask = torch.where(torch.rand(T, T, generator=gen, device="cuda") < 0.2,
                       float("-inf"), 0.0)
    mask.fill_diagonal_(0.0)
    return mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_attention_core_bwd_every_head_width(gen, hd, masked):
    """Every head width the backward takes (multiples of 8 up to 128, the
    set the forward and the routing take), at T = 200 over two heads,
    against the plain backward at 2**-5 as ``test_attention_core_bwd``:
    widths off the 16-column step run the contraction zero-padded, widths
    over 64 the dK/dV pass in halves of 32 queries."""
    B, T, H = 2, 200, 2
    qkv = _randn(gen, B, T, 3 * H * hd)
    g = _randn(gen, B, T, H * hd)
    mask = _random_mask(gen, T) if masked else None
    got = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_bwd_reference(qkv, g, H, mask), 2 ** -5)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "masked"])
@pytest.mark.parametrize("hd", [32, 128])
def test_attention_core_bwd_head_widths_32_128(gen, hd, masked):
    """Heads of 32 and 128 (four and two a 128-lane group's worth) at T =
    600: elementwise at 2**-5, each of dQ, dK and dV within 2**-5 of its own
    largest value, and the planted last-key-tile fault (dK and dV of the
    last key tile scaled by exp(-1/8)) must fail that check."""
    B, T = 2, 600
    H = 256 // hd
    qkv = _randn(gen, B, T, 3 * H * hd)
    g = _randn(gen, B, T, H * hd)
    mask = _random_mask(gen, T) if masked else None
    got = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    torch.cuda.synchronize()
    ref = k_attn.attention_core_bwd_reference(qkv, g, H, mask)
    _assert_close(got, ref, 2 ** -5)
    D = H * hd
    assert _each_within_share_of_max(got, ref, D, 2 ** -5)
    fault = got.clone()
    fault[:, (T - 1) // 64 * 64:, D:] *= math.exp(-1 / 8)
    assert not _each_within_share_of_max(fault, ref, D, 2 ** -5)


@pytest.mark.parametrize("P,L", [(6, 64), (5, 24)])
def test_attention_core_bwd_block_causal(gen, P, L):
    """The block-causal mask of P packed sequences of L tokens: at L = 64
    every 64 x 64 tile off the diagonal is wholly -inf (the kernel's warps
    skip them), at L = 24 (MaPLe's text rows) some 16-row warp tiles are.
    Against the plain backward at 2**-5, as the random masks."""
    B, H, T = 3, 2, P * L
    qkv = _randn(gen, B, T, 3 * H * 64)
    g = _randn(gen, B, T, H * 64)
    mask = build_block_causal_mask(P, L, device="cuda")
    got = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.attention_core_bwd_reference(qkv, g, H, mask), 2 ** -5)


@pytest.mark.parametrize("masked", [False, True])
def test_attention_core_bwd_is_deterministic(gen, masked):
    """No sum crosses blocks (no atomics): two calls give the same bits."""
    B, H, T = 8, 4, 200
    qkv = _randn(gen, B, T, 3 * H * 64)
    g = _randn(gen, B, T, H * 64)
    mask = build_block_causal_mask(5, 40, device="cuda") if masked else None
    first = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    second = k_attn.attention_core_bwd_cuda(qkv, g, H, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
@pytest.mark.parametrize("rows,D", [(1, 8), (37, 200), (513, 768), (300, 1024), (37, 100),
                                    (1000, 8), (3, 768), (129, 512), (37, 300), (37, 600),
                                    (300, 1000)])
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
        k_attn.attention_core_cuda(_randn(gen, 1, 8, 3 * 2 * 12), 2)  # head width 12
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 8, 3 * 2 * 136), 2)  # head width 136
    for hd in (12, 136):  # the backward takes the forward's head widths
        with pytest.raises(ValueError):
            k_attn.attention_core_bwd_cuda(_randn(gen, 1, 8, 3 * 2 * hd), _randn(gen, 1, 8, 2 * hd),
                                           2)
    assert k_attn.attention_core_key_tiles(64, 300) == 0  # two passes past 256 keys
    assert k_attn.attention_core_key_tiles(128, 200) == 0  # and past head width 64
    with pytest.raises(RuntimeError):  # one pass forced past 256 keys
        k_attn._attention_core_cuda_forced(_randn(gen, 1, 300, 384), 2, 4)
    with pytest.raises(RuntimeError):  # two key tiles forced at 129 keys
        k_attn._attention_core_cuda_forced(_randn(gen, 1, 129, 384), 2, 2)
    with pytest.raises(ValueError):
        k_attn.attention_core_cuda(_randn(gen, 1, 8, 384), 2, valid_T=9)
    with pytest.raises(ValueError):
        k_block.gemm_epilogue_cuda(_randn(gen, 4, 12), _randn(gen, 12, 8))
    with pytest.raises(ValueError):
        k_block.gemm_tn_cuda(_randn(gen, 16, 12), _randn(gen, 16, 8))
    with pytest.raises(ValueError):
        k_block.layernorm_bwd_rows_cuda(
            _randn(gen, 2, 1032), _randn(gen, 2, 1032, dtype=torch.float32),
            _randn(gen, 2, 1032), torch.ones(1032, device="cuda"), torch.bfloat16)


@pytest.mark.parametrize("T", [1, 7, 199, 200, 257])
def test_packed_attention(gen, T):
    """K2 and K2b (the mask-free packed attention of the unfused route)
    against the plain version, forward at K1's 2**-6 and d(QKV) at K1b's
    2**-5, with one launch of each counted."""
    B, H = 3, 2
    qkv = _randn(gen, B, T, 3 * H * 64).requires_grad_(True)
    g = _randn(gen, B, T, H * 64)
    before = (k_attn.packed_attention.launches, k_attn.packed_attention_bwd.launches)
    out = k_attn.packed_attention(qkv, H)
    (got,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert (k_attn.packed_attention.launches,
            k_attn.packed_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref_out = k_attn.packed_attention_reference(qkv, H)
    (ref,) = torch.autograd.grad(ref_out, qkv, g)
    _assert_close(out, ref_out, 2 ** -6)
    _assert_close(got, ref, 2 ** -5)


@pytest.mark.parametrize("T", [7, 199])
def test_two_kernel_block(gen, T):
    """K6a and K6b against their plain versions at the block's 2**-5, each
    launched once; B odd."""
    B, D, H = 3, 128, 2
    p = _block_params(gen, D, torch.bfloat16, False)
    x = _randn(gen, B, T, D)
    before = (k_block.fused_ln_attention_residual.launches,
              k_block.fused_ln_mlp_residual.launches)
    y = k_block.fused_ln_attention_residual(x, p["ln_1"], p["attn"], H)
    out = k_block.fused_ln_mlp_residual(y, p["ln_2"], p["mlp"])
    torch.cuda.synchronize()
    assert (k_block.fused_ln_attention_residual.launches,
            k_block.fused_ln_mlp_residual.launches) == (before[0] + 1, before[1] + 1)
    ref_y = k_block.fused_ln_attention_residual_reference(x, p["ln_1"], p["attn"], H)
    assert y.dtype == out.dtype == torch.bfloat16
    _assert_close(y, ref_y, 2 ** -5)
    _assert_close(out, k_block.fused_ln_mlp_residual_reference(y, p["ln_2"], p["mlp"]),
                  2 ** -5)


@pytest.mark.parametrize("T", [7, 200])
def test_fused_ln_attention(gen, T):
    """K7's output, dx (bf16) and LayerNorm gradients (fp32) against its
    plain version: the output at 2**-5, dx and the LayerNorm gradients at
    2**-5 of their largest value; one forward and one backward counted."""
    B, D, H = 3, 128, 2
    p = _block_params(gen, D, torch.bfloat16, False)
    x = _randn(gen, B, T, D).requires_grad_(True)
    dy = _randn(gen, B, T, D)
    ln, w, b = p["ln_1"], p["attn"]["w_qkv"], p["attn"]["b_qkv"]
    fn = k_block.fused_ln_attention
    before = (fn.launches, fn.backward_launches)
    out = fn(x, ln, w, b, H)
    got = torch.autograd.grad(out, [x, ln["scale"], ln["bias"]], dy)
    torch.cuda.synchronize()
    assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    ref_out = k_block.fused_ln_attention_reference(x, ln, w, b, H)
    ref = torch.autograd.grad(ref_out, [x, ln["scale"], ln["bias"]], dy)
    _assert_close(out, ref_out, 2 ** -5)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    for g, r in zip(got, ref):
        d = (g.float() - r.float()).abs()
        assert float(d.max()) <= 2 ** -5 * float(r.abs().max()), float(d.max())


# The LayerNorm backward's instances on the main path: (x, dres, dx dtypes,
# bf16 copy, partials) of LN2's and LN1's backward (K3, K4), K7's and P2's.
LN_BWD_INSTANCES = {
    "LN2": (torch.float32, torch.bfloat16, torch.float32, True, True),
    "LN1": (torch.bfloat16, torch.float32, torch.bfloat16, False, True),
    "K7": (torch.bfloat16, None, torch.bfloat16, False, True),
    "P2": (torch.bfloat16, None, torch.bfloat16, False, False),
}


def _ln_bwd_case(gen, instance, rows, D=768):
    x_dtype, res_dtype, out_dtype, copy, partials = LN_BWD_INSTANCES[instance]
    x = _randn(gen, rows, D, dtype=x_dtype, scale=3.0) + 1.0
    dxn = _randn(gen, rows, D, dtype=torch.float32)
    dres = None if res_dtype is None else _randn(gen, rows, D, dtype=res_dtype)
    gamma = _randn(gen, D, dtype=torch.float32) * 0.1 + 1
    return (x, dxn, dres, gamma, out_dtype, copy), partials


@pytest.mark.parametrize("rows", [3, 102400, 102401])
@pytest.mark.parametrize("instance", list(LN_BWD_INSTANCES))
def test_layernorm_bwd_rows_instances(gen, instance, rows):
    """Each instance at the main path's width: at the step's 102,400 rows,
    one more (a ragged last pass of the grid) and fewer rows than a block
    has warps. The card tests' elementwise limits, and from 102,400 rows
    each output also to a share of its own largest value (bf16 2**-7, fp32
    sums in another order 2**-14), which a dropped tail of rows fails."""
    args, partials = _ln_bwd_case(gen, instance, rows)
    got = k_block.layernorm_bwd_rows_cuda(*args, param_grads=partials)
    torch.cuda.synchronize()
    ref = k_block.layernorm_bwd_rows_reference(*args)
    if not partials:
        assert got[2] is None and got[3] is None
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None:
            continue
        assert g.dtype == r.dtype
        bf = g.dtype == torch.bfloat16
        _assert_close(g, r, 2 ** -7 if bf else 1e-4 if i == 0 else 1e-4 * rows ** 0.5)
        if rows >= 102400:
            assert _within_share_of_max(g, r, 2 ** -7 if bf else 2 ** -14), i


@pytest.mark.parametrize("instance", ["LN2", "P2"])
def test_layernorm_bwd_rows_is_deterministic(gen, instance):
    """Two launches write the same bits."""
    args, partials = _ln_bwd_case(gen, instance, 102400)
    first = k_block.layernorm_bwd_rows_cuda(*args, param_grads=partials)
    again = k_block.layernorm_bwd_rows_cuda(*args, param_grads=partials)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("D", [100, 1000, 1024])
@pytest.mark.parametrize("instance", ["LN2", "LN1"])
def test_layernorm_bwd_rows_dx_without_partials(gen, instance, D):
    """With a residual branch, at a scalar width of each end of the range
    and at the largest vector width, the instance with no partials writes
    the same dx (and bf16 copy) bits as the one with them."""
    args, _ = _ln_bwd_case(gen, instance, 1001, D)
    full = k_block.layernorm_bwd_rows_cuda(*args)
    bare = k_block.layernorm_bwd_rows_cuda(*args, param_grads=False)
    torch.cuda.synchronize()
    assert bare[2] is None and bare[3] is None
    assert torch.equal(bare[0], full[0])
    assert (bare[1] is None and full[1] is None) or torch.equal(bare[1], full[1])


def _ln_bwd_ptxas(build_log: str) -> dict:
    """``(vector width, D's bucket)``: the spill bytes (stores, loads) that
    ``ptxas -v`` printed for each ``layernorm_bwd_rows_kernel`` instance."""
    import re

    out, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"layernorm_bwd_rows_kernelI.*?Lb\dELi(\d+)ELi(\d+)EE", line)
            entry = m and (int(m[1]), int(m[2]))
            continue
        spill = entry and re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out.setdefault(entry, []).append((int(spill[1]), int(spill[2])))
    return out


def test_layernorm_bwd_rows_plan_fills_the_card(gen):
    """At the main path's shape every instance's grid is one whole wave of
    the blocks that fit, no instance at D = 768 spills, and a dropped last
    row fails the comparison."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for x_dtype, res_dtype, out_dtype, _, partials in LN_BWD_INSTANCES.values():
        per_sm = k_block.ln_bwd_blocks_per_sm(k_block.ln_bwd_variant(
            768, x_dtype, res_dtype, out_dtype, partials))
        assert per_sm >= 1
        blocks, _ = k_block.ln_bwd_plan(102400, sms, per_sm)
        assert blocks == sms * per_sm
    spills = _ln_bwd_ptxas(_build.build_log)[(8, 3)]
    assert len(spills) == 16 and set(spills) == {(0, 0)}, spills
    args, partials = _ln_bwd_case(gen, "LN1", 102400)
    got = list(k_block.layernorm_bwd_rows_cuda(*args))
    ref = k_block.layernorm_bwd_rows_reference(*args)
    got[0][-1:] = 0
    assert not _within_share_of_max(got[0], ref[0], 2 ** -7)


def test_layernorm_bwd_rows_without_residual(gen):
    """The LayerNorm backward with no residual branch (K7's)."""
    x = _randn(gen, 513, 768, scale=3.0) + 1.0
    dxn = _randn(gen, 513, 768, dtype=torch.float32)
    gamma = _randn(gen, 768, dtype=torch.float32) * 0.1 + 1
    got = k_block.layernorm_bwd_rows_cuda(x, dxn, None, gamma, torch.bfloat16)
    torch.cuda.synchronize()
    ref = k_block.layernorm_bwd_rows_reference(x, dxn, None, gamma, torch.bfloat16)
    assert got[1] is None and ref[1] is None
    for i, tol in ((0, 2 ** -7), (2, 1e-4 * 513 ** 0.5), (3, 1e-4 * 513 ** 0.5)):
        _assert_close(got[i], ref[i], tol)


def test_layernorm_bwd_rows_without_parameter_gradients(gen):
    """With ``param_grads=False`` (P2's LayerNorm backward) the kernel keeps
    no partials and writes the same dx bits as with them."""
    x = _randn(gen, 513, 768, scale=3.0) + 1.0
    dxn = _randn(gen, 513, 768, dtype=torch.float32)
    gamma = _randn(gen, 768, dtype=torch.float32) * 0.1 + 1
    full = k_block.layernorm_bwd_rows_cuda(x, dxn, None, gamma, torch.bfloat16)
    bare = k_block.layernorm_bwd_rows_cuda(x, dxn, None, gamma, torch.bfloat16,
                                           param_grads=False)
    torch.cuda.synchronize()
    assert bare[2] is None and bare[3] is None
    assert torch.equal(bare[0], full[0])


@pytest.mark.parametrize("M,N,K", [(300, 136, 72), (1, 8, 8), (129, 768, 2304),
                                   (1000, 24, 2312), (102400 // 50, 768, 2304)])
def test_gemm_nt_f32(gen, M, N, K):
    """The wgmma GEMM against fp32 products of the same bf16 values, at
    ragged M, N and K (the TMA fills past the edges with zeros; rows and
    columns past them are not written) and at P2's N and K: fp32 sums in
    another order, held to 2**-14 of the largest value; two launches give
    the same bits."""
    from federated_multi_modal_tpu_torch.ops.kernels import gemm as k_gemm

    a, b = _randn(gen, M, K), _randn(gen, N, K)
    got = k_gemm.gemm_nt_f32_cuda(a, b)
    again = k_gemm.gemm_nt_f32_cuda(a, b)
    torch.cuda.synchronize()
    ref = k_gemm.gemm_nt_f32_reference(a, b)
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert _within_share_of_max(got, ref, 2 ** -14), float((got - ref).abs().max())
    assert torch.equal(got, again)


# gemm_epilogue.cu's instances (fused_block.GEMM_INSTANCES) at ragged shapes:
# every M of 1, 127, 129, 300, N of 8, 136, 2304, 3072 and K of 8, 72 and
# 3072 (K off the kernel's 64-deep step, N off its 256-wide tile).
GEMM_SHAPES = [(1, 8, 8), (127, 136, 72), (129, 2304, 3072), (300, 3072, 72),
               (300, 8, 3072), (1, 3072, 3072), (127, 2304, 8), (129, 136, 8)]
GEMM_NN_NT = sorted(i for i in k_block.GEMM_INSTANCES if i[0] != k_block._TN)


def _gemm_case(gen, layout, code, M, N, K):
    """Seeded inputs of one instance: ``a``, ``w`` and the keyword arguments
    of ``gemm_epilogue_cuda`` and its plain version."""
    e = k_block.epilogue_fields(code)
    a = _randn(gen, M, K)
    w = _randn(gen, *((N, K) if layout == k_block._NT else (K, N)), scale=K ** -0.5)
    kw = {"out_dtype": e["out"], "trans_w": layout == k_block._NT, "gelu": e["gelu"],
          "pre_dtype": e["pre"]}
    if e["bias"]:
        kw["bias"] = _randn(gen, N, dtype=torch.float32)
    if e["dgelu"]:
        kw["dgelu_of"] = _randn(gen, M, N, dtype=e["dgelu"], scale=2.0)
    if e["residual"]:
        kw["residual"] = _randn(gen, M, N, dtype=e["residual"])
    return a, w, kw


def _gemm_held(got, ref) -> bool:
    """bf16 results at 2**-7 (a flipped rounding), fp32 ones at 2**-14 of
    their largest value (sums in another order), each output of a dual
    write on its own."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        d = (g.float() - r.float()).abs()
        if g.dtype == torch.bfloat16:
            if not bool((d <= 2 ** -7 + 2 ** -7 * r.float().abs()).all()):
                return False
        elif not _within_share_of_max(g, r, 2 ** -14):
            return False
    return True


def _same_bits(x, y) -> bool:
    x = x if isinstance(x, tuple) else (x,)
    y = y if isinstance(y, tuple) else (y,)
    return all(torch.equal(u, v) for u, v in zip(x, y))


@pytest.mark.parametrize("M,N,K", GEMM_SHAPES)
@pytest.mark.parametrize("layout,code", GEMM_NN_NT,
                         ids=[f"{('NN', 'NT')[lay]}-{code:#05x}" for lay, code in GEMM_NN_NT])
def test_gemm_every_instance(gen, layout, code, M, N, K):
    """Each NN and NT instance, every epilogue and both dtypes of pre_out,
    h and the residual, against the plain version; two launches give the
    same bits."""
    a, w, kw = _gemm_case(gen, layout, code, M, N, K)
    got = k_block.gemm_epilogue_cuda(a, w, **kw)
    again = k_block.gemm_epilogue_cuda(a, w, **kw)
    torch.cuda.synchronize()
    assert _gemm_held(got, k_block.gemm_epilogue_reference(a, w, **kw))
    assert _same_bits(got, again)


@pytest.mark.parametrize("M,N", [(768, 2304), (3072, 768)])
@pytest.mark.parametrize("K", [37, 5000, 102400])
def test_gemm_tn_split(gen, K, M, N):
    """The weight gradient over K rows with the split the planner picks (one
    at K = 37 and 5000, seven or nine at 102,400): fp32 at 2**-14 of its
    largest value, the same bits on repeat."""
    a, b = _randn(gen, K, M), _randn(gen, K, N)
    got = k_block.gemm_tn_cuda(a, b)
    again = k_block.gemm_tn_cuda(a, b)
    torch.cuda.synchronize()
    assert _within_share_of_max(got, k_block.gemm_tn_reference(a, b), 2 ** -14)
    assert torch.equal(got, again)


def test_gemm_refuses_what_it_does_not_build(gen):
    """A combination outside GEMM_INSTANCES raises in the wrapper, and the
    entry point refuses it too (NN with QuickGELU' is not built)."""
    a, w = _randn(gen, 8, 16), _randn(gen, 16, 8)
    h = _randn(gen, 8, 8)
    with pytest.raises(ValueError, match="no instance"):
        k_block.gemm_epilogue_cuda(a, w, dgelu_of=h)
    out = torch.empty(8, 8, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(RuntimeError, match="fmm_gemm_epilogue"):
        k_block._gemm_launch(a, w, k_block._NN, 8, 8, 16, out, dgelu_of=h)


@pytest.mark.parametrize("layout,code", [
    (k_block._NN, k_block.epilogue_code(bias=True, residual=torch.bfloat16, out=torch.float32)),
    (k_block._NN, k_block.epilogue_code(bias=True, gelu=True)),
    (k_block._NT, k_block.epilogue_code(dgelu=torch.float32)),
    (k_block._NT, k_block.epilogue_code(out=torch.float32))], ids=["out_proj", "fc", "dh", "dxn2"])
def test_gemm_planted_faults_are_caught(gen, layout, code):
    """The checks above catch a kernel that drops its last 64-deep K stage,
    and one that skips the epilogue on its last 256-column tile (the same
    product with no epilogue spliced in there)."""
    M, N, K = 300, 2304, 3072
    a, w, kw = _gemm_case(gen, layout, code, M, N, K)
    ref = k_block.gemm_epilogue_reference(a, w, **kw)
    cut = w[:, :K - 64] if layout == k_block._NT else w[:K - 64]
    dropped = k_block.gemm_epilogue_cuda(a[:, :K - 64].contiguous(), cut.contiguous(), **kw)
    assert not _gemm_held(dropped, ref)
    if code != k_block.epilogue_code(out=kw["out_dtype"]):
        got = k_block.gemm_epilogue_cuda(a, w, **kw)
        bare = k_block.gemm_epilogue_cuda(a, w, out_dtype=kw["out_dtype"],
                                          trans_w=kw["trans_w"])
        got = got[0] if isinstance(got, tuple) else got
        got[:, (N - 1) // 256 * 256:] = bare[:, (N - 1) // 256 * 256:]
        assert not _gemm_held(got, ref[0] if isinstance(ref, tuple) else ref)


def test_gemm_tn_planted_fault_is_caught(gen):
    """The TN check catches a last split whose partial is never written
    (the product over the rows of the other splits only)."""
    K, M, N = 102400, 768, 768
    a, b = _randn(gen, K, M), _randn(gen, K, N)
    splits, k_per = k_block.tn_split_plan(
        M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
    assert splits > 1
    rows = (splits - 1) * k_per
    fault = k_block.gemm_tn_cuda(a[:rows].contiguous(), b[:rows].contiguous())
    assert not _within_share_of_max(fault, k_block.gemm_tn_reference(a, b), 2 ** -14)


def test_group_and_split_routes_launch_their_kernels(gen, monkeypatch):
    """``FMM_TPU_FUSED_NBLK=2`` runs the eval tower through the group kernel
    K9 (groups 0-1 and 2 of Tiny's three blocks, one deep prompt injected
    in the first group) and heads that do not pack into 128 lanes through
    K8, each launching its kernels; the grouped tower matches the plain
    path."""
    from federated_multi_modal_tpu_torch.engine.tree import to_device
    from federated_multi_modal_tpu_torch.models.clip_model import encode_image
    from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
    from federated_multi_modal_tpu_torch.ops import primitives

    cfg = BACKBONE_CONFIGS["Tiny"]
    visual = to_device(init_clip_params(cfg, torch.Generator().manual_seed(0))["visual"], "cuda")
    images = _randn(gen, 2, 32, 32, 3)
    prompts = _randn(gen, 2, cfg.vision_width)
    monkeypatch.setenv("FMM_TPU_FUSED_NBLK", "2")
    before = (k_block.fused_block_group_residual.launches, k_block.fused_block_residual.launches,
              _build.LAUNCHES["fmm_inject_rows"])
    got = encode_image(visual, cfg, images, shallow_prompts=prompts, deep_prompts=[prompts],
                       inference=True)
    torch.cuda.synchronize()
    assert (k_block.fused_block_group_residual.launches, k_block.fused_block_residual.launches,
            _build.LAUNCHES["fmm_inject_rows"]) == (before[0] + 2, before[1], before[2] + 1)
    monkeypatch.setattr(primitives, "_block_kernels", types.SimpleNamespace(**{
        **vars(k_block),
        "fused_block_group_residual": k_block.fused_block_group_residual_reference}))
    ref = encode_image(visual, cfg, images, shallow_prompts=prompts, deep_prompts=[prompts],
                       inference=True)
    _assert_close(got, ref, 2 ** -4)

    D, n_head = 96, 3  # 32-wide heads, 3 of them: no 128-lane packing
    p = {"w_qkv": _randn(gen, D, 3 * D), "b_qkv": _randn(gen, 3 * D),
         "w_out": _randn(gen, D, D), "b_out": _randn(gen, D)}
    before = (k_attn.fused_attention.launches, _build.LAUNCHES["fmm_attention_split"])
    out = primitives.multi_head_attention(_randn(gen, 1, 40, D), p, n_head)
    torch.cuda.synchronize()
    assert out.shape == (1, 40, D)
    assert (k_attn.fused_attention.launches,
            _build.LAUNCHES["fmm_attention_split"]) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n_extra", [0, 1, 3])
@pytest.mark.parametrize("B,T,D", [(1, 8, 8), (5, 13, 128), (512, 200, 768)])
def test_inject_rows(gen, B, T, D, n_extra):
    """The trailing rows of an fp32 stream take the bf16 prompt (every
    sample) then the extra rows, exactly; the rows before stay."""
    n_ctx = min(2, T - n_extra)
    stream = _randn(gen, B, T, D, dtype=torch.float32)
    prompt = _randn(gen, n_ctx, D)
    extra = _randn(gen, B, n_extra, D) if n_extra else None
    ref = k_block.inject_rows_reference(stream.clone(), prompt, extra)
    before = _build.LAUNCHES["fmm_inject_rows"]
    got = k_block.inject_rows_cuda(stream, prompt, extra)
    torch.cuda.synchronize()
    assert got is stream and _build.LAUNCHES["fmm_inject_rows"] == before + 1
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("T,G", [(13, 3), (199, 2)])
def test_fused_block_group_residual(gen, T, G, extra):
    """K9 over G blocks with an injection inside the group (and at its first
    block for G=2: flags at blocks 0 and 1), against its plain version at
    twice the block's 2**-5; one launch counted."""
    B, D, H = 3, 128, 2
    blocks = [_block_params(gen, D, torch.bfloat16, False) for _ in range(G)]
    flags = (False, True, True)[:G] if G == 3 else (True, True)
    prompts = [_randn(gen, 2, D, scale=0.3) for f in flags if f]
    ex = _randn(gen, B, 1, D, scale=0.3) if extra else None
    x = _randn(gen, B, T, D)
    before = k_block.fused_block_group_residual.launches
    got = k_block.fused_block_group_residual(x, blocks, H, flags, prompts, ex)
    torch.cuda.synchronize()
    assert k_block.fused_block_group_residual.launches == before + 1
    assert got.dtype == torch.bfloat16
    ref = k_block.fused_block_group_residual_reference(x, blocks, H, flags, prompts, ex)
    _assert_close(got, ref, 2 ** -4)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("hd,T", [(40, 77), (80, 257), (96, 77), (96, 13), (8, 40),
                                  (128, 289), (80, 600), (128, 400)])
def test_fused_attention(gen, hd, T, masked):
    """K8 on the column split of a packed QKV (row stride 3D) against its
    plain version: the forward at K1's 2**-6, the gradients of
    ``fused_attention_diff`` (the plain VJP on both sides) against plain
    autograd at 2**-5 of their largest value; T=13 and 77 are off the
    multiple of 8, T=289 was the shared-memory limit at head width 128 of
    the earlier kernel, and T=600 at 80 and 400 at 128 lie past it."""
    from federated_multi_modal_tpu_torch.ops.primitives import build_causal_mask

    B, H = 3, 2
    D = H * hd
    qkv = _randn(gen, B, T, 3 * D).requires_grad_(True)
    mask = build_causal_mask(T, device="cuda") if masked else None
    g = _randn(gen, B, T, D)
    before = k_attn.fused_attention.launches
    out = k_attn.fused_attention_diff(*qkv.split(D, dim=-1), H, mask)
    (got,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert k_attn.fused_attention.launches == before + 1
    ref_out = k_attn.fused_attention_reference(*qkv.split(D, dim=-1), H, mask)
    (ref,) = torch.autograd.grad(ref_out, qkv, g)
    _assert_close(out, ref_out, 2 ** -6)
    d = (got.float() - ref.float()).abs()
    assert float(d.max()) <= 2 ** -5 * float(ref.float().abs().max()), float(d.max())


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("hd", range(8, 129, 8))
def test_fused_attention_every_head_width(gen, hd, masked):
    """Every head width the kernel is built for, at T = 70 (a full and a
    ragged 64-key tile), on three separate contiguous operands, against the
    plain version at K1's 2**-6; widths off the multiple of 16 run Q.K^T
    over a zero-padded column tile and P.V in 8-column steps."""
    from federated_multi_modal_tpu_torch.ops.primitives import build_causal_mask

    B, H, T = 2, 3, 70
    q, k, v = (_randn(gen, B, T, H * hd) for _ in range(3))
    mask = build_causal_mask(T, device="cuda") if masked else None
    got = k_attn.fused_attention_cuda(q, k, v, H, mask)
    torch.cuda.synchronize()
    _assert_close(got, k_attn.fused_attention_reference(q, k, v, H, mask), 2 ** -6)


def test_fused_attention_refuses_what_it_does_not_take(gen):
    """Head widths off the multiple of 8 or over 128, fp32 operands and a
    batch stride other than T rows raise."""
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(*[_randn(gen, 1, 8, 60)] * 3, 2)  # head width 30
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(*[_randn(gen, 1, 8, 272)] * 2 + [_randn(gen, 1, 8, 272)], 1)
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(*[_randn(gen, 1, 8, 64, dtype=torch.float32)] * 3, 1)
    q = _randn(gen, 2, 16, 64)[:, :8]
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(q, q, q, 1)


# -- the attention microbench's prototypes P1-P3 ------------------------------


def _lnqkv_params(gen, D):
    lnp = {"scale": _randn(gen, D, dtype=torch.float32) * 0.1 + 1,
           "bias": _randn(gen, D, dtype=torch.float32, scale=0.1)}
    return lnp, _randn(gen, D, 3 * D, scale=D ** -0.5), _randn(gen, 3 * D, scale=0.1)


@pytest.mark.parametrize("B,T,D", [(4, 16, 128), (4, 32, 128), (4, 48, 128), (2, 200, 768),
                                   (4, 40, 128), (2, 197, 768), (2, 256, 768)])
def test_fused_lnqkv_attention_prototypes(gen, B, T, D):
    """P1 (forward) and P2 (dx) against their plain versions, at K7's limits:
    the output at 2**-5 (against K7's plain forward, which P1's plain
    version returns), dx at 2**-5 of its largest value (against K7's plain
    backward, which P2's plain version returns); where the TPU prototype's
    T % 8 == 0 holds, through ``make_fused_lnqkv_attention_fb`` one launch
    of each is counted and its dx equals the direct call's bit for bit. T =
    32 and 48 run two and three warps over fewer than 64 padded tokens,
    where a warp's 16 x 64 output tile is larger than its score tile. T = 40
    and 197 are off P1's 32-row GEMM groups and 64-key tiles, and 197 and
    256 (P1's and P2's largest) off the old P2's 208-token limit."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    H = D // 64
    lnp, w, b = _lnqkv_params(gen, D)
    x = _randn(gen, B, T, D)
    got = k_proto.fused_lnqkv_attention_cuda(x, lnp, w, b, H)
    torch.cuda.synchronize()
    ref = k_block.ln_attention_forward(x, lnp, w, b, H, k_block.PLAIN_STEPS)
    _assert_close(got, ref, 2 ** -5)
    dy = _randn(gen, B, T, D)
    dx = k_proto.fused_lnqkv_attention_bwd_dx_cuda(x, lnp, w, b, dy, H)
    torch.cuda.synchronize()
    ref_dx = k_block.ln_attention_backward(x, dy, lnp, w, b, H, k_block.PLAIN_STEPS)[0]
    assert _within_share_of_max(dx, ref_dx, 2 ** -5), float((dx - ref_dx).float().abs().max())
    if T % 8:
        return

    before = (k_proto.fused_lnqkv_attention.launches,
              k_proto.fused_lnqkv_attention_bwd_dx.launches)
    xr = x.clone().requires_grad_(True)
    out = k_proto.make_fused_lnqkv_attention_fb(H, GB=2)(xr, lnp, w, b)
    (dx_fb,) = torch.autograd.grad(out, xr, dy)
    torch.cuda.synchronize()
    assert (k_proto.fused_lnqkv_attention.launches,
            k_proto.fused_lnqkv_attention_bwd_dx.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(dx_fb, dx, rtol=0, atol=0)  # no atomics: bit for bit


def test_fused_lnqkv_attention_bwd_dx_catches_a_zeroed_head(gen):
    """P2's dx at the microbench's width against its plain version, and the
    same with one head's d(QKV) scratch zeroed before the GEMM, which must
    fail the 2**-5 share-of-max check (the GEMM's sum over heads sees the
    scratch as the attention stage left it)."""
    from federated_multi_modal_tpu_torch.ops.kernels import gemm as k_gemm
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, T, D, H = 2, 200, 768, 12
    lnp, w, b = _lnqkv_params(gen, D)
    x, dy = _randn(gen, B, T, D), _randn(gen, B, T, D)
    ref = k_block.ln_attention_backward(x, dy, lnp, w, b, H, k_block.PLAIN_STEPS)[0]
    assert _within_share_of_max(k_proto.fused_lnqkv_attention_bwd_dx_cuda(x, lnp, w, b, dy, H),
                                ref, 2 ** -5)
    gemm = k_gemm.gemm_nt_f32_cuda

    def zero_head0(a, wt):
        a = a.clone()
        a[:, 0:64] = 0
        a[:, D:D + 64] = 0
        a[:, 2 * D:2 * D + 64] = 0
        return gemm(a, wt)

    k_proto.gemm_nt_f32_cuda = zero_head0
    try:
        fault = k_proto.fused_lnqkv_attention_bwd_dx_cuda(x, lnp, w, b, dy, H)
    finally:
        k_proto.gemm_nt_f32_cuda = gemm
    torch.cuda.synchronize()
    assert not _within_share_of_max(fault, ref, 2 ** -5)


@pytest.mark.parametrize("T,tpad", [(16, 8), (32, 8), (48, 8), (40, 16), (200, 8), (200, 16),
                                    (13, 16)])
def test_packed4d_attention(gen, T, tpad):
    """P3 against its plain version (tokens padded to ``tpad``, padded keys
    at -inf) at K2's 2**-6, one launch counted; T = 13 and 40 end inside a
    64-key tile; T = 32, 40 and 48 run warps over fewer than 64 tokens."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, H = 3, 4
    qkv = _randn(gen, B, T, 3 * H * 64)
    before = k_proto.packed4d_attention.launches
    got = k_proto.packed4d_attention(qkv, H, tpad)
    torch.cuda.synchronize()
    assert k_proto.packed4d_attention.launches == before + 1
    _assert_close(got, k_proto.packed4d_attention_reference(qkv, H, tpad), 2 ** -6)


@pytest.mark.parametrize("T", [77, 200, 600, 1030])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_packed4d_attention_head_widths(gen, hd, T):
    """P3 at every head width its 128-lane groups take (4, 2 and 1 heads a
    group, two groups), within one pass's 256 keys and past them, against
    its plain version at 2**-6 elementwise and 2**-6 of the output's largest
    value; past 256 tokens the kernel with its last key tile dropped
    (``valid_T`` at the tile's first key) must fail the latter."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, H = 2, 256 // hd
    qkv = _randn(gen, B, T, 3 * H * hd)
    got = k_proto.packed4d_attention_cuda(qkv, H)
    torch.cuda.synchronize()
    ref = k_proto.packed4d_attention_reference(qkv, H)
    _assert_close(got, ref, 2 ** -6)
    assert _within_share_of_max(got, ref, 2 ** -6)
    assert k_proto.packed4d_attention_key_tiles(hd, T) == (4 if hd == 64 and T <= 256 else 0)
    if T > 256:
        fault = k_proto.packed4d_attention_cuda(qkv, H, valid_T=(T - 1) // 64 * 64)
        assert not _within_share_of_max(fault, ref, 2 ** -6)


def test_prototypes_refuse_what_they_do_not_take(gen):
    """P1 with T % 8 != 0, B % GB != 0 or T over 256 raises, and so does P2
    over 256 or at a head width other than 64; P3 raises at head widths its
    128-lane groups do not split (16), for heads that do not fill whole
    groups and for valid_T < 1. What the earlier kernels refused and the new
    ones take is checked beside: P3 at 241 tokens (its old shared-memory
    limit was 240) and P2 at 216 (its old limit was 208), each against its
    plain version."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    with pytest.raises(ValueError):
        k_proto.packed4d_attention_cuda(_randn(gen, 1, 16, 3 * 8 * 16), 8)  # heads of 16
    with pytest.raises(ValueError):
        k_proto.packed4d_attention_cuda(_randn(gen, 1, 16, 3 * 3 * 64), 3)  # 192 lanes
    with pytest.raises(ValueError):
        k_proto.packed4d_attention_cuda(_randn(gen, 1, 16, 384), 2, valid_T=0)
    qkv = _randn(gen, 2, 241, 384)
    _assert_close(k_proto.packed4d_attention_cuda(qkv, 2),
                  k_proto.packed4d_attention_reference(qkv, 2), 2 ** -6)

    lnp, w, b = _lnqkv_params(gen, 128)
    with pytest.raises(ValueError, match="T % 8"):
        k_proto.fused_lnqkv_attention(_randn(gen, 4, 12, 128), lnp, w, b, 2)
    with pytest.raises(ValueError, match="GB"):
        k_proto.fused_lnqkv_attention(_randn(gen, 3, 16, 128), lnp, w, b, 2)
    with pytest.raises(ValueError):
        k_proto.fused_lnqkv_attention(_randn(gen, 4, k_proto.MAX_TOKENS_LNQKV + 8, 128),
                                      lnp, w, b, 2)
    x = _randn(gen, 4, k_proto.MAX_TOKENS_LNQKV + 8, 128)
    with pytest.raises(ValueError):
        k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, x, 2)
    x = _randn(gen, 4, 16, 128)
    with pytest.raises(ValueError):
        k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, x, 4)  # heads of 32
    x, dy = _randn(gen, 2, 216, 128), _randn(gen, 2, 216, 128)
    assert _within_share_of_max(
        k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy, 2, GB=2),
        k_proto.fused_lnqkv_attention_bwd_dx_reference(x, lnp, w, b, dy, 2, GB=2), 2 ** -5)
