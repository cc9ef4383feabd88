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
    """Fp32 operands, a batch stride other than T rows and head widths past
    288 raise. The widths the earlier kernel refused and this one takes are
    checked beside against the plain version at 2**-6: 30 (off the multiple
    of 8, padded to 32) and 272 (past 128, padded to the 288 instance)."""
    for hd, H in ((30, 2), (272, 1)):
        q, k, v = (_randn(gen, 1, 8, H * hd) for _ in range(3))
        got = k_attn.fused_attention_cuda(q, k, v, H)
        torch.cuda.synchronize()
        _assert_close(got, k_attn.fused_attention_reference(q, k, v, H), 2 ** -6)
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(*[_randn(gen, 1, 8, 296)] * 3, 1)  # head width 296
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(*[_randn(gen, 1, 8, 64, dtype=torch.float32)] * 3, 1)
    q = _randn(gen, 2, 16, 64)[:, :8]
    with pytest.raises(ValueError):
        k_attn.fused_attention_cuda(q, q, q, 1)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("hd", [12, 30, 80, 96, 136, 160, 192, 224, 256, 272, 288])
def test_fused_attention_any_head_width(gen, hd, masked):
    """K8 through ``fused_attention_diff`` (the route ``multi_head_attention``
    takes for heads that do not pack into 128 lanes at T >= 32) at widths off
    the multiple of 8 and past 128, on the column split of a packed QKV, T =
    77 (a ragged second key tile): the forward at 2**-6 and 2**-6 of its
    largest value, the gradients (the plain VJP on both sides) at 2**-5 of
    theirs, one launch counted; the kernel with its last key tile dropped
    (``valid`` keys cut by a mask) must fail the share-of-max check."""
    from federated_multi_modal_tpu_torch.ops.primitives import build_causal_mask

    B, H, T = 2, 2, 77
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
    assert _within_share_of_max(out, ref_out, 2 ** -6)
    assert _within_share_of_max(got, ref, 2 ** -5)
    cut = torch.zeros(T, T, device="cuda")
    cut[:, 64:] = float("-inf")
    q, k, v = (t.detach() for t in qkv.split(D, dim=-1))
    fault = k_attn.fused_attention_cuda(q, k, v, H, cut if mask is None else mask + cut)
    assert not _within_share_of_max(fault, ref_out, 2 ** -6)


@pytest.mark.parametrize("masked", [False, True], ids=["K2", "K1"])
@pytest.mark.parametrize("hd", [1, 2, 4])
def test_packed_attention_small_heads(gen, hd, masked):
    """K2/K2b (no mask, T = 200) and K1/K1b (block-causal, MaPLe's packed
    text rows of 120) at the head widths ``_packed_hp`` admits below 8, as
    the routing sends them: 128 columns of 128 / hd heads, each zero-padded
    to 8 by the wrapper. Forward at 2**-6 and d(QKV) at 2**-5 of its largest
    value against the plain versions, one launch of each counted, and a
    kernel run at the padded width's scale instead of the true one's must
    fail the forward check."""
    B, D = 3, 128
    H, T = D // hd, 120 if masked else 200
    qkv = _randn(gen, B, T, 3 * D).requires_grad_(True)
    mask = build_block_causal_mask(5, 24, device="cuda") if masked else None
    g = _randn(gen, B, T, D)
    fwd = k_attn.packed_attention_masked if masked else k_attn.packed_attention
    bwd = k_attn.packed_attention_masked_bwd if masked else k_attn.packed_attention_bwd
    before = (fwd.launches, bwd.launches)
    out = fwd(qkv, mask, H) if masked else fwd(qkv, H)
    (got,) = torch.autograd.grad(out, qkv, g)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    q = qkv.detach()
    ref_out = k_attn.attention_core_reference(q, H, mask)
    _assert_close(out, ref_out, 2 ** -6)
    assert _within_share_of_max(got, k_attn.attention_core_bwd_reference(q, g, H, mask), 2 ** -5)
    fault = k_attn.unpad_heads(k_attn.attention_core_cuda(k_attn.pad_heads(q, H, 8), H, mask),
                               H, hd, parts=1)
    assert not _within_share_of_max(fault, ref_out, 2 ** -6)


def test_attention_core_bwd_head_width_160(gen):
    """The backward's one wide instance (160, no mask; P2's streamed route)
    against its plain version at 2**-5 of each gradient's largest value, at
    T = 77 and 300 (two and five key tiles); with a mask it raises."""
    for T in (77, 300):
        qkv, g = _randn(gen, 2, T, 3 * 2 * 160), _randn(gen, 2, T, 2 * 160)
        got = k_attn.attention_core_bwd_cuda(qkv, g, 2)
        torch.cuda.synchronize()
        ref = k_attn.attention_core_bwd_reference(qkv, g, 2)
        for part in range(3):
            sl = slice(part * 320, (part + 1) * 320)
            assert _within_share_of_max(got[..., sl], ref[..., sl], 2 ** -5), (T, part)
    with pytest.raises(ValueError):
        k_attn.attention_core_bwd_cuda(qkv, g, 2, torch.zeros(300, 300, device="cuda"))


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
    """P1 with T % 8 != 0 or B % GB != 0 raises, and so do P1 and P2 at heads
    wider than 160; P3 raises for heads that do not fill whole 128-lane
    groups and for valid_T < 1. What the earlier kernels refused and the new
    ones take is checked beside, each against its plain version: P3 at 241
    tokens (its old shared-memory limit was 240) and at heads of 16; P1 and
    P2 past 256 tokens (the old limit of both), P2 at 216 (its older limit
    was 208) and at heads of 32 (the old kernels took 64 only)."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    with pytest.raises(ValueError):
        k_proto.packed4d_attention_cuda(_randn(gen, 1, 16, 3 * 3 * 64), 3)  # 192 lanes
    with pytest.raises(ValueError):
        k_proto.packed4d_attention_cuda(_randn(gen, 1, 16, 384), 2, valid_T=0)
    for qkv, H in ((_randn(gen, 2, 241, 384), 2), (_randn(gen, 1, 16, 3 * 8 * 16), 8)):
        _assert_close(k_proto.packed4d_attention_cuda(qkv, H),
                      k_proto.packed4d_attention_reference(qkv, H), 2 ** -6)

    lnp, w, b = _lnqkv_params(gen, 128)
    with pytest.raises(ValueError, match="T % 8"):
        k_proto.fused_lnqkv_attention(_randn(gen, 4, 12, 128), lnp, w, b, 2)
    with pytest.raises(ValueError, match="GB"):
        k_proto.fused_lnqkv_attention(_randn(gen, 3, 16, 128), lnp, w, b, 2)
    wide = _lnqkv_params(gen, 168)
    with pytest.raises(ValueError, match="heads up to 160"):
        k_proto.fused_lnqkv_attention(_randn(gen, 4, 16, 168), *wide, 1)
    with pytest.raises(ValueError, match="heads up to 160"):
        x = _randn(gen, 4, 16, 168)
        k_proto.fused_lnqkv_attention_bwd_dx(x, *wide, x, 1)
    x = _randn(gen, 4, 264, 128)
    _assert_close(k_proto.fused_lnqkv_attention(x, lnp, w, b, 2),
                  k_proto.fused_lnqkv_attention_reference(x, lnp, w, b, 2), 2 ** -5)
    for x, dy, H in ((x, _randn(gen, 4, 264, 128), 2),
                     (_randn(gen, 4, 16, 128), _randn(gen, 4, 16, 128), 4),
                     (_randn(gen, 2, 216, 128), _randn(gen, 2, 216, 128), 2)):
        assert _within_share_of_max(
            k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy, H, GB=2),
            k_proto.fused_lnqkv_attention_bwd_dx_reference(x, lnp, w, b, dy, H, GB=2), 2 ** -5)


@pytest.mark.parametrize("hd,T", [(16, 200), (30, 200), (32, 200), (128, 200), (160, 200),
                                  (64, 264), (160, 264), (16, 520), (8, 64)])
def test_fused_lnqkv_attention_any_head_width(gen, hd, T):
    """P1 and P2 at head widths other than 64 and past 256 tokens, each with
    its route (the fused kernels at stage widths 16, 32 and 64 up to 256
    tokens, else the projection into a QKV scratch and the streamed
    attention), four heads: the output at 2**-5 and 2**-5 of its largest
    value, dx at 2**-5 of its largest value, against the plain versions (K7's
    plain forward and backward); one launch of each counted through the
    prototypes' entry points, and the route's kernels launched. D = 4 hd is
    off the 64-column contraction step at 30, 8 and 160 (x, gamma and beta
    padded). A planted fault: each head's first q and v columns swapped in W
    must fail the share-of-max check."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, H = 2, 4
    D = H * hd
    lnp, w, b = _lnqkv_params(gen, D)
    x, dy = _randn(gen, B, T, D), _randn(gen, B, T, D)
    kd = k_proto.lnqkv_head_width(hd)
    fused = k_proto.lnqkv_fused(kd, T)
    before = dict(_build.LAUNCHES)
    counts = (k_proto.fused_lnqkv_attention.launches,
              k_proto.fused_lnqkv_attention_bwd_dx.launches)
    got = k_proto.fused_lnqkv_attention(x, lnp, w, b, H, GB=2)
    dx = k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy, H, GB=2)
    torch.cuda.synchronize()
    assert (k_proto.fused_lnqkv_attention.launches,
            k_proto.fused_lnqkv_attention_bwd_dx.launches) == (counts[0] + 1, counts[1] + 1)
    launched = {k for k, v in _build.LAUNCHES.items() if v > before[k]}
    want = ({"fmm_lnqkv_attention", "fmm_lnqkv_attention_bwd_dqkv"} if fused else
            {"fmm_lnqkv_project", "fmm_attention_split", "fmm_attention_core_bwd"})
    assert want | {"fmm_gemm_nt_f32", "fmm_layernorm_bwd_rows"} == launched, launched
    ref = k_block.ln_attention_forward(x, lnp, w, b, H, k_block.PLAIN_STEPS)
    _assert_close(got, ref, 2 ** -5)
    assert _within_share_of_max(got, ref, 2 ** -5)
    ref_dx = k_block.ln_attention_backward(x, dy, lnp, w, b, H, k_block.PLAIN_STEPS)[0]
    assert _within_share_of_max(dx, ref_dx, 2 ** -5), float((dx - ref_dx).float().abs().max())
    w_fault = w.clone()
    for h in range(H):
        q0, v0 = h * hd, 2 * D + h * hd
        w_fault[:, [q0, v0]] = w_fault[:, [v0, q0]]
    fault = k_proto.fused_lnqkv_attention(x, lnp, w_fault, b, H, GB=2)
    assert not _within_share_of_max(fault, ref, 2 ** -5)


@pytest.mark.parametrize("T", [16, 77, 200, 600])
@pytest.mark.parametrize("hd", [8, 16])
def test_packed4d_attention_small_heads(gen, hd, T):
    """P3 at heads of 16 (8 a 128-lane group, 32 warps a block) and 8 (padded
    to 16 by the wrapper), two groups, against its plain version at 2**-6
    elementwise and 2**-6 of the output's largest value, one launch counted;
    the kernel with its last key tile dropped must fail the latter where T
    spans more than one tile."""
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    B, H = 2, 256 // hd
    qkv = _randn(gen, B, T, 3 * H * hd)
    before = k_proto.packed4d_attention.launches
    got = k_proto.packed4d_attention(qkv, H)
    torch.cuda.synchronize()
    assert k_proto.packed4d_attention.launches == before + 1
    ref = k_proto.packed4d_attention_reference(qkv, H)
    _assert_close(got, ref, 2 ** -6)
    assert _within_share_of_max(got, ref, 2 ** -6)
    if T > 64:
        fault = k_proto.packed4d_attention_cuda(qkv, H, valid_T=(T - 1) // 64 * 64)
        assert not _within_share_of_max(fault, ref, 2 ** -6)


def _cli_maple_tiny(tmp_path, impl):
    """One epoch of MaPLe through the port's command line at the Tiny width
    on the card (``TPU.ATTENTION_IMPL`` ``impl``), the module globals and
    ``sys.stdout`` put back: the first step's loss and the launches of
    K1, K1b, K3, K4 and K5 over the run."""
    import sys

    from federated_multi_modal_tpu_torch import train as port_cli
    from federated_multi_modal_tpu_torch.engine import trainer as eng
    from federated_multi_modal_tpu_torch.models import clip_model
    from federated_multi_modal_tpu_torch.ops import primitives

    wrappers = {"K1": k_attn.packed_attention_masked, "K3": k_block.fused_block_train,
                "K4": k_block.fused_block_train_dw, "K5": k_block.fused_block_residual}
    for fn in wrappers.values():
        fn.launches = 0
    k_attn.packed_attention_masked_bwd.launches = 0
    losses = []
    step = eng.FunctionalTrainerMixin.train_step

    def recorded(self, batch):
        out = step(self, batch)
        losses.append(float(self._pending_summaries[-1][0]) if out is None else out["loss"])
        return out

    argv = ["--root", str(tmp_path / "data"), "--seed", "1", "--trainer", "MaPLe",
            "--dataset-config-file", "configs/datasets/synthetic.yaml",
            "--config-file", "configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml",
            "--output-dir", str(tmp_path / impl), "MODEL.BACKBONE.NAME", "Tiny",
            "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
            "TRAINER.MAPLE.PROMPT_DEPTH", "3", "OPTIM.MAX_EPOCH", "1",
            "DATALOADER.TEST.BATCH_SIZE", "8", "TPU.ATTENTION_IMPL", impl]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        mp.setattr(primitives, "_ATTENTION_IMPL", primitives._ATTENTION_IMPL)
        mp.setattr(clip_model, "_TEXT_PACK_DEFAULT", clip_model._TEXT_PACK_DEFAULT)
        mp.setattr(eng.FunctionalTrainerMixin, "train_step", recorded)
        mp.delenv("FMM_TPU_PLATFORM", raising=False)
        for gate in ("FMM_TPU_FUSED", "FMM_TPU_FUSED_BLOCK", "FMM_TPU_FUSED_TRAIN",
                     "FMM_TPU_FUSED_TRAIN_BLOCK", "FMM_TPU_FUSED_TRAIN_DW",
                     "FMM_TPU_FUSED_NBLK"):
            mp.delenv(gate, raising=False)
        trainer = port_cli.main(port_cli.build_parser().parse_args(argv))
    counts = {k: fn.launches for k, fn in wrappers.items()}
    counts["K1b"] = k_attn.packed_attention_masked_bwd.launches
    return losses[0], counts, trainer


def test_cli_maple_tiny_on_the_card(gen, tmp_path):
    """MaPLe through the command line for one epoch at the Tiny width (3
    blocks a tower, 4 steps, 2 test batches): K1 3 a step and 3 in
    ``test()``, K1b 3 a step, K3 2 and K4 1 a step, K5 3 a test batch; the
    first loss within 2**-8 of the same run on the plain formulation
    (``TPU.ATTENTION_IMPL xla``), which launches no kernel."""
    loss, counts, trainer = _cli_maple_tiny(tmp_path, "pallas")
    assert trainer.device.type == "cuda"
    steps = trainer.epoch_stats[0]["steps"]
    tests = len(trainer.test_loader)
    assert (steps, tests) == (4, 2)
    assert counts == {"K1": 3 * steps + 3, "K1b": 3 * steps, "K3": 2 * steps,
                      "K4": steps, "K5": 3 * tests}, counts
    loss_xla, counts_xla, _ = _cli_maple_tiny(tmp_path, "xla")
    assert not any(counts_xla.values()), counts_xla
    assert abs(loss - loss_xla) <= 2.0 ** -8 * abs(loss_xla), (loss, loss_xla)


def test_federated_round_tiny_on_the_card(gen, tmp_path):
    """One federated round of ``MaPLeFederated`` through the command line at
    the Tiny width on the card, two Synthetic clients of one local epoch
    each: no failed client or skipped round, one update, and the launches
    the routing implies: per client step K1 3, K1b 3, K3 2, K4 1; per
    ``test()`` (one after each client's epoch, the round's and the final
    one on client 0) K1 3 and K5 3 a test batch."""
    import sys

    from federated_multi_modal_tpu_torch import train as port_cli
    from federated_multi_modal_tpu_torch.models import clip_model
    from federated_multi_modal_tpu_torch.ops import primitives

    wrappers = {"K1": k_attn.packed_attention_masked, "K1b": k_attn.packed_attention_masked_bwd,
                "K3": k_block.fused_block_train, "K4": k_block.fused_block_train_dw,
                "K5": k_block.fused_block_residual}
    for fn in wrappers.values():
        fn.launches = 0
    argv = ["--root", str(tmp_path / "data"), "--seed", "1", "--trainer", "MaPLeFederated",
            "--dataset-config-file", "configs/datasets/synthetic.yaml", "--config-file",
            "configs/trainers/MaPLeFederated/vit_b16_c2_ep5_batch4_2ctx_cross_datasets.yaml",
            "--output-dir", str(tmp_path / "fed"), "MODEL.BACKBONE.NAME", "Tiny",
            "INPUT.SIZE", "(32, 32)", "INPUT.CANVAS_SIZE", "40",
            "TRAINER.MAPLE.PROMPT_DEPTH", "3", "FED.NUM_ROUNDS", "1", "FED.LOCAL_EPOCHS", "1",
            "FED.DATASETS", "('Synthetic', 'Synthetic')", "FED.CLASSNAME_ONLY_DATASETS", "()",
            "DATALOADER.TEST.BATCH_SIZE", "8"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdout", sys.stdout)
        mp.setattr(primitives, "_ATTENTION_IMPL", primitives._ATTENTION_IMPL)
        mp.setattr(clip_model, "_TEXT_PACK_DEFAULT", clip_model._TEXT_PACK_DEFAULT)
        mp.delenv("FMM_TPU_PLATFORM", raising=False)
        for gate in ("FMM_TPU_FUSED", "FMM_TPU_FUSED_BLOCK", "FMM_TPU_FUSED_TRAIN",
                     "FMM_TPU_FUSED_TRAIN_BLOCK", "FMM_TPU_FUSED_TRAIN_DW",
                     "FMM_TPU_FUSED_NBLK"):
            mp.delenv(gate, raising=False)
        fed = port_cli.main(port_cli.build_parser().parse_args(argv))
    assert fed.device.type == "cuda"
    assert fed.nan_stats == {"total_updates": 1, "failed_clients": [], "skipped_rounds": 0}
    steps = sum(c.epoch_stats[0]["steps"] for c in fed.clients)
    tests, batches = 4, len(fed.clients[0].test_loader)
    assert (steps, batches) == (8, 2)
    counts = {k: fn.launches for k, fn in wrappers.items()}
    assert counts == {"K1": 3 * steps + 3 * tests, "K1b": 3 * steps, "K3": 2 * steps,
                      "K4": steps, "K5": 3 * batches * tests}, counts


# -- the base-to-novel trainers' shapes (VPT, IVLP, CoCoOp) ---------------------------


@pytest.mark.parametrize("T,n_ctx", [(205, 8), (199, 2)], ids=["VPT", "IVLP"])
def test_fused_block_train_vision_prompt_rows(gen, T, n_ctx, monkeypatch):
    """K3 at VPT's ``(4, 205, 768)`` (8 vision prompts) and IVLP's ``(4, 199,
    768)`` (2), ViT-B/16's 12 heads of 64 with frozen bf16 weights: the
    output and dx against the plain version at the block's 2**-5, and the
    trailing prompt rows, whose dx is all the prompts' gradient there is,
    held to 2**-5 of their largest value, per image and summed over the
    batch as the shared prompt's gradient. A planted fault that leaves those
    rows of the last image unwritten (zero) in LN1's backward must fail that
    check."""
    B, D, H = 4, 768, 12
    p = _block_params(gen, D, torch.bfloat16, False)
    x = _randn(gen, B, T, D).requires_grad_(True)
    dy = _randn(gen, B, T, D)
    before = (k_block.fused_block_train.launches, k_block.fused_block_train.backward_launches)
    out = k_block.fused_block_train(x, p, H)
    (dx,) = torch.autograd.grad(out, [x], dy)
    torch.cuda.synchronize()
    assert (k_block.fused_block_train.launches,
            k_block.fused_block_train.backward_launches) == (before[0] + 1, before[1] + 1)
    ref_out = k_block.fused_block_train_reference(x, p, H)
    (ref_dx,) = torch.autograd.grad(ref_out, [x], dy)
    _assert_close(out, ref_out, 2 ** -5)
    _assert_close(dx, ref_dx, 2 ** -5)
    tail, ref_tail = dx[:, T - n_ctx:], ref_dx[:, T - n_ctx:]
    assert _within_share_of_max(tail, ref_tail, 2 ** -5)
    assert _within_share_of_max(tail.float().sum(0), ref_tail.float().sum(0), 2 ** -5)

    layernorm_bwd = k_block.CUDA_STEPS.layernorm_bwd

    def tail_unwritten(x2, dxn, dres, gamma, out_dtype, copy_bf16=False):
        dx2, copy, dg, db = layernorm_bwd(x2, dxn, dres, gamma, out_dtype, copy_bf16)
        if out_dtype != torch.float32:  # LN1's, writing the block's dx
            dx2[-n_ctx:] = 0
        return dx2, copy, dg, db

    monkeypatch.setattr(k_block, "CUDA_STEPS",
                        k_block.CUDA_STEPS._replace(layernorm_bwd=tail_unwritten))
    (fault,) = torch.autograd.grad(k_block.fused_block_train(x, p, H), [x], dy)
    assert not _within_share_of_max(fault[:, T - n_ctx:], ref_tail, 2 ** -5)


def test_packed_attention_masked_cocoop_rows(gen):
    """K1 and K1b over CoCoOp's packed text rows at ViT-B/16's text width (8
    heads of 64) and the Caltech101 prompts' 24 tokens, five prompts a
    120-token row under the block-causal mask: the forward over a test
    batch's 100 x 50 = 5,000 prompts (1,000 rows) at K1's 2**-6, and forward
    and d(QKV) over a 16-image step's 800 (160 rows), d(QKV) at K1b's 2**-5
    and each of dQ, dK and dV within 2**-5 of its largest value."""
    H, D = 8, 512
    mask = build_block_causal_mask(5, 24, device="cuda")
    qkv = _randn(gen, 1000, 120, 3 * D)
    _assert_close(k_attn.packed_attention_masked(qkv, mask, H),
                  k_attn.packed_attention_masked_reference(qkv, mask, H), 2 ** -6)
    del qkv
    qkv = _randn(gen, 160, 120, 3 * D).requires_grad_(True)
    g = _randn(gen, 160, 120, D)
    before = k_attn.packed_attention_masked_bwd.launches
    out = k_attn.packed_attention_masked(qkv, mask, H)
    (got,) = torch.autograd.grad(out, [qkv], g)
    torch.cuda.synchronize()
    assert k_attn.packed_attention_masked_bwd.launches == before + 1
    ref_out = k_attn.packed_attention_masked_reference(qkv, mask, H)
    (ref,) = torch.autograd.grad(ref_out, [qkv], g)
    _assert_close(out, ref_out, 2 ** -6)
    _assert_close(got, ref, 2 ** -5)
    assert _each_within_share_of_max(got, ref, D, 2 ** -5)


@pytest.mark.parametrize("T,P", [(77, 1), (32, 4)], ids=["zeroshot-77", "coop-4x32"])
@pytest.mark.parametrize("H", [10, 12], ids=["RN50x4", "RN50x16"])
def test_packed_attention_masked_scaled_resnet_text(gen, H, T, P):
    """K1 and K1b at the scaled ResNets' text widths, 10 heads of 64
    (RN50x4, width 640) and 12 (RN50x16, 768): zero-shot's 77 tokens under
    the causal mask, and CoOp's rows of four 32-token prompts under the
    block-causal mask. The forward at K1's 2**-6, d(QKV) at K1b's 2**-5 and
    each of dQ, dK and dV within 2**-5 of its largest value; the forward
    with its mask dropped (a planted fault) must fail its limit."""
    D = H * 64
    L = T * P
    mask = _forward_mask(gen, T, True) if P == 1 else build_block_causal_mask(P, T, device="cuda")
    qkv = _randn(gen, 48, L, 3 * D).requires_grad_(True)
    g = _randn(gen, 48, L, D)
    out = k_attn.packed_attention_masked(qkv, mask, H)
    (got,) = torch.autograd.grad(out, [qkv], g)
    torch.cuda.synchronize()
    ref_out = k_attn.packed_attention_masked_reference(qkv, mask, H)
    (ref,) = torch.autograd.grad(ref_out, [qkv], g)
    _assert_close(out, ref_out, 2 ** -6)
    _assert_close(got, ref, 2 ** -5)
    assert _each_within_share_of_max(got, ref, D, 2 ** -5)
    fault = k_attn.attention_core_cuda(qkv.detach(), H, None)
    d = (fault.float() - ref_out.float()).abs()
    assert not bool((d <= 2 ** -6 + 2 ** -6 * ref_out.float().abs()).all())


def test_rn50_tower_against_the_cpu_fp32_run(gen, monkeypatch):
    """The RN50 image tower on the card (bf16 policy, cuDNN on channels-last
    views) against the port's fp32 run of the same weights on the CPU, 16
    seeded images, BatchNorms calibrated as chip_smoke.py's
    ``calibrate_batchnorms`` does: each feature row's relative L2 error
    within 2**-5 (``TOL_RN_TOWER``; chip_smoke.py's rn phase reads ~0.0098
    on an H100). The attention pool's mean token replaced by the first
    spatial token (a planted fault, ~0.11 there) must fail that limit."""
    from chip_smoke import TOL_RN_TOWER, calibrate_batchnorms, feature_gap
    from federated_multi_modal_tpu_torch.engine.tree import to_device, tree_map_with_path
    from federated_multi_modal_tpu_torch.models import params, resnet
    from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto

    arch = params.BACKBONE_CONFIGS["RN50"]
    tree = params.init_clip_params(arch, torch.Generator().manual_seed(0), dtype_policy=False)
    calibrate_batchnorms(tree["visual"], arch)
    visual = params.apply_dtype_policy(tree)["visual"]
    images = torch.randn((16, 224, 224, 3), generator=torch.Generator().manual_seed(1))
    ref = encode_image_auto(tree_map_with_path(lambda _, t: t.float(), visual), arch, images)
    on_card = to_device(visual, "cuda")

    def gap():
        with torch.no_grad():
            got = encode_image_auto(on_card, arch, images.cuda(), inference=True)
        assert got.dtype == torch.float32 and got.shape == (16, arch.embed_dim)
        return feature_gap(got, ref)["max_rel_l2"]

    assert gap() <= TOL_RN_TOWER
    monkeypatch.setattr(resnet, "mean_token", lambda tokens: tokens[:, :1])
    assert gap() > TOL_RN_TOWER


# -- the distributed layer: remat and the parallel federated step --------------------


@pytest.mark.parametrize("wgrad", [False, True], ids=["K3", "K4"])
def test_fused_block_train_under_checkpoint(gen, wgrad):
    """K3 and K4 inside ``torch.utils.checkpoint`` (non-reentrant, as
    ``TPU.REMAT`` runs them): the same output and gradients, bit for bit, as
    the same call without it; the forward launches twice (once more where
    the backward recomputes it) and the backward once."""
    B, T, D, H = 3, 200, 128, 2
    p = _block_params(gen, D, torch.float32 if wgrad else torch.bfloat16, wgrad)
    x = _randn(gen, B, T, D).requires_grad_(True)
    dy = _randn(gen, B, T, D)
    kernel = k_block.fused_block_train_dw if wgrad else k_block.fused_block_train
    leaves = [x] + [p[a][b] for a, b in k_block.BLOCK_LEAVES if p[a][b].requires_grad]
    out = kernel(x, p, H)
    got = torch.autograd.grad(out, leaves, dy)
    before = (kernel.launches, kernel.backward_launches)
    out_c = torch.utils.checkpoint.checkpoint(kernel, x, p, H, use_reentrant=False)
    got_c = torch.autograd.grad(out_c, leaves, dy)
    torch.cuda.synchronize()
    assert (kernel.launches - before[0], kernel.backward_launches - before[1]) == (2, 1)
    assert torch.equal(out_c, out)
    for g, r in zip(got_c, got):
        assert torch.equal(g, r)


def test_parallel_fed_step_one_client_on_the_card(gen):
    """``build_parallel_fed_step`` on one card at one client (the mesh
    ``{client: 1, data: 1}``): the plain local step, launching per step the
    routing's kernels (Tiny: K1 and K1b 3, K3 2, K4 1), its loss within
    2**-8 of the same step under ``TPU.ATTENTION_IMPL xla``, which launches
    none; the parameters move and stay finite."""
    from federated_multi_modal_tpu_torch import flagship
    from federated_multi_modal_tpu_torch.engine.tree import leaves as tree_leaves
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.parallel import (
        build_parallel_fed_step,
        make_client_mesh,
        stack_client_trees,
    )

    wrappers = {"K1": k_attn.packed_attention_masked, "K1b": k_attn.packed_attention_masked_bwd,
                "K3": k_block.fused_block_train, "K4": k_block.fused_block_train_dw}
    out = {}
    for impl in ("pallas", "xla"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(primitives, "_ATTENTION_IMPL", impl)
            prog = flagship.build_maple_program("Tiny", depth=3, seed=0, device="cuda")
            mesh = make_client_mesh(1)
            assert mesh.shape == {"client": 1, "data": 1}
            tx = flagship.build_fed_optimizer()
            step = build_parallel_fed_step(prog["loss_fn"], tx, mesh)
            stacked = stack_client_trees([prog["trainable"]])
            opt = stack_client_trees([tx.init(prog["trainable"])])
            batch = {k: v[None] for k, v in
                     flagship.example_batch(prog["arch"], 4, prog["n_cls"], device="cuda").items()}
            for fn in wrappers.values():
                fn.launches = 0
            new, _, losses = step(stacked, prog["frozen"], opt, batch)
            torch.cuda.synchronize()
            out[impl] = (float(losses[0]), {k: fn.launches for k, fn in wrappers.items()})
            assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
            assert not torch.equal(new["prompt_learner"]["ctx"], stacked["prompt_learner"]["ctx"])
    assert out["pallas"][1] == {"K1": 3, "K1b": 3, "K3": 2, "K4": 1}, out["pallas"][1]
    assert not any(out["xla"][1].values()), out["xla"][1]
    assert abs(out["pallas"][0] - out["xla"][0]) <= 2.0 ** -8 * abs(out["xla"][0]), out


# -- ViT-L/14's shapes: width 1024, 16 heads of 64, an MLP of 4096, T = 260 in
#    training and 259 in eval (B T = 133,120 rows at B = 512); ViT-B/32's
#    T = 53. Each case holds the kernel against its plain version and a
#    planted fault against the same check.

L14_D, L14_H, L14_HIDDEN = 1024, 16, 4096
L14_ROWS = 512 * 260
L14_PRODUCTS = {p.key: p for ps in k_block.block_gemm_products(
    L14_ROWS, L14_D, L14_HIDDEN).values() for p in ps}


def _close(got, ref, tol) -> bool:
    """``_assert_close``'s limit as a predicate."""
    d = (got.float() - ref.float()).abs()
    return bool((d <= tol + tol * ref.float().abs()).all())


def _tail_zeroed(t, rows):
    """A copy of ``t`` with its last ``rows`` rows (over the last axis) zero."""
    out = t.detach().clone()
    out.reshape(-1, out.shape[-1])[-rows:] = 0
    return out


@pytest.mark.parametrize("wgrad", [False, True], ids=["K3", "K4"])
def test_vit_l14_train_block(gen, wgrad):
    """K3 and K4 at ViT-L/14's train block (T = 260, 16 heads of 64, hidden
    4096) against their plain versions at ``test_fused_block_train``'s
    limits; dx with the last image's rows unwritten fails them."""
    B, T = 2, 260
    p = _block_params(gen, L14_D, torch.float32 if wgrad else torch.bfloat16, wgrad)
    x = _randn(gen, B, T, L14_D).requires_grad_(True)
    dy = _randn(gen, B, T, L14_D)
    kernel = k_block.fused_block_train_dw if wgrad else k_block.fused_block_train
    plain = (k_block.fused_block_train_dw_reference if wgrad
             else k_block.fused_block_train_reference)
    leaves = [x] + [p[a][b] for a, b in k_block.BLOCK_LEAVES if p[a][b].requires_grad]
    out = kernel(x, p, L14_H)
    got = torch.autograd.grad(out, leaves, dy)
    torch.cuda.synchronize()
    ref_out = plain(x, p, L14_H)
    ref = torch.autograd.grad(ref_out, leaves, dy)
    assert _close(out, ref_out, 2 ** -5) and _close(got[0], ref[0], 2 ** -5)
    assert not _close(_tail_zeroed(got[0], T), ref[0], 2 ** -5)
    for g, r in zip(got[1:], ref[1:]):
        d = (g.float() - r.float()).abs()
        assert bool((d <= 2 ** -5 * (float(r.abs().max()) + r.abs())).all()), float(d.max())


@pytest.mark.parametrize("T", [259, 260])
def test_vit_l14_inference_block(gen, T):
    """K5, and K6a then K6b, at ViT-L/14's eval and train lengths against
    their plain versions at the block's 2**-5; an output with its last
    rows unwritten fails that."""
    B = 2
    p = _block_params(gen, L14_D, torch.bfloat16, False)
    x = _randn(gen, B, T, L14_D)
    got = k_block.fused_block_residual(x, p, L14_H)
    y = k_block.fused_ln_attention_residual(x, p["ln_1"], p["attn"], L14_H)
    out = k_block.fused_ln_mlp_residual(y, p["ln_2"], p["mlp"])
    torch.cuda.synchronize()
    ref = k_block.fused_block_residual_reference(x, p, L14_H)
    ref_y = k_block.fused_ln_attention_residual_reference(x, p["ln_1"], p["attn"], L14_H)
    ref_out = k_block.fused_ln_mlp_residual_reference(y, p["ln_2"], p["mlp"])
    for g, r in ((got, ref), (y, ref_y), (out, ref_out)):
        assert _close(g, r, 2 ** -5)
        assert not _close(_tail_zeroed(g, 64), r, 2 ** -5)


def test_vit_l14_ln_attention(gen):
    """K7 at ViT-L/14's train block against its plain version at
    ``test_fused_ln_attention``'s limits; dx with the last image's rows
    unwritten fails them."""
    B, T = 2, 260
    p = _block_params(gen, L14_D, torch.bfloat16, False)
    x = _randn(gen, B, T, L14_D).requires_grad_(True)
    dy = _randn(gen, B, T, L14_D)
    ln, w, b = p["ln_1"], p["attn"]["w_qkv"], p["attn"]["b_qkv"]
    out = k_block.fused_ln_attention(x, ln, w, b, L14_H)
    got = torch.autograd.grad(out, [x, ln["scale"], ln["bias"]], dy)
    torch.cuda.synchronize()
    ref_out = k_block.fused_ln_attention_reference(x, ln, w, b, L14_H)
    ref = torch.autograd.grad(ref_out, [x, ln["scale"], ln["bias"]], dy)
    assert _close(out, ref_out, 2 ** -5)
    for g, r in zip(got, ref):
        assert _within_share_of_max(g, r, 2 ** -5)
    assert not _within_share_of_max(_tail_zeroed(got[0], T), ref[0], 2 ** -5)


def test_vit_l14_block_group(gen):
    """K9 over ViT-L/14's first group of ``FMM_TPU_FUSED_NBLK=4`` (blocks
    0-3, deep prompts injected before 1-3 with the caption row) at T = 259
    against its plain version at ``test_fused_block_group_residual``'s
    2**-4; an output with its last rows unwritten fails that."""
    B, T = 2, 259
    blocks = [_block_params(gen, L14_D, torch.bfloat16, False) for _ in range(4)]
    flags = (False, True, True, True)
    prompts = [_randn(gen, 2, L14_D, scale=0.3) for f in flags if f]
    extra = _randn(gen, B, 1, L14_D, scale=0.3)
    x = _randn(gen, B, T, L14_D)
    got = k_block.fused_block_group_residual(x, blocks, L14_H, flags, prompts, extra)
    torch.cuda.synchronize()
    ref = k_block.fused_block_group_residual_reference(x, blocks, L14_H, flags, prompts, extra)
    assert _close(got, ref, 2 ** -4)
    assert not _close(_tail_zeroed(got, 64), ref, 2 ** -4)


@pytest.mark.parametrize("key", sorted(L14_PRODUCTS), ids=[
    f"{L14_PRODUCTS[k].name}-{('NN', 'NT', 'TN')[k[0]]}" for k in sorted(L14_PRODUCTS)])
def test_vit_l14_gemm_product(gen, key):
    """Each product of ViT-L/14's train and eval blocks at the B = 512
    step's 133,120 rows (NN and NT against their plain versions at
    ``_gemm_held``'s limits, the weight gradients (TN) at 2**-14 of their
    largest value); the product without its last 64-deep stage of the
    contraction (NN, NT) or over all but the last split's rows (TN) fails
    the same check."""
    prod = L14_PRODUCTS[key]
    M, N, K = prod.rows, prod.cols, prod.k
    if prod.layout == k_block._TN:
        a, b = _randn(gen, K, M), _randn(gen, K, N)
        got = k_block.gemm_tn_cuda(a, b)
        torch.cuda.synchronize()
        ref = k_block.gemm_tn_reference(a, b)
        assert _within_share_of_max(got, ref, 2 ** -14)
        splits, k_per = k_block.tn_split_plan(
            M, N, K, torch.cuda.get_device_properties(0).multi_processor_count)
        rows = (splits - 1) * k_per if splits > 1 else K - 64
        fault = k_block.gemm_tn_cuda(a[:rows].contiguous(), b[:rows].contiguous())
        assert not _within_share_of_max(fault, ref, 2 ** -14)
        return
    a, w, kw = _gemm_case(gen, prod.layout, prod.code, M, N, K)
    got = k_block.gemm_epilogue_cuda(a, w, **kw)
    torch.cuda.synchronize()
    ref = k_block.gemm_epilogue_reference(a, w, **kw)
    assert _gemm_held(got, ref)
    cut = w[:, :K - 64] if prod.layout == k_block._NT else w[:K - 64]
    dropped = k_block.gemm_epilogue_cuda(a[:, :K - 64].contiguous(), cut.contiguous(), **kw)
    assert not _gemm_held(dropped, ref)


@pytest.mark.parametrize("instance", ["LN2", "LN1", "P2"])
def test_vit_l14_layernorm_bwd_rows(gen, instance):
    """LN2's and LN1's instance (with d gamma and d beta partials) and the
    one without partials at ViT-L/14's 133,120 rows of 1024, against the
    plain version at ``test_layernorm_bwd_rows_instances``' limits; dx with
    its last 256 rows unwritten fails the share of its largest value."""
    args, partials = _ln_bwd_case(gen, instance, L14_ROWS, D=L14_D)
    got = k_block.layernorm_bwd_rows_cuda(*args, param_grads=partials)
    torch.cuda.synchronize()
    ref = k_block.layernorm_bwd_rows_reference(*args)
    if not partials:
        assert got[2] is None and got[3] is None
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None:
            continue
        bf = g.dtype == torch.bfloat16
        _assert_close(g, r, 2 ** -7 if bf else 1e-4 if i == 0 else 1e-4 * L14_ROWS ** 0.5)
        assert _within_share_of_max(g, r, 2 ** -7 if bf else 2 ** -14), i
    share = 2 ** -7 if got[0].dtype == torch.bfloat16 else 2 ** -14
    assert not _within_share_of_max(_tail_zeroed(got[0], 256), ref[0], share)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vit_l14_layernorm_rows(gen, dtype):
    """The LayerNorm forward over ViT-L/14's 133,120 rows of 1024 (LN1's
    bf16 input, LN2's fp32 one) against its plain version at 2**-7; its
    last rows unwritten fail that."""
    x = _randn(gen, L14_ROWS, L14_D, dtype=dtype, scale=3.0) + 1.0
    gamma = _randn(gen, L14_D, dtype=torch.float32) * 0.1 + 1
    beta = _randn(gen, L14_D, dtype=torch.float32, scale=0.1)
    got = k_block.layernorm_rows_cuda(x, gamma, beta, torch.bfloat16)
    torch.cuda.synchronize()
    ref = k_block.layernorm_rows_reference(x, gamma, beta, torch.bfloat16)
    assert _close(got, ref, 2 ** -7)
    assert not _close(_tail_zeroed(got, 256), ref, 2 ** -7)


@pytest.mark.parametrize("T", [53, 259, 260])
def test_vit_l14_attention(gen, T):
    """The attention forward and backward at 16 heads of 64 (ViT-L/14's
    vision rows; T = 53 is ViT-B/32's train length at its 12 heads' head
    width): the forward at 2**-6 elementwise and of its largest value,
    d(QKV) at 2**-5 and each of dQ, dK and dV at 2**-5 of its largest
    value. Planted faults: the forward with its last key tile dropped (the
    last 8 keys where T is one tile), dK and dV of the last key tile scaled
    by exp(-1/8)."""
    B = 4
    D = L14_H * 64
    qkv = _randn(gen, B, T, 3 * D)
    g = _randn(gen, B, T, D)
    out = k_attn.attention_core_cuda(qkv, L14_H)
    dqkv = k_attn.attention_core_bwd_cuda(qkv, g, L14_H)
    torch.cuda.synchronize()
    ref_out = k_attn.attention_core_reference(qkv, L14_H)
    ref = k_attn.attention_core_bwd_reference(qkv, g, L14_H)
    assert _close(out, ref_out, 2 ** -6) and _within_share_of_max(out, ref_out, 2 ** -6)
    assert _close(dqkv, ref, 2 ** -5) and _each_within_share_of_max(dqkv, ref, D, 2 ** -5)
    last = (T - 1) // 64 * 64
    dropped = k_attn.attention_core_cuda(qkv, L14_H, valid_T=last if last else T - 8)
    assert not _within_share_of_max(dropped, ref_out, 2 ** -6)
    fault = dqkv.clone()
    fault[:, last:, D:] *= math.exp(-1 / 8)
    assert not _each_within_share_of_max(fault, ref, D, 2 ** -5)


# -- the port's bench: --dispatch scan as a captured CUDA graph -------------------

BENCH_TINY = ["--backbone", "Tiny", "--depth", "3", "--batch-size", "8", "--n-cls", "10",
              "--steps", "3"]


def test_bench_replay_equals_eager(gen):
    """One replay of the bench's captured train step (Tiny, batch 8, captions,
    crops drawn on the card from a generator registered with the graph)
    equals the eager step from the same state with the same draws, bit for
    bit; the captured step launches the routing's kernels, and the state is
    put back."""
    from federated_multi_modal_tpu_torch import bench
    from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.ops.preprocess import sample_rrc_boxes_torch
    from federated_multi_modal_tpu_torch.tokenizer import tokenize

    B = 8
    prog = build_maple_program("Tiny", classnames=[f"class {i}" for i in range(10)], depth=3)
    tx = build_optimizer(lr=0.0026, clip=1.0)
    one_step = bench.make_one_step(prog, tx, use_captions=True)
    canvas = torch.randint(0, 255, (B, 256, 256, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda", dtype=torch.int32)
    captions = torch.from_numpy(tokenize(["a satellite photo of a scene"] * B)).cuda()
    draws = torch.Generator(device="cuda").manual_seed(0)

    def apply(state, drawn, run):
        tr, opt, loss = one_step(state[0], prog["frozen"], state[1], canvas, *drawn, labels,
                                 captions, run)
        return (tr, opt), loss

    state = (prog["trainable"], tx.init(prog["trainable"]))
    before = bench._clone(state)
    held, launches = bench.replay_vs_eager(
        apply, state, lambda: sample_rrc_boxes_torch(draws, B), (draws,))
    assert held["bit_for_bit"], held
    assert launches == {"K1 packed_attention_masked": 3, "K1b packed_attention_masked_bwd": 3,
                        "K3 fused_block_train": 2, "K3 fused_block_train (backward)": 2,
                        "K4 fused_block_train_dw": 1, "K4 fused_block_train_dw (backward)": 1}
    assert bench.held_bitwise(state, before)["bit_for_bit"]


@pytest.mark.parametrize("mode", [
    ["--no-secondary"], ["--mode", "eval"], ["--mode", "fed-step"], ["--mode", "cocoop"],
    ["--mode", "cocoop", "--cocoop-loop"],
], ids=["train", "eval", "fed-step", "cocoop", "cocoop-loop"])
def test_bench_scan_tiny_on_the_card(gen, capsys, monkeypatch, mode):
    """``--dispatch scan`` (the default) at Tiny through the bench's ``main``:
    exit 0, one line naming the card and its power limit, and the replayed
    step equal to the eager one bit for bit."""
    import json

    from federated_multi_modal_tpu_torch import bench
    from federated_multi_modal_tpu_torch.models import clip_model
    from federated_multi_modal_tpu_torch.ops import primitives

    monkeypatch.setattr(primitives, "_ATTENTION_IMPL", primitives._ATTENTION_IMPL)
    monkeypatch.setattr(clip_model, "_TEXT_PACK_DEFAULT", clip_model._TEXT_PACK_DEFAULT)
    assert bench.main(BENCH_TINY + mode) == 0
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    rec = json.loads(lines[0])
    assert rec["device"] == torch.cuda.get_device_name(0) and rec["power_limit_w"] > 0
    replay = [json.loads(ln.split(": ", 1)[1]) for ln in err.splitlines()
              if ln.startswith("# replay_vs_eager: ")]
    assert len(replay) == 1 and replay[0]["bit_for_bit"], replay


def test_bench_capture_of_a_host_read_fails_loudly(gen):
    """A step that reads a device tensor on the host cannot be captured:
    ``capture_step`` raises saying so (in a child process, whose CUDA
    context the failed capture leaves behind)."""
    import os
    import subprocess
    import sys

    script = (
        "import torch\n"
        "from federated_multi_modal_tpu_torch import bench\n"
        "x = torch.ones(4, device='cuda')\n"
        "def step(state, run):\n"
        "    y = state[0] * 2\n"
        "    if y.sum().item() > 0:\n"
        "        y = y + 1\n"
        "    return (y,), y.sum()\n"
        "try:\n"
        "    bench.capture_step(step, (x,))\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=root)
    assert "raised: --dispatch scan: the step cannot be captured" in proc.stdout, \
        proc.stdout + proc.stderr[-2000:]


# -- several devices in one process: two replicas of the one card ------------------

BENCH_TINY_LAUNCHES = {"K1 packed_attention_masked": 3, "K1b packed_attention_masked_bwd": 3,
                       "K3 fused_block_train": 2, "K3 fused_block_train (backward)": 2,
                       "K4 fused_block_train_dw": 1, "K4 fused_block_train_dw (backward)": 1}


@pytest.mark.parametrize("mode", [["--no-secondary"], ["--mode", "fed-step"]],
                         ids=["train", "fed-step"])
def test_bench_scan_over_a_card_named_twice(gen, capsys, monkeypatch, mode):
    """``--dispatch scan`` over ``[cuda:0, cuda:0]`` at Tiny through the
    bench's ``main``: the train batch split over the two replicas, the
    fed-step's two clients one a replica, each replica a graph of its own on
    its own stream; the replayed step equals the eager one bit for bit, the
    captured step launches twice the one-device routing's kernels, and the
    line says ``devices=2``."""
    import json

    from federated_multi_modal_tpu_torch import bench
    from federated_multi_modal_tpu_torch.models import clip_model
    from federated_multi_modal_tpu_torch.ops import primitives

    monkeypatch.setattr(primitives, "_ATTENTION_IMPL", primitives._ATTENTION_IMPL)
    monkeypatch.setattr(clip_model, "_TEXT_PACK_DEFAULT", clip_model._TEXT_PACK_DEFAULT)
    card = torch.device("cuda", 0)
    monkeypatch.setattr(bench, "visible_devices", lambda device: [card, card])
    assert bench.main(BENCH_TINY + mode) == 0
    out, err = capsys.readouterr()
    assert len([ln for ln in out.splitlines() if ln.startswith("{")]) == 1, out
    records = {ln[2:].split(": ", 1)[0]: ln.split(": ", 1)[1] for ln in err.splitlines()
               if ln.startswith(("# replay_vs_eager: ", "# launches: "))}
    replay = json.loads(records["replay_vs_eager"])
    assert replay["bit_for_bit"], replay
    assert json.loads(records["launches"]) == {k: 2 * v for k, v in BENCH_TINY_LAUNCHES.items()}
    assert "devices=2" in err, err[-2000:]


def test_replicas_mean_without_its_event_reads_a_stale_shard(gen, monkeypatch):
    """Two replicas of the card, each sleeping on its stream before it
    writes its shard: with the home stream's wait for the replicas' events
    (``mesh._join``) the mean is right, eagerly and replayed; with the wait
    taken out (a planted fault) the mean reads the shards the last call or
    replay left, and differs."""
    from federated_multi_modal_tpu_torch import bench
    from federated_multi_modal_tpu_torch.parallel import mesh

    card = torch.device("cuda", 0)

    def work(d, v):
        torch.cuda._sleep(100_000_000)
        return v * 2

    def mean(v, run=mesh.run_replicas):
        return mesh.mean_over_devices(run(work, [card, card], [v, v + 1], card), card)

    def step(state, run):
        y = mean(state[0], run)
        return (y,), y.sum()

    x = torch.ones(1 << 16, device=card)
    assert torch.equal(mean(x), torch.full_like(x, 3.0))
    state = (x.clone(),)
    graph, _, _ = bench.capture_step(step, state)
    state[0].fill_(1.0)
    graph.replay()
    assert torch.equal(state[0], torch.full_like(x, 3.0))
    monkeypatch.setattr(mesh, "_join", lambda stream, home: None)
    stale = mean(x * 5)
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(stale, torch.full_like(x, 11.0))
    assert not torch.equal(state[0], torch.full_like(x, 7.0))


def test_capture_of_a_replica_host_read_fails_loudly(gen):
    """A step over two replicas whose replica reads a device tensor on the
    host cannot be captured: ``capture_step`` raises saying so rather than
    running the step eagerly (in a child process, whose CUDA context the
    failed capture leaves behind)."""
    import os
    import subprocess
    import sys

    script = (
        "import torch\n"
        "from federated_multi_modal_tpu_torch import bench\n"
        "from federated_multi_modal_tpu_torch.parallel import mesh\n"
        "card = torch.device('cuda', 0)\n"
        "x = torch.ones(4, device=card)\n"
        "def work(d, v):\n"
        "    y = v * 2\n"
        "    if y.sum().item() > 0:\n"
        "        y = y + 1\n"
        "    return y\n"
        "def step(state, run):\n"
        "    y = mesh.mean_over_devices(run(work, [card, card], [state[0], state[0]], card),\n"
        "                               card)\n"
        "    return (y,), y.sum()\n"
        "try:\n"
        "    bench.capture_step(step, (x,))\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=root)
    assert "raised: --dispatch scan: the step cannot be captured" in proc.stdout, \
        proc.stdout + proc.stderr[-2000:]


def test_captured_step_marks_its_spans_in_every_replay(gen, monkeypatch):
    """A MaPLe train step (Tiny, batch 8, captions, the crop drawn on the
    card, the engine's step with its clip and SGD) captured by
    ``capture_step``: the spans' markers launched during the capture nest as
    the program's spans do, and three replays under ``torch.profiler`` run
    every marker once each, in capture order, under names that decode to
    ``SPANS``."""
    import re

    from test_torch_spans import TRAIN_TREE, _flat

    from federated_multi_modal_tpu_torch import bench
    from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
    from federated_multi_modal_tpu_torch.engine.trainer import make_train_step_with_aux
    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.tokenizer import tokenize
    from federated_multi_modal_tpu_torch.utils import profiling

    B = 8
    prog = build_maple_program("Tiny", classnames=[f"class {i}" for i in range(10)], depth=3)
    tx = build_optimizer(lr=0.0026, clip=1.0)
    engine_step = make_train_step_with_aux(prog["loss_fn"], tx)
    canvas = torch.randint(0, 255, (B, 256, 256, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (B,), generator=gen, device="cuda", dtype=torch.int32)
    captions = torch.from_numpy(tokenize(["a satellite photo of a scene"] * B)).cuda()
    draws = torch.Generator(device="cuda").manual_seed(0)

    def step(state, run):
        boxes, flips = sample_rrc_boxes_torch(draws, B)
        batch = {"image": crop_resize_flip_normalize(canvas, boxes, flips,
                                                     out_size=prog["arch"].image_resolution),
                 "label": labels, "caption_tokens": captions}
        tr, opt, loss, _, _ = engine_step(state[0], prog["frozen"], state[1], batch)
        return (tr, opt), loss

    captured = []
    launch = profiling._launch_marker

    def record(span_id, opening):
        captured.append((profiling.SPANS[span_id], opening))
        launch(span_id, opening)

    monkeypatch.setattr(profiling, "_launch_marker", record)
    graph, _, _ = bench.capture_step(step, (prog["trainable"], tx.init(prog["trainable"])),
                                     (draws,))
    monkeypatch.setattr(profiling, "_launch_marker", launch)
    assert captured == _flat([("step", TRAIN_TREE)])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    pattern = re.compile(r"span_marker<(\d+), (true|false)>")
    cuda = torch.autograd.DeviceType.CUDA
    seen = sorted((e.start_ns(), pattern.search(e.name())) for e in
                  prof.profiler.kineto_results.events()
                  if e.device_type() == cuda and pattern.search(e.name()))
    got = [(profiling.SPANS[int(m.group(1))], m.group(2) == "true") for _, m in seen]
    assert got == captured * 3
    host = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "replay" in host
