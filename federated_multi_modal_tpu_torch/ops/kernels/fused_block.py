"""Whole pre-LN transformer block: the port of the TPU kernels
``federated_multi_modal_tpu/ops/pallas/fused_block.py::fused_block_residual``
(``pl.pallas_call`` in ``_fused_block_group_jit`` with one block), which runs
every vision block of the eval path ``encode_image(inference=True)``, and
``fused_block_train`` / ``fused_block_train_dw`` (``_fbt_fwd_save`` and
``_fbt_bwd``), which run the vision blocks of the train step (see "the
training block" below).

The TPU kernel keeps all ~15 MB of a ViT-B/16 block's weights resident in
VMEM and carries the attention-half output ``y`` in fp32 between the two
halves. A Hopper SM has 227 KB of shared memory, so on the card the block is
a short sequence of hand-written kernels behind one function:

    LN1 (layernorm_rows) -> QKV + b (gemm_epilogue) -> attention
    (attention_core) -> out-proj + b + x, fp32 y (gemm_epilogue) -> LN2
    (layernorm_rows) -> fc + b, QuickGELU (gemm_epilogue) -> proj + b + y
    (gemm_epilogue)

``y`` makes one fp32 round trip through device memory, so the numbers match
the TPU kernel's fp32 ``y`` (``_block_body32``).

Bound on the H100: operations. At ViT-B/16 eval width, x ``(512, 199, 768)``
bf16 and hidden 3072, the four products are ~1.44 TFLOP and attention
~0.06 TFLOP: ~1.52 ms at 989 TFLOP/s, against ~0.1 ms to read x and the
weights and write the output. The design keeps every product on the tensor
cores with fp32 accumulation and fuses bias, QuickGELU, residual and the
output cast into the product's epilogue, so the only extra traffic is the
sequence's intermediates (qkv, attention output, y, the LN outputs and the
hidden activation), each written once and read once.

On a CUDA tensor :func:`fused_block_residual` launches those kernels; on a
CPU tensor it runs :func:`fused_block_residual_reference`, the same
sequence with the plain PyTorch version of each step. It has no gradient,
like the TPU kernel. The training block's backward adds three kernels:
``attention_core_bwd``, ``layernorm_bwd_rows`` (with ``column_sum``) and
the transposed layouts and gradient epilogues of ``gemm_epilogue``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels.attention import (
    attention_core_bwd_cuda,
    attention_core_bwd_reference,
    attention_core_cuda,
    attention_core_reference,
    full_fp32_products,
)


# -- the steps: plain versions -------------------------------------------


def layernorm_rows_reference(x, gamma, beta, out_dtype, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 mean, variance, gamma and beta,
    output in ``out_dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(out_dtype)


def _quick_gelu_grad(h):
    sig = torch.sigmoid(1.702 * h)
    return sig * (1.0 + 1.702 * h * (1.0 - sig))


def gemm_epilogue_reference(a, w, bias=None, residual=None, gelu=False,
                            out_dtype=None, trans_w=False, dgelu_of=None,
                            pre_dtype=None):
    """``a @ w`` (``a @ w^T`` with ``trans_w``) as fp32 products of the
    storage dtype's values, then ``+ bias`` (rounded to the storage dtype),
    the pre-activation copy (``pre_dtype``), QuickGELU, ``* QuickGELU'(
    dgelu_of)``, ``+ residual``, cast to ``out_dtype``. TF32 is off for the
    fp32 product (``full_fp32_products``). Returns ``out``, or ``(out,
    pre)`` with ``pre_dtype``."""
    wt = w.to(a.dtype).float()
    with full_fp32_products():
        acc = torch.matmul(a.float(), wt.T if trans_w else wt)
    if bias is not None:
        acc = acc + bias.to(a.dtype).float()
    pre = None if pre_dtype is None else acc.to(pre_dtype)
    if gelu:
        acc = acc * torch.sigmoid(1.702 * acc)
    if dgelu_of is not None:
        acc = acc * _quick_gelu_grad(dgelu_of.float())
    if residual is not None:
        acc = acc + residual.float()
    out = acc.to(out_dtype or a.dtype)
    return out if pre_dtype is None else (out, pre)


def gemm_tn_reference(a, b):
    """``a^T @ b`` over the rows of ``a (K, M)`` and ``b (K, N)``: fp32
    products of their values, fp32 ``(M, N)`` result (a weight gradient)."""
    with full_fp32_products():
        return torch.matmul(a.float().T, b.float())


def column_sum_reference(x):
    """fp32 sums over the rows of ``x (rows, N)`` (a bias gradient)."""
    return x.float().sum(0)


def layernorm_bwd_rows_reference(x, dxn, dres, gamma, out_dtype,
                                 copy_bf16: bool = False, eps: float = 1e-5):
    """Backward of :func:`layernorm_rows_reference` plus the residual
    branch: with the fp32 moments of ``x`` recomputed and ``gv = dxn *
    gamma``, ``dx = dres + rstd * (gv - mean(gv) - x^ * mean(gv * x^))`` in
    ``out_dtype``. Returns ``(dx, dx in bf16 or None, d gamma, d beta)``,
    the last two fp32 column sums of ``dxn * x^`` and ``dxn``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxn = dxn.float()
    gv = dxn * gamma.float()
    m1 = gv.mean(-1, keepdim=True)
    m2 = (gv * xhat).mean(-1, keepdim=True)
    dx = dres.float() + rstd * (gv - m1 - xhat * m2)
    copy = dx.to(torch.bfloat16) if copy_bf16 else None
    return dx.to(out_dtype), copy, (dxn * xhat).sum(0), dxn.sum(0)


# -- the steps: CUDA kernels -----------------------------------------------


def _check_cuda(name, t, dtypes):
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs a contiguous 16-byte aligned CUDA tensor of "
            f"{dtypes}, got {t.dtype} on {t.device}")


_BF16_F32 = (torch.bfloat16, torch.float32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _is_f32(t):
    return int(t is not None and t.dtype == torch.float32)


def layernorm_rows_cuda(x, gamma, beta, out_dtype, eps: float = 1e-5):
    """Launch ``layernorm_rows.cu``: ``x (rows, D)`` bf16 or fp32 -> bf16."""
    _check_cuda("layernorm_rows x", x, _BF16_F32)
    if out_dtype != torch.bfloat16:
        raise ValueError("layernorm_rows writes bf16")
    rows, D = x.shape
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    out = torch.empty(rows, D, dtype=torch.bfloat16, device=x.device)
    _build.launch("fmm_layernorm_rows", x.data_ptr(),
                  int(x.dtype == torch.float32), gamma.data_ptr(),
                  beta.data_ptr(), out.data_ptr(), rows, D, eps)
    return out


_NN, _NT, _TN = 0, 1, 2
_BK = 32  # the kernel's K step; a split of the contraction is a multiple


def _gemm_launch(a, w, layout, M, N, K, out, splits=1, k_per_split=None,
                 bias=None, pre=None, gelu=False, dgelu_of=None,
                 residual=None):
    _build.launch(
        "fmm_gemm_epilogue", a.data_ptr(), w.data_ptr(), layout, M, N, K,
        splits, k_per_split or -(-K // _BK) * _BK, _ptr(bias), _ptr(pre),
        _is_f32(pre), int(gelu), _ptr(dgelu_of), _is_f32(dgelu_of),
        _ptr(residual), _is_f32(residual), out.data_ptr(), _is_f32(out))


def gemm_epilogue_cuda(a, w, bias=None, residual=None, gelu=False,
                       out_dtype=None, trans_w=False, dgelu_of=None,
                       pre_dtype=None):
    """Launch ``gemm_epilogue.cu``: ``a (M, K) @ w (K, N)`` (or ``@ w^T``
    for ``w (N, K)`` with ``trans_w``) in bf16 with fp32 accumulation and
    the fused epilogue of :func:`gemm_epilogue_reference`."""
    out_dtype = out_dtype or a.dtype
    w = w.to(torch.bfloat16).contiguous()
    _check_cuda("gemm_epilogue a", a, (torch.bfloat16,))
    _check_cuda("gemm_epilogue w", w, (torch.bfloat16,))
    M, K = a.shape
    N, Kw = w.shape if trans_w else w.shape[::-1]
    if Kw != K or N % 8 or K % 8:
        raise ValueError(f"gemm_epilogue: a {tuple(a.shape)} @ w "
                         f"{tuple(w.shape)} (trans_w={trans_w}) needs matching "
                         "K, N % 8 == 0 and K % 8 == 0")
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
        _check_cuda("gemm_epilogue bias", bias, (torch.bfloat16,))
    for name, t in (("residual", residual), ("dgelu_of", dgelu_of)):
        if t is not None:
            _check_cuda(f"gemm_epilogue {name}", t, _BF16_F32)
            if t.shape != (M, N):
                raise ValueError(f"gemm_epilogue: {name} must be ({M}, {N})")
    if out_dtype not in _BF16_F32 or pre_dtype not in (None, *_BF16_F32):
        raise ValueError(f"gemm_epilogue writes bf16 or fp32, not {out_dtype}")
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    pre = None if pre_dtype is None else torch.empty(M, N, dtype=pre_dtype,
                                                     device=a.device)
    _gemm_launch(a, w, _NT if trans_w else _NN, M, N, K, out, bias=bias,
                 pre=pre, gelu=gelu, dgelu_of=dgelu_of, residual=residual)
    return out if pre is None else (out, pre)


def _row_splits(rows, blocks_across, target_blocks=1024):
    """Split ``rows`` into parts of equal length (the last may be shorter)
    so that ``blocks_across * parts`` comes near ``target_blocks``."""
    parts = max(1, min(rows, -(-target_blocks // max(blocks_across, 1))))
    per = -(-rows // parts)
    return -(-rows // per), per


def column_sum_cuda(x):
    """Launch ``column_sum`` (``layernorm_bwd_rows.cu``): fp32 sums over the
    rows of ``x (rows, N)``, bf16 or fp32; rows split over blocks, then the
    partial sums added by a second launch."""
    _check_cuda("column_sum x", x, _BF16_F32)
    rows, N = x.shape
    splits, per = _row_splits(rows, -(-N // 256))
    out = torch.empty(splits, N, dtype=torch.float32, device=x.device)
    _build.launch("fmm_column_sum", x.data_ptr(), _is_f32(x), out.data_ptr(),
                  rows, N, splits, per)
    if splits == 1:
        return out[0]
    total = torch.empty(1, N, dtype=torch.float32, device=x.device)
    _build.launch("fmm_column_sum", out.data_ptr(), 1, total.data_ptr(),
                  splits, N, 1, splits)
    return total[0]


def gemm_tn_cuda(a, b):
    """Launch ``gemm_epilogue.cu`` in its TN layout: ``a^T @ b`` for bf16
    ``a (K, M)`` and ``b (K, N)`` -> fp32 ``(M, N)``. A long contraction (the
    batch rows) is split over blocks into fp32 partial products, which
    :func:`column_sum_cuda` adds up."""
    _check_cuda("gemm_tn a", a, (torch.bfloat16,))
    _check_cuda("gemm_tn b", b, (torch.bfloat16,))
    K, M = a.shape
    Kb, N = b.shape
    if Kb != K or M % 8 or N % 8:
        raise ValueError(f"gemm_tn: a {tuple(a.shape)}^T @ b {tuple(b.shape)} "
                         "needs matching K, M % 8 == 0 and N % 8 == 0")
    tiles = -(-M // 128) * -(-N // 128)
    want = max(1, min(-(-264 // tiles), -(-K // _BK)))
    k_per = -(-K // (want * _BK)) * _BK
    splits = -(-K // k_per)
    out = torch.empty(splits, M, N, dtype=torch.float32, device=a.device)
    _gemm_launch(a, b, _TN, M, N, K, out, splits=splits, k_per_split=k_per)
    if splits == 1:
        return out[0]
    return column_sum_cuda(out.reshape(splits, M * N)).reshape(M, N)


_LN_ROWS_PER_BLOCK = 256


def layernorm_bwd_rows_cuda(x, dxn, dres, gamma, out_dtype,
                            copy_bf16: bool = False, eps: float = 1e-5):
    """Launch ``layernorm_bwd_rows.cu`` on ``x (rows, D)`` (bf16 or fp32),
    fp32 ``dxn`` and ``dres`` (bf16 or fp32); the column sums of d gamma
    and d beta come from the per-block partials through
    :func:`column_sum_cuda`. Same returns as the plain version."""
    _check_cuda("layernorm_bwd_rows x", x, _BF16_F32)
    _check_cuda("layernorm_bwd_rows dxn", dxn, (torch.float32,))
    _check_cuda("layernorm_bwd_rows dres", dres, _BF16_F32)
    rows, D = x.shape
    if dxn.shape != (rows, D) or dres.shape != (rows, D) or D > 1024:
        raise ValueError(f"layernorm_bwd_rows: dxn and dres must be ({rows}, "
                         f"{D}) with D <= 1024")
    if out_dtype not in _BF16_F32:
        raise ValueError(f"layernorm_bwd_rows writes bf16 or fp32, not {out_dtype}")
    gamma = gamma.to(torch.float32).contiguous()
    dx = torch.empty(rows, D, dtype=out_dtype, device=x.device)
    copy = (torch.empty(rows, D, dtype=torch.bfloat16, device=x.device)
            if copy_bf16 else None)
    blocks = -(-rows // _LN_ROWS_PER_BLOCK)
    partial = torch.empty(blocks, 2 * D, dtype=torch.float32, device=x.device)
    _build.launch("fmm_layernorm_bwd_rows", x.data_ptr(), _is_f32(x),
                  dxn.data_ptr(), dres.data_ptr(), _is_f32(dres),
                  gamma.data_ptr(), dx.data_ptr(), _is_f32(dx), _ptr(copy),
                  partial.data_ptr(), rows, D, _LN_ROWS_PER_BLOCK, eps)
    sums = column_sum_cuda(partial)
    return dx, copy, sums[:D], sums[D:]


# -- the block -------------------------------------------------------------


def _block(x, p, n_head, layernorm, gemm, attention):
    """The whole-block sequence of ``_block_body32`` over given steps."""
    B, T, D = x.shape
    dt = x.dtype
    x2 = x.reshape(B * T, D)
    attn, mlp = p["attn"], p["mlp"]
    xn = layernorm(x2, p["ln_1"]["scale"], p["ln_1"]["bias"], dt)
    qkv = gemm(xn, attn["w_qkv"], attn["b_qkv"], out_dtype=dt)
    a = attention(qkv.reshape(B, T, 3 * D), n_head).reshape(B * T, D)
    y = gemm(a, attn["w_out"], attn["b_out"], residual=x2,
             out_dtype=torch.float32)
    xn2 = layernorm(y, p["ln_2"]["scale"], p["ln_2"]["bias"], dt)
    h = gemm(xn2, mlp["w_fc"], mlp["b_fc"], gelu=True, out_dtype=dt)
    out = gemm(h, mlp["w_proj"], mlp["b_proj"], residual=y, out_dtype=dt)
    return out.reshape(B, T, D)


def fused_block_residual_reference(x, p, n_head: int):
    """Plain version of :func:`fused_block_residual`."""
    return _block(x, p, n_head, layernorm_rows_reference,
                  gemm_epilogue_reference, attention_core_reference)


def fused_block_residual(x, p, n_head: int):
    """``x + attn(ln_1(x))`` then ``y + mlp(ln_2(y))`` for one pre-LN block
    (``p`` holds ``ln_1, attn{w_qkv, b_qkv, w_out, b_out}, ln_2,
    mlp{w_fc, b_fc, w_proj, b_proj}`` in the JAX package's layout)."""
    if x.requires_grad:
        raise NotImplementedError(
            "fused_block_residual is forward-only, like the TPU kernel")
    if x.device.type == "cpu":
        return fused_block_residual_reference(x, p, n_head)
    out = _block(x.contiguous(), p, n_head, layernorm_rows_cuda,
                 gemm_epilogue_cuda, attention_core_cuda)
    fused_block_residual.launches += 1
    return out


fused_block_residual.launches = 0


def fused_block_eligible(B, T, D, n_head, hidden, attn_mask) -> bool:
    """The JAX package's routing predicate for the whole-block kernel
    (``fused_block_eligible``: mask-free, lane-aligned width, 4x MLP)."""
    return (attn_mask is None and D % 128 == 0 and D % n_head == 0
            and (D // n_head) % 8 == 0 and hidden == 4 * D)


# -- the training block ----------------------------------------------------
#
# The port of the TPU whole-block TRAIN kernels of
# ``federated_multi_modal_tpu/ops/pallas/fused_block.py``:
#
# * ``fused_block_train`` (K3: ``_fbt_fwd_save`` and ``_fbt_bwd`` in "save"
#   mode) for blocks whose non-LN weights are frozen: exact dx and both
#   LayerNorms' gradients, no weight gradients;
# * ``fused_block_train_dw`` (K4: the same two calls with ``wgrad=True`` and
#   ``save_h=False``) for trainable blocks: every gradient, dW and db summed
#   in fp32.
#
# The forward is the inference block's sequence that also saves ``qkv`` and,
# for K3, the fc pre-activation ``h`` (bf16; QuickGELU reads the fp32 h). The
# backward recomputes the attention output ``a`` and the fp32 ``y`` from the
# saved ``qkv`` (``_train_bwd_kernel``'s "save" mode), K4 also LN1's output
# and, in fp32, ``h``. K3's QuickGELU' reads the saved bf16 ``h`` and K4's the
# recomputed fp32 one, as the TPU kernels do. The bias gradients sum the bf16
# ``dh`` and ``dqkv`` but the fp32 ``dout`` and ``dyh``
# (``_train_bwd_kernel`` :1099-1106, 1128, 1179).
#
# Bound on the H100: operations. At ViT-B/16 train width, x ``(512, 200,
# 768)`` bf16 and hidden 3072, the forward's products are ~1.45 TFLOP plus
# ~0.06 of attention, the backward's activation gradients as many again plus
# ~0.13 of attention (recomputation not counted), and K4's weight gradients
# another ~1.45: ~3.1 ms (K3) and ~4.5 ms (K4) at 989 TFLOP/s, against
# ~0.3 ms of memory traffic for x, dy, dx and the weights.


class BlockSteps(NamedTuple):
    """The steps a block runs: the CUDA kernels or their plain versions."""

    layernorm: Callable
    gemm: Callable
    attention: Callable
    attention_bwd: Callable
    layernorm_bwd: Callable
    gemm_tn: Callable
    column_sum: Callable


PLAIN_STEPS = BlockSteps(
    layernorm_rows_reference, gemm_epilogue_reference, attention_core_reference,
    attention_core_bwd_reference, layernorm_bwd_rows_reference,
    gemm_tn_reference, column_sum_reference)
CUDA_STEPS = BlockSteps(
    layernorm_rows_cuda, gemm_epilogue_cuda, attention_core_cuda,
    attention_core_bwd_cuda, layernorm_bwd_rows_cuda, gemm_tn_cuda,
    column_sum_cuda)

# The block's leaves in the JAX package's layout, LayerNorms first.
LN_LEAVES = (("ln_1", "scale"), ("ln_1", "bias"), ("ln_2", "scale"),
             ("ln_2", "bias"))
WEIGHT_LEAVES = (("attn", "w_qkv"), ("attn", "b_qkv"), ("attn", "w_out"),
                 ("attn", "b_out"), ("mlp", "w_fc"), ("mlp", "b_fc"),
                 ("mlp", "w_proj"), ("mlp", "b_proj"))
BLOCK_LEAVES = LN_LEAVES + WEIGHT_LEAVES


def _leaves(p):
    return [p[a][b] for a, b in BLOCK_LEAVES]


def _tree(leaves):
    p = {}
    for (a, b), t in zip(BLOCK_LEAVES, leaves):
        p.setdefault(a, {})[b] = t
    return p


def block_train_forward(x, p, n_head: int, steps: BlockSteps, save_h: bool):
    """The block's forward with its residuals: ``(out, qkv, h)`` with ``h``
    the bf16 fc pre-activation (``None`` unless ``save_h``)."""
    B, T, D = x.shape
    dt = x.dtype
    x2 = x.reshape(B * T, D)
    attn, mlp = p["attn"], p["mlp"]
    xn = steps.layernorm(x2, p["ln_1"]["scale"], p["ln_1"]["bias"], dt)
    qkv = steps.gemm(xn, attn["w_qkv"], attn["b_qkv"], out_dtype=dt)
    a = steps.attention(qkv.reshape(B, T, 3 * D), n_head).reshape(B * T, D)
    y = steps.gemm(a, attn["w_out"], attn["b_out"], residual=x2,
                   out_dtype=torch.float32)
    xn2 = steps.layernorm(y, p["ln_2"]["scale"], p["ln_2"]["bias"], dt)
    h = None
    if save_h:
        g, h = steps.gemm(xn2, mlp["w_fc"], mlp["b_fc"], gelu=True,
                          out_dtype=dt, pre_dtype=dt)
    else:
        g = steps.gemm(xn2, mlp["w_fc"], mlp["b_fc"], gelu=True, out_dtype=dt)
    out = steps.gemm(g, mlp["w_proj"], mlp["b_proj"], residual=y, out_dtype=dt)
    return out.reshape(B, T, D), qkv.reshape(B, T, 3 * D), h


def block_train_backward(x, dy, p, n_head: int, qkv, h, steps: BlockSteps,
                         wgrad: bool):
    """``(dx, grads)`` of the block for the output cotangent ``dy``, from the
    saved ``qkv`` and (K3) ``h``. ``grads`` maps each leaf name of
    :data:`BLOCK_LEAVES` to its fp32 gradient: the LayerNorms' always, the
    weights' and biases' with ``wgrad`` (K4, which recomputes ``h`` in
    fp32 and ignores the ``h`` given)."""
    B, T, D = x.shape
    dt = x.dtype
    M = B * T
    x2 = x.reshape(M, D)
    qkv2 = qkv.reshape(M, 3 * D)
    attn, mlp = p["attn"], p["mlp"]
    dout = dy.reshape(M, D).to(dt).contiguous()
    a = steps.attention(qkv, n_head).reshape(M, D)
    y = steps.gemm(a, attn["w_out"], attn["b_out"], residual=x2,
                   out_dtype=torch.float32)
    if wgrad:
        xn2 = steps.layernorm(y, p["ln_2"]["scale"], p["ln_2"]["bias"], dt)
        g, h = steps.gemm(xn2, mlp["w_fc"], mlp["b_fc"], gelu=True,
                          out_dtype=dt, pre_dtype=torch.float32)
    dh = steps.gemm(dout, mlp["w_proj"], trans_w=True, dgelu_of=h, out_dtype=dt)
    dxn2 = steps.gemm(dh, mlp["w_fc"], trans_w=True, out_dtype=torch.float32)
    dyh, dyh_c, dg2, db2 = steps.layernorm_bwd(
        y, dxn2, dout, p["ln_2"]["scale"], torch.float32, copy_bf16=dt != torch.float32)
    dyh_c = dyh if dyh_c is None else dyh_c
    da = steps.gemm(dyh_c, attn["w_out"], trans_w=True, out_dtype=dt)
    dqkv = steps.attention_bwd(qkv, da.reshape(B, T, D), n_head).reshape(M, 3 * D)
    dyln1 = steps.gemm(dqkv, attn["w_qkv"], trans_w=True, out_dtype=torch.float32)
    dx, _, dg1, db1 = steps.layernorm_bwd(x2, dyln1, dyh, p["ln_1"]["scale"], dt)
    grads = {("ln_1", "scale"): dg1, ("ln_1", "bias"): db1,
             ("ln_2", "scale"): dg2, ("ln_2", "bias"): db2}
    if wgrad:
        xn1 = steps.layernorm(x2, p["ln_1"]["scale"], p["ln_1"]["bias"], dt)
        grads.update({
            ("attn", "w_qkv"): steps.gemm_tn(xn1, dqkv),
            ("attn", "b_qkv"): steps.column_sum(dqkv),
            ("attn", "w_out"): steps.gemm_tn(a, dyh_c),
            ("attn", "b_out"): steps.column_sum(dyh),
            ("mlp", "w_fc"): steps.gemm_tn(xn2, dh),
            ("mlp", "b_fc"): steps.column_sum(dh),
            ("mlp", "w_proj"): steps.gemm_tn(g, dout),
            ("mlp", "b_proj"): steps.column_sum(dout),
        })
    return dx.reshape(B, T, D), grads


class _FusedBlockTrain(torch.autograd.Function):
    """One block's forward and backward as given by ``steps``; ``wgrad``
    selects K4 (every gradient) over K3 (no weight gradients). ``counter``
    is the wrapper whose counts of launches to raise, or ``None``."""

    @staticmethod
    def forward(ctx, x, n_head, steps, wgrad, counter, *leaves):
        p = _tree(leaves)
        out, qkv, h = block_train_forward(x, p, n_head, steps, save_h=not wgrad)
        ctx.save_for_backward(x, qkv, h, *leaves)
        ctx.n_head, ctx.steps, ctx.wgrad, ctx.counter = n_head, steps, wgrad, counter
        if counter is not None:
            counter.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, qkv, h, *leaves = ctx.saved_tensors
        dx, grads = block_train_backward(
            x, dy, _tree(leaves), ctx.n_head, qkv, h, ctx.steps, ctx.wgrad)
        if ctx.counter is not None:
            ctx.counter.backward_launches += 1
        leaf_grads = [
            None if name not in grads or not need
            else grads[name].to(leaf.dtype).reshape(leaf.shape)
            for name, leaf, need in zip(BLOCK_LEAVES, leaves,
                                        ctx.needs_input_grad[5:])
        ]
        return (dx, None, None, None, None, *leaf_grads)


def _frozen_weights_guard(p):
    trainable = [f"{a}.{b}" for a, b in WEIGHT_LEAVES if p[a][b].requires_grad]
    if trainable:
        raise ValueError(
            "fused_block_train returns no gradient for the block's attention "
            f"and MLP weights, but {trainable} require one: route the block "
            "through fused_block_train_dw")


def fused_block_train_reference(x, p, n_head: int):
    """Plain version of :func:`fused_block_train`, on any device."""
    _frozen_weights_guard(p)
    return _FusedBlockTrain.apply(x, n_head, PLAIN_STEPS, False, None, *_leaves(p))


def fused_block_train(x, p, n_head: int):
    """The pre-LN block of :func:`fused_block_residual`, differentiable in
    ``x`` and the LayerNorms, for a block whose attention and MLP weights
    are frozen: raises if any of them requires a gradient (the TPU kernel
    would return zeros for them)."""
    if x.device.type == "cpu":
        return fused_block_train_reference(x, p, n_head)
    _frozen_weights_guard(p)
    return _FusedBlockTrain.apply(x.contiguous(), n_head, CUDA_STEPS, False,
                                  fused_block_train, *_leaves(p))


def fused_block_train_dw_reference(x, p, n_head: int):
    """Plain version of :func:`fused_block_train_dw`, on any device."""
    return _FusedBlockTrain.apply(x, n_head, PLAIN_STEPS, True, None, *_leaves(p))


def fused_block_train_dw(x, p, n_head: int):
    """The pre-LN block of :func:`fused_block_residual`, differentiable in
    ``x`` and every leaf of ``p`` (gradients in each leaf's dtype)."""
    if x.device.type == "cpu":
        return fused_block_train_dw_reference(x, p, n_head)
    return _FusedBlockTrain.apply(x.contiguous(), n_head, CUDA_STEPS, True,
                                  fused_block_train_dw, *_leaves(p))


for _fn in (fused_block_train, fused_block_train_dw):
    _fn.launches = 0
    _fn.backward_launches = 0
