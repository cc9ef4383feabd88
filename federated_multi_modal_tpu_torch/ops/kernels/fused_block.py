"""Whole pre-LN transformer block: the port of the TPU kernels
``federated_multi_modal_tpu/ops/pallas/fused_block.py::fused_block_residual``
(``pl.pallas_call`` in ``_fused_block_group_jit`` with one block), which runs
every vision block of the eval path ``encode_image(inference=True)``, the
same call with G > 1 blocks, ``fused_block_group_residual`` (K9, "the
block-group inference kernel" below, under ``FMM_TPU_FUSED_NBLK > 1``), and
``fused_block_train`` / ``fused_block_train_dw`` (``_fbt_fwd_save`` and
``_fbt_bwd``), which run the vision blocks of the train step (see "the
training block" below). Under the JAX package's routing gates, which this
module reads as the JAX one does ("the routing gates" below), the eval
block may instead take the two-kernel block ``fused_ln_attention_residual``
and ``fused_ln_mlp_residual``, and a frozen train block the sublayer kernel
``fused_ln_attention``: each is a sequence of the same hand-written kernels.

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

import collections
import functools
import os
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
    ``out_dtype`` (``dres`` may be ``None``: no residual branch). Returns
    ``(dx, dx in bf16 or None, d gamma, d beta)``, the last two fp32 column
    sums of ``dxn * x^`` and ``dxn``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * rstd
    dxn = dxn.float()
    gv = dxn * gamma.float()
    m1 = gv.mean(-1, keepdim=True)
    m2 = (gv * xhat).mean(-1, keepdim=True)
    dx = rstd * (gv - m1 - xhat * m2)
    if dres is not None:
        dx = dres.float() + dx
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
_BK = 64  # the kernel's K step; a split of the contraction is a multiple
_TILE_M, _TILE_N = 128, 256  # the kernel's output tile
_F32, _B16 = torch.float32, torch.bfloat16


def _field(dtype):
    return 0 if dtype is None else 1 if dtype == _B16 else 2


def epilogue_code(bias=False, gelu=False, pre=None, dgelu=None, residual=None,
                  out=_B16) -> int:
    """The kernel's code of an epilogue (``code`` in ``gemm_epilogue.cu``):
    ``bias`` and ``gelu`` flags, the dtypes of ``pre`` (the pre-activation
    copy), ``dgelu`` (h of ``* QuickGELU'(h)``) and ``residual`` (``None``
    when absent) and of the output."""
    return (int(bias) | int(gelu) << 1 | _field(pre) << 2 | _field(dgelu) << 4
            | _field(residual) << 6 | int(out == _F32) << 8)


def epilogue_fields(code: int) -> dict:
    """The epilogue of a code, as :func:`epilogue_code`'s arguments."""
    def dtype(v):
        return (None, _B16, _F32)[v]

    return {"bias": bool(code & 1), "gelu": bool(code >> 1 & 1), "pre": dtype(code >> 2 & 3),
            "dgelu": dtype(code >> 4 & 3), "residual": dtype(code >> 6 & 3),
            "out": _F32 if code >> 8 & 1 else _B16}


# The (layout, epilogue code) instances that gemm_epilogue.cu builds
# (kInstances there): every product of the blocks and P2, and NN's other
# plain, bias and QuickGELU forms in either output type.
GEMM_INSTANCES = frozenset(
    [(_NN, epilogue_code(bias=b, gelu=g, out=o))
     for b, g in ((False, False), (True, False), (True, True)) for o in (_B16, _F32)]
    + [(_NN, epilogue_code(bias=True, residual=r, out=o))
       for r in (_B16, _F32) for o in (_B16, _F32)]
    + [(_NN, epilogue_code(bias=True, gelu=True, pre=p)) for p in (_B16, _F32)]
    + [(_NT, epilogue_code(out=o)) for o in (_B16, _F32)]
    + [(_NT, epilogue_code(dgelu=h)) for h in (_B16, _F32)]
    + [(_TN, epilogue_code(out=_F32))])


# Launches of gemm_epilogue.cu since the last reset, by product: (layout,
# output rows, output columns, contraction, epilogue code), as
# :class:`GemmProduct` has them.
GEMM_LAUNCHES = collections.Counter()


def _dtype(t):
    return None if t is None else t.dtype


def _gemm_launch(a, w, layout, M, N, K, out, splits=1, k_per_split=None,
                 bias=None, pre=None, gelu=False, dgelu_of=None,
                 residual=None):
    GEMM_LAUNCHES[(layout, M, N, K, epilogue_code(
        bias is not None, gelu, _dtype(pre), _dtype(dgelu_of), _dtype(residual),
        out.dtype))] += 1
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
    the fused epilogue of :func:`gemm_epilogue_reference`, one of
    :data:`GEMM_INSTANCES`."""
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
    layout = _NT if trans_w else _NN
    code = epilogue_code(bias is not None, gelu, pre_dtype, _dtype(dgelu_of),
                         _dtype(residual), out_dtype)
    if (layout, code) not in GEMM_INSTANCES:
        raise ValueError(f"gemm_epilogue: no instance built for layout {layout} with "
                         f"epilogue code {code:#05x} (GEMM_INSTANCES)")
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    pre = None if pre_dtype is None else torch.empty(M, N, dtype=pre_dtype,
                                                     device=a.device)
    _gemm_launch(a, w, layout, M, N, K, out, bias=bias, pre=pre, gelu=gelu,
                 dgelu_of=dgelu_of, residual=residual)
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


# Bytes of device-memory traffic that take as long as one SM's 128 x 256 x
# 64 step of the product, at the H100's data-sheet rates (989 TFLOP/s dense
# bf16 over 132 SMs, 3.35 TB/s): ~1.9 MB.
_STEP_BYTES = 2 * _TILE_M * _TILE_N * _BK / (989e12 / 132) * 3.35e12


def tn_split_plan(M: int, N: int, K: int, sms: int = 132) -> tuple:
    """``(splits, k_per_split)`` of ``gemm_tn_cuda``'s contraction over K
    rows into an ``(M, N)`` output, on a card of ``sms`` SMs (one block
    each, walking every split of every output tile). Takes the split count
    whose modelled time is least: the waves of equal tiles times the
    K steps of one, plus the fp32 partials written and read again (none
    for one split); the fewest splits among equals. ``k_per_split`` is a
    multiple of the kernel's K step."""
    tiles = -(-M // _TILE_M) * -(-N // _TILE_N)
    steps = -(-K // _BK)
    best = None
    for want in range(1, min(steps, 256) + 1):
        per = -(-steps // want)
        splits = -(-steps // per)
        cost = -(-tiles * splits // sms) * per
        if splits > 1:
            cost += splits * M * N * 8 / _STEP_BYTES
        if best is None or cost < best[0]:
            best = (cost, splits, per * _BK)
    return best[1], best[2]


def gemm_tn_cuda(a, b):
    """Launch ``gemm_epilogue.cu`` in its TN layout: ``a^T @ b`` for bf16
    ``a (K, M)`` and ``b (K, N)`` -> fp32 ``(M, N)``. A long contraction (the
    batch rows) is split over tiles into fp32 partial products
    (:func:`tn_split_plan`), which :func:`column_sum_cuda` adds up."""
    _check_cuda("gemm_tn a", a, (torch.bfloat16,))
    _check_cuda("gemm_tn b", b, (torch.bfloat16,))
    K, M = a.shape
    Kb, N = b.shape
    if Kb != K or M % 8 or N % 8:
        raise ValueError(f"gemm_tn: a {tuple(a.shape)}^T @ b {tuple(b.shape)} "
                         "needs matching K, M % 8 == 0 and N % 8 == 0")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits, k_per = tn_split_plan(M, N, K, sms)
    out = torch.empty(splits, M, N, dtype=torch.float32, device=a.device)
    _gemm_launch(a, b, _TN, M, N, K, out, splits=splits, k_per_split=k_per)
    if splits == 1:
        return out[0]
    return column_sum_cuda(out.reshape(splits, M * N)).reshape(M, N)


_LN_WARPS = 4  # kWarps in layernorm_bwd_rows.cu: one row a warp at a time
# Launches of layernorm_bwd_rows.cu since the last clear, by instance:
# (rows, D, x dtype, dres dtype or None, dx dtype, bf16 copy, partials).
LN_BWD_LAUNCHES = collections.Counter()


def ln_bwd_plan(rows: int, sms: int, blocks_per_sm: int) -> tuple:
    """``(blocks, stride)`` of ``layernorm_bwd_rows.cu``'s persistent grid on
    a card of ``sms`` SMs where ``blocks_per_sm`` of its blocks fit: one
    wave of every block that fits, or fewer where the rows do not fill
    them. Warp ``w`` of the grid's ``blocks * 4`` takes rows ``w, w +
    stride, ...``; each block writes one partial of d gamma and d beta."""
    if rows < 1 or sms < 1 or blocks_per_sm < 1:
        raise ValueError(f"ln_bwd_plan: rows {rows}, sms {sms} and blocks per SM "
                         f"{blocks_per_sm} must be positive")
    blocks = min(sms * blocks_per_sm, -(-rows // _LN_WARPS))
    return blocks, blocks * _LN_WARPS


def ln_bwd_variant(D: int, x_dtype, dres_dtype, out_dtype, partials: bool) -> int:
    """The instance of ``layernorm_bwd_rows.cu`` that a launch takes, as its
    ``fmm_layernorm_bwd_rows_blocks_per_sm`` entry point names it."""
    f32 = torch.float32
    return (D | (x_dtype == f32) << 11 | (dres_dtype == f32) << 12
            | (out_dtype == f32) << 13 | bool(partials) << 14)


def ln_bwd_instance(x, dres, out_dtype, copy_bf16: bool, param_grads: bool) -> tuple:
    """A launch's key in :data:`LN_BWD_LAUNCHES`."""
    def name(dtype):
        return None if dtype is None else str(dtype).replace("torch.", "")
    return (*x.shape, name(x.dtype), name(None if dres is None else dres.dtype),
            name(out_dtype), bool(copy_bf16), bool(param_grads))


@functools.lru_cache(maxsize=None)
def ln_bwd_blocks_per_sm(variant: int) -> int:
    """Resident blocks per SM of one instance (:func:`ln_bwd_variant`),
    read once per process."""
    return _build.blocks_per_sm("fmm_layernorm_bwd_rows_blocks_per_sm", variant, False)[0]


def layernorm_bwd_rows_cuda(x, dxn, dres, gamma, out_dtype,
                            copy_bf16: bool = False, eps: float = 1e-5,
                            param_grads: bool = True):
    """Launch ``layernorm_bwd_rows.cu`` on ``x (rows, D)`` (bf16 or fp32),
    fp32 ``dxn`` and ``dres`` (bf16, fp32 or ``None``); the column sums of
    d gamma and d beta come from the per-block partials through
    :func:`column_sum_cuda`. Same returns as the plain version, except that
    with ``param_grads=False`` the kernel keeps no partials and d gamma and
    d beta are ``None``."""
    _check_cuda("layernorm_bwd_rows x", x, _BF16_F32)
    _check_cuda("layernorm_bwd_rows dxn", dxn, (torch.float32,))
    if dres is not None:
        _check_cuda("layernorm_bwd_rows dres", dres, _BF16_F32)
    rows, D = x.shape
    if dxn.shape != (rows, D) or (dres is not None and dres.shape != (rows, D)) \
            or D > 1024:
        raise ValueError(f"layernorm_bwd_rows: dxn and dres must be ({rows}, "
                         f"{D}) with D <= 1024")
    if out_dtype not in _BF16_F32:
        raise ValueError(f"layernorm_bwd_rows writes bf16 or fp32, not {out_dtype}")
    gamma = gamma.to(torch.float32).contiguous()
    dx = torch.empty(rows, D, dtype=out_dtype, device=x.device)
    copy = (torch.empty(rows, D, dtype=torch.bfloat16, device=x.device)
            if copy_bf16 else None)
    variant = ln_bwd_variant(D, x.dtype, None if dres is None else dres.dtype, out_dtype,
                             param_grads)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks, _ = ln_bwd_plan(rows, sms, ln_bwd_blocks_per_sm(variant))
    partial = (torch.empty(blocks, 2 * D, dtype=torch.float32, device=x.device)
               if param_grads else None)
    _build.launch("fmm_layernorm_bwd_rows", x.data_ptr(), _is_f32(x),
                  dxn.data_ptr(), _ptr(dres), _is_f32(dres),
                  gamma.data_ptr(), dx.data_ptr(), _is_f32(dx), _ptr(copy),
                  _ptr(partial), rows, D, blocks, eps)
    LN_BWD_LAUNCHES[ln_bwd_instance(x, dres, out_dtype, copy_bf16, param_grads)] += 1
    if not param_grads:
        return dx, copy, None, None
    sums = column_sum_cuda(partial)
    return dx, copy, sums[:D], sums[D:]


# -- the block and its halves --------------------------------------------


def _ln_qkv_attention(x2, B, T, lnp, w_qkv, b_qkv, n_head, layernorm, gemm,
                      attention, dt=None):
    """LN1 -> QKV + b -> attention over ``x2 (B * T, D)``: ``(a, qkv)``,
    the ``(B * T, D)`` attention output and the ``(B * T, 3D)`` QKV, both
    in the storage dtype ``dt`` (``x2``'s unless given: an fp32 stream
    keeps its block's storage dtype)."""
    dt = dt or x2.dtype
    xn = layernorm(x2, lnp["scale"], lnp["bias"], dt)
    qkv = gemm(xn, w_qkv, b_qkv, out_dtype=dt)
    a = attention(qkv.reshape(B, T, -1), n_head).reshape(B * T, -1)
    return a, qkv


def _attention_half(x2, B, T, lnp, attnp, n_head, out_dtype, layernorm, gemm,
                    attention, dt=None):
    """``x + out_proj(attention(qkv(ln_1(x))))`` over ``x2 (B * T, D)``,
    one rounding to ``out_dtype`` after the fp32 sum."""
    a, _ = _ln_qkv_attention(x2, B, T, lnp, attnp["w_qkv"], attnp["b_qkv"],
                             n_head, layernorm, gemm, attention, dt)
    return gemm(a, attnp["w_out"], attnp["b_out"], residual=x2, out_dtype=out_dtype)


def _mlp_half(y, lnp, mlpp, dt, layernorm, gemm, out_dtype=None):
    """``y + proj(QuickGELU(fc(ln_2(y))))`` over ``y (rows, D)`` (bf16 or
    fp32), with LN2's output and the hidden activation in the storage dtype
    ``dt`` and the result in ``out_dtype`` (``dt`` unless given)."""
    xn2 = layernorm(y, lnp["scale"], lnp["bias"], dt)
    h = gemm(xn2, mlpp["w_fc"], mlpp["b_fc"], gelu=True, out_dtype=dt)
    return gemm(h, mlpp["w_proj"], mlpp["b_proj"], residual=y, out_dtype=out_dtype or dt)


def _block(x, p, n_head, layernorm, gemm, attention):
    """The whole-block sequence of ``_block_body32`` over given steps."""
    B, T, D = x.shape
    y = _attention_half(x.reshape(B * T, D), B, T, p["ln_1"], p["attn"], n_head,
                        torch.float32, layernorm, gemm, attention)
    out = _mlp_half(y, p["ln_2"], p["mlp"], x.dtype, layernorm, gemm)
    return out.reshape(B, T, D)


def fused_block_residual_reference(x, p, n_head: int):
    """Plain version of :func:`fused_block_residual`."""
    return _block(x, p, n_head, layernorm_rows_reference,
                  gemm_epilogue_reference, attention_core_reference)


def _forward_only(name, x):
    if x.requires_grad:
        raise NotImplementedError(f"{name} is forward-only, like the TPU kernel")


def fused_block_residual(x, p, n_head: int):
    """``x + attn(ln_1(x))`` then ``y + mlp(ln_2(y))`` for one pre-LN block
    (``p`` holds ``ln_1, attn{w_qkv, b_qkv, w_out, b_out}, ln_2,
    mlp{w_fc, b_fc, w_proj, b_proj}`` in the JAX package's layout)."""
    _forward_only("fused_block_residual", x)
    if x.device.type == "cpu":
        return fused_block_residual_reference(x, p, n_head)
    out = _block(x.contiguous(), p, n_head, layernorm_rows_cuda,
                 gemm_epilogue_cuda, attention_core_cuda)
    fused_block_residual.launches += 1
    return out


# -- the two-kernel inference block ----------------------------------------
#
# The port of ``fused_ln_attention_residual`` (K6a) and
# ``fused_ln_mlp_residual`` (K6b), the eval block under
# ``FMM_TPU_FUSED_BLOCK=0``: the two halves of :func:`fused_block_residual`,
# but ``y`` is rounded to the storage dtype between them (K6a writes
# ``x32 + proj + b_out`` with one rounding, K6b reads it). The TPU's K6b
# consumes the hidden activation in two column chunks; that changes only the
# order of its fp32 sums. Forward-only, like the TPU kernels. Bound on the
# H100: operations, as the whole block's (at ViT-B/16 eval width ~0.55 TFLOP
# for K6a, ~0.96 for K6b: ~0.55 and ~0.97 ms at 989 TFLOP/s, against ~0.1 ms
# each of memory traffic for x, the weights and the output).


def _ln_attention_residual(x, lnp, attnp, n_head, layernorm, gemm, attention):
    B, T, D = x.shape
    out = _attention_half(x.reshape(B * T, D), B, T, lnp, attnp, n_head, x.dtype,
                          layernorm, gemm, attention)
    return out.reshape(B, T, D)


def fused_ln_attention_residual_reference(x, lnp, attnp, n_head: int):
    """Plain version of :func:`fused_ln_attention_residual`."""
    return _ln_attention_residual(x, lnp, attnp, n_head, layernorm_rows_reference,
                                  gemm_epilogue_reference, attention_core_reference)


def fused_ln_attention_residual(x, lnp, attnp, n_head: int):
    """``x + out_proj(attention(qkv(ln_1(x))))`` in ``x``'s dtype (``lnp``
    holds ``scale, bias``; ``attnp`` ``w_qkv, b_qkv, w_out, b_out``)."""
    _forward_only("fused_ln_attention_residual", x)
    if x.device.type == "cpu":
        return fused_ln_attention_residual_reference(x, lnp, attnp, n_head)
    out = _ln_attention_residual(x.contiguous(), lnp, attnp, n_head, layernorm_rows_cuda,
                                 gemm_epilogue_cuda, attention_core_cuda)
    fused_ln_attention_residual.launches += 1
    return out


def _ln_mlp_residual(x, lnp, mlpp, layernorm, gemm):
    B, T, D = x.shape
    return _mlp_half(x.reshape(B * T, D), lnp, mlpp, x.dtype, layernorm,
                     gemm).reshape(B, T, D)


def fused_ln_mlp_residual_reference(x, lnp, mlpp):
    """Plain version of :func:`fused_ln_mlp_residual`."""
    return _ln_mlp_residual(x, lnp, mlpp, layernorm_rows_reference,
                            gemm_epilogue_reference)


def fused_ln_mlp_residual(x, lnp, mlpp):
    """``x + proj(QuickGELU(fc(ln_2(x))))`` in ``x``'s dtype (``mlpp`` holds
    ``w_fc, b_fc, w_proj, b_proj``)."""
    _forward_only("fused_ln_mlp_residual", x)
    if x.device.type == "cpu":
        return fused_ln_mlp_residual_reference(x, lnp, mlpp)
    out = _ln_mlp_residual(x.contiguous(), lnp, mlpp, layernorm_rows_cuda,
                           gemm_epilogue_cuda)
    fused_ln_mlp_residual.launches += 1
    return out


# -- the block-group inference kernel ----------------------------------------
#
# The port of ``fused_block_group_residual`` (K9: ``_group_kernel`` in
# ``_fused_block_group_jit`` with G > 1), the eval tower under
# ``FMM_TPU_FUSED_NBLK > 1``: G consecutive blocks in one call, the residual
# stream in fp32 from the group's first block to its last and rounded to the
# storage dtype only at the group's end, and the deep-prompt injection done
# inside: before each flagged block, rows ``[T - n_ctx - n_extra, T)`` of the
# fp32 stream take the block's ``(n_ctx, D)`` prompt, broadcast over the
# batch, then the ``(B, n_extra, D)`` extra rows. The TPU kernel keeps the
# stream in VMEM; here each block is K5's sequence of kernels reading and
# writing an fp32 stream (``layernorm_rows`` reads fp32, ``gemm_epilogue``
# takes an fp32 residual and, except in the group's last block, writes the
# fp32 stream), and ``csrc/inject_rows.cu`` writes the injected rows into it
# in place. A flagged first block injects into an fp32 copy of ``x``. Bound on
# the H100: operations, G times K5's (~1.52 ms a block at ViT-B/16 eval width),
# against an fp32 stream of ~0.05 ms of traffic per block boundary.


def inject_rows_reference(stream, prompt, extra=None):
    """Plain version of ``inject_rows.cu``: rows ``[T - n_ctx - n_extra,
    T)`` of the fp32 ``stream (B, T, D)`` take ``prompt (n_ctx, D)`` for
    every sample, then ``extra (B, n_extra, D)``, in place."""
    T = stream.shape[1]
    n_extra = 0 if extra is None else extra.shape[1]
    stream[:, T - n_extra - prompt.shape[0]:T - n_extra] = prompt.float()
    if extra is not None:
        stream[:, T - n_extra:] = extra.float()
    return stream


def inject_rows_cuda(stream, prompt, extra=None):
    """Launch ``inject_rows.cu`` on a CUDA fp32 ``stream (B, T, D)`` with
    bf16 ``prompt (n_ctx, D)`` and ``extra (B, n_extra, D)`` or ``None``."""
    B, T, D = stream.shape
    _check_cuda("inject_rows stream", stream, (torch.float32,))
    _check_cuda("inject_rows prompt", prompt, (torch.bfloat16,))
    n_extra = 0
    if extra is not None:
        _check_cuda("inject_rows extra", extra, (torch.bfloat16,))
        n_extra = extra.shape[1]
        if extra.shape != (B, n_extra, D):
            raise ValueError(f"inject_rows: extra must be ({B}, k, {D})")
    n_ctx = prompt.shape[0]
    if prompt.shape != (n_ctx, D) or D % 8 or not 0 < n_ctx + n_extra <= T:
        raise ValueError(f"inject_rows: prompt must be (n_ctx, {D}) with D % 8 == 0 "
                         f"and n_ctx + n_extra <= T = {T}")
    _build.launch("fmm_inject_rows", stream.data_ptr(), prompt.data_ptr(), _ptr(extra),
                  B, T, D, n_ctx, n_extra)
    return stream


def _group(x, blocks, n_head, inject_flags, prompts, extra, layernorm, gemm,
           attention, inject):
    """``_group_kernel``'s sequence over given steps: the stream in fp32
    between the blocks, the injections before the flagged blocks, and one
    rounding to ``x.dtype`` at the group's end."""
    B, T, D = x.shape
    dt = x.dtype
    s = x.reshape(B * T, D)
    prompts = iter(prompts)
    extra = None if extra is None else extra.to(dt).contiguous()
    for g, p in enumerate(blocks):
        if inject_flags[g]:
            if g == 0:
                s = s.to(torch.float32, copy=True)
            inject(s.view(B, T, D), next(prompts).to(dt).contiguous(), extra)
        last = g == len(blocks) - 1
        y = _attention_half(s, B, T, p["ln_1"], p["attn"], n_head, torch.float32,
                            layernorm, gemm, attention, dt)
        s = _mlp_half(y, p["ln_2"], p["mlp"], dt, layernorm, gemm,
                      dt if last else torch.float32)
    return s.reshape(B, T, D)


def fused_block_group_residual_reference(x, blocks, n_head: int, inject_flags=(),
                                         prompts=(), extra=None):
    """Plain version of :func:`fused_block_group_residual`."""
    flags = _group_flags(blocks, inject_flags, prompts, extra)
    return _group(x, blocks, n_head, flags, prompts, extra, layernorm_rows_reference,
                  gemm_epilogue_reference, attention_core_reference,
                  inject_rows_reference)


def _group_flags(blocks, inject_flags, prompts, extra):
    if extra is not None and not any(inject_flags):
        raise ValueError(
            "fused_block_group_residual: `extra` tokens are only consumed at injection "
            "points, but every inject_flag is False: pass a True flag or drop `extra`")
    flags = tuple(inject_flags) or (False,) * len(blocks)
    if len(flags) != len(blocks) or len(prompts) != sum(flags):
        raise ValueError(
            f"fused_block_group_residual: {len(flags)} inject_flags for {len(blocks)} "
            f"blocks and {len(prompts)} prompts for {sum(flags)} True flags")
    return flags


def fused_block_group_residual(x, blocks, n_head: int, inject_flags=(), prompts=(),
                               extra=None):
    """``len(blocks)`` consecutive pre-LN blocks (each ``p`` as for
    :func:`fused_block_residual`) with the residual stream in fp32 across
    them. ``inject_flags[g]``: before block ``g``, replace the trailing
    rows with the next of ``prompts`` (``(n_ctx, D)``, shared by the batch)
    and ``extra`` (``(B, k, D)``, per sample, or ``None``)."""
    _forward_only("fused_block_group_residual", x)
    if x.device.type == "cpu":
        return fused_block_group_residual_reference(x, blocks, n_head, inject_flags,
                                                    prompts, extra)
    flags = _group_flags(blocks, inject_flags, prompts, extra)
    out = _group(x.contiguous(), blocks, n_head, flags, prompts, extra, layernorm_rows_cuda,
                 gemm_epilogue_cuda, attention_core_cuda, inject_rows_cuda)
    fused_block_group_residual.launches += 1
    return out


for _fn in (fused_block_residual, fused_ln_attention_residual, fused_ln_mlp_residual,
            fused_block_group_residual):
    _fn.launches = 0


# -- the routing gates -----------------------------------------------------
#
# The JAX package's environment switches that choose a vision block's
# kernel, with the same names and defaults, read when a block is routed
# (never at import). Its gates for TPU tiling and VMEM (``FMM_TPU_FUSED_GB*``,
# ``FMM_TPU_FUSED_VMEM``, ``FMM_TPU_FUSED_TRAIN_MODE``,
# ``FMM_TPU_FUSED_TRAIN_DW_SAVEH``, ``FMM_TPU_PACKED_GB``) choose no kernel
# and have no counterpart here.


def _env_off(name: str) -> bool:
    return os.environ.get(name, "1").lower() in ("0", "off", "false")


def _env_on(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() in ("1", "on", "true")


def fused_ln_attention_eligible(B, T, D, n_head, attn_mask) -> bool:
    """Mask-free, lane-aligned attention halves take the fused kernels
    (K5, K6a, K3, K7); ``FMM_TPU_FUSED=0`` turns them all off."""
    if _env_off("FMM_TPU_FUSED") or attn_mask is not None:
        return False
    return D % n_head == 0 and D % 128 == 0 and (D // n_head) % 8 == 0 and B >= 1


def fused_ln_mlp_eligible(B, T, D, hidden) -> bool:
    """Lane-aligned 4x MLP halves take the fused kernels; shares
    ``FMM_TPU_FUSED`` with the attention half."""
    if _env_off("FMM_TPU_FUSED"):
        return False
    return D % 128 == 0 and hidden == 4 * D and B >= 1


def fused_block_eligible(B, T, D, n_head, hidden, attn_mask) -> bool:
    """The whole-block kernel (K5): both halves eligible, and
    ``FMM_TPU_FUSED_BLOCK`` not 0 (else the eval block takes K6a and K6b)."""
    if _env_off("FMM_TPU_FUSED_BLOCK"):
        return False
    return (fused_ln_attention_eligible(B, T, D, n_head, attn_mask)
            and fused_ln_mlp_eligible(B, T, D, hidden))


def fused_block_train_enabled() -> bool:
    """``FMM_TPU_FUSED_TRAIN_BLOCK`` (default on): frozen train blocks take
    the whole-block train kernel K3 (else K7 under ``FMM_TPU_FUSED_TRAIN``)."""
    return _env_on("FMM_TPU_FUSED_TRAIN_BLOCK", "1")


def fused_block_train_dw_enabled() -> bool:
    """``FMM_TPU_FUSED_TRAIN_DW`` (default on): trainable blocks take K4
    (else the plain block with K2 and K2b)."""
    return _env_on("FMM_TPU_FUSED_TRAIN_DW", "1")


def fused_block_group_size() -> int:
    """``FMM_TPU_FUSED_NBLK``: blocks per call on the eval path (the group
    kernel K9 for more than one)."""
    try:
        return max(1, int(os.environ.get("FMM_TPU_FUSED_NBLK", "1")))
    except ValueError:
        return 1


def fused_block_group_eligible(B, T, D, n_head, hidden, deep_prompts) -> bool:
    """Whether the JAX package's eval tower would run its blocks through
    the group kernel K9 (``clip_model.py:218-230``): a group size over 1,
    whole-block shapes, and batch-shared deep prompts."""
    return (fused_block_group_size() > 1
            and fused_block_eligible(B, T, D, n_head, hidden, None)
            and all(p.ndim == 2 for p in deep_prompts))


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

class GemmProduct(NamedTuple):
    """One product a block runs through ``gemm_epilogue.cu``: the output's
    ``rows`` and ``cols``, the contraction ``k``, the layout (``_NN``,
    ``_NT`` or ``_TN``) and the epilogue's code (:func:`epilogue_code`)."""

    name: str
    layout: int
    rows: int
    cols: int
    k: int
    code: int

    @property
    def key(self) -> tuple:
        """The product's key in :data:`GEMM_LAUNCHES`."""
        return (self.layout, self.rows, self.cols, self.k, self.code)

    @property
    def flops(self) -> int:
        return 2 * self.rows * self.cols * self.k


def block_gemm_products(M: int, D: int, hidden: int, dtype=torch.bfloat16) -> dict:
    """The products of one pre-LN block over ``M`` rows of width ``D`` with
    an MLP of ``hidden``, in the storage dtype ``dtype``, by pass, in the
    order the block runs them: ``forward`` (the eval block K5, and K4's
    forward), ``forward_save_h`` (K3's, which keeps the fc pre-activation),
    ``backward`` (K3's) and ``backward_wgrad`` (K4's: y and h recomputed, h
    in fp32, and the four weight gradients over the ``M`` rows)."""
    qkv = GemmProduct("qkv", _NN, M, 3 * D, D, epilogue_code(bias=True, out=dtype))
    out_proj = GemmProduct("out_proj", _NN, M, D, D,
                           epilogue_code(bias=True, residual=dtype, out=_F32))
    fc = GemmProduct("fc", _NN, M, hidden, D, epilogue_code(bias=True, gelu=True, out=dtype))
    proj = GemmProduct("proj", _NN, M, D, hidden,
                       epilogue_code(bias=True, residual=_F32, out=dtype))
    dxn2 = GemmProduct("dxn2", _NT, M, D, hidden, epilogue_code(out=_F32))
    da = GemmProduct("da", _NT, M, D, D, epilogue_code(out=dtype))
    dyln1 = GemmProduct("dyln1", _NT, M, D, 3 * D, epilogue_code(out=_F32))
    tn = epilogue_code(out=_F32)
    return {
        "forward": [qkv, out_proj, fc, proj],
        "forward_save_h": [qkv, out_proj, fc._replace(
            name="fc_save_h", code=epilogue_code(bias=True, gelu=True, pre=dtype, out=dtype)),
            proj],
        "backward": [out_proj, GemmProduct("dh", _NT, M, hidden, D,
                                           epilogue_code(dgelu=dtype, out=dtype)),
                     dxn2, da, dyln1],
        "backward_wgrad": [
            out_proj,
            fc._replace(name="fc_h_f32",
                        code=epilogue_code(bias=True, gelu=True, pre=_F32, out=dtype)),
            GemmProduct("dh_h_f32", _NT, M, hidden, D, epilogue_code(dgelu=_F32, out=dtype)),
            dxn2, da, dyln1,
            GemmProduct("dw_qkv", _TN, D, 3 * D, M, tn),
            GemmProduct("dw_out", _TN, D, D, M, tn),
            GemmProduct("dw_fc", _TN, D, hidden, M, tn),
            GemmProduct("dw_proj", _TN, hidden, D, M, tn)],
    }


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
    a, qkv = _ln_qkv_attention(x2, B, T, p["ln_1"], attn["w_qkv"], attn["b_qkv"],
                               n_head, steps.layernorm, steps.gemm, steps.attention)
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


# -- the sublayer train kernel ---------------------------------------------
#
# The port of ``fused_ln_attention`` (K7: ``fused_ln_attention_fwd`` and
# ``fused_ln_attention_bwd`` behind a custom VJP), which the JAX package runs
# in frozen train blocks under ``FMM_TPU_FUSED_TRAIN=1`` with
# ``FMM_TPU_FUSED_TRAIN_BLOCK=0``; the out-projection and the MLP around it
# stay plain autodiff. Forward: LN1 -> QKV + b -> attention, the
# pre-out-projection output, saving only ``x`` (and the parameters), as the
# TPU kernel does. Backward: LN1 and QKV recomputed, the attention backward,
# d(LN1 out) = d(QKV) . W_qkv^T in fp32 (the TPU kernel folds it in per
# head; the sums run in another order), then LN1's backward with no residual
# branch: dx in x's dtype, fp32 d gamma and d beta. The TPU kernel returns
# zeros for ``w`` and ``b``; the port refuses a ``w`` or ``b`` that requires
# a gradient instead. Bound on the H100: operations. At ViT-B/16 train
# width the forward's QKV product is ~0.36 TFLOP plus ~0.06 of attention
# (~0.43 ms), the backward's d(LN1 out) ~0.36 plus ~0.13 of attention
# (~0.5 ms; recomputation not counted), against ~0.1 and ~0.2 ms of memory
# traffic.


def ln_attention_forward(x, lnp, w, b, n_head: int, steps: BlockSteps):
    """K7's forward over ``x (B, T, D)``: the ``(B, T, D)`` attention output
    before the out-projection, in ``x``'s dtype."""
    B, T, D = x.shape
    a, _ = _ln_qkv_attention(x.reshape(B * T, D), B, T, lnp, w, b, n_head,
                             steps.layernorm, steps.gemm, steps.attention)
    return a.reshape(B, T, D)


def ln_attention_backward(x, dy, lnp, w, b, n_head: int, steps: BlockSteps):
    """K7's backward for the output cotangent ``dy``: ``(dx, d gamma,
    d beta)``, dx in ``x``'s dtype and the LayerNorm gradients in fp32."""
    B, T, D = x.shape
    dt = x.dtype
    x2 = x.reshape(B * T, D)
    xn = steps.layernorm(x2, lnp["scale"], lnp["bias"], dt)
    qkv = steps.gemm(xn, w, b, out_dtype=dt)
    dqkv = steps.attention_bwd(qkv.reshape(B, T, 3 * D),
                               dy.reshape(B, T, D).to(dt).contiguous(), n_head)
    dyln = steps.gemm(dqkv.reshape(B * T, 3 * D), w, trans_w=True,
                      out_dtype=torch.float32)
    dx, _, dg, db = steps.layernorm_bwd(x2, dyln, None, lnp["scale"], dt)
    return dx.reshape(B, T, D), dg, db


class _FusedLnAttention(torch.autograd.Function):
    """K7's forward and backward as given by ``steps``; ``counter`` is the
    wrapper whose counts of launches to raise, or ``None``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, n_head, steps, counter):
        out = ln_attention_forward(x, {"scale": gamma, "bias": beta}, w, b, n_head, steps)
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.n_head, ctx.steps, ctx.counter = n_head, steps, counter
        if counter is not None:
            counter.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, b = ctx.saved_tensors
        dx, dg, db = ln_attention_backward(
            x, dy, {"scale": gamma, "bias": beta}, w, b, ctx.n_head, ctx.steps)
        if ctx.counter is not None:
            ctx.counter.backward_launches += 1
        return (dx, dg.to(gamma.dtype).reshape(gamma.shape),
                db.to(beta.dtype).reshape(beta.shape), None, None, None, None, None)


def _frozen_qkv_guard(w, b):
    if w.requires_grad or b.requires_grad:
        raise ValueError(
            "fused_ln_attention returns no gradient for w_qkv and b_qkv, but "
            "they require one: route the block through fused_block_train_dw")


def fused_ln_attention_reference(x, lnp, w, b, n_head: int):
    """Plain version of :func:`fused_ln_attention`, on any device."""
    _frozen_qkv_guard(w, b)
    return _FusedLnAttention.apply(x, lnp["scale"], lnp["bias"], w, b, n_head,
                                   PLAIN_STEPS, None)


def fused_ln_attention(x, lnp, w, b, n_head: int):
    """``attention(qkv(ln_1(x)))`` before the out-projection, differentiable
    in ``x`` and the LayerNorm (``lnp`` holds ``scale, bias``), for frozen
    ``w (D, 3D)`` and ``b (3D,)``: raises if either requires a gradient
    (the TPU kernel would return zeros for them)."""
    if x.device.type == "cpu":
        return fused_ln_attention_reference(x, lnp, w, b, n_head)
    _frozen_qkv_guard(w, b)
    return _FusedLnAttention.apply(x.contiguous(), lnp["scale"], lnp["bias"], w, b,
                                   n_head, CUDA_STEPS, fused_ln_attention)


fused_ln_attention.launches = 0
fused_ln_attention.backward_launches = 0
