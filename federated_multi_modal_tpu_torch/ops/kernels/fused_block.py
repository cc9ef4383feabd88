"""Whole pre-LN transformer block for inference: the port of the TPU kernel
``federated_multi_modal_tpu/ops/pallas/fused_block.py::fused_block_residual``
(``pl.pallas_call`` in ``_fused_block_group_jit`` with one block), which runs
every vision block of the eval path ``encode_image(inference=True)``.

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
like the TPU kernel.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels.attention import (
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


def gemm_epilogue_reference(a, w, bias=None, residual=None, gelu=False,
                            out_dtype=None):
    """``a @ w`` as fp32 products of the storage dtype's values, then
    ``+ bias`` (rounded to the storage dtype), QuickGELU, ``+ residual``,
    cast to ``out_dtype``. TF32 is off for the fp32 product
    (``full_fp32_products``)."""
    with full_fp32_products():
        acc = torch.matmul(a.float(), w.to(a.dtype).float())
    if bias is not None:
        acc = acc + bias.to(a.dtype).float()
    if gelu:
        acc = acc * torch.sigmoid(1.702 * acc)
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype or a.dtype)


# -- the steps: CUDA kernels -----------------------------------------------


def _check_cuda(name, t, dtypes):
    if not t.is_cuda or t.dtype not in dtypes or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs a contiguous 16-byte aligned CUDA tensor of "
            f"{dtypes}, got {t.dtype} on {t.device}")


def layernorm_rows_cuda(x, gamma, beta, out_dtype, eps: float = 1e-5):
    """Launch ``layernorm_rows.cu``: ``x (rows, D)`` bf16 or fp32 -> bf16."""
    _check_cuda("layernorm_rows x", x, (torch.bfloat16, torch.float32))
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


def gemm_epilogue_cuda(a, w, bias=None, residual=None, gelu=False,
                       out_dtype=None):
    """Launch ``gemm_epilogue.cu``: ``a (M, K) @ w (K, N)`` in bf16 with
    fp32 accumulation and the fused epilogue of
    :func:`gemm_epilogue_reference`."""
    out_dtype = out_dtype or a.dtype
    w = w.to(torch.bfloat16).contiguous()
    _check_cuda("gemm_epilogue a", a, (torch.bfloat16,))
    _check_cuda("gemm_epilogue w", w, (torch.bfloat16,))
    M, K = a.shape
    N = w.shape[1]
    if w.shape[0] != K or N % 8 or K % 8:
        raise ValueError(f"gemm_epilogue: a {tuple(a.shape)} @ w "
                         f"{tuple(w.shape)} needs matching K and N, K % 8 == 0")
    if bias is not None:
        bias = bias.to(torch.bfloat16).contiguous()
        _check_cuda("gemm_epilogue bias", bias, (torch.bfloat16,))
    if residual is not None:
        _check_cuda("gemm_epilogue residual", residual,
                    (torch.bfloat16, torch.float32))
        if residual.shape != (M, N):
            raise ValueError(f"gemm_epilogue: residual must be ({M}, {N})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm_epilogue writes bf16 or fp32, not {out_dtype}")
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    _build.launch(
        "fmm_gemm_epilogue", a.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        int(residual is not None and residual.dtype == torch.float32),
        out.data_ptr(), int(out_dtype == torch.float32), M, N, K, int(gelu),
    )
    return out


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
