"""The port's plain warpgroup GEMM: ``C = A . B^T`` in fp32 for bf16
``A (M, K)`` and ``B (N, K)``, both with K contiguous: the NT instance of
``csrc/gemm_epilogue.cu`` with no epilogue and an fp32 output (a persistent
grid of 128 x 256 tiles, a ring of shared-memory stages filled by the Tensor
Memory Accelerator, products on ``wgmma`` with fp32 sums, no sum split
across blocks).

It carries P2's largest product (:func:`prototypes.fused_lnqkv_attention_bwd_dx`:
``dxn = d(QKV) . W^T``, ``W (D, 3D)`` as stored). There is no dispatching
wrapper: its callers are CUDA paths, whose plain versions compute the same
product their own way.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels.attention import full_fp32_products


def gemm_nt_f32_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) . b (N, K)^T`` as fp32 products of their values, fp32 sums."""
    with full_fp32_products():
        return torch.matmul(a.float(), b.float().T)


def gemm_nt_f32_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch ``fmm_gemm_nt_f32`` (``gemm_epilogue.cu``) on contiguous
    16-byte aligned CUDA bf16 ``a (M, K)`` and ``b (N, K)`` with K and N
    multiples of 8; returns the fp32 ``(M, N)`` product."""
    for name, t in (("a", a), ("b", b)):
        if (not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 2
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"gemm_nt_f32 takes a contiguous 16-byte aligned 2-D CUDA bf16 "
                             f"{name}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    (M, K), (N, Kb) = a.shape, b.shape
    if M < 1 or K != Kb or K % 8 or N % 8:
        raise ValueError(f"gemm_nt_f32 takes a (M, K) and b (N, K) with K and N multiples "
                         f"of 8, got {tuple(a.shape)} and {tuple(b.shape)}")
    c = torch.empty(M, N, dtype=torch.float32, device=a.device)
    _build.launch("fmm_gemm_nt_f32", a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K)
    return c
