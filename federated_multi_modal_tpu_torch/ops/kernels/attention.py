"""Masked packed-QKV attention: the port of the TPU kernel
``federated_multi_modal_tpu/ops/pallas/attention.py::packed_attention_masked``
(forward ``attention_packed_fwd_masked``), which runs the attention of every
text block on sequence-packed rows under a block-causal mask.

On a CUDA tensor :func:`packed_attention_masked` launches the hand-written
kernel ``csrc/attention_core.cu``; on a CPU tensor it runs the plain
PyTorch version beside it. Nothing else selects between the two.

Bound on the H100: memory. At the text shape of the MaPLe eval path, qkv
``(200, 120, 1536)`` bf16 with 8 heads, a launch reads ~74 MB and writes
~25 MB (~29 us at 3.35 TB/s) for ~6 GFLOP (~6 us at 989 TFLOP/s). The
kernel reads each head's q, k and v once into shared memory and keeps the
scores and probabilities there, so no score tensor reaches device memory;
see the source for what still keeps it off its bound.

Only the forward is ported: the wrapper refuses a ``qkv`` that requires a
gradient until the training slice brings the backward kernel
(``attention_packed_bwd_masked``).
"""

from __future__ import annotations

import contextlib
import math

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build

HEAD_DIM = 64  # the only head width attention_core.cu is built for
MAX_TOKENS = 512  # kMaxT in attention_core.cu: a head's q, k, v in shared memory


@contextlib.contextmanager
def full_fp32_products():
    """Switch TF32 off (``allow_tf32 = False`` for matmul and cuDNN) for the
    plain versions' fp32 products, so that on the card they run in full
    fp32, and put the caller's settings back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def attention_core_reference(qkv: torch.Tensor, n_head: int,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch attention over packed ``(B, T, 3D)`` QKV with the TPU
    kernels' numerics: fp32 scores and softmax (products of the storage
    dtype's values, exact in fp32, TF32 off), ``p`` rounded to the storage
    dtype before P.V, fp32 P.V sums, output in the storage dtype."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_head
    q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2).float()
               for t in qkv.split(D, dim=-1))
    with full_fp32_products():
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1).to(qkv.dtype)
        out = torch.matmul(p.float(), v).to(qkv.dtype)
    return out.transpose(1, 2).reshape(B, T, D)


def attention_core_cuda(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``attention_core.cu`` on a CUDA ``(B, T, 3D)`` bf16 tensor."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    if not qkv.is_cuda:
        raise ValueError(f"attention_core runs on CUDA tensors, got {qkv.device}")
    if (qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError(
            f"attention_core takes contiguous 16-byte aligned bf16 qkv, got "
            f"{qkv.dtype}")
    if D != n_head * HEAD_DIM:
        raise ValueError(
            f"attention_core is built for head width {HEAD_DIM}: D={D}, "
            f"{n_head} heads")
    if T > MAX_TOKENS:
        raise ValueError(
            f"attention_core holds at most {MAX_TOKENS} tokens per row in "
            f"shared memory, got T={T}")
    if mask is not None:
        if mask.shape != (T, T) or mask.device != qkv.device:
            raise ValueError(f"mask must be ({T}, {T}) on {qkv.device}")
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty(B, T, D, dtype=qkv.dtype, device=qkv.device)
    _build.launch(
        "fmm_attention_core", qkv.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        B, T, D, n_head, T, 1.0 / math.sqrt(HEAD_DIM),
    )
    return out


def packed_attention_masked_reference(qkv: torch.Tensor, attn_mask: torch.Tensor,
                                      n_head: int) -> torch.Tensor:
    """Plain version of :func:`packed_attention_masked`."""
    return attention_core_reference(qkv, n_head, attn_mask)


def packed_attention_masked(qkv: torch.Tensor, attn_mask: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd) + M).v per head over a packed ``(B, T, 3D)``
    QKV tensor with a constant additive ``(T, T)`` mask -> ``(B, T, D)``."""
    if qkv.requires_grad:
        raise NotImplementedError(
            "packed_attention_masked has no backward kernel in the port yet "
            "(attention_packed_bwd_masked is the next slice's)")
    if qkv.device.type == "cpu":
        return packed_attention_masked_reference(qkv, attn_mask, n_head)
    out = attention_core_cuda(qkv, n_head, attn_mask)
    packed_attention_masked.launches += 1
    return out


packed_attention_masked.launches = 0

