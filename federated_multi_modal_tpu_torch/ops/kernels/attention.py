"""Masked packed-QKV attention: the port of the TPU kernel
``federated_multi_modal_tpu/ops/pallas/attention.py::packed_attention_masked``
and its custom VJP (forward ``attention_packed_fwd_masked``, backward
``attention_packed_bwd_masked``), which runs the attention of every text
block on sequence-packed rows under a block-causal mask.

On CUDA tensors :func:`packed_attention_masked` launches the hand-written
kernel ``csrc/attention_core.cu`` and, in the backward,
``csrc/attention_core_bwd.cu`` (:func:`packed_attention_masked_bwd`); on CPU
tensors it runs the plain PyTorch versions beside them. Nothing else
selects between the two. The forward saves ``qkv`` only and the backward
recomputes the probabilities from it, as the TPU kernel does; the mask gets
no gradient.

Bound on the H100: memory. At the text shape of the MaPLe paths, qkv
``(200, 120, 1536)`` bf16 with 8 heads, the forward reads ~74 MB and writes
~25 MB (~29 us at 3.35 TB/s) and the backward reads ~98 MB and writes
~74 MB (~51 us), for ~0.6 and ~1.5 GFLOP on the mask's finite pairs. Both
kernels read each head's q, k and v (and g) once into shared memory and
keep the scores and probabilities there, so no score tensor reaches device
memory; see the sources for what still keeps them off their bounds.
"""

from __future__ import annotations

import contextlib
import math

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build

HEAD_DIM = 64  # the only head width attention_core.cu is built for
MAX_TOKENS = 512  # kMaxT in attention_core.cu: a head's q, k, v in shared memory
MAX_TOKENS_BWD = 320  # kMaxT in attention_core_bwd.cu: q, k, v and g of a head


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


def attention_core_bwd_reference(qkv: torch.Tensor, g: torch.Tensor, n_head: int,
                                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain d(QKV) of :func:`attention_core_reference` for the output
    cotangent ``g (B, T, D)``, with the TPU kernels' numerics
    (``_packed_bwd_body``): the fp32 probabilities recomputed; ``p`` rounded
    to the storage dtype for dV = P^T g; dP = g v^T and rowsum(dP * P) over
    the fp32 P; dS = P * (dP - rowsum) * scale rounded to the storage dtype
    before dQ = dS k and dK = dS^T q; fp32 sums; the mask gets no gradient.
    Returns the packed ``(B, T, 3D)`` gradient in the storage dtype."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_head
    dt = qkv.dtype
    scale = 1.0 / math.sqrt(hd)

    def heads(t):
        return t.reshape(B, T, n_head, hd).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(D, dim=-1))
    gh = heads(g.to(dt))
    with full_fp32_products():
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask.float()
        p = torch.softmax(s, dim=-1)
        dv = torch.matmul(p.to(dt).float().transpose(-1, -2), gh).to(dt)
        dp = torch.matmul(gh, v.transpose(-1, -2))
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dt).float()
        dq = torch.matmul(ds, k).to(dt)
        dk = torch.matmul(ds.transpose(-1, -2), q).to(dt)
    return torch.cat([t.transpose(1, 2).reshape(B, T, D) for t in (dq, dk, dv)],
                     dim=-1)


def attention_core_bwd_cuda(qkv: torch.Tensor, g: torch.Tensor, n_head: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``attention_core_bwd.cu`` on CUDA bf16 ``qkv (B, T, 3D)`` and
    ``g (B, T, D)``."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    for name, t, shape in (("qkv", qkv, (B, T, D3)), ("g", g, (B, T, D))):
        if (not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16 or tuple(t.shape) != shape):
            raise ValueError(
                f"attention_core_bwd takes a contiguous 16-byte aligned bf16 "
                f"CUDA {name} of shape {shape}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    if D != n_head * HEAD_DIM:
        raise ValueError(
            f"attention_core_bwd is built for head width {HEAD_DIM}: D={D}, "
            f"{n_head} heads")
    if T > MAX_TOKENS_BWD:
        raise ValueError(
            f"attention_core_bwd holds at most {MAX_TOKENS_BWD} tokens per row "
            f"in shared memory, got T={T}")
    if mask is not None:
        if mask.shape != (T, T) or mask.device != qkv.device:
            raise ValueError(f"mask must be ({T}, {T}) on {qkv.device}")
        mask = mask.to(torch.float32).contiguous()
    dqkv = torch.empty_like(qkv)
    _build.launch(
        "fmm_attention_core_bwd", qkv.data_ptr(), g.data_ptr(),
        None if mask is None else mask.data_ptr(), dqkv.data_ptr(),
        B, T, D, n_head, 1.0 / math.sqrt(HEAD_DIM),
    )
    return dqkv


class _PackedAttentionMasked(torch.autograd.Function):
    """``forward`` and ``backward`` are the two halves of the TPU kernel's
    custom VJP, given as functions (the kernels or their plain versions)."""

    @staticmethod
    def forward(ctx, qkv, attn_mask, n_head, fwd, bwd):
        ctx.save_for_backward(qkv)
        ctx.attn_mask, ctx.n_head, ctx.bwd = attn_mask, n_head, bwd
        return fwd(qkv, attn_mask, n_head)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return ctx.bwd(qkv, g.contiguous(), ctx.attn_mask, ctx.n_head), None, None, None, None


def _fwd_reference(qkv, attn_mask, n_head):
    return attention_core_reference(qkv, n_head, attn_mask)


def _bwd_reference(qkv, g, attn_mask, n_head):
    return attention_core_bwd_reference(qkv, g, n_head, attn_mask)


def _fwd_cuda(qkv, attn_mask, n_head):
    out = attention_core_cuda(qkv, n_head, attn_mask)
    packed_attention_masked.launches += 1
    return out


def packed_attention_masked_reference(qkv: torch.Tensor, attn_mask: torch.Tensor,
                                      n_head: int) -> torch.Tensor:
    """Plain version of :func:`packed_attention_masked`, forward and
    backward, on any device."""
    return _PackedAttentionMasked.apply(qkv, attn_mask, n_head, _fwd_reference,
                                        _bwd_reference)


def packed_attention_masked_bwd(qkv: torch.Tensor, g: torch.Tensor,
                                attn_mask: torch.Tensor, n_head: int) -> torch.Tensor:
    """d(QKV) of :func:`packed_attention_masked` for the output cotangent
    ``g``: the port of ``attention_packed_bwd_masked``."""
    if qkv.device.type == "cpu":
        return attention_core_bwd_reference(qkv, g, n_head, attn_mask)
    dqkv = attention_core_bwd_cuda(qkv, g, n_head, attn_mask)
    packed_attention_masked_bwd.launches += 1
    return dqkv


def packed_attention_masked(qkv: torch.Tensor, attn_mask: torch.Tensor,
                            n_head: int) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd) + M).v per head over a packed ``(B, T, 3D)``
    QKV tensor with a constant additive ``(T, T)`` mask -> ``(B, T, D)``;
    differentiable in ``qkv``."""
    if qkv.device.type == "cpu":
        return packed_attention_masked_reference(qkv, attn_mask, n_head)
    return _PackedAttentionMasked.apply(qkv, attn_mask, n_head, _fwd_cuda,
                                        packed_attention_masked_bwd)


packed_attention_masked.launches = 0
packed_attention_masked_bwd.launches = 0
