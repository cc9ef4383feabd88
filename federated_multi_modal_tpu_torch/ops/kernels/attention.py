"""Packed-QKV attention: the port of the TPU kernels
``federated_multi_modal_tpu/ops/pallas/attention.py::packed_attention_masked``
(forward ``attention_packed_fwd_masked``, backward
``attention_packed_bwd_masked``), which runs the attention of every text
block on sequence-packed rows under a block-causal mask, and
``packed_attention`` (forward ``attention_packed_fwd``, backward
``attention_packed_bwd``), the mask-free attention of every vision block
that no fused block kernel takes (``FMM_TPU_FUSED=0``, and the trainable
block under ``FMM_TPU_FUSED_TRAIN_DW=0``). The attention over split q, k
and v for heads that do not pack into 128 lanes (``fused_attention``,
``fused_attention_diff``) is at the end ("split-head attention").

On CUDA tensors both launch the hand-written kernel ``csrc/attention_core.cu``
and, in the backward, ``csrc/attention_core_bwd.cu``
(:func:`packed_attention_masked_bwd`, :func:`packed_attention_bwd`); on CPU
tensors they run the plain PyTorch versions beside them. Nothing else
selects between the two. The forward saves ``qkv`` only and the backward
recomputes the probabilities from it, as the TPU kernels do; the mask gets
no gradient.

Bound on the H100: memory. At the text shape of the MaPLe paths, qkv
``(200, 120, 1536)`` bf16 with 8 heads, the forward reads ~74 MB and writes
~25 MB (~29 us at 3.35 TB/s) and the backward reads ~98 MB and writes
~74 MB (~51 us), for ~0.6 and ~1.5 GFLOP on the mask's finite pairs. At the
vision shape ``(512, 200, 2304)`` with 12 heads the forward moves ~629 MB
(~0.19 ms) and the backward ~1.1 GB (~0.33 ms), for ~63 and ~157 GFLOP.
Both stream 64-row tiles through shared memory and run their products on
the tensor cores with the scores in registers, so no score tensor reaches
device memory: the forward in one pass over the key tiles (rows of up to 256
keys at head widths up to 64) or two (statistics, then P.V), the backward in
three (row statistics, dK and dV, dQ) with two fp32 ``(B, H, T)`` scratch
vectors between them; see the sources for what keeps them off their bounds.
Both take any T and any head width that is a multiple of 8 up to 128.
"""

from __future__ import annotations

import contextlib
import math

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build


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


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              n_head: int, attn_mask: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """Plain PyTorch attention over ``(B, T, D)`` q, k and v with the TPU
    kernels' numerics (``_attn_body``): fp32 scores and softmax (products
    of the storage dtype's values, exact in fp32, TF32 off), the additive
    mask, ``p`` rounded to the storage dtype before P.V, fp32 P.V sums,
    output in the storage dtype. Differentiable by autograd."""
    B, T, D = q.shape
    hd = D // n_head

    def heads(t):
        return t.reshape(B, T, n_head, hd).transpose(1, 2).float()

    with full_fp32_products():
        s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if attn_mask is not None:
            s = s + attn_mask.float()
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out = torch.matmul(p.float(), heads(v)).to(q.dtype)
    return out.transpose(1, 2).reshape(B, T, D)


def attention_core_reference(qkv: torch.Tensor, n_head: int,
                             mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``attention_core.cu``: :func:`fused_attention_reference`
    over the column split of a packed ``(B, T, 3D)`` QKV tensor."""
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return fused_attention_reference(q, k, v, n_head, mask)


def _attention_core_args(qkv: torch.Tensor, n_head: int, mask: torch.Tensor | None,
                         valid_T: int | None) -> tuple:
    """The arguments of ``attention_core.cu``'s entry points after the
    checks of what it takes: qkv, the fp32 mask or None, the output, B, T,
    D, heads, valid_T and the scale."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    if not qkv.is_cuda:
        raise ValueError(f"attention_core runs on CUDA tensors, got {qkv.device}")
    if (qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
            or qkv.data_ptr() % 16):
        raise ValueError(
            f"attention_core takes contiguous 16-byte aligned bf16 qkv, got "
            f"{qkv.dtype}")
    hd = D // n_head
    if D3 != 3 * D or D != n_head * hd or hd % 8 or hd > 128:
        raise ValueError(
            f"attention_core takes head widths that are multiples of 8 up to 128: "
            f"D={D}, {n_head} heads")
    valid_T = T if valid_T is None else valid_T
    if not 1 <= valid_T <= T:
        raise ValueError(f"valid_T must lie in [1, {T}], got {valid_T}")
    if mask is not None:
        if mask.shape != (T, T) or mask.device != qkv.device:
            raise ValueError(f"mask must be ({T}, {T}) on {qkv.device}")
        mask = mask.to(torch.float32).contiguous()
    out = torch.empty(B, T, D, dtype=qkv.dtype, device=qkv.device)
    return (qkv.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, T, D, n_head, valid_T, 1.0 / math.sqrt(hd)), out


def attention_core_cuda(qkv: torch.Tensor, n_head: int,
                        mask: torch.Tensor | None = None,
                        valid_T: int | None = None) -> torch.Tensor:
    """Launch ``attention_core.cu`` on a CUDA ``(B, T, 3D)`` bf16 tensor,
    any T, head widths that are multiples of 8 up to 128; keys at or past
    ``valid_T`` (default T: none) get ``-inf``. The kernel chooses one pass
    over the key tiles or two (:func:`attention_core_key_tiles`)."""
    args, out = _attention_core_args(qkv, n_head, mask, valid_T)
    _build.launch("fmm_attention_core", *args)
    return out


def attention_core_key_tiles(head_dim: int, valid_T: int) -> int:
    """The key tiles ``attention_core.cu`` holds in registers at this head
    width and ``valid_T``, as the kernel chooses: 2 or 4 (one pass over the
    key tiles), 0 (two passes). Launches nothing."""
    return _build.library().fmm_attention_core_key_tiles(head_dim, valid_T)


def _attention_core_cuda_forced(qkv: torch.Tensor, n_head: int, key_tiles: int,
                                mask: torch.Tensor | None = None,
                                valid_T: int | None = None) -> torch.Tensor:
    """:func:`attention_core_cuda` with the kernel's variant forced, for
    tests and timings only: ``key_tiles`` 0 takes two passes, 2 or 4 one
    pass (head widths up to 64, ``valid_T`` up to 64 ``key_tiles``)."""
    args, out = _attention_core_args(qkv, n_head, mask, valid_T)
    _build.launch("fmm_attention_core_forced", *args, key_tiles)
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
    ``g (B, T, D)``, any T, head widths that are multiples of 8 up to 128;
    its row statistics (log-sum-exp and rowsum(dP * P), fp32 ``(B, H, T)``
    each) go through scratch allocated here."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    for name, t, shape in (("qkv", qkv, (B, T, D3)), ("g", g, (B, T, D))):
        if (not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16 or tuple(t.shape) != shape):
            raise ValueError(
                f"attention_core_bwd takes a contiguous 16-byte aligned bf16 "
                f"CUDA {name} of shape {shape}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}")
    hd = D // n_head
    if D3 != 3 * D or D != n_head * hd or hd % 8 or hd > 128:
        raise ValueError(
            f"attention_core_bwd takes head widths that are multiples of 8 up to 128: "
            f"D={D}, {n_head} heads")
    if mask is not None:
        if mask.shape != (T, T) or mask.device != qkv.device:
            raise ValueError(f"mask must be ({T}, {T}) on {qkv.device}")
        mask = mask.to(torch.float32).contiguous()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(2, B, n_head, T, dtype=torch.float32, device=qkv.device)
    _build.launch(
        "fmm_attention_core_bwd", qkv.data_ptr(), g.data_ptr(),
        None if mask is None else mask.data_ptr(), stats.data_ptr(), dqkv.data_ptr(),
        B, T, D, n_head, 1.0 / math.sqrt(hd),
    )
    return dqkv


class _PackedAttention(torch.autograd.Function):
    """``forward`` and ``backward`` are the two halves of a TPU kernel's
    custom VJP, given as functions (the kernels or their plain versions) of
    ``(qkv, mask, n_head)`` and ``(qkv, g, mask, n_head)``; ``mask`` is
    ``None`` for the mask-free kernel."""

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
    (packed_attention if attn_mask is None else packed_attention_masked).launches += 1
    return out


def _bwd_cuda(qkv, g, attn_mask, n_head):
    if attn_mask is None:
        return packed_attention_bwd(qkv, g, n_head)
    return packed_attention_masked_bwd(qkv, g, attn_mask, n_head)


def packed_attention_masked_reference(qkv: torch.Tensor, attn_mask: torch.Tensor,
                                      n_head: int) -> torch.Tensor:
    """Plain version of :func:`packed_attention_masked`, forward and
    backward, on any device."""
    return _PackedAttention.apply(qkv, attn_mask, n_head, _fwd_reference,
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
    return _PackedAttention.apply(qkv, attn_mask, n_head, _fwd_cuda, _bwd_cuda)


def packed_attention_reference(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """Plain version of :func:`packed_attention`, forward and backward, on
    any device."""
    return _PackedAttention.apply(qkv, None, n_head, _fwd_reference, _bwd_reference)


def packed_attention_bwd(qkv: torch.Tensor, g: torch.Tensor, n_head: int) -> torch.Tensor:
    """d(QKV) of :func:`packed_attention` for the output cotangent ``g``:
    the port of ``attention_packed_bwd``."""
    if qkv.device.type == "cpu":
        return attention_core_bwd_reference(qkv, g, n_head)
    dqkv = attention_core_bwd_cuda(qkv, g, n_head)
    packed_attention_bwd.launches += 1
    return dqkv


def packed_attention(qkv: torch.Tensor, n_head: int) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd)).v per head over a packed ``(B, T, 3D)`` QKV
    tensor -> ``(B, T, D)``, differentiable in ``qkv``: the mask-free
    attention of a vision block outside the fused block kernels."""
    if qkv.device.type == "cpu":
        return packed_attention_reference(qkv, n_head)
    return _PackedAttention.apply(qkv.contiguous(), None, n_head, _fwd_cuda, _bwd_cuda)


for _fn in (packed_attention_masked, packed_attention_masked_bwd, packed_attention,
            packed_attention_bwd):
    _fn.launches = 0


# -- split-head attention --------------------------------------------------
#
# The port of ``fused_attention`` (K8: ``_attn_kernel_nomask`` and
# ``_attn_kernel``, ``pallas_call`` at ``attention.py:127`` and ``:147``) and
# of ``fused_attention_diff``, its custom VJP: the attention that
# ``multi_head_attention`` runs when ``T >= 32`` and the heads do not pack
# into 128 lanes. No backbone of the repository has such heads. On CUDA
# tensors the forward launches ``csrc/attention_split.cu``, which reads q, k
# and v through their own row strides (the column split of the packed QKV,
# no copy), takes any head width that is a multiple of 8 up to 128 and any T
# (key tiles stream through shared memory). The backward is the VJP of
# :func:`fused_attention_reference`, recomputed from the saved q, k and v, as
# ``_fad_bwd`` derives it through XLA; the mask gets no gradient. Bound on
# the H100: memory (see the source).


def fused_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                         attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``attention_split.cu`` on CUDA bf16 ``(B, T, D)`` q, k and v,
    each with unit column stride, a row stride that is a multiple of 8 and
    a batch stride of T rows."""
    B, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (not t.is_cuda or t.dtype != torch.bfloat16 or tuple(t.shape) != (B, T, D)
                or t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) != T * t.stride(1)
                or t.data_ptr() % 16):
            raise ValueError(
                f"fused_attention takes bf16 CUDA q, k, v of one shape {(B, T, D)} with "
                f"unit column stride, a row stride that is a multiple of 8 and a batch "
                f"stride of T rows; got {name} {t.dtype} {tuple(t.shape)} strides "
                f"{t.stride()} on {t.device}")
    hd = D // n_head
    if D != n_head * hd or hd % 8 or hd > 128:
        raise ValueError(f"fused_attention takes head widths that are multiples of 8 up "
                         f"to 128: D={D}, {n_head} heads")
    if attn_mask is not None:
        if attn_mask.shape != (T, T) or attn_mask.device != q.device:
            raise ValueError(f"attn_mask must be ({T}, {T}) on {q.device}")
        attn_mask = attn_mask.to(torch.float32).contiguous()
    out = torch.empty(B, T, D, dtype=q.dtype, device=q.device)
    _build.launch(
        "fmm_attention_split", q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1),
        k.stride(1), v.stride(1), None if attn_mask is None else attn_mask.data_ptr(),
        out.data_ptr(), B, T, D, n_head, hd, 1.0 / math.sqrt(hd))
    return out


def _fused_attention_launch(q, k, v, n_head, attn_mask):
    out = fused_attention_cuda(q, k, v, n_head, attn_mask)
    fused_attention.launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                    attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q.k^T / sqrt(hd) + M).v per head over ``(B, T, D)`` q, k and
    v with an optional additive ``(T, T)`` mask -> ``(B, T, D)``, before the
    out-projection. Forward-only, like the TPU kernel:
    :func:`fused_attention_diff` is its differentiable form."""
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("fused_attention is forward-only, like the TPU kernel; "
                                  "use fused_attention_diff")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, n_head, attn_mask)
    return _fused_attention_launch(q, k, v, n_head, attn_mask)


class _FusedAttentionDiff(torch.autograd.Function):
    """``fwd`` (the kernel or the plain version) forward; the backward
    recomputes :func:`fused_attention_reference` from the saved q, k and v
    and takes its VJP, in full fp32 products."""

    @staticmethod
    def forward(ctx, q, k, v, n_head, attn_mask, fwd):
        ctx.save_for_backward(q, k, v)
        ctx.n_head, ctx.attn_mask = n_head, attn_mask
        return fwd(q, k, v, n_head, attn_mask)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad(), full_fp32_products():
            leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = fused_attention_reference(*leaves, ctx.n_head, ctx.attn_mask)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None, None


def fused_attention_diff_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   n_head: int, attn_mask: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """Plain version of :func:`fused_attention_diff`, on any device."""
    return _FusedAttentionDiff.apply(q, k, v, n_head, attn_mask, fused_attention_reference)


def fused_attention_diff(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                         attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`fused_attention`, differentiable in q, k and v (the mask is a
    constant and gets no gradient)."""
    if q.device.type == "cpu":
        return fused_attention_diff_reference(q, k, v, n_head, attn_mask)
    return _FusedAttentionDiff.apply(q, k, v, n_head, attn_mask, _fused_attention_launch)


def multi_head_attention_pallas(x: torch.Tensor, p, n_head: int,
                                attn_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's drop-in for ``multi_head_attention`` over
    :func:`fused_attention` (forward-only; same packed-QKV parameters)."""
    from federated_multi_modal_tpu_torch.ops.primitives import linear

    qkv = linear(x, p["w_qkv"], p["b_qkv"])
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    return linear(fused_attention(q, k, v, n_head, attn_mask), p["w_out"], p["b_out"])


fused_attention.launches = 0
