"""Core compute primitives for the CLIP transformer stacks (port of
``federated_multi_modal_tpu/ops/primitives.py``).

Same contract as the JAX module: functions on ``(batch, tokens, dim)``
tensors, weights stored input-major ``(d_in, d_out)``, LayerNorm in fp32
and cast back. The routing of :func:`multi_head_attention` and
:func:`residual_block` mirrors the JAX package's under its ``"pallas"``
implementation: its shape predicates and its environment gates
(``FMM_TPU_FUSED``, ``FMM_TPU_FUSED_BLOCK``, ``FMM_TPU_FUSED_TRAIN``,
``FMM_TPU_FUSED_TRAIN_BLOCK``, ``FMM_TPU_FUSED_TRAIN_DW``), read when a
block is routed. With the defaults:

* text rows with a mask and ``T >= 32`` -> ``packed_attention_masked``;
* ``T >= 32`` with heads that do not pack into 128 lanes (no backbone of
  the repository has them) -> ``fused_attention_diff``;
* inference blocks without a mask -> ``fused_block_residual``, or, for
  groups of ``FMM_TPU_FUSED_NBLK > 1`` blocks of the eval tower,
  ``fused_block_group_residual`` (:func:`residual_block_group`);
* training blocks without a mask -> ``fused_block_train_dw`` when any of
  the block's attention or MLP weights requires a gradient, else
  ``fused_block_train`` (the JAX package declares which blocks train in a
  module global, ``set_vision_attn_wgrad_blocks``; the port reads it from
  the tensors, so a trainable weight can never take K3's zero gradient);
* ``T < 32`` -> the plain formulation (the JAX package's XLA path).

The gates move mask-free blocks onto the other kernels, as in the JAX
package: ``FMM_TPU_FUSED_BLOCK=0`` sends the eval block to
``fused_ln_attention_residual`` and ``fused_ln_mlp_residual``;
``FMM_TPU_FUSED_TRAIN=1`` with ``FMM_TPU_FUSED_TRAIN_BLOCK=0`` sends a frozen
train block to ``fused_ln_attention`` with a plain out-projection and MLP,
and both at 0 send it to ``fused_block_train_dw``; ``FMM_TPU_FUSED_TRAIN_DW=0``
sends the trainable block, and ``FMM_TPU_FUSED=0`` every mask-free block, to
the plain block, whose attention is ``packed_attention``.

:func:`set_attention_impl` chooses between that routing (``"pallas"``) and
the JAX package's XLA route (``"xla"``), which calls no kernel at all.
"""

from __future__ import annotations

import math
import os

import torch

from federated_multi_modal_tpu_torch.ops.kernels import attention as _attn_kernels
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as _block_kernels


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, fp32 math, output in input dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor = None) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


_ATTENTION_IMPL = "pallas"


def set_attention_impl(impl: str) -> None:
    """``"pallas"``: :func:`multi_head_attention`, :func:`residual_block`,
    :func:`residual_block_group` and the eval tower's group gate take the
    kernel routes above. ``"xla"``: the gate closes, and the other two take
    the plain formulation (the JAX package's XLA path: ``torch.matmul``
    linears, eager fp32 softmax) and call no kernel wrapper;
    :func:`residual_block_group`, K9's route alone, raises. The port's default is ``"pallas"``, the
    JAX package's module default ``"xla"`` (its trainers and ``bench.py``
    set ``"pallas"`` on a TPU): the port has a kernel for every route on
    its card, so a bare call takes it."""
    global _ATTENTION_IMPL
    if impl not in ("xla", "pallas"):
        raise ValueError(f"attention implementation must be 'xla' or 'pallas', got {impl!r}")
    _ATTENTION_IMPL = impl


def attention_impl() -> str:
    return _ATTENTION_IMPL


def fused_train_enabled() -> bool:
    """``FMM_TPU_FUSED_TRAIN`` (default off): frozen train blocks take the
    fused attention kernels too (K7 when ``FMM_TPU_FUSED_TRAIN_BLOCK=0``)."""
    return os.environ.get("FMM_TPU_FUSED_TRAIN", "0").lower() in ("1", "on", "true")


def multi_head_attention(x: torch.Tensor, p, n_head: int,
                         attn_mask: torch.Tensor = None) -> torch.Tensor:
    """Self-attention with packed QKV (``w_qkv (D, 3D)``, ``b_qkv``,
    ``w_out (D, D)``, ``b_out``) and an optional additive ``(T, T)`` mask."""
    B, T, D = x.shape
    head_dim = D // n_head
    qkv = linear(x, p["w_qkv"], p["b_qkv"])

    if _ATTENTION_IMPL == "pallas":
        # heads pack into 128 lanes: the JAX package's packed-QKV kernels apply
        packs = 128 % head_dim == 0 and n_head % (128 // head_dim) == 0
        if packs and attn_mask is None:
            out = _attn_kernels.packed_attention(qkv, n_head)
            return linear(out, p["w_out"], p["b_out"])
        if packs and T >= 32:
            out = _attn_kernels.packed_attention_masked(qkv, attn_mask, n_head)
            return linear(out, p["w_out"], p["b_out"])
        if T >= 32:
            out = _attn_kernels.fused_attention_diff(*qkv.split(D, dim=-1), n_head, attn_mask)
            return linear(out, p["w_out"], p["b_out"])

    q, k, v = (t.reshape(B, T, n_head, head_dim).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    scale = 1.0 / math.sqrt(head_dim)
    # fp32 scores and softmax: products of the storage dtype's values
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_mask is not None:
        scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v)
    out = out.transpose(1, 2).reshape(B, T, D)
    return linear(out, p["w_out"], p["b_out"])


def mlp(x: torch.Tensor, p) -> torch.Tensor:
    h = quick_gelu(linear(x, p["w_fc"], p["b_fc"]))
    return linear(h, p["w_proj"], p["b_proj"])


def residual_block(x: torch.Tensor, p, n_head: int,
                   attn_mask: torch.Tensor = None,
                   inference: bool = False) -> torch.Tensor:
    """Pre-LN transformer block. ``inference=True`` asserts that no
    gradient flows through the block (eval towers); in training, a block
    none of whose attention or MLP weights requires a gradient is frozen.
    Mask-free blocks take the kernel that the JAX package's
    ``residual_block`` and ``encode_image`` pick for that case under the
    environment gates (see the module docstring)."""
    if _ATTENTION_IMPL == "xla":
        x = x + multi_head_attention(layer_norm(x, p["ln_1"]), p["attn"], n_head, attn_mask)
        return x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
    B, T, D = x.shape
    hidden = p["mlp"]["w_fc"].shape[-1]
    kernels = _block_kernels
    trainable = any(p[a][b].requires_grad for a, b in kernels.WEIGHT_LEAVES)
    # the JAX package takes the frozen-weight route for every inference
    # block, and in training for the blocks its trainers declare frozen,
    # once either train gate asks for the declaration
    frozen_route = inference or (not trainable and (
        fused_train_enabled() or kernels.fused_block_train_enabled()))
    if frozen_route and kernels.fused_ln_attention_eligible(B, T, D, n_head, attn_mask):
        mlp_fused = kernels.fused_ln_mlp_eligible(B, T, D, hidden)
        if inference:
            if kernels.fused_block_eligible(B, T, D, n_head, hidden, attn_mask):
                return kernels.fused_block_residual(x, p, n_head)
            x = kernels.fused_ln_attention_residual(x, p["ln_1"], p["attn"], n_head)
            if mlp_fused:
                return kernels.fused_ln_mlp_residual(x, p["ln_2"], p["mlp"])
            return x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
        if kernels.fused_block_train_enabled() and mlp_fused:
            return kernels.fused_block_train(x, p, n_head)
        a = kernels.fused_ln_attention(x, p["ln_1"], p["attn"]["w_qkv"],
                                       p["attn"]["b_qkv"], n_head)
        x = x + linear(a, p["attn"]["w_out"], p["attn"]["b_out"])
        return x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
    if (not inference and kernels.fused_block_train_dw_enabled()
            and kernels.fused_ln_attention_eligible(B, T, D, n_head, attn_mask)
            and kernels.fused_ln_mlp_eligible(B, T, D, hidden)):
        return kernels.fused_block_train_dw(x, p, n_head)
    x = x + multi_head_attention(layer_norm(x, p["ln_1"]), p["attn"], n_head,
                                 attn_mask)
    x = x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
    return x


def residual_block_group(x: torch.Tensor, blocks, n_head: int, inject_flags,
                         prompts, extra=None) -> torch.Tensor:
    """Consecutive inference blocks in one call of the group kernel K9, with
    the deep-prompt injections before the flagged blocks (the eval tower
    under ``FMM_TPU_FUSED_NBLK > 1``; see ``fused_block_group_residual``).
    A kernel route only: ``encode_image`` takes no group under ``"xla"``."""
    if _ATTENTION_IMPL == "xla":
        raise RuntimeError("residual_block_group is K9's route; under 'xla' run the "
                           "blocks through residual_block")
    return _block_kernels.fused_block_group_residual(x, blocks, n_head, inject_flags,
                                                     prompts, extra)


def build_causal_mask(context_length: int, device=None) -> torch.Tensor:
    """Additive causal mask: ``-inf`` above the diagonal."""
    mask = torch.full((context_length, context_length), float("-inf"),
                      dtype=torch.float32, device=device)
    return torch.triu(mask, diagonal=1)


def build_block_causal_mask(n_blocks: int, block_len: int,
                            device=None) -> torch.Tensor:
    """Block-diagonal causal mask for sequence-packed text rows: position
    ``i`` may attend to ``j`` iff both lie in the same block and
    ``j <= i``."""
    L = n_blocks * block_len
    idx = torch.arange(L, device=device)
    same_block = (idx[:, None] // block_len) == (idx[None, :] // block_len)
    causal = idx[None, :] <= idx[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(same_block & causal, zero, float("-inf"))


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """fp32 L2 normalization (reference ``F.normalize(..., eps=1e-8)``)."""
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=dim, keepdim=True)
    return x32 / torch.clamp(norm, min=eps)
