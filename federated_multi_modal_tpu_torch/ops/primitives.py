"""Core compute primitives for the CLIP transformer stacks (port of
``federated_multi_modal_tpu/ops/primitives.py``).

Same contract as the JAX module: functions on ``(batch, tokens, dim)``
tensors, weights stored input-major ``(d_in, d_out)``, LayerNorm in fp32
and cast back. The routing of :func:`multi_head_attention` and
:func:`residual_block` mirrors the JAX package's under its ``"pallas"``
implementation, as predicates on shapes:

* text rows with a mask and ``T >= 32`` -> ``packed_attention_masked``;
* inference blocks without a mask -> ``fused_block_residual``;
* training blocks without a mask -> ``fused_block_train_dw`` when any of
  the block's attention or MLP weights requires a gradient, else
  ``fused_block_train`` (the JAX package declares which blocks train in a
  module global, ``set_vision_attn_wgrad_blocks``; the port reads it from
  the tensors, so a trainable weight can never take K3's zero gradient);
* ``T < 32`` -> the plain formulation (the JAX package's XLA path).

Shapes that the JAX package sends to a Pallas kernel the port has not
ported yet run the plain formulation on the CPU and raise on CUDA, so a
run on the card never takes a path without its kernel.
"""

from __future__ import annotations

import math

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


def _not_ported(x: torch.Tensor, kernel: str) -> None:
    if x.is_cuda:
        raise NotImplementedError(
            f"this shape takes the TPU kernel {kernel} in the JAX package, "
            "which has no CUDA port yet (ROADMAP.md); it runs on the CPU only")


def multi_head_attention(x: torch.Tensor, p, n_head: int,
                         attn_mask: torch.Tensor = None) -> torch.Tensor:
    """Self-attention with packed QKV (``w_qkv (D, 3D)``, ``b_qkv``,
    ``w_out (D, D)``, ``b_out``) and an optional additive ``(T, T)`` mask."""
    B, T, D = x.shape
    head_dim = D // n_head
    qkv = linear(x, p["w_qkv"], p["b_qkv"])

    # heads pack into 128 lanes: the JAX package's packed-QKV kernels apply
    packs = 128 % head_dim == 0 and n_head % (128 // head_dim) == 0
    if packs and attn_mask is None:
        _not_ported(x, "packed_attention (ops/pallas/attention.py:438)")
    elif packs and T >= 32:
        out = _attn_kernels.packed_attention_masked(qkv, attn_mask, n_head)
        return linear(out, p["w_out"], p["b_out"])
    elif T >= 32:
        _not_ported(x, "fused_attention_diff (ops/pallas/attention.py:601)")

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
    gradient flows through the block (eval towers); mask-free blocks then
    take the whole-block kernel, and in training one of the two whole-block
    train kernels, by whether the block's weights require gradients."""
    B, T, D = x.shape
    hidden = p["mlp"]["w_fc"].shape[-1]
    if _block_kernels.fused_block_eligible(B, T, D, n_head, hidden, attn_mask):
        if inference:
            return _block_kernels.fused_block_residual(x, p, n_head)
        if any(p[a][b].requires_grad for a, b in _block_kernels.WEIGHT_LEAVES):
            return _block_kernels.fused_block_train_dw(x, p, n_head)
        return _block_kernels.fused_block_train(x, p, n_head)
    x = x + multi_head_attention(layer_norm(x, p["ln_1"]), p["attn"], n_head,
                                 attn_mask)
    x = x + mlp(layer_norm(x, p["ln_2"]), p["mlp"])
    return x


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
