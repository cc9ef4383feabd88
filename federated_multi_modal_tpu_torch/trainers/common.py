"""Prompt-learner building blocks (port of
``federated_multi_modal_tpu/trainers/common.py``): the frozen class-prompt
constants, context-vector initialization, prompt assembly (class token at
the end, or at any of CoOp's positions through a layout of gathers), the
small linear layers of the prompt learners and the precision policy."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path
from federated_multi_modal_tpu_torch.models.clip_model import embed_tokens
from federated_multi_modal_tpu_torch.tokenizer import get_tokenizer, tokenize


@dataclass
class PromptConstants:
    """Frozen, class-conditioned tensors for a prompt learner."""

    tokenized: torch.Tensor       # (n_cls, 77) int32
    eot_index: torch.Tensor       # (n_cls,) int64
    token_prefix: torch.Tensor    # (n_cls, 1, d)  SOS embedding
    token_suffix: torch.Tensor    # (n_cls, 77-1-n_ctx, d)  class+EOS+pad
    full_embedding: torch.Tensor  # (n_cls, 77, d)
    name_lens: List[int] = field(default_factory=list)
    n_cls: int = 0
    n_ctx: int = 0
    # every EOT lies before text_len, so the causal text tower may stop there
    text_len: int = 77


def ctx_init_vectors(text_params, ctx_init: str, n_ctx: int) -> torch.Tensor:
    """Embed the init phrase and take tokens ``1 .. 1 + n_ctx`` (fp32)."""
    tokens = torch.from_numpy(tokenize(ctx_init.replace("_", " ")))
    emb = embed_tokens(text_params, tokens.to(text_params["token_embedding"].device))
    return emb[0, 1: 1 + n_ctx, :].float()


def random_ctx_vectors(generator: torch.Generator, n_ctx: int, dim: int,
                       n_cls: int = 0) -> torch.Tensor:
    shape = (n_cls, n_ctx, dim) if n_cls else (n_ctx, dim)
    return torch.randn(shape, generator=generator) * 0.02


def build_prompt_constants(text_params, classnames: List[str],
                           prompt_prefix: str, n_ctx: int) -> PromptConstants:
    tok = get_tokenizer()
    classnames = [name.replace("_", " ") for name in classnames]
    name_lens = [len(tok.encode(name)) for name in classnames]
    prompts = [f"{prompt_prefix} {name}." for name in classnames]

    tokenized_np = tokenize(prompts)  # (n_cls, 77) int32
    eot_np = tokenized_np.argmax(-1)
    # round up to a multiple of 8, as the JAX package does for its tiling,
    # so that both packages run the same text shapes
    max_eot = int(eot_np.max()) + 1
    text_len = min(tokenized_np.shape[1], -(-max_eot // 8) * 8)

    device = text_params["token_embedding"].device
    tokenized = torch.from_numpy(tokenized_np).to(device)
    embedding = embed_tokens(text_params, tokenized)
    return PromptConstants(
        tokenized=tokenized,
        eot_index=torch.from_numpy(eot_np).to(device),
        token_prefix=embedding[:, :1, :],
        token_suffix=embedding[:, 1 + n_ctx:, :],
        full_embedding=embedding,
        name_lens=name_lens,
        n_cls=len(classnames),
        n_ctx=n_ctx,
        text_len=text_len,
    )


def assemble_prompts_end(ctx, prefix, suffix):
    """``cat(prefix, ctx, suffix)``; ``ctx`` is (n_ctx, d) shared or
    (n_cls, n_ctx, d) class-specific."""
    n_cls = prefix.shape[0]
    if ctx.ndim == 2:
        ctx = ctx[None].expand(n_cls, *ctx.shape)
    return torch.cat([prefix, ctx.to(prefix.dtype), suffix], dim=1)


def linear_params(generator: torch.Generator, d_in: int, d_out: int) -> dict:
    """Kaiming-uniform init as torch ``nn.Linear``, input-major weight."""
    bound = 1.0 / np.sqrt(d_in)

    def uniform(*shape):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    return {"w": uniform(d_in, d_out), "b": uniform(d_out)}


def apply_linear(p, x):
    return torch.matmul(x, p["w"].to(x.dtype)) + p["b"].to(x.dtype)


def build_position_layout(position: str, n_cls: int, n_ctx: int, seq_len: int,
                          name_lens: List[int]):
    """The class-token layout of CoOp's ``end``, ``middle`` and ``front``
    positions as index tensors: ``(is_ctx, ctx_slot, src_pos)``, each
    ``(n_cls, seq_len)``; output position ``p`` of class ``i`` reads
    ``ctx[i, ctx_slot[i, p]]`` where ``is_ctx`` and else
    ``full_embedding[i, src_pos[i, p]]``. The token layout of
    ``full_embedding`` is ``[SOS, n_ctx placeholders, name (name_len
    tokens), '.', EOS, padding]``."""
    is_ctx = np.zeros((n_cls, seq_len), bool)
    ctx_slot = np.zeros((n_cls, seq_len), np.int64)
    src_pos = np.zeros((n_cls, seq_len), np.int64)
    for i, name_len in enumerate(name_lens[:n_cls]):
        name = [("fix", 1 + n_ctx + k) for k in range(name_len)]
        rest = [("fix", p) for p in range(1 + n_ctx + name_len, seq_len)]
        ctx = [("ctx", j) for j in range(n_ctx)]
        if position == "end":
            order = ctx + name + rest
        elif position == "middle":
            half = n_ctx // 2
            order = ctx[:half] + name + ctx[half:] + rest
        elif position == "front":
            order = name + ctx + rest
        else:
            raise ValueError(f"class token position {position!r}: end, middle or front")
        for p, (kind, idx) in enumerate([("fix", 0)] + order[:seq_len - 1]):
            if kind == "ctx":
                is_ctx[i, p] = True
                ctx_slot[i, p] = idx
            else:
                src_pos[i, p] = idx
    return tuple(torch.from_numpy(a) for a in (is_ctx, ctx_slot, src_pos))


def assemble_prompts_positional(ctx, full_embedding, layout):
    """Prompts for any class-token position by one gather from ``ctx``
    (``(n_ctx, d)`` shared or ``(n_cls, n_ctx, d)`` class-specific) and one
    from ``full_embedding (n_cls, seq, d)``, as ``layout``
    (:func:`build_position_layout`) says."""
    is_ctx, ctx_slot, src_pos = layout
    n_cls, _, d = full_embedding.shape
    if ctx.ndim == 2:
        ctx = ctx[None].expand(n_cls, *ctx.shape)
    ctx = ctx.to(full_embedding.dtype)
    ctx_rows = torch.gather(ctx, 1, ctx_slot[:, :, None].expand(-1, -1, d))
    fix_rows = torch.gather(full_embedding, 1, src_pos[:, :, None].expand(-1, -1, d))
    return torch.where(is_ctx[:, :, None], ctx_rows, fix_rows)


def apply_prec(prec: str, clip_params):
    """``TRAINER.*.PREC``: ``"fp32"`` casts the frozen CLIP weights to fp32;
    ``"fp16"``, ``"amp"`` and ``"bf16"`` keep the bf16 policy with fp32
    LayerNorms."""
    if prec == "fp32":
        return tree_map_with_path(lambda _, t: t.to(torch.float32), clip_params)
    return clip_params
