"""Prompt-learner building blocks (port of
``federated_multi_modal_tpu/trainers/common.py``): the frozen class-prompt
constants, context-vector initialization, prompt assembly and the small
linear layers of the prompt learners."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

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
