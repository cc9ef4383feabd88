"""MaPLe's functional half (port of ``federated_multi_modal_tpu/trainers/
maple.py``): the unfreeze predicate, the prompt learner's parameters and
forward, the caption token, and the prompt-cached eval functions.

The coupled prompt learner alternates: even depths own a text-side prompt
projected into the vision width, odd depths a vision-side prompt projected
into the text width. The ``MaPLe`` trainer class is still to port; the loss
is ``flagship.py``'s.
"""

from __future__ import annotations

from typing import List

import torch

from federated_multi_modal_tpu_torch.engine.tree import merge_trees
from federated_multi_modal_tpu_torch.models.clip_model import (
    embed_tokens,
    encode_image,
    encode_text_embedded,
)
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_linear,
    assemble_prompts_end,
    linear_params,
    random_ctx_vectors,
)


def maple_trainable_predicate(visual_layers: int, text_layers: int):
    """Prompt learner + every LayerNorm + the last block of both towers."""
    ln_names = ("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final")
    vis_last = f"visual.blocks.{visual_layers - 1}."
    txt_last = f"text.blocks.{text_layers - 1}."

    def pred(path: str) -> bool:
        if path.startswith("prompt_learner"):
            return True
        if any(f".{ln}." in path or path.endswith(ln) for ln in ln_names):
            return True
        return vis_last in path or txt_last in path

    return pred


def init_maple_prompt_learner(generator: torch.Generator, arch, n_ctx: int,
                              depth: int, ctx_vectors: torch.Tensor,
                              use_captions: bool) -> dict:
    """The MultiModalPromptLearner parameter tree (the JAX package's names;
    ``proj_vis_to_lang`` and the caption parameters are unused by eval and
    kept for checkpoint parity)."""
    d_text = arch.transformer_width
    d_vis = arch.vision_width
    pl = {
        "ctx": ctx_vectors,
        "proj_lang_to_vis": linear_params(generator, d_text, d_vis),
        "proj_vis_to_lang": linear_params(generator, d_vis, d_text),
    }
    text_deep, vis_deep, couplers = [], [], []
    for i in range(depth - 1):
        if i % 2 == 0:
            text_deep.append(random_ctx_vectors(generator, n_ctx, d_text))
            couplers.append(linear_params(generator, d_text, d_vis))
        else:
            vis_deep.append(random_ctx_vectors(generator, n_ctx, d_vis))
            couplers.append(linear_params(generator, d_vis, d_text))
    pl.update(text_deep_params=text_deep, vis_deep_params=vis_deep,
              couplers=couplers)
    if use_captions:
        pl["caption_pool_w"] = torch.randn(d_text, generator=generator) * d_text ** -0.5
        pl["caption_proj"] = linear_params(generator, d_text, d_vis)
    return pl


def maple_prompts(pl: dict, prefix, suffix, depth: int):
    """The prompt learner's forward: the assembled text prompts, the shared
    vision context and the coupled deep prompt lists."""
    text_deep: List = [None] * (depth - 1)
    vis_deep: List = [None] * (depth - 1)
    ti = vi = 0
    for i in range(depth - 1):
        proj = pl["couplers"][i]
        if i % 2 == 0:
            p = pl["text_deep_params"][ti]
            vis_deep[i] = apply_linear(proj, p)
            text_deep[i] = p
            ti += 1
        else:
            p = pl["vis_deep_params"][vi]
            text_deep[i] = apply_linear(proj, p)
            vis_deep[i] = p
            vi += 1
    shared_ctx = apply_linear(pl["proj_lang_to_vis"], pl["ctx"])
    prompts = assemble_prompts_end(pl["ctx"], prefix, suffix)
    return prompts, shared_ctx, text_deep, vis_deep


def caption_tokens_to_extra(pl: dict, text_params, caption_tokens):
    """Pool the frozen caption embeddings into one vision-width token per
    image: ``(B, 77)`` token ids -> ``(B, 1, width)`` fp32. The embeddings
    get no gradient; the pooling softmax runs in fp32."""
    emb = embed_tokens(text_params, caption_tokens).detach().float()  # (B, 77, d)
    scores = torch.einsum("btd,d->bt", emb, pl["caption_pool_w"].float())
    probs = torch.softmax(scores, dim=1)
    pooled = torch.einsum("btd,bt->bd", emb, probs)
    return apply_linear(pl["caption_proj"], pooled)[:, None, :]


def make_maple_eval_fns(arch, depth: int, text_len: int):
    """Prompt-cached eval: ``eval_prepare_fn`` computes the image-independent
    text features once; ``eval_apply_fn`` runs image batches against them.
    Both take the ``{"model", "prompt_const"}`` frozen layout."""

    @torch.no_grad()
    def eval_prepare_fn(trainable, frozen):
        m = merge_trees(trainable, frozen["model"])
        pc = frozen["prompt_const"]
        prompts, shared_ctx, text_deep, vis_deep = maple_prompts(
            m["prompt_learner"], pc["token_prefix"], pc["token_suffix"], depth)
        txt = encode_text_embedded(
            m["clip"]["text"], arch, prompts, pc["eot_index"],
            deep_prompts=text_deep, max_len=text_len)
        scale = torch.clamp(torch.exp(m["clip"]["logit_scale"].float()), max=100.0)
        return {"txt_n": l2_normalize(txt), "shared_ctx": shared_ctx,
                "vis_deep": vis_deep, "scale": scale}

    @torch.no_grad()
    def eval_apply_fn(trainable, frozen, images, prep):
        m = merge_trees(trainable, frozen["model"])
        img = encode_image(
            m["clip"]["visual"], arch, images,
            shallow_prompts=prep["shared_ctx"],
            deep_prompts=prep["vis_deep"], inference=True)
        return prep["scale"] * l2_normalize(img) @ prep["txt_n"].T

    return eval_prepare_fn, eval_apply_fn
