"""The flagship MaPLe program, eval half (port of
``federated_multi_modal_tpu/flagship.py::build_maple_program``): parameters
and the prompt-cached eval functions, without the data manager or trainer.
The loss and the train step come with the training slice."""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.tree import cast_tree, split_tree, to_device
from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
from federated_multi_modal_tpu_torch.trainers.common import (
    build_prompt_constants,
    ctx_init_vectors,
)
from federated_multi_modal_tpu_torch.trainers.maple import (
    init_maple_prompt_learner,
    maple_trainable_predicate,
    make_maple_eval_fns,
)

DEFAULT_CLASSNAMES = [
    "airport", "beach", "bridge", "farmland", "forest",
    "harbor", "parking lot", "river", "runway", "storage tank",
]


def build_maple_program(
    backbone: str = "ViT-B/16",
    classnames=None,
    n_ctx: int = 2,
    depth: int = 9,
    use_captions: bool = True,
    seed: int = 0,
    device=None,
):
    """Random-init MaPLe state and its eval functions.

    Returns a dict with ``arch, trainable, frozen, eval_prepare_fn,
    eval_apply_fn, n_cls, text_len``: ``trainable`` (prompt learner, every
    LayerNorm, the last block of each tower) in fp32, ``frozen`` under the
    dtype policy, both on ``device`` (``None`` means ``"cuda"``).
    ``eval_prepare_fn(trainable, frozen)`` computes the text features once;
    ``eval_apply_fn(trainable, frozen, images, prep)`` gives the logits of
    an image batch.
    """
    device = resolve_device(device)
    classnames = classnames or DEFAULT_CLASSNAMES
    arch = BACKBONE_CONFIGS[backbone]
    depth = min(depth, arch.vision_layers)
    gen = torch.Generator().manual_seed(seed)
    clip_params = init_clip_params(arch, gen)

    const = build_prompt_constants(clip_params["text"], classnames,
                                   "a photo of a", n_ctx)
    ctx = ctx_init_vectors(clip_params["text"], "a photo of a", n_ctx)
    pl = init_maple_prompt_learner(gen, arch, n_ctx, depth, ctx, use_captions)

    model = {"clip": clip_params, "prompt_learner": pl}
    pred = maple_trainable_predicate(arch.vision_layers, arch.transformer_layers)
    trainable, frozen_model = split_tree(model, pred)
    trainable = cast_tree(trainable, torch.float32)
    frozen = {
        "model": frozen_model,
        "prompt_const": {
            "token_prefix": const.token_prefix,
            "token_suffix": const.token_suffix,
            "eot_index": const.eot_index,
        },
    }
    eval_prepare_fn, eval_apply_fn = make_maple_eval_fns(arch, depth, const.text_len)
    return {
        "arch": arch,
        "trainable": to_device(trainable, device),
        "frozen": to_device(frozen, device),
        "eval_prepare_fn": eval_prepare_fn,
        "eval_apply_fn": eval_apply_fn,
        "n_cls": len(classnames),
        "text_len": const.text_len,
        "n_ctx": n_ctx,
        "use_captions": use_captions,
    }
