"""The flagship MaPLe program (port of
``federated_multi_modal_tpu/flagship.py``): parameters, the loss, the logits
and the prompt-cached eval functions, without the data manager or trainer;
the optimizer of the federated step, an example batch, and the analytic
FLOP count of one train step (``bench.py::estimate_train_step_flops``)."""

from __future__ import annotations

import numpy as np
import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.tree import (
    cast_tree,
    split_tree,
    to_device,
)
from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.trainers.common import (
    DEFAULT_CLASSNAMES,
    build_prompt_constants,
    ctx_init_vectors,
)
from federated_multi_modal_tpu_torch.trainers.maple import (
    init_maple_prompt_learner,
    maple_trainable_predicate,
    make_maple_eval_fns,
    make_maple_model_fns,
)



def build_maple_program(
    backbone: str = "ViT-B/16",
    classnames=None,
    n_ctx: int = 2,
    depth: int = 9,
    use_captions: bool = True,
    seed: int = 0,
    align_lambda: float = 0.5,
    remat: bool = False,
    device=None,
):
    """Random-init MaPLe state, its loss and its eval functions.

    Returns a dict with ``arch, trainable, frozen, loss_fn, logits_fn,
    eval_prepare_fn, eval_apply_fn, n_cls, text_len``:
    ``trainable`` (prompt learner, every LayerNorm, the last block of each
    tower) in fp32, ``frozen`` under the dtype policy, both on ``device``
    (``None`` means ``"cuda"``). ``loss_fn(trainable, frozen, batch) ->
    (loss, {"acc", "align"})`` (``trainers/maple.py::make_maple_model_fns``)
    with ``batch`` holding ``image (B, H, W, 3)``, ``label (B,)`` and
    optionally ``caption_tokens (B, 77)``: cross-entropy of the
    cosine logits plus ``align_lambda`` x (1 - mean cosine between each
    image and its label's text feature), with ``exp(logit_scale)`` clamped
    at 100. ``eval_prepare_fn(trainable, frozen)`` computes the text
    features once; ``eval_apply_fn(trainable, frozen, images, prep)`` gives
    the logits of an image batch. ``remat`` recomputes each block of both
    towers in the loss's backward (``bench.py --remat``, ``TPU.REMAT``).
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
    text_len = const.text_len

    logits_fn, loss_fn = make_maple_model_fns(arch, depth, text_len, use_captions,
                                              align_lambda, remat)
    eval_prepare_fn, eval_apply_fn = make_maple_eval_fns(arch, depth, text_len)
    return {
        "arch": arch,
        "trainable": to_device(trainable, device),
        "frozen": to_device(frozen, device),
        "loss_fn": loss_fn,
        "logits_fn": logits_fn,
        "eval_prepare_fn": eval_prepare_fn,
        "eval_apply_fn": eval_apply_fn,
        "n_cls": len(classnames),
        "text_len": text_len,
        "n_ctx": n_ctx,
        "use_captions": use_captions,
    }


def example_batch(arch, batch_size: int = 4, n_cls: int = 10,
                  use_captions: bool = True, seed: int = 0, device=None):
    """The JAX package's ``example_batch``: the same numpy draws from
    ``seed`` (standard-normal bf16 images, uniform labels, one tokenized
    caption per image), on ``device`` (``None`` means ``"cuda"``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    res = arch.image_resolution
    images = rng.standard_normal((batch_size, res, res, 3))
    labels = rng.integers(0, n_cls, batch_size)
    batch = {
        "image": torch.from_numpy(images.astype(np.float32)).to(torch.bfloat16).to(device),
        "label": torch.from_numpy(labels.astype(np.int32)).to(device),
    }
    if use_captions:
        captions = ["a photo of a test scene"] * batch_size
        batch["caption_tokens"] = torch.from_numpy(tokenize(captions)).to(device)
    return batch


def build_fed_optimizer(lr: float = 0.0026):
    """SGD of the federated MaPLe step: momentum 0.9, weight decay 5e-4,
    no Nesterov (the config defaults) and MaPLe's global-norm clip of 1.0
    (reference ``maple.py:577``)."""
    return build_optimizer(lr=lr, clip=1.0)


def estimate_train_step_flops(arch, batch_size, n_cls, text_len,
                              use_captions=True, n_vis_ctx=2):
    """Analytic matmul FLOPs of one MaPLe train step (a copy of the JAX
    package's ``bench.py::estimate_train_step_flops``): 2*M*N*K per product,
    LN, softmax and elementwise work excluded. Per block of width D at
    sequence length T: forward linears 24*T*D^2 and attention 4*T^2*D; the
    backward's activation gradients 1x the linears and 2x the attention;
    dW (1x the linears) for the one trainable vision block; the patch
    embedding forward only; the text tower at its EOT-truncated length over
    ``n_cls`` prompts (packing makes compute proportional to real tokens).
    42.3e12 at ViT-B/16, batch 512, 1000 classes."""
    if not arch.is_vit:
        return None
    D = arch.vision_width
    grid = arch.grid_size
    T = 1 + grid * grid + n_vis_ctx + (1 if use_captions else 0)

    def tower(rows, T, D, layers, trainable_blocks):
        lin_f = 24 * T * D * D
        attn_f = 4 * T * T * D
        fwd = layers * (lin_f + attn_f)
        bwd = layers * (lin_f + 2 * attn_f) + trainable_blocks * lin_f
        return rows * (fwd + bwd)

    flops = tower(batch_size, T, D, arch.vision_layers, trainable_blocks=1)
    patch_in = 3 * arch.vision_patch_size ** 2
    flops += batch_size * 2 * grid * grid * patch_in * D
    flops += tower(n_cls, text_len, arch.transformer_width,
                   arch.transformer_layers, trainable_blocks=0)
    return float(flops)
