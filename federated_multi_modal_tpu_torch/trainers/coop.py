"""CoOp, context optimization (port of the functional half of
``federated_multi_modal_tpu/trainers/coop.py``): learnable text context
vectors, shared or class-specific, with the class token at the end, the
middle or the front, on a frozen CLIP. Only the prompt learner trains; the
image tower is frozen and prompt-free, so it takes the inference kernels
(``encode_image_auto(..., inference=True)``) in the train step and in eval.

The ``CoOp`` trainer class, its registry entry, the LR schedule and the
checkpoint surface wait for the trainer engine (ROADMAP module item 8).
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.flagship import DEFAULT_CLASSNAMES
from federated_multi_modal_tpu_torch.models.clip_model import (
    cosine_logits,
    encode_image_auto,
    encode_text_embedded,
)
from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_prec,
    assemble_prompts_positional,
    build_position_layout,
    build_prompt_constants,
    ctx_init_vectors,
    random_ctx_vectors,
)


def build_coop_program(
    backbone: str = "ViT-B/16",
    classnames=None,
    n_ctx: int = 16,
    csc: bool = False,
    class_token_position: str = "end",
    ctx_init: str = "",
    prec: str = "fp16",
    seed: int = 0,
    device=None,
):
    """Random-init CoOp state, its loss and its eval functions (the
    defaults are ``TRAINER.COOP``'s; the classes, MaPLe's flagship ten).

    Returns a dict with ``arch, trainable, frozen, loss_fn, logits_fn,
    eval_prepare_fn, eval_apply_fn, n_cls, text_len, n_ctx``: ``trainable``
    is ``{"prompt_learner": {"ctx"}}`` in fp32, ``frozen`` holds ``clip``
    (under ``prec``) and ``prompt_const`` (``full_embedding``,
    ``eot_index``, ``layout``), both on ``device`` (``None`` means
    ``"cuda"``). ``loss_fn(trainable, frozen, batch) -> (loss, {"acc"})``
    is the cross-entropy of the cosine logits, with an unclamped
    ``exp(logit_scale)``, for ``batch`` holding ``image (B, H, W, 3)`` and
    ``label (B,)``; ``eval_prepare_fn(trainable, frozen)`` gives the text
    features, ``eval_apply_fn(trainable, frozen, images, txt)`` the logits
    of an image batch."""
    device = resolve_device(device)
    classnames = classnames or DEFAULT_CLASSNAMES
    arch = BACKBONE_CONFIGS[backbone]
    gen = torch.Generator().manual_seed(seed)
    clip_params = apply_prec(prec, init_clip_params(arch, gen))
    n_cls = len(classnames)

    if ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        n_ctx = len(ctx_init.split(" "))
        ctx = ctx_init_vectors(clip_params["text"], ctx_init, n_ctx)
        prompt_prefix = ctx_init
    else:
        ctx = random_ctx_vectors(gen, n_ctx, arch.transformer_width,
                                 n_cls=n_cls if csc else 0)
        prompt_prefix = " ".join(["X"] * n_ctx)
    const = build_prompt_constants(clip_params["text"], classnames, prompt_prefix, n_ctx)
    layout = build_position_layout(class_token_position, n_cls, n_ctx,
                                   arch.context_length, const.name_lens)
    frozen = {
        "clip": clip_params,
        "prompt_const": {"full_embedding": const.full_embedding,
                         "eot_index": const.eot_index, "layout": layout},
    }
    trainable = {"prompt_learner": {"ctx": ctx.float()}}
    text_len = const.text_len

    def text_features(trainable, frozen):
        pc = frozen["prompt_const"]
        prompts = assemble_prompts_positional(
            trainable["prompt_learner"]["ctx"], pc["full_embedding"], pc["layout"])
        return encode_text_embedded(frozen["clip"]["text"], arch, prompts,
                                    pc["eot_index"], max_len=text_len)

    def image_logits(frozen, images, txt):
        img = encode_image_auto(frozen["clip"]["visual"], arch, images, inference=True)
        return cosine_logits(img, txt, frozen["clip"]["logit_scale"])

    def logits_fn(trainable, frozen, images):
        return image_logits(frozen, images, text_features(trainable, frozen))

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        labels = batch["label"].long()
        loss = torch.nn.functional.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc * 100.0}

    @torch.no_grad()
    def eval_prepare_fn(trainable, frozen):
        return text_features(trainable, frozen)

    @torch.no_grad()
    def eval_apply_fn(trainable, frozen, images, txt):
        return image_logits(frozen, images, txt)

    return {
        "arch": arch,
        "trainable": to_device(trainable, device),
        "frozen": to_device(frozen, device),
        "loss_fn": loss_fn,
        "logits_fn": logits_fn,
        "eval_prepare_fn": eval_prepare_fn,
        "eval_apply_fn": eval_apply_fn,
        "n_cls": n_cls,
        "text_len": text_len,
        "n_ctx": n_ctx,
    }


def build_coop_optimizer(lr: float = 0.002):
    """SGD of ``configs/trainers/CoOp/vit_b16.yaml``: lr 0.002, momentum
    0.9, weight decay 5e-4, no Nesterov and no clip (``OPTIM.GRAD_CLIP_NORM``
    0, as every Dassl trainer)."""
    return build_optimizer(lr=lr, momentum=0.9, weight_decay=5e-4, clip=0.0)
