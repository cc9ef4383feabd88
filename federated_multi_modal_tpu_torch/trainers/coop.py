"""CoOp, context optimization (port of
``federated_multi_modal_tpu/trainers/coop.py``): learnable text context
vectors, shared or class-specific, with the class token at the end, the
middle or the front, on a frozen CLIP. Only the prompt learner trains; the
image tower is frozen and prompt-free, so it takes the inference kernels
(``encode_image_auto(..., inference=True)``) in the train step and in eval.

``build_coop_program`` is the state and functions on a random-init CLIP;
the ``CoOp`` trainer builds the same over ``load_clip_backbone``'s weights.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params, to_numpy, unflatten_into
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import (
    FunctionalTrainerMixin,
    TrainerX,
    count_params,
)
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.clip_model import (
    cosine_logits,
    encode_image_auto,
    encode_text_embedded,
)
from federated_multi_modal_tpu_torch.models.params import (
    BACKBONE_CONFIGS,
    init_clip_params,
    load_clip_backbone,
)
from federated_multi_modal_tpu_torch.trainers.common import (
    DEFAULT_CLASSNAMES,
    apply_prec,
    assemble_prompts_positional,
    build_position_layout,
    build_prompt_constants,
    ctx_init_vectors,
    random_ctx_vectors,
)


def coop_state(clip_params, arch, classnames, n_ctx: int = 16, csc: bool = False,
               class_token_position: str = "end", ctx_init: str = "",
               generator: torch.Generator = None):
    """CoOp's state over ``clip_params`` (on the CPU, the precision policy
    already applied): ``(trainable, frozen, const, n_ctx)`` with
    ``trainable = {"prompt_learner": {"ctx"}}`` in fp32 and ``frozen =
    {"clip", "prompt_const": {"full_embedding", "eot_index", "layout"}}``.
    ``ctx_init`` sets the context from a phrase (and ``n_ctx`` from its
    words); else it is drawn from ``generator``."""
    n_cls = len(classnames)
    if ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        n_ctx = len(ctx_init.split(" "))
        ctx = ctx_init_vectors(clip_params["text"], ctx_init, n_ctx)
        prompt_prefix = ctx_init
    else:
        print("Initializing class-specific contexts" if csc
              else "Initializing a generic context")
        ctx = random_ctx_vectors(generator, n_ctx, arch.transformer_width,
                                 n_cls=n_cls if csc else 0)
        prompt_prefix = " ".join(["X"] * n_ctx)
    print(f'Initial context: "{prompt_prefix}"')
    print(f"Number of context words (tokens): {n_ctx}")
    const = build_prompt_constants(clip_params["text"], classnames, prompt_prefix, n_ctx)
    layout = build_position_layout(class_token_position, n_cls, n_ctx,
                                   arch.context_length, const.name_lens)
    frozen = {
        "clip": clip_params,
        "prompt_const": {"full_embedding": const.full_embedding,
                         "eot_index": const.eot_index, "layout": layout},
    }
    trainable = {"prompt_learner": {"ctx": ctx.float()}}
    return trainable, frozen, const, n_ctx


def make_coop_fns(arch, text_len: int) -> dict:
    """CoOp's functions over :func:`coop_state`'s layout:
    ``loss_fn(trainable, frozen, batch) -> (loss, {"acc"})``, the
    cross-entropy of the cosine logits with an unclamped
    ``exp(logit_scale)``, for ``batch`` holding ``image (B, H, W, 3)`` and
    ``label (B,)``; ``logits_fn``; ``eval_prepare_fn(trainable, frozen)``,
    the text features; ``eval_apply_fn(trainable, frozen, images, txt)``,
    the logits of an image batch."""

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

    return {"loss_fn": loss_fn, "logits_fn": logits_fn,
            "eval_prepare_fn": eval_prepare_fn, "eval_apply_fn": eval_apply_fn}


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
    eval_prepare_fn, eval_apply_fn, n_cls, text_len, n_ctx``
    (:func:`coop_state`, :func:`make_coop_fns`), the state on ``device``
    (``None`` means ``"cuda"``)."""
    device = resolve_device(device)
    classnames = classnames or DEFAULT_CLASSNAMES
    arch = BACKBONE_CONFIGS[backbone]
    gen = torch.Generator().manual_seed(seed)
    clip_params = apply_prec(prec, init_clip_params(arch, gen))
    trainable, frozen, const, n_ctx = coop_state(
        clip_params, arch, classnames, n_ctx, csc, class_token_position, ctx_init, gen)
    return {
        "arch": arch,
        "trainable": to_device(trainable, device),
        "frozen": to_device(frozen, device),
        **make_coop_fns(arch, const.text_len),
        "n_cls": len(classnames),
        "text_len": const.text_len,
        "n_ctx": n_ctx,
    }


def build_coop_optimizer(lr: float = 0.002):
    """SGD of ``configs/trainers/CoOp/vit_b16.yaml``: lr 0.002, momentum
    0.9, weight decay 5e-4, no Nesterov and no clip (``OPTIM.GRAD_CLIP_NORM``
    0, as every Dassl trainer)."""
    return build_optimizer(lr=lr, momentum=0.9, weight_decay=5e-4, clip=0.0)


@TRAINER_REGISTRY.register()
class CoOp(FunctionalTrainerMixin, TrainerX):
    """Learning to Prompt for Vision-Language Models
    (https://arxiv.org/abs/2109.01134)."""

    def check_cfg(self, cfg):
        assert cfg.TRAINER.COOP.PREC in ("fp16", "fp32", "amp", "bf16")

    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.COOP
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        clip_params = apply_prec(tcfg.PREC, clip_params)
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        trainable, frozen, self.const, _ = coop_state(
            clip_params, self.arch, classnames, tcfg.N_CTX, tcfg.CSC,
            tcfg.CLASS_TOKEN_POSITION, tcfg.CTX_INIT, gen)
        self.trainable = to_device(trainable, self.device)
        self.frozen = to_device(frozen, self.device)
        fns = make_coop_fns(self.arch, self.const.text_len)
        self.loss_fn, self.logits_fn = fns["loss_fn"], fns["logits_fn"]
        self.eval_prepare_fn = fns["eval_prepare_fn"]
        self.eval_apply_fn = fns["eval_apply_fn"]
        self.setup_optimization()
        self.load_init_weights()
        print(f"Trainable params: {count_params(self.trainable):,}")
        self.register_model("prompt_learner", self._get_state, self._set_state)

    # -- checkpoint surface (reference names: ctx/token_prefix/token_suffix) --
    def _get_state(self):
        sd = flatten_params(self.trainable["prompt_learner"])
        sd["token_prefix"] = to_numpy(self.const.token_prefix)
        sd["token_suffix"] = to_numpy(self.const.token_suffix)
        return {"state_dict": sd, "optimizer": None, "scheduler": None}

    def _set_state(self, flat):
        self.invalidate_eval_cache()
        new, _ = unflatten_into(self.trainable["prompt_learner"], flat, strict_shapes=True)
        self.trainable = {"prompt_learner": new}

    # -- training ----------------------------------------------------------
    def forward_backward(self, batch):
        images, labels = self.parse_batch_train(batch)
        summary = self.train_step({"image": images, "label": labels})
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
        return summary
