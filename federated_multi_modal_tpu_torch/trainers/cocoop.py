"""CoCoOp, conditional context optimization (port of
``federated_multi_modal_tpu/trainers/cocoop.py``).

A meta-net (linear, ReLU, linear) maps each image's l2-normalised features
from the frozen, prompt-free image tower to a shift of the shared context,
so every image has its own class prompts. As in the JAX package, the
``(B, n_cls)`` conditional prompts are folded into one text-tower call over
``B * n_cls`` rows (the reference loops over the images). The image tower
runs with ``inference=True`` in the train step too: nothing trains in it,
and its features enter the graph only as the meta-net's input.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params, to_numpy, unflatten_into
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import (
    FunctionalTrainerMixin,
    TrainerX,
    count_params,
)
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto, encode_text_embedded
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_linear,
    apply_prec,
    build_prompt_constants,
    ctx_init_vectors,
    linear_params,
    random_ctx_vectors,
)


def cocoop_state(clip_params, arch, classnames, n_ctx: int, ctx_init: str,
                 generator: torch.Generator):
    """CoCoOp's state over ``clip_params``: ``(trainable, frozen, const,
    n_ctx)`` with ``trainable = {"prompt_learner": {"ctx", "meta_net":
    {"linear1", "linear2"}}}`` in fp32 on the CPU and ``frozen = {"clip",
    "prompt_const": {"token_prefix", "token_suffix", "eot_index"}}``.
    ``ctx_init`` sets the context from a phrase (and ``n_ctx`` from its
    words); else it is drawn from ``generator``, then the meta-net's two
    layers."""
    if ctx_init:
        ctx_init = ctx_init.replace("_", " ")
        n_ctx = len(ctx_init.split(" "))
        ctx = ctx_init_vectors(clip_params["text"], ctx_init, n_ctx).cpu()
        prompt_prefix = ctx_init
    else:
        ctx = random_ctx_vectors(generator, n_ctx, arch.transformer_width)
        prompt_prefix = " ".join(["X"] * n_ctx)
    print(f'Initial context: "{prompt_prefix}"')
    print(f"Number of context words (tokens): {n_ctx}")
    const = build_prompt_constants(clip_params["text"], classnames, prompt_prefix, n_ctx)
    vis_dim, ctx_dim = arch.embed_dim, arch.transformer_width
    meta_net = {"linear1": linear_params(generator, vis_dim, vis_dim // 16),
                "linear2": linear_params(generator, vis_dim // 16, ctx_dim)}
    trainable = {"prompt_learner": {"ctx": ctx.float(), "meta_net": meta_net}}
    frozen = {"clip": clip_params,
              "prompt_const": {"token_prefix": const.token_prefix,
                               "token_suffix": const.token_suffix,
                               "eot_index": const.eot_index}}
    return trainable, frozen, const, n_ctx


def conditional_prompts(pl: dict, prefix, suffix, img_n):
    """The ``(B * n_cls, T, d)`` prompts of the batch: each image's context,
    ``ctx + meta_net(img_n)``, between every class's prefix and suffix,
    image-major."""
    h = torch.relu(apply_linear(pl["meta_net"]["linear1"], img_n))
    bias = apply_linear(pl["meta_net"]["linear2"], h)          # (B, d)
    ctx_shift = pl["ctx"][None] + bias[:, None, :]             # (B, n_ctx, d)
    B = img_n.shape[0]
    n_cls, n_ctx, d = prefix.shape[0], ctx_shift.shape[1], ctx_shift.shape[2]
    ctx_b = ctx_shift[:, None].to(prefix.dtype).expand(B, n_cls, n_ctx, d)
    prompts = torch.cat([prefix[None].expand(B, *prefix.shape), ctx_b,
                         suffix[None].expand(B, *suffix.shape)], dim=2)
    return prompts.reshape(B * n_cls, prompts.shape[2], d)


def make_cocoop_fns(arch, text_len: int) -> dict:
    """``loss_fn(trainable, frozen, batch) -> (loss, {})`` (cross-entropy
    of ``exp(logit_scale) * <img_n, txt_n>`` per image and class) and
    ``logits_fn``. CoCoOp has no prompt cache: the text features depend on
    the image, so ``test()`` runs ``logits_fn`` on every batch."""

    def logits_fn(trainable, frozen, images):
        pl, pc = trainable["prompt_learner"], frozen["prompt_const"]
        with torch.no_grad():
            img = encode_image_auto(frozen["clip"]["visual"], arch, images, inference=True)
        img_n = l2_normalize(img)
        prompts = conditional_prompts(pl, pc["token_prefix"], pc["token_suffix"], img_n)
        B, n_cls = img_n.shape[0], pc["token_prefix"].shape[0]
        eot = pc["eot_index"].repeat(B)
        txt = encode_text_embedded(frozen["clip"]["text"], arch, prompts, eot,
                                   max_len=text_len)
        txt = l2_normalize(txt).reshape(B, n_cls, -1)
        scale = torch.exp(frozen["clip"]["logit_scale"].float())
        return scale * torch.einsum("bd,bcd->bc", img_n, txt)

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        return torch.nn.functional.cross_entropy(logits, batch["label"].long()), {}

    return {"loss_fn": loss_fn, "logits_fn": logits_fn}


@TRAINER_REGISTRY.register()
class CoCoOp(FunctionalTrainerMixin, TrainerX):
    """Conditional Prompt Learning for Vision-Language Models
    (https://arxiv.org/abs/2203.05557)."""

    def check_cfg(self, cfg):
        assert cfg.TRAINER.COCOOP.PREC in ("fp16", "fp32", "amp", "bf16")

    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.COCOOP
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        clip_params = to_device(apply_prec(tcfg.PREC, clip_params), self.device)
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        trainable, self.frozen, self.const, _ = cocoop_state(
            clip_params, self.arch, classnames, tcfg.N_CTX, tcfg.CTX_INIT, gen)
        self.trainable = to_device(trainable, self.device)
        fns = make_cocoop_fns(self.arch, self.const.text_len)
        self.loss_fn, self.logits_fn = fns["loss_fn"], fns["logits_fn"]
        self.setup_optimization()
        self.load_init_weights()
        print(f"Trainable params: {count_params(self.trainable):,}")
        self.register_model("prompt_learner", self._get_state, self._set_state)

    def _get_state(self):
        sd = flatten_params(self.trainable["prompt_learner"])
        sd["token_prefix"] = to_numpy(self.const.token_prefix)
        sd["token_suffix"] = to_numpy(self.const.token_suffix)
        return {"state_dict": sd, "optimizer": None, "scheduler": None}

    def _set_state(self, flat):
        self.invalidate_eval_cache()
        new, _ = unflatten_into(self.trainable["prompt_learner"], flat, strict_shapes=True)
        self.trainable = {"prompt_learner": new}

    def forward_backward(self, batch):
        images, labels = self.parse_batch_train(batch)
        summary = self.train_step({"image": images, "label": labels})
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
        return summary
