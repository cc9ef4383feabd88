"""IVLP, independent vision-language prompting (port of
``federated_multi_modal_tpu/trainers/ivlp.py``).

A learnable text context (CoOp's, initialised from ``CTX_INIT`` when it has
at most four words) and independent deep prompts in both towers: text
blocks ``1 .. depth_text - 1`` replace rows ``1 .. n_ctx``, vision blocks
``1 .. depth_vision - 1`` the trailing prompt rows. ``N_CTX_VISION`` or
``PROMPT_DEPTH_VISION`` 0 leaves the vision tower unprompted (the
language-only configuration). Every tower weight is frozen: the text tower
runs the masked attention kernel forward and backward, the vision tower the
frozen-weight train kernel.
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
from federated_multi_modal_tpu_torch.models.clip_model import cosine_logits, encode_text_embedded
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_prec,
    assemble_prompts_end,
    build_prompt_constants,
    ctx_init_vectors,
    random_ctx_vectors,
)
from federated_multi_modal_tpu_torch.trainers.vpt import encode_prompted_image, vision_prompts


def ivlp_state(clip_params, arch, classnames, n_ctx_text: int, n_ctx_vision: int,
               depth_text: int, depth_vision: int, ctx_init: str,
               generator: torch.Generator):
    """IVLP's state over ``clip_params``: ``(trainable, frozen, const)``
    with ``trainable = {"prompt_learner": {"ctx", "deep_text"}, "vpt":
    {"shallow", "deep"} or {}}`` in fp32 on the CPU and ``frozen = {"clip",
    "prompt_const": {"token_prefix", "token_suffix", "eot_index"}}``."""
    if ctx_init and n_ctx_text <= 4:
        ctx = ctx_init_vectors(clip_params["text"], ctx_init, n_ctx_text).cpu()
        prompt_prefix = ctx_init.replace("_", " ")
    else:
        ctx = random_ctx_vectors(generator, n_ctx_text, arch.transformer_width)
        prompt_prefix = " ".join(["X"] * n_ctx_text)
    print("Independent V-L design")
    print(f'Initial text context: "{prompt_prefix}"')
    print(f"Number of context words (tokens) for Language prompting: {n_ctx_text}")
    print(f"Number of context words (tokens) for Vision prompting: {n_ctx_vision}")
    const = build_prompt_constants(clip_params["text"], classnames, prompt_prefix, n_ctx_text)
    deep_text = [random_ctx_vectors(generator, n_ctx_text, arch.transformer_width)
                 for _ in range(depth_text - 1)]
    vpt = {}
    if n_ctx_vision > 0 and depth_vision > 0:
        vpt = vision_prompts(generator, n_ctx_vision, depth_vision, arch.vision_width)
    trainable = {"prompt_learner": {"ctx": ctx.float(), "deep_text": deep_text}, "vpt": vpt}
    frozen = {"clip": clip_params,
              "prompt_const": {"token_prefix": const.token_prefix,
                               "token_suffix": const.token_suffix,
                               "eot_index": const.eot_index}}
    return trainable, frozen, const


def make_ivlp_fns(arch, text_len: int) -> dict:
    """``loss_fn(trainable, frozen, batch) -> (loss, {})`` (cross-entropy
    of the cosine logits, ``exp(logit_scale)`` unclamped), ``logits_fn``,
    and the eval pair: ``eval_prepare_fn`` the text features of the prompt
    learner, ``eval_apply_fn`` the prompted image tower with
    ``inference=True`` against them."""

    def text_features(trainable, frozen):
        pl, pc = trainable["prompt_learner"], frozen["prompt_const"]
        prompts = assemble_prompts_end(pl["ctx"], pc["token_prefix"], pc["token_suffix"])
        return encode_text_embedded(frozen["clip"]["text"], arch, prompts, pc["eot_index"],
                                    deep_prompts=pl["deep_text"], max_len=text_len)

    def logits_fn(trainable, frozen, images):
        txt = text_features(trainable, frozen)
        img = encode_prompted_image(frozen["clip"], arch, images, trainable["vpt"])
        return cosine_logits(img, txt, frozen["clip"]["logit_scale"])

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        return torch.nn.functional.cross_entropy(logits, batch["label"].long()), {}

    @torch.no_grad()
    def eval_prepare_fn(trainable, frozen):
        return text_features(trainable, frozen)

    @torch.no_grad()
    def eval_apply_fn(trainable, frozen, images, txt):
        img = encode_prompted_image(frozen["clip"], arch, images, trainable["vpt"],
                                    inference=True)
        return cosine_logits(img, txt, frozen["clip"]["logit_scale"])

    return {"loss_fn": loss_fn, "logits_fn": logits_fn,
            "eval_prepare_fn": eval_prepare_fn, "eval_apply_fn": eval_apply_fn}


@TRAINER_REGISTRY.register()
class IVLP(FunctionalTrainerMixin, TrainerX):
    """Independent vision-language prompting (the baseline of MaPLe,
    https://arxiv.org/abs/2210.03117)."""

    def check_cfg(self, cfg):
        assert cfg.TRAINER.IVLP.PREC in ("fp16", "fp32", "amp", "bf16")
        assert cfg.TRAINER.IVLP.PROMPT_DEPTH_TEXT >= 1, (
            "In Independent VL prompting, Language prompt depth should be >=1")

    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.IVLP
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        if not self.arch.is_vit:
            raise ValueError("IVLP requires a ViT backbone (vision prompt injection); "
                             f"got {cfg.MODEL.BACKBONE.NAME}")
        clip_params = to_device(apply_prec(tcfg.PREC, clip_params), self.device)
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        trainable, self.frozen, self.const = ivlp_state(
            clip_params, self.arch, classnames, tcfg.N_CTX_TEXT, tcfg.N_CTX_VISION,
            tcfg.PROMPT_DEPTH_TEXT, tcfg.PROMPT_DEPTH_VISION, tcfg.CTX_INIT, gen)
        self.trainable = to_device(trainable, self.device)
        fns = make_ivlp_fns(self.arch, self.const.text_len)
        self.loss_fn, self.logits_fn = fns["loss_fn"], fns["logits_fn"]
        self.eval_prepare_fn = fns["eval_prepare_fn"]
        self.eval_apply_fn = fns["eval_apply_fn"]
        self.setup_optimization()
        self.load_init_weights()
        print(f"Trainable params: {count_params(self.trainable):,}")
        self.register_model("VLPromptLearner", self._get_state, self._set_state)

    def _get_state(self):
        sd = flatten_params(self.trainable)
        sd["token_prefix"] = to_numpy(self.const.token_prefix)
        sd["token_suffix"] = to_numpy(self.const.token_suffix)
        return {"state_dict": sd, "optimizer": None, "scheduler": None}

    def _set_state(self, flat):
        self.invalidate_eval_cache()
        self.trainable, _ = unflatten_into(self.trainable, flat, strict_shapes=True)

    def forward_backward(self, batch):
        images, labels = self.parse_batch_train(batch)
        summary = self.train_step({"image": images, "label": labels})
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
        return summary
