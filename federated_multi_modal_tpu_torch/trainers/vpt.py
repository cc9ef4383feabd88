"""VPT, deep vision prompt tuning (port of
``federated_multi_modal_tpu/trainers/vpt.py``).

The text features of ``"a photo of a <class>."`` are computed once and
frozen; only the vision prompt tokens train: ``shallow`` tokens appended
after the positional embedding, and ``deep`` ones that replace them before
blocks ``1 .. depth - 1``. Every vision block's weights are frozen, so in
training each takes the frozen-weight train kernel (``fused_block_train``),
whose dx carries the prompts' gradient, and in eval the inference kernel.
"""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params, unflatten_into
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import (
    FunctionalTrainerMixin,
    TrainerX,
    count_params,
)
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.clip_model import (
    cosine_logits,
    encode_image,
    encode_text_tokens,
)
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.trainers.common import apply_prec


def vision_prompts(generator: torch.Generator, n_ctx: int, depth: int, width: int) -> dict:
    """``{"shallow": (n_ctx, width), "deep": [depth - 1 of them]}``, each
    ``N(0, 0.02^2)`` in fp32, drawn in that order from ``generator``."""
    draws = [torch.randn(n_ctx, width, generator=generator) * 0.02 for _ in range(depth)]
    return {"shallow": draws[0], "deep": draws[1:]}


def encode_prompted_image(clip_params, arch, images, vpt: dict, inference: bool = False):
    """The image tower with ``vpt``'s shallow and deep prompts (none for an
    empty ``vpt``)."""
    return encode_image(clip_params["visual"], arch, images,
                        shallow_prompts=vpt.get("shallow"), deep_prompts=vpt.get("deep"),
                        inference=inference)


@torch.no_grad()
def fixed_text_features(clip_params, arch, classnames):
    """The frozen text features of ``"a photo of a <class>."`` (77 tokens,
    EOT at the argmax), on ``clip_params``' device."""
    prompts = ["a photo of a " + name.replace("_", " ") + "." for name in classnames]
    device = clip_params["text"]["token_embedding"].device
    tokens = torch.from_numpy(tokenize(prompts)).to(device)
    return encode_text_tokens(clip_params["text"], arch, tokens)


def vpt_state(clip_params, arch, classnames, n_ctx: int, depth: int,
              generator: torch.Generator):
    """VPT's state over ``clip_params`` (on its device, the precision
    policy applied): ``trainable = {"vpt": {"shallow", "deep"}}`` in fp32
    on the CPU and ``frozen = {"clip", "text_features"}``."""
    frozen = {"clip": clip_params,
              "text_features": fixed_text_features(clip_params, arch, classnames)}
    return {"vpt": vision_prompts(generator, n_ctx, depth, arch.vision_width)}, frozen


def make_vpt_fns(arch) -> dict:
    """``loss_fn(trainable, frozen, batch) -> (loss, {})`` (cross-entropy
    of the cosine logits, ``exp(logit_scale)`` unclamped), ``logits_fn``,
    and the eval pair: ``eval_prepare_fn`` returns the fixed text features,
    ``eval_apply_fn`` runs the prompted tower with ``inference=True``."""

    def logits_fn(trainable, frozen, images):
        img = encode_prompted_image(frozen["clip"], arch, images, trainable["vpt"])
        return cosine_logits(img, frozen["text_features"], frozen["clip"]["logit_scale"])

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        return torch.nn.functional.cross_entropy(logits, batch["label"].long()), {}

    @torch.no_grad()
    def eval_prepare_fn(trainable, frozen):
        return frozen["text_features"]

    @torch.no_grad()
    def eval_apply_fn(trainable, frozen, images, txt):
        img = encode_prompted_image(frozen["clip"], arch, images, trainable["vpt"],
                                    inference=True)
        return cosine_logits(img, txt, frozen["clip"]["logit_scale"])

    return {"loss_fn": loss_fn, "logits_fn": logits_fn,
            "eval_prepare_fn": eval_prepare_fn, "eval_apply_fn": eval_apply_fn}


@TRAINER_REGISTRY.register()
class VPT(FunctionalTrainerMixin, TrainerX):
    """Visual Prompt Tuning (https://arxiv.org/abs/2203.12119), deep
    variant, on a frozen CLIP with hand-crafted class prompts."""

    def check_cfg(self, cfg):
        assert cfg.TRAINER.VPT.PREC in ("fp16", "fp32", "amp", "bf16")
        assert cfg.TRAINER.VPT.PROMPT_DEPTH_VISION >= 1, (
            "For Vision Prompting, PROMPT_DEPTH_VISION should be >= 1")

    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.VPT
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        if not self.arch.is_vit:
            raise ValueError("VPT requires a ViT backbone (vision prompt injection); "
                             f"got {cfg.MODEL.BACKBONE.NAME}")
        clip_params = to_device(apply_prec(tcfg.PREC, clip_params), self.device)
        print("Vision Prompting Design")
        print('Initial context: "a photo of a"')
        print(f"Number of context words (tokens) for Vision prompting: {tcfg.N_CTX_VISION}")
        print("Using fixed hand crafted prompts")
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        trainable, self.frozen = vpt_state(clip_params, self.arch, classnames,
                                           tcfg.N_CTX_VISION, tcfg.PROMPT_DEPTH_VISION, gen)
        self.trainable = to_device(trainable, self.device)
        fns = make_vpt_fns(self.arch)
        self.loss_fn, self.logits_fn = fns["loss_fn"], fns["logits_fn"]
        self.eval_prepare_fn = fns["eval_prepare_fn"]
        self.eval_apply_fn = fns["eval_apply_fn"]
        self.setup_optimization()
        self.load_init_weights()
        print(f"Trainable params: {count_params(self.trainable):,}")
        self.register_model("prompt_learner", self._get_state, self._set_state)

    def _get_state(self):
        return {"state_dict": flatten_params(self.trainable), "optimizer": None,
                "scheduler": None}

    def _set_state(self, flat):
        self.invalidate_eval_cache()
        self.trainable, _ = unflatten_into(self.trainable, flat, strict_shapes=True)

    def forward_backward(self, batch):
        images, labels = self.parse_batch_train(batch)
        summary = self.train_step({"image": images, "label": labels})
        if (self.batch_idx + 1) == self.num_batches:
            self.update_lr()
        return summary
