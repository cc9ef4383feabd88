"""MaPLe, multi-modal prompt learning (port of
``federated_multi_modal_tpu/trainers/maple.py``): the unfreeze predicate, the
prompt learner's parameters and forward, the caption token, the loss, the
prompt-cached eval functions and the ``MaPLe`` trainer, standalone or as
a client of ``trainers/maple_fed.py::MaPLeFederated``.

The coupled prompt learner alternates: even depths own a text-side prompt
projected into the vision width, odd depths a vision-side prompt projected
into the text width. The loss is cross-entropy (hard labels) or KL (soft
labels) of the cosine logits, ``exp(logit_scale)`` clamped at 100, plus
``ALIGN_LAMBDA`` x (1 - mean cosine between each image and its label's
text); the trainable set is the prompt learner, every LayerNorm and the last
block of each tower.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params, to_numpy, unflatten_into
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import (
    FunctionalTrainerMixin,
    TrainerX,
    count_params,
)
from federated_multi_modal_tpu_torch.engine.tree import (
    merge_trees,
    split_tree,
    to_device,
    tree_map_with_path,
)
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.models.clip_model import (
    embed_tokens,
    encode_image,
    encode_text_embedded,
)
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_linear,
    apply_prec,
    assemble_prompts_end,
    build_prompt_constants,
    ctx_init_vectors,
    linear_params,
    random_ctx_vectors,
)
from federated_multi_modal_tpu_torch.utils.profiling import span, span_boundary


@functools.lru_cache(maxsize=65536)
def _tokenize_caption(caption: str) -> np.ndarray:
    """Memoized BPE tokenization: the same dataset captions recur every
    epoch."""
    return np.asarray(tokenize([caption], truncate=True)[0])


def dataset_provides_captions(dm) -> bool:
    """Whether any item in the manager's train or test split carries a
    caption (the whole split is scanned)."""
    for split in (dm.dataset.train_x, dm.dataset.test):
        if split and any(getattr(d, "caption", "") for d in split):
            return True
    return False


def maple_clip_params(prec: str, clip_params, device):
    """CLIP's weights as MaPLe holds them, on ``device``: under
    ``TRAINER.MAPLE.PREC``, with ``logit_scale`` pinned at ln(1/0.07) (the
    reference's CustomCLIP replaces CLIP's with a fresh parameter, which the
    unfreeze policy leaves frozen). The federated aggregator makes this tree
    once and its clients share it."""
    clip_params = dict(to_device(apply_prec(prec, clip_params), device))
    clip_params["logit_scale"] = torch.tensor(
        math.log(1.0 / 0.07), dtype=torch.float32, device=device)
    return clip_params


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
    vision context and the coupled deep prompt lists (span
    ``prompt_learner``, its backward ``prompt_learner.backward``)."""
    with span("prompt_learner"):
        (pl,) = span_boundary("prompt_learner", pl, entry=True)
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
        return span_boundary("prompt_learner", prompts, shared_ctx, text_deep, vis_deep,
                             entry=False)


def caption_tokens_to_extra(pl: dict, text_params, caption_tokens):
    """Pool the frozen caption embeddings into one vision-width token per
    image: ``(B, 77)`` token ids -> ``(B, 1, width)`` fp32. The embeddings
    get no gradient; the pooling softmax runs in fp32. A second
    ``prompt_learner`` span, as :func:`maple_prompts`."""
    with span("prompt_learner"):
        (pl,) = span_boundary("prompt_learner", pl, entry=True)
        emb = embed_tokens(text_params, caption_tokens).detach().float()  # (B, 77, d)
        scores = torch.einsum("btd,d->bt", emb, pl["caption_pool_w"].float())
        probs = torch.softmax(scores, dim=1)
        pooled = torch.einsum("btd,bt->bd", emb, probs)
        extra = apply_linear(pl["caption_proj"], pooled)[:, None, :]
        return span_boundary("prompt_learner", extra, entry=False)[0]


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
        with span("logits"):
            return prep["scale"] * l2_normalize(img) @ prep["txt_n"].T

    return eval_prepare_fn, eval_apply_fn


def make_maple_model_fns(arch, depth: int, text_len: int, use_captions: bool,
                         align_lambda: float, remat: bool = False):
    """``(logits_fn, loss_fn)`` of MaPLe over the ``{"model",
    "prompt_const"}`` frozen layout; ``remat`` recomputes each block of both
    towers in the backward (``TPU.REMAT``). ``loss_fn(trainable, frozen, batch) ->
    (loss, {"acc", "align"})`` for ``batch`` holding ``image (B, H, W, 3)``,
    ``label (B,)`` and optionally ``caption_tokens (B, 77)`` and
    ``soft_label (B, n_cls)`` (the KL branch). The loss from the towers'
    features on is span ``loss`` (its backward ``loss.backward``)."""

    def features(trainable, frozen, images, caption_tokens=None):
        """``(image features, text features, logit_scale)``, before the
        normalisation."""
        m = merge_trees(trainable, frozen["model"])
        pc = frozen["prompt_const"]
        prompts, shared_ctx, text_deep, vis_deep = maple_prompts(
            m["prompt_learner"], pc["token_prefix"], pc["token_suffix"], depth)
        extra = None
        if caption_tokens is not None and use_captions:
            extra = caption_tokens_to_extra(
                m["prompt_learner"], m["clip"]["text"], caption_tokens)
        txt = encode_text_embedded(
            m["clip"]["text"], arch, prompts, pc["eot_index"],
            deep_prompts=text_deep, remat=remat, max_len=text_len)
        img = encode_image(
            m["clip"]["visual"], arch, images, shallow_prompts=shared_ctx,
            deep_prompts=vis_deep, extra_tokens=extra, remat=remat)
        return img, txt, m["clip"]["logit_scale"]

    def scaled(logit_scale):
        return torch.clamp(torch.exp(logit_scale.float()), max=100.0)

    def logits_fn(trainable, frozen, images):
        img, txt, logit_scale = features(trainable, frozen, images)
        return scaled(logit_scale) * l2_normalize(img) @ l2_normalize(txt).T

    def loss_fn(trainable, frozen, batch):
        img, txt, logit_scale = features(
            trainable, frozen, batch["image"], batch.get("caption_tokens"))
        with span("loss"):
            img, txt = span_boundary("loss", img, txt, entry=True)
            img_n, txt_n = l2_normalize(img), l2_normalize(txt)
            logits = scaled(logit_scale) * img_n @ txt_n.T
            labels = batch["label"].long()
            if "soft_label" in batch:
                target = torch.clamp(batch["soft_label"], min=1e-8)
                logp = torch.log_softmax(logits, dim=1)
                loss = (target * (torch.log(target) - logp)).sum(1).mean()
                txt_sel = target @ txt_n
            else:
                loss = torch.nn.functional.cross_entropy(logits, labels)
                txt_sel = txt_n[labels]
            alignment = 1.0 - (img_n * txt_sel).sum(-1).mean()
            acc = (logits.argmax(-1) == labels).float().mean()
            total = span_boundary("loss", loss + align_lambda * alignment, entry=False)[0]
            return total, {"acc": acc * 100.0, "align": alignment}

    return logits_fn, loss_fn


@TRAINER_REGISTRY.register()
class MaPLe(FunctionalTrainerMixin, TrainerX):
    """MaPLe trainer, standalone or a client of ``MaPLeFederated``, which
    injects a ``ClientDataManager``, the unified classnames, one shared
    frozen tower and one caption decision for every client
    (``trainers/maple_fed.py:164-176``)."""

    # the reference hard-codes clip_grad_norm_(max_norm=1.0) in its
    # forward_backward: MaPLe is the only trainer that clips
    GRAD_CLIP_OVERRIDE = 1.0

    def __init__(self, cfg, client_id: Optional[int] = None,
                 classnames: Optional[List[str]] = None, dm=None,
                 shared_clip=None, use_captions_override: Optional[bool] = None,
                 device=None):
        self.client_id = client_id
        self.classnames_override = classnames
        self._injected_dm = dm
        # the aggregator's one decision for all clients, so that every
        # client's trainable tree has the same structure for FedAvg
        self._use_captions_override = use_captions_override
        # (arch, MaPLe's CLIP tree on the device, from maple_clip_params):
        # the frozen tower is the same for every client, so the clients hold
        # one copy of it instead of the reference's N model replicas
        self._shared_clip = shared_clip
        super().__init__(cfg, device=device)
        self.grad_norms = []

    def check_cfg(self, cfg):
        assert cfg.TRAINER.MAPLE.PREC in ("fp16", "fp32", "amp", "bf16"), (
            f"Invalid precision setting: {cfg.TRAINER.MAPLE.PREC}"
        )

    def build_data_loader(self):
        if self._injected_dm is None:
            return super().build_data_loader()
        self.dm = self._injected_dm
        self.train_loader_x = self.dm.train_loader
        self.val_loader = self.dm.val_loader
        self.test_loader = self.dm.test_loader
        self.num_classes = self.dm.num_classes

    @property
    def _tag(self):
        return f"[Client {self.client_id}] " if self.client_id is not None else ""

    def build_model(self):
        cfg = self.cfg
        tcfg = cfg.TRAINER.MAPLE
        classnames = self.classnames_override or self.dm.dataset.classnames
        print(f"{self._tag}# of classnames = {len(classnames)}")
        if self._shared_clip is not None:
            self.arch, clip_params = self._shared_clip
        else:
            print(f"{self._tag}Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
            self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        arch = self.arch
        if not arch.is_vit:
            raise ValueError(
                "MaPLe requires a ViT backbone (multi-modal prompt injection into "
                f"transformer blocks); got {cfg.MODEL.BACKBONE.NAME}")
        if self._shared_clip is None:
            clip_params = maple_clip_params(tcfg.PREC, clip_params, self.device)
        n_ctx = tcfg.N_CTX
        depth = tcfg.PROMPT_DEPTH
        assert depth >= 1, "For MaPLe, PROMPT_DEPTH should be >= 1"
        assert cfg.INPUT.SIZE[0] == arch.image_resolution, (
            f"cfg_imsize ({cfg.INPUT.SIZE[0]}) must equal clip_imsize "
            f"({arch.image_resolution})")
        # the caption branch only where the dataset provides captions (or
        # as the aggregator decided for every client)
        if self._use_captions_override is not None:
            self.use_captions = bool(tcfg.USE_CAPTIONS) and bool(self._use_captions_override)
        else:
            dataset_has_captions = dataset_provides_captions(self.dm)
            self.use_captions = bool(tcfg.USE_CAPTIONS) and dataset_has_captions
            if tcfg.USE_CAPTIONS and not dataset_has_captions:
                print(f"{self._tag}Dataset provides no captions; caption branch off")
        self.align_lambda = float(tcfg.ALIGN_LAMBDA)
        remat = bool(cfg.TPU.REMAT)

        ctx_init = tcfg.CTX_INIT
        gen = torch.Generator().manual_seed(cfg.SEED if cfg.SEED >= 0 else 0)
        if ctx_init and n_ctx <= 4:
            ctx = ctx_init_vectors(clip_params["text"], ctx_init, n_ctx)
            prompt_prefix = ctx_init.replace("_", " ")
        else:
            ctx = random_ctx_vectors(gen, n_ctx, arch.transformer_width)
            prompt_prefix = " ".join(["X"] * n_ctx)
        print("MaPLe design: Multi-modal Prompt Learning")
        print(f'Initial context: "{prompt_prefix}"')
        print(f"Number of MaPLe context words (tokens): {n_ctx}")

        const = build_prompt_constants(clip_params["text"], classnames, prompt_prefix, n_ctx)
        self.const = const
        pl = init_maple_prompt_learner(gen, arch, n_ctx, depth, ctx, self.use_captions)
        model = {"clip": clip_params, "prompt_learner": pl}
        pred = maple_trainable_predicate(arch.vision_layers, arch.transformer_layers)
        trainable, frozen_clip = split_tree(model, pred)
        # fp32 copies: no trainable leaf shares a tensor with a shared tower
        self.trainable = tree_map_with_path(
            lambda _, t: t.to(self.device, torch.float32, copy=True), trainable)
        self.frozen = to_device({
            "model": frozen_clip,
            "prompt_const": {
                "token_prefix": const.token_prefix,
                "token_suffix": const.token_suffix,
                "eot_index": const.eot_index,
            },
        }, self.device)
        self.depth = depth

        self.logits_fn, self.loss_fn = make_maple_model_fns(
            arch, depth, const.text_len, self.use_captions, self.align_lambda, remat)
        self.eval_prepare_fn, self.eval_apply_fn = make_maple_eval_fns(
            arch, depth, const.text_len)
        self.setup_optimization()
        self.load_init_weights()
        print(f"{self._tag}Trainable params: {count_params(self.trainable):,}")
        self.model_name = ("MultiModalPromptLearner" if self.client_id is None
                           else f"MultiModalPromptLearner_{self.client_id}")
        self.register_model(self.model_name, self._get_state, self._set_state)

    # -- state surface ---------------------------------------------------------
    def _get_state(self):
        sd = flatten_params(self.trainable)
        sd["prompt_learner.token_prefix"] = to_numpy(self.const.token_prefix)
        sd["prompt_learner.token_suffix"] = to_numpy(self.const.token_suffix)
        return {"state_dict": sd, "optimizer": None, "scheduler": None}

    def _set_state(self, flat):
        self.invalidate_eval_cache()
        self.trainable, _ = unflatten_into(self.trainable, flat, strict_shapes=True)

    # -- batches ---------------------------------------------------------------
    def parse_batch_train(self, batch):
        images, labels = super().parse_batch_train(batch)
        step = {"image": images, "label": labels}
        if self.use_captions:
            captions = [c or "" for c in batch.get("caption", [])]
            if len(captions) != images.shape[0]:
                captions = [""] * images.shape[0]
            step["caption_tokens"] = torch.from_numpy(
                np.stack([_tokenize_caption(c) for c in captions])).to(self.device)
        return step

    def forward_backward(self, batch):
        summary = self.train_step(self.parse_batch_train(batch))
        if summary is None:  # deferred mode: checked at drain time
            return None
        if not np.isfinite(summary["loss"]):
            # the reference hard-raises on a NaN/Inf loss
            raise RuntimeError("NaN/Inf in total loss")
        self.grad_norms.append(summary.get("grad_norm", 0.0))
        return summary

    def drain_summaries(self):
        """The NaN hard-raise and the grad-norm history at the drain point."""
        drained = super().drain_summaries()
        for s in drained:
            if not np.isfinite(s["loss"]):
                raise RuntimeError("NaN/Inf in total loss")
            self.grad_norms.append(s.get("grad_norm", 0.0))
        return drained

    def run_epoch(self, epoch=None):
        """Standalone (``epoch`` None): the base epoch runner, then the LR
        stepped once per epoch. Driven by the aggregator
        (``trainers/maple.py:629-653``): one local epoch with the summaries
        drained every ``TRAIN.PRINT_FREQ`` steps (a non-finite loss raises
        ``RuntimeError`` there), then ``epoch`` set to the global epoch, the
        LR stepped to its successor's, a ``test()``; returns ``{"avg_loss"}``."""
        if epoch is None:
            loss = TrainerX.run_epoch(self)
            self.update_lr()
            return loss
        avg_loss = TrainerX.run_epoch(self, progress=False)
        self.epoch_stats[-1]["epoch"] = epoch
        self.epoch = epoch
        self.update_lr()
        local = self.test()
        print(f"{self._tag}Epoch {epoch} done. Loss={avg_loss:.4f}, "
              f"Acc={local['accuracy']:.2f}%")
        return {"avg_loss": avg_loss}

