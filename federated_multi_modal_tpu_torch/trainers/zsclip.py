"""Zero-shot CLIP (port of ``federated_multi_modal_tpu/trainers/zsclip.py``):
class text features from hand templates, normalized once, then cosine
logits of the frozen image tower. One template (the dataset's) is
``ZeroshotCLIP``; the ImageNet select set plus the dataset's template is
``ZeroshotCLIP2``'s prompt ensemble."""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.registry import TRAINER_REGISTRY
from federated_multi_modal_tpu_torch.engine.trainer import TrainerX
from federated_multi_modal_tpu_torch.engine.tree import to_device
from federated_multi_modal_tpu_torch.models.clip_model import (
    encode_image_auto,
    encode_text_tokens,
)
from federated_multi_modal_tpu_torch.models.params import load_clip_backbone
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.trainers.templates import (
    CUSTOM_TEMPLATES,
    IMAGENET_TEMPLATES_SELECT,
)


@torch.no_grad()
def zeroshot_text_features(clip_params, arch, classnames, templates, device=None):
    """``(n_cls, embed_dim)`` normalized text features of ``classnames``:
    ``l2_normalize(encode_text_tokens(...))`` of each template filled with
    each class name, and for several templates the mean of those, normalized
    again. ``clip_params`` (``text``, on ``device``; ``None`` means
    ``"cuda"``) is CLIP's tree."""
    device = resolve_device(device)
    feats = []
    for template in templates:
        prompts = [template.format(c.replace("_", " ")) for c in classnames]
        tokens = torch.from_numpy(tokenize(prompts)).to(device)
        feats.append(l2_normalize(encode_text_tokens(clip_params["text"], arch, tokens)))
    if len(feats) == 1:
        return feats[0]
    return l2_normalize(sum(feats) / len(feats))


def make_zeroshot_infer(arch):
    """``infer(clip_params, text_features, images)``: the cosine logits of
    an image batch against the class features, ``exp(logit_scale)``
    unclamped."""

    @torch.no_grad()
    def infer(clip_params, text_features, images):
        img = l2_normalize(encode_image_auto(clip_params["visual"], arch, images,
                                             inference=True))
        scale = torch.exp(clip_params["logit_scale"].float())
        return scale * img @ text_features.T

    return infer


@TRAINER_REGISTRY.register()
class ZeroshotCLIP(TrainerX):
    """Evaluation only: the dataset's template over the class names."""

    def templates(self, dataset_name: str) -> list:
        return [CUSTOM_TEMPLATES[dataset_name]]

    def build_model(self):
        cfg = self.cfg
        classnames = self.dm.dataset.classnames
        print(f"Loading CLIP (backbone: {cfg.MODEL.BACKBONE.NAME})")
        self.arch, clip_params = load_clip_backbone(cfg.MODEL)
        self.clip_params = to_device(clip_params, self.device)
        templates = self.templates(cfg.DATASET.NAME)
        if len(templates) == 1:
            print(f"Prompts: {[templates[0].format(c.replace('_', ' ')) for c in classnames]}")
        else:
            print(f"Prompt ensembling (n={len(templates)})")
        self.text_features = zeroshot_text_features(
            self.clip_params, self.arch, classnames, templates, device=self.device)
        self._infer_fn = make_zeroshot_infer(self.arch)

    def model_inference(self, images):
        return self._infer_fn(self.clip_params, self.text_features, images)

    def train(self):
        # zero-shot: evaluation only
        self.test()

    def forward_backward(self, batch):
        raise RuntimeError("ZeroshotCLIP is evaluation-only")


@TRAINER_REGISTRY.register()
class ZeroshotCLIP2(ZeroshotCLIP):
    """Prompt ensembling over the select ImageNet templates, plus the
    dataset's own template on other datasets."""

    def templates(self, dataset_name: str) -> list:
        templates = list(IMAGENET_TEMPLATES_SELECT)
        if dataset_name != "ImageNet":
            templates.append(CUSTOM_TEMPLATES[dataset_name])
        return templates
