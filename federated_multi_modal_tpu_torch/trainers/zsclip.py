"""Zero-shot CLIP (port of the functional half of
``federated_multi_modal_tpu/trainers/zsclip.py``): class text features from
hand templates, normalized once, then cosine logits of the frozen image
tower. One template is ``ZeroshotCLIP``; several (the ImageNet select set)
are ``ZeroshotCLIP2``'s prompt ensemble. The trainer classes wait for the
trainer engine (ROADMAP module item 8)."""

from __future__ import annotations

import torch

from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.models.clip_model import (
    encode_image_auto,
    encode_text_tokens,
)
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize
from federated_multi_modal_tpu_torch.tokenizer import tokenize


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
