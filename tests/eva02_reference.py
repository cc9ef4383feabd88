"""Plain float32 PyTorch reference of EVA02-CLIP-L/14 with MaPLe's prompts,
for the CPU tests of the port's EVA route.

Imports no JAX and nothing of the port. The towers are those of
``benchmark/reference/eva02.py``, the benchmark's plain reference, so that
one copy of the equations serves both: it reads EVA-CLIP's published state
dict layout (``EVA02_CLIP_L_psz14_s4B.pt``: ``visual.patch_embed.proj``,
``visual.blocks.{i}.attn.{q,k,v}_proj``, ``q_bias``, ``v_bias``,
``inner_attn_ln``, ``mlp.{w1,w2,ffn_ln,w3}``, ``visual.norm``,
``visual.head``, and OpenCLIP's ``text.*``) and follows github.com/baaivision/
EVA (``EVA-CLIP/rei/eva_clip/eva_vit_model.py``: ``Attention`` with ``rope``
and ``subln``, ``SwiGLU`` with ``subln``, ``VisionRotaryEmbeddingFast``;
``transformer.py``'s ``TextTransformer`` with ``nn.GELU``). This module adds
the loss and the gradients the tests hold the port's to, over the prompt
learner's values as the port holds them (``ctx`` included) and the class
prompts' tokens as given; MaPLe's prompts and caption token are
``benchmark/reference/model.py``'s (Khattak et al. 2023).

Departures from EVA's code, each the configuration's choice:

* MaPLe's prompt and caption rows follow the 256 patches; like CLS they are
  not rotated (EVA turns every row after CLS, and has no such rows);
* q, k and v are three products (EVA's too) whose sum the port takes in one;
* the rotary table is computed from its formula (``pt_seq_len`` = the
  grid), not read from the ``rope.freqs_*`` buffers;
* the text tower runs the prompts truncated after the last EOT, exact under
  the causal mask.

``allow_tf32`` is off for matmul and cuDNN (:func:`strict_fp32`).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from benchmark.reference import eva02 as towers
from benchmark.reference import model as base
from benchmark.reference.eva02 import encode_image, rope_cos_sin, rotate_half  # noqa: F401
from benchmark.reference.model import strict_fp32  # noqa: F401


class EvaMaple:
    """The reference's parameters and its loss: ``sd`` EVA's state dict,
    ``pl`` the prompt learner's flat values (``ctx`` included), ``ids`` and
    ``eot`` the class prompts' tokens and EOT positions."""

    def __init__(self, sd, pl, ids, eot, n_ctx, depth, text_len, align, device="cpu"):
        self.params = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in sd.items()
                       if "rope.freqs" not in k}
        self.params.update({"prompt_learner." + k: v.detach().to(device, torch.float32)
                            for k, v in pl.items()})
        self.trainable = towers.trainable_names(sd, list(pl))
        self.prompts = SimpleNamespace(ids=ids.to(device), eot=eot.to(device), n_ctx=n_ctx,
                                       text_len=text_len)
        self.depth, self.align = depth, align

    def _split(self, params):
        sd = {k: v for k, v in params.items() if not k.startswith("prompt_learner.")}
        pl = base._unflat({k[len("prompt_learner."):]: v for k, v in params.items()
                           if k.startswith("prompt_learner.")})
        return sd, pl

    def features(self, params, images, caption_ids=None):
        sd, pl = self._split(params)
        text_deep, vis_deep = base.prompts(pl, self.depth)
        txt = towers.encode_text(sd, self.prompts, pl["ctx"], text_deep)
        shared = pl["ctx"] @ pl["proj_lang_to_vis"]["w"] + pl["proj_lang_to_vis"]["b"]
        extra = None
        if caption_ids is not None:
            extra = base.caption_token({"token_embedding.weight": sd["text.token_embedding.weight"]},
                                       pl, caption_ids)
        return encode_image(sd, images, shared, vis_deep, extra), txt

    def logits(self, images):
        with torch.no_grad():
            img, txt = self.features(self.params, images)
            scale = self.params["logit_scale"].exp().clamp(max=100.0)
            return scale * F.normalize(img, dim=-1, eps=1e-8) @ F.normalize(txt, dim=-1,
                                                                            eps=1e-8).T

    def loss_and_grads(self, images, labels, caption_ids=None):
        params = {k: (v.clone().requires_grad_(True) if k in self.trainable else v)
                  for k, v in self.params.items()}
        img, txt = self.features(params, images, caption_ids)
        img_n, txt_n = F.normalize(img, dim=-1, eps=1e-8), F.normalize(txt, dim=-1, eps=1e-8)
        logits = params["logit_scale"].exp().clamp(max=100.0) * img_n @ txt_n.T
        loss = F.cross_entropy(logits, labels) \
            + self.align * (1.0 - (img_n * txt_n[labels]).sum(-1)).mean()
        loss.backward()
        grads = {k: (params[k].grad if params[k].grad is not None
                     else torch.zeros_like(params[k])) for k in self.trainable}
        return float(loss), img.detach(), grads
