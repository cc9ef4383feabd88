"""Plain PyTorch reference of EVA02-CLIP-L/14 under MaPLe, in float32: its two
towers, with the train step and eval of ``benchmark/reference/model.py``
around them (``tests/eva02_reference.py`` puts the CPU tests' loss around the
same towers).

It reads EVA-CLIP's published state dict layout (``visual.patch_embed.proj``,
``visual.blocks.{i}.attn.{q,k,v}_proj``, ``q_bias``, ``v_bias``,
``inner_attn_ln``, ``mlp.{w1,w2,ffn_ln,w3}``, ``visual.norm``, ``visual.head``,
OpenCLIP's ``text.*``), follows ``eva_vit_model.py`` of github.com/baaivision/
EVA (``rope``, ``subln``, ``naiveswiglu``, LayerNorm eps 1e-6) and OpenCLIP's
text tower (exact GELU), and takes MaPLe's prompts, the caption token, the
loss, the clip and SGD from ``model.py``. Nothing of the program is imported.
Departures from EVA's code: MaPLe's prompt and caption rows follow the
patches and are not rotated (EVA has no such rows); the rotary table is
computed from its formula (``pt_seq_len`` 16 = the grid); the text runs
truncated after the last EOT (exact under the causal mask).

``quant`` puts every product of the two towers' blocks and the patch
embedding on float8 operands (``model.py``'s control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import model as base
from benchmark.reference.model import crop, grad_norm, strict_fp32  # noqa: F401

VISION_EPS, TEXT_EPS = 1e-6, 1e-5


def rope_cos_sin(grid: int, head_dim: int, theta: float = 10000.0):
    """``VisionRotaryEmbeddingFast``'s ``(grid^2, head_dim)`` cos and sin."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2)[:dim // 2].float() / dim))
    freqs = torch.einsum("i,f->if", torch.arange(grid).float(), freqs).repeat_interleave(2, -1)
    freqs = torch.cat([freqs[:, None, :].expand(grid, grid, dim),
                       freqs[None, :, :].expand(grid, grid, dim)], -1)
    return freqs.cos().reshape(-1, head_dim), freqs.sin().reshape(-1, head_dim)


def rotate_half(x):
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), -1).flatten(-2)


def _ln(x, sd, p, eps):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], eps)


def _lin(x, sd, w, b, quant):
    return base._linear(x, sd[w], None if b is None else sd[b], quant)


def eva_block(x, sd, p, heads, cos, sin, quant):
    B, T, D = x.shape
    hd = D // heads
    h = _ln(x, sd, p + "norm1", VISION_EPS)
    q = _lin(h, sd, p + "attn.q_proj.weight", p + "attn.q_bias", quant)
    k = _lin(h, sd, p + "attn.k_proj.weight", None, quant)
    v = _lin(h, sd, p + "attn.v_proj.weight", p + "attn.v_bias", quant)
    q, k, v = (t.reshape(B, T, heads, hd).transpose(1, 2) for t in (q, k, v))
    n = cos.shape[0]

    def rope(t):
        mid = t[:, :, 1:1 + n]
        return torch.cat([t[:, :, :1], mid * cos + rotate_half(mid) * sin, t[:, :, 1 + n:]], 2)

    q, k = rope(q), rope(k)
    s = base._q(q, quant) @ base._q(k, quant).transpose(-1, -2) * hd ** -0.5
    o = base._q(torch.softmax(s, -1), quant) @ base._q(v, quant)
    o = _ln(o.transpose(1, 2).reshape(B, T, D), sd, p + "attn.inner_attn_ln", VISION_EPS)
    x = x + _lin(o, sd, p + "attn.proj.weight", p + "attn.proj.bias", quant)
    h = _ln(x, sd, p + "norm2", VISION_EPS)
    g = F.silu(_lin(h, sd, p + "mlp.w1.weight", p + "mlp.w1.bias", quant)) \
        * _lin(h, sd, p + "mlp.w2.weight", p + "mlp.w2.bias", quant)
    g = _ln(g, sd, p + "mlp.ffn_ln", VISION_EPS)
    return x + _lin(g, sd, p + "mlp.w3.weight", p + "mlp.w3.bias", quant)


def text_block(x, sd, p, heads, quant):
    """OpenCLIP's causal text block: CLIP's with exact GELU."""
    B, T, D = x.shape
    h = _ln(x, sd, p + "ln_1", TEXT_EPS)
    qkv = _lin(h, sd, p + "attn.in_proj_weight", p + "attn.in_proj_bias", quant)
    q, k, v = (t.reshape(B, T, heads, D // heads).transpose(1, 2) for t in qkv.chunk(3, -1))
    s = base._q(q, quant) @ base._q(k, quant).transpose(-1, -2) / math.sqrt(D // heads)
    s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = (base._q(torch.softmax(s, -1), quant) @ base._q(v, quant)).transpose(1, 2).reshape(B, T, D)
    x = x + _lin(o, sd, p + "attn.out_proj.weight", p + "attn.out_proj.bias", quant)
    h = F.gelu(_lin(_ln(x, sd, p + "ln_2", TEXT_EPS), sd, p + "mlp.c_fc.weight",
                    p + "mlp.c_fc.bias", quant))
    return x + _lin(h, sd, p + "mlp.c_proj.weight", p + "mlp.c_proj.bias", quant)


def _count(sd, prefix):
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def encode_image(sd, images, shared_ctx, vis_deep, extra=None, quant=False):
    w = sd["visual.patch_embed.proj.weight"]
    x = F.conv2d(base._q(images, quant), base._q(w, quant), sd["visual.patch_embed.proj.bias"],
                 stride=w.shape[-1])
    B, D, g, _ = x.shape
    x = torch.cat([sd["visual.cls_token"].expand(B, 1, D), x.flatten(2).transpose(1, 2)], 1)
    x = x + sd["visual.pos_embed"]
    tail = [shared_ctx[None].expand(B, -1, -1)] + ([extra] if extra is not None else [])
    x = torch.cat([x] + tail, 1)
    n_tail = sum(t.shape[1] for t in tail)
    heads = D // 64
    cos, sin = (t.to(x.device) for t in rope_cos_sin(g, D // heads))
    for i in range(_count(sd, "visual.blocks.")):
        if 1 <= i <= len(vis_deep):
            tail = [vis_deep[i - 1][None].expand(B, -1, -1)] + ([extra] if extra is not None else [])
            x = torch.cat([x[:, :x.shape[1] - n_tail]] + tail, 1)
        x = eva_block(x, sd, f"visual.blocks.{i}.", heads, cos, sin, quant)
    x = _ln(x[:, 0], sd, "visual.norm", VISION_EPS)
    return F.linear(x, sd["visual.head.weight"], sd["visual.head.bias"])


def encode_text(sd, cp: base.ClassPrompts, ctx, text_deep, quant=False):
    emb = sd["text.token_embedding.weight"]
    x = emb[cp.ids.to(emb.device)]
    n = x.shape[0]
    x = torch.cat([x[:, :1], ctx[None].expand(n, -1, -1), x[:, 1 + cp.n_ctx:]], 1)
    x = x[:, :cp.text_len] + sd["text.positional_embedding"][:cp.text_len]
    heads = x.shape[-1] // 64
    for i in range(_count(sd, "text.transformer.resblocks.")):
        if 1 <= i <= len(text_deep):
            x = torch.cat([x[:, :1], text_deep[i - 1][None].expand(n, -1, -1),
                           x[:, 1 + cp.n_ctx:]], 1)
        x = text_block(x, sd, f"text.transformer.resblocks.{i}.", heads, quant)
    x = _ln(x, sd, "text.ln_final", TEXT_EPS)
    return x[torch.arange(n, device=x.device), cp.eot.to(x.device)] @ sd["text.text_projection"]


def trainable_names(sd, pl_names) -> list:
    """The prompt learner, every LayerNorm (the sub-LNs too) and the last block
    of each tower."""
    v_last = _count(sd, "visual.blocks.") - 1
    t_last = _count(sd, "text.transformer.resblocks.") - 1
    norms = ("norm1.", "norm2.", "inner_attn_ln.", "ffn_ln.", "visual.norm.", "ln_1.", "ln_2.",
             "ln_final.")
    names = [k for k in sd if any(s in k for s in norms)
             or k.startswith(f"visual.blocks.{v_last}.")
             or k.startswith(f"text.transformer.resblocks.{t_last}.")]
    return names + ["prompt_learner." + n for n in pl_names]


class MaPLe(base.MaPLe):
    """``model.py``'s MaPLe (state, loss, gradients, SGD, eval logits) over
    EVA02-CLIP's towers; ``sd`` in EVA-CLIP's layout."""

    def __init__(self, sd, pl: dict, classnames, cfg: dict, device, quant: bool = False):
        sd = {k: v for k, v in sd.items() if "rope.freqs" not in k}
        text = {"token_embedding.weight": sd["text.token_embedding.weight"]}
        # model.py's constructor, with EVA's names for the text embedding
        m, o = cfg["maple"], cfg["optim"]
        self.depth, self.align = m["prompt_depth"], m["align_lambda"]
        self.lr, self.momentum = o["lr"], o["momentum"]
        self.wd, self.clip = o["weight_decay"], o["clip_norm"]
        self.quant = quant
        self.params = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.cp = base.ClassPrompts(m["ctx_init"], classnames, m["n_ctx"])
        flat_pl = {"prompt_learner." + k: v.to(device=device, dtype=torch.float32).clone()
                   for k, v in pl.items()}
        flat_pl["prompt_learner.ctx"] = self.cp.ctx_init(
            {k: v.to(device=device, dtype=torch.float32) for k, v in text.items()})
        self.params.update(flat_pl)
        self.trainable = trainable_names(sd, [k[len("prompt_learner."):] for k in flat_pl])
        self.trace = {k: torch.zeros_like(self.params[k]) for k in self.trainable}

    def text_features(self, params):
        sd, pl = self._split(params)
        text_deep, _ = base.prompts(pl, self.depth)
        return encode_text(sd, self.cp, pl["ctx"], text_deep, self.quant)

    def image_features(self, params, images, caption_ids=None):
        sd, pl = self._split(params)
        _, vis_deep = base.prompts(pl, self.depth)
        shared = pl["ctx"] @ pl["proj_lang_to_vis"]["w"] + pl["proj_lang_to_vis"]["b"]
        extra = None
        if caption_ids is not None:
            extra = base.caption_token({"token_embedding.weight": sd["text.token_embedding.weight"]},
                                       pl, caption_ids)
        return encode_image(sd, images, shared, vis_deep, extra, self.quant)
