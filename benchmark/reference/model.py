"""Plain PyTorch reference of the MaPLe train step and eval, in float32.

It reads CLIP's weights in OpenAI's layout (``visual.conv1.weight``,
``transformer.resblocks.{i}.attn.in_proj_weight`` ...), the prompt
learner's initial values as the benchmark made them, the uint8 canvas, the
crop boxes, the labels and the caption token ids, and works out everything
else itself: the class prompts' tokens and embeddings, the context vectors
from the init phrase, the crops, both towers, the loss, the gradients, the
clip and SGD. Nothing of the program is imported.

The model follows CLIP (github.com/openai/CLIP ``clip/model.py``: pre-LN
blocks, QuickGELU, causal text attention, pooling at EOT) with MaPLe's
prompts (Khattak et al. 2023) as this repository specifies them:

* text: ``[SOT, ctx, rest of "<phrase> <name>."]``; at layers
  ``1 .. depth-1`` the rows ``1 .. n_ctx`` are replaced by that layer's
  text prompt;
* vision: ``[CLS, patches] + positions``, then the shared prompt
  ``proj_lang_to_vis(ctx)`` and the caption token appended (no position);
  at layers ``1 .. depth-1`` the trailing rows are replaced by that layer's
  vision prompt and the caption token again;
* the prompts alternate: at even ``i`` a text prompt is learnt and coupled
  into the vision width, at odd ``i`` a vision prompt into the text width;
* the caption token: the caption's token embeddings pooled by a softmax
  over all 77 positions of ``emb @ caption_pool_w``, then ``caption_proj``;
* the loss: cross-entropy of ``min(exp(logit_scale), 100) * cos`` plus
  ``align`` x (1 - mean cosine of each image with its label's text);
* SGD with momentum and coupled weight decay after a global-norm clip of
  the raw gradients (``g / norm * clip`` where the norm reaches the clip).

The text tower runs the prompts truncated after the last EOT (rounded up to
a multiple of 8, as the program does; exact under the causal mask).

``quant`` runs every product of the two towers' blocks, and the patch
embedding, on operands rounded to float8: e4m3 forward, e5m2 for the
gradients, each scaled to its tensor's largest magnitude. That is the
control: the step below bfloat16 that would tempt a faster build.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import tokens

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def strict_fp32() -> None:
    """Products in float32 on the card: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# -- float8 operands for the control ----------------------------------------------


def _round_to(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_to(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2, 57344.0)


def _q(x: torch.Tensor, quant: bool) -> torch.Tensor:
    return _Fp8.apply(x) if quant else x


# -- blocks --------------------------------------------------------------------------


def _linear(x, w, b, quant):
    return F.linear(_q(x, quant), _q(w, quant), b)


def block(x, p: str, sd: dict, heads: int, causal: bool, quant: bool) -> torch.Tensor:
    """One residual block of CLIP, weights ``sd[p + ...]``."""
    B, T, D = x.shape
    h = F.layer_norm(x, (D,), sd[p + "ln_1.weight"], sd[p + "ln_1.bias"], 1e-5)
    qkv = _linear(h, sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"], quant)
    q, k, v = (t.reshape(B, T, heads, D // heads).transpose(1, 2) for t in qkv.chunk(3, -1))
    s = _q(q, quant) @ _q(k, quant).transpose(-1, -2) / math.sqrt(D // heads)
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
    o = _q(torch.softmax(s, -1), quant) @ _q(v, quant)
    o = o.transpose(1, 2).reshape(B, T, D)
    x = x + _linear(o, sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"], quant)
    h = F.layer_norm(x, (D,), sd[p + "ln_2.weight"], sd[p + "ln_2.bias"], 1e-5)
    h = _linear(h, sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"], quant)
    h = h * torch.sigmoid(1.702 * h)
    return x + _linear(h, sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"], quant)


def _layers(sd: dict, prefix: str) -> int:
    return len({k.split(".")[len(prefix.split(".")) - 1] for k in sd if k.startswith(prefix)})


# -- the prompt learner -----------------------------------------------------------------


def prompts(pl: dict, depth: int):
    """``(text_deep, vis_deep)``: the prompts of layers ``1 .. depth-1``."""
    text_deep, vis_deep = [], []
    for i in range(depth - 1):
        c = pl["couplers"][i]
        if i % 2 == 0:
            p = pl["text_deep_params"][i // 2]
            text_deep.append(p)
            vis_deep.append(p @ c["w"] + c["b"])
        else:
            p = pl["vis_deep_params"][i // 2]
            vis_deep.append(p)
            text_deep.append(p @ c["w"] + c["b"])
    return text_deep, vis_deep


class ClassPrompts:
    """The class prompts' token ids, worked out from the names."""

    def __init__(self, phrase: str, classnames, n_ctx: int):
        self.ids = torch.from_numpy(tokens.tokenize([f"{phrase} {c}." for c in classnames]))
        self.phrase_ids = torch.from_numpy(tokens.tokenize([phrase]))[0]
        self.eot = self.ids.argmax(-1)
        self.n_ctx = n_ctx
        self.text_len = min(tokens.CONTEXT, -(-(int(self.eot.max()) + 1) // 8) * 8)

    def ctx_init(self, sd: dict) -> torch.Tensor:
        """The context vectors MaPLe starts from: the phrase's tokens 1 .. n_ctx."""
        emb = sd["token_embedding.weight"]
        return emb[self.phrase_ids[1:1 + self.n_ctx].to(emb.device)].clone()


def encode_text(sd: dict, cp: ClassPrompts, ctx, text_deep, quant: bool = False):
    emb = sd["token_embedding.weight"]
    ids = cp.ids.to(emb.device)
    x = emb[ids]
    n = x.shape[0]
    x = torch.cat([x[:, :1], ctx[None].expand(n, -1, -1), x[:, 1 + cp.n_ctx:]], 1)
    x = x[:, :cp.text_len] + sd["positional_embedding"][:cp.text_len]
    heads = x.shape[-1] // 64
    for i in range(_layers(sd, "transformer.resblocks.")):
        if 1 <= i <= len(text_deep):
            p = text_deep[i - 1][None].expand(n, -1, -1)
            x = torch.cat([x[:, :1], p, x[:, 1 + cp.n_ctx:]], 1)
        x = block(x, f"transformer.resblocks.{i}.", sd, heads, True, quant)
    x = F.layer_norm(x, x.shape[-1:], sd["ln_final.weight"], sd["ln_final.bias"], 1e-5)
    return x[torch.arange(n, device=x.device), cp.eot.to(x.device)] @ sd["text_projection"]


def caption_token(sd: dict, pl: dict, caption_ids) -> torch.Tensor:
    emb = sd["token_embedding.weight"][caption_ids]
    probs = torch.softmax(emb @ pl["caption_pool_w"], dim=1)
    pooled = (probs[..., None] * emb).sum(1)
    return (pooled @ pl["caption_proj"]["w"] + pl["caption_proj"]["b"])[:, None]


def encode_image(sd: dict, images, shared_ctx, vis_deep, extra=None, quant: bool = False):
    """``images (B, 3, H, W)`` normalised -> ``(B, embed)``."""
    w = sd["visual.conv1.weight"]
    x = F.conv2d(_q(images, quant), _q(w, quant), stride=w.shape[-1])
    B, D = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([sd["visual.class_embedding"].expand(B, 1, D), x], 1)
    x = x + sd["visual.positional_embedding"]
    tail = [shared_ctx[None].expand(B, -1, -1)] + ([extra] if extra is not None else [])
    x = torch.cat([x] + tail, 1)
    n_tail = sum(t.shape[1] for t in tail)
    x = F.layer_norm(x, (D,), sd["visual.ln_pre.weight"], sd["visual.ln_pre.bias"], 1e-5)
    for i in range(_layers(sd, "visual.transformer.resblocks.")):
        if 1 <= i <= len(vis_deep):
            tail = [vis_deep[i - 1][None].expand(B, -1, -1)]
            tail += [extra] if extra is not None else []
            x = torch.cat([x[:, :x.shape[1] - n_tail]] + tail, 1)
        x = block(x, f"visual.transformer.resblocks.{i}.", sd, D // 64, False, quant)
    x = F.layer_norm(x[:, 0], (D,), sd["visual.ln_post.weight"], sd["visual.ln_post.bias"], 1e-5)
    return x @ sd["visual.proj"]


# -- the crops -----------------------------------------------------------------------------


def _cubic(t, a=-0.5):
    t = t.abs()
    return torch.where(t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                       torch.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                                   torch.zeros_like(t)))


def _axis_weights(size: int, out: int, start, length):
    """``(B, out, size)``: bicubic (a = -0.5) resampling of the window
    ``[start, start + length)``, the kernel widened by the downscale factor
    and cut to the window, each row summing to 1 (PIL's ``resize(box=)``)."""
    start, length = start[:, None, None].double(), length[:, None, None].double()
    scale = length / out
    o = torch.arange(out, dtype=torch.float64, device=start.device)[None, :, None]
    pos = torch.arange(size, dtype=torch.float64, device=start.device)[None, None, :]
    centre = start + (o + 0.5) * scale - 0.5
    w = _cubic((pos - centre) / scale.clamp(min=1.0))
    w = w * ((pos + 0.5 >= start) & (pos + 0.5 <= start + length))
    return (w / w.sum(-1, keepdim=True)).float()


def crop(canvas, boxes, flips, out: int) -> torch.Tensor:
    """``canvas (B, S, S, 3)`` uint8, ``boxes (B, 4)`` ``(y0, x0, h, w)``,
    ``flips (B,)`` -> ``(B, 3, out, out)`` CLIP-normalised float32."""
    S = canvas.shape[1]
    wy = _axis_weights(S, out, boxes[:, 0], boxes[:, 2])
    wx = _axis_weights(S, out, boxes[:, 1], boxes[:, 3])
    img = canvas.float().permute(0, 3, 1, 2) / 255.0  # (B, 3, S, S)
    img = wy[:, None] @ img @ wx[:, None].transpose(-1, -2)
    img = torch.where(flips[:, None, None, None], img.flip(-1), img)
    mean = torch.tensor(CLIP_MEAN, device=img.device)[None, :, None, None]
    std = torch.tensor(CLIP_STD, device=img.device)[None, :, None, None]
    return (img - mean) / std


# -- the loss and the step -----------------------------------------------------------------


def trainable_names(sd: dict, pl_names) -> list:
    """The leaves MaPLe trains: the prompt learner, every LayerNorm and the
    last block of each tower."""
    v_last = _layers(sd, "visual.transformer.resblocks.") - 1
    t_last = _layers(sd, "transformer.resblocks.") - 1
    lns = ("ln_1.", "ln_2.", "ln_pre.", "ln_post.", "ln_final.")
    names = [k for k in sd if any(s in k for s in lns)
             or k.startswith(f"visual.transformer.resblocks.{v_last}.")
             or k.startswith(f"transformer.resblocks.{t_last}.")]
    return names + ["prompt_learner." + n for n in pl_names]


def _unflat(flat: dict):
    """``{"a.0.w": t}`` -> ``{"a": [{"w": t}]}`` (digit levels become lists)."""
    root = {}
    for name, t in flat.items():
        node, parts = root, name.split(".")
        for a, b in zip(parts, parts[1:]):
            node = node.setdefault(a, {})
        node[parts[-1]] = t

    def lists(n):
        if isinstance(n, dict) and n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()} if isinstance(n, dict) else n

    return lists(root)


class MaPLe:
    """The reference's state and its step.

    ``sd``: OpenAI state dict (any float type, read as float32 on
    ``device``); ``pl``: the prompt learner's initial values, a flat
    ``{dotted name: tensor}`` dict without ``ctx``, which is worked out from
    the phrase. ``cfg``: the configuration's ``maple`` and ``optim``
    groups."""

    def __init__(self, sd, pl: dict, classnames, cfg: dict, device, quant: bool = False):
        m, o = cfg["maple"], cfg["optim"]
        self.depth, self.align = m["prompt_depth"], m["align_lambda"]
        self.lr, self.momentum = o["lr"], o["momentum"]
        self.wd, self.clip = o["weight_decay"], o["clip_norm"]
        self.quant = quant
        self.params = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()}
        self.cp = ClassPrompts(m["ctx_init"], classnames, m["n_ctx"])
        flat_pl = {"prompt_learner." + k: v.to(device=device, dtype=torch.float32).clone()
                   for k, v in pl.items()}
        flat_pl["prompt_learner.ctx"] = self.cp.ctx_init(self.params)
        self.params.update(flat_pl)
        self.trainable = trainable_names(sd, [k[len("prompt_learner."):] for k in flat_pl])
        self.trace = {k: torch.zeros_like(self.params[k]) for k in self.trainable}

    def _split(self, params):
        sd = {k: v for k, v in params.items() if not k.startswith("prompt_learner.")}
        pl = _unflat({k[len("prompt_learner."):]: v for k, v in params.items()
                      if k.startswith("prompt_learner.")})
        return sd, pl

    def text_features(self, params):
        sd, pl = self._split(params)
        text_deep, _ = prompts(pl, self.depth)
        return encode_text(sd, self.cp, pl["ctx"], text_deep, self.quant)

    def image_features(self, params, images, caption_ids=None):
        sd, pl = self._split(params)
        _, vis_deep = prompts(pl, self.depth)
        shared = pl["ctx"] @ pl["proj_lang_to_vis"]["w"] + pl["proj_lang_to_vis"]["b"]
        extra = caption_token(sd, pl, caption_ids) if caption_ids is not None else None
        return encode_image(sd, images, shared, vis_deep, extra, self.quant)

    def _scale(self, params):
        return params["logit_scale"].exp().clamp(max=100.0)

    def logits(self, images, rows: int):
        """Eval logits of ``images (B, 3, H, W)``, ``rows`` images at a time."""
        with torch.no_grad():
            txt = F.normalize(self.text_features(self.params), dim=-1, eps=1e-8)
            out = [self._scale(self.params) * F.normalize(
                self.image_features(self.params, images[i:i + rows]), dim=-1, eps=1e-8) @ txt.T
                for i in range(0, images.shape[0], rows)]
        return torch.cat(out)

    def loss_and_grads(self, images, labels, caption_ids, rows: int, take=None):
        """The batch's loss and the gradient of every trainable leaf, the
        image tower run ``rows`` images at a time. ``take``: the loss is the
        mean over these rows alone (the half-batch fault)."""
        params = {k: (v.detach().requires_grad_(True) if k in self.trainable else v)
                  for k, v in self.params.items()}
        txt = self.text_features(params)
        txt_leaf = txt.detach().requires_grad_(True)
        idx = torch.arange(images.shape[0], device=images.device) if take is None else take
        total = 0.0
        for i in range(0, idx.shape[0], rows):
            r = idx[i:i + rows]
            img = self.image_features(params, images[r],
                                      None if caption_ids is None else caption_ids[r])
            img_n = F.normalize(img, dim=-1, eps=1e-8)
            txt_n = F.normalize(txt_leaf, dim=-1, eps=1e-8)
            logits = self._scale(params) * img_n @ txt_n.T
            y = labels[r]
            part = (F.cross_entropy(logits, y, reduction="sum")
                    + self.align * (1.0 - (img_n * txt_n[y]).sum(-1)).sum()) / idx.shape[0]
            part.backward()
            total += float(part.detach())
        txt.backward(txt_leaf.grad)
        grads = {k: (params[k].grad if params[k].grad is not None
                     else torch.zeros_like(params[k])) for k in self.trainable}
        return total, grads

    def step(self, grads) -> dict:
        """SGD as the configuration states; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        clipped = {k: g * factor for k, g in grads.items()}
        with torch.no_grad():
            for k, g in clipped.items():
                self.trace[k] = g + self.wd * self.params[k] + self.momentum * self.trace[k]
                self.params[k] = self.params[k] - self.lr * self.trace[k]
        return clipped


def grad_norm(grads: dict) -> float:
    return float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))
