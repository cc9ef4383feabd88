"""EVA02-CLIP-L/14 with MaPLe (``"architecture": "eva02_clip"``).

Every piece a loop takes from its model, under the names that
``benchmark/harness.py`` lists for an architecture: seeded weights in
EVA-CLIP's published state dict layout (``EVA02_CLIP_L_psz14_s4B.pt``'s
keys, at EVA's initialisation scales: ``eva_vit_model.py``'s
``_init_weights`` and ``fix_init_weight``; OpenCLIP's text as CLIP's; the
rotary buffers left out, which the port's loader ignores), the
system under test (``benchmark/system/eva02.py``: the port's loader and
program), the plain reference (``benchmark/reference/eva02.py``) with
``model.py``'s crop, and the frozen counts (``benchmark/counts/eva02.py``).
EVA's block: rotary q.k on the patch rows, sub-LNs, a SwiGLU MLP of 2730.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts.eva02 import (  # noqa: F401
    attention_work,
    eval_batch_flops,
    gemm_work,
    train_step_flops,
)
from benchmark.reference.eva02 import MaPLe as Reference  # noqa: F401
from benchmark.reference.eva02 import crop, grad_norm, strict_fp32  # noqa: F401
from benchmark.system import eva02 as system  # noqa: F401
from benchmark.traffic import weights
from benchmark.traffic.weights import prompt_learner  # noqa: F401


def _vision(cfg: dict):
    """``(drawn (name, shape, std), constants {name: (kind, shape)})`` of the
    vision tower."""
    D, P, L, H = (cfg["vision_width"], cfg["vision_patch_size"], cfg["vision_layers"],
                  cfg["vision_mlp_width"])
    grid = cfg["image_resolution"] // P
    drawn = [("visual.patch_embed.proj.weight", (D, 3, P, P), 0.02),
             ("visual.cls_token", (1, 1, D), 0.02),
             ("visual.pos_embed", (1, grid * grid + 1, D), 0.02),
             ("visual.head.weight", (cfg["embed_dim"], D), 0.02)]
    consts = {"visual.patch_embed.proj.bias": ("zeros", (D,)),
              "visual.norm.weight": ("ones", (D,)), "visual.norm.bias": ("zeros", (D,)),
              "visual.head.bias": ("zeros", (cfg["embed_dim"],))}
    for i in range(L):
        p = f"visual.blocks.{i}."
        rescale = (2.0 * (i + 1)) ** -0.5
        drawn += [(p + "attn.q_proj.weight", (D, D), 0.02), (p + "attn.k_proj.weight", (D, D), 0.02),
                  (p + "attn.v_proj.weight", (D, D), 0.02),
                  (p + "attn.proj.weight", (D, D), 0.02 * rescale),
                  (p + "mlp.w1.weight", (H, D), 0.02), (p + "mlp.w2.weight", (H, D), 0.02),
                  (p + "mlp.w3.weight", (D, H), 0.02 * rescale)]
        for name, n in (("norm1", D), ("norm2", D), ("attn.inner_attn_ln", D), ("mlp.ffn_ln", H)):
            consts[p + name + ".weight"] = ("ones", (n,))
            consts[p + name + ".bias"] = ("zeros", (n,))
        for name, n in (("attn.q_bias", D), ("attn.v_bias", D), ("attn.proj.bias", D),
                        ("mlp.w1.bias", H), ("mlp.w2.bias", H), ("mlp.w3.bias", D)):
            consts[p + name] = ("zeros", (n,))
    return drawn, consts


def state_dict(cfg: dict, seed: int, device) -> dict:
    """An EVA02-CLIP state dict of ``cfg``'s sizes: one ``randn`` for all
    drawn weights, in bfloat16 on ``device``."""
    d, Lt, E = cfg["transformer_width"], cfg["transformer_layers"], cfg["embed_dim"]
    drawn, consts = _vision(cfg)
    drawn += [("text.token_embedding.weight", (cfg["vocab_size"], d), 0.02),
              ("text.positional_embedding", (cfg["context_length"], d), 0.01),
              ("text.text_projection", (d, E), d ** -0.5)]
    consts.update({"text.ln_final.weight": ("ones", (d,)), "text.ln_final.bias": ("zeros", (d,))})
    for i in range(Lt):
        drawn += weights._block_shapes(f"text.transformer.resblocks.{i}.", d, Lt)
        consts.update(weights._block_constants(f"text.transformer.resblocks.{i}.", d))
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=weights.generator(seed, weights._WEIGHT_STREAM, device),
                       device=device, dtype=torch.bfloat16)
    sd, at = {}, 0
    for name, shape, std in drawn:
        n = math.prod(shape)
        sd[name] = flat[at:at + n].view(shape).mul_(std)
        at += n
    for name, (kind, shape) in consts.items():
        sd[name] = (torch.ones if kind == "ones" else torch.zeros)(
            shape, dtype=torch.bfloat16, device=device)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07), dtype=torch.float32, device=device)
    return sd


def reference_rows(cfg: dict, mix: dict, device) -> int:
    """Images the reference's image tower takes at once: what fits half the
    free memory, by a rough count of float32 activations kept for the
    backward (the SwiGLU hidden's three 2730-wide tensors and the sub-LNs
    beside attention's)."""
    if device.type != "cuda":
        return mix["batch"]
    D, L = cfg["vision_width"], cfg["vision_layers"]
    T = (cfg["image_resolution"] // cfg["vision_patch_size"]) ** 2 + 4
    per_image = 4 * L * (48 * T * D + 4 * (D // 64) * T * T)
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(mix["batch"], int(0.5 * free // per_image)))
