"""The weights both sides start from, made on the device from the seed.

CLIP's weights as an OpenAI state dict (the layout users load), drawn in one
call per distribution in bfloat16, the type the program serves them in, with
the scales of CLIP's initialisation (``clip/model.py``
``initialize_parameters``); the prompt learner's initial values, a flat
``{dotted name: tensor}`` dict in float32. The same seed gives the same
tensors.
"""

from __future__ import annotations

import math

import torch

_WEIGHT_STREAM, _PROMPT_STREAM = 0x5EED0001, 0x5EED0002


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2 ** 63)


def _block_shapes(prefix: str, width: int, layers: int) -> list:
    """``(name, shape, std)`` of a block's drawn weights; LayerNorm and biases
    are constants."""
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    return [(prefix + "attn.in_proj_weight", (3 * width, width), attn_std),
            (prefix + "attn.out_proj.weight", (width, width), proj_std),
            (prefix + "mlp.c_fc.weight", (4 * width, width), (2 * width) ** -0.5),
            (prefix + "mlp.c_proj.weight", (width, 4 * width), proj_std)]


def _block_constants(prefix: str, width: int) -> dict:
    zeros = {"attn.in_proj_bias": 3 * width, "attn.out_proj.bias": width,
             "mlp.c_fc.bias": 4 * width, "mlp.c_proj.bias": width,
             "ln_1.bias": width, "ln_2.bias": width}
    out = {prefix + k: ("zeros", (n,)) for k, n in zeros.items()}
    out.update({prefix + "ln_1.weight": ("ones", (width,)),
                prefix + "ln_2.weight": ("ones", (width,))})
    return out


def openai_state_dict(cfg: dict, seed: int, device) -> dict:
    """A CLIP ViT state dict of ``cfg``'s sizes: one ``randn`` for all
    drawn weights, in bfloat16 on ``device``."""
    W, P, L = cfg["vision_width"], cfg["vision_patch_size"], cfg["vision_layers"]
    d, Lt, E = cfg["transformer_width"], cfg["transformer_layers"], cfg["embed_dim"]
    grid = cfg["image_resolution"] // P
    drawn = [("visual.conv1.weight", (W, 3, P, P), (3 * P * P) ** -0.5),
             ("visual.class_embedding", (W,), W ** -0.5),
             ("visual.positional_embedding", (grid * grid + 1, W), W ** -0.5),
             ("visual.proj", (W, E), W ** -0.5),
             ("token_embedding.weight", (cfg["vocab_size"], d), 0.02),
             ("positional_embedding", (cfg["context_length"], d), 0.01),
             ("text_projection", (d, E), d ** -0.5)]
    consts = {"visual.ln_pre.weight": ("ones", (W,)), "visual.ln_pre.bias": ("zeros", (W,)),
              "visual.ln_post.weight": ("ones", (W,)), "visual.ln_post.bias": ("zeros", (W,)),
              "ln_final.weight": ("ones", (d,)), "ln_final.bias": ("zeros", (d,))}
    for i in range(L):
        drawn += _block_shapes(f"visual.transformer.resblocks.{i}.", W, L)
        consts.update(_block_constants(f"visual.transformer.resblocks.{i}.", W))
    for i in range(Lt):
        drawn += _block_shapes(f"transformer.resblocks.{i}.", d, Lt)
        consts.update(_block_constants(f"transformer.resblocks.{i}.", d))
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=generator(seed, _WEIGHT_STREAM, device),
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


def prompt_learner(cfg: dict, use_captions: bool, seed: int, device) -> dict:
    """MaPLe's prompt learner without ``ctx`` (worked out from the init
    phrase by each side): the deep prompts ~ N(0, 0.02), the couplers and
    projections as ``nn.Linear`` initialises them (uniform within
    ``1/sqrt(d_in)``; weights input-major), the caption pooling vector ~
    N(0, 1/d). One ``rand`` and one ``randn`` call."""
    d, W = cfg["transformer_width"], cfg["vision_width"]
    m = cfg["maple"]
    n_ctx, depth = m["n_ctx"], min(m["prompt_depth"], cfg["vision_layers"])
    linears = [("proj_lang_to_vis", d, W), ("proj_vis_to_lang", W, d)]
    normals = []
    for i in range(depth - 1):
        if i % 2 == 0:
            normals.append((f"text_deep_params.{i // 2}", (n_ctx, d), 0.02))
            linears.append((f"couplers.{i}", d, W))
        else:
            normals.append((f"vis_deep_params.{i // 2}", (n_ctx, W), 0.02))
            linears.append((f"couplers.{i}", W, d))
    if use_captions:
        normals.append(("caption_pool_w", (d,), d ** -0.5))
        linears.append(("caption_proj", d, W))
    gen = generator(seed, _PROMPT_STREAM, device)
    n_uniform = sum(a * b + b for _, a, b in linears)
    n_normal = sum(math.prod(s) for _, s, _ in normals)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, at = {}, 0
    for name, d_in, d_out in linears:
        bound = d_in ** -0.5
        out[name + ".w"] = uniform[at:at + d_in * d_out].view(d_in, d_out) * bound
        at += d_in * d_out
        out[name + ".b"] = uniform[at:at + d_out] * bound
        at += d_out
    at = 0
    for name, shape, std in normals:
        n = math.prod(shape)
        out[name] = normal[at:at + n].view(shape) * std
        at += n
    return out
