"""CLIP parameter construction for the port (counterpart of
``federated_multi_modal_tpu/models/params.py``): architecture config, random
init in CLIP's scheme from a ``torch.Generator``, the dtype policy, and the
weight bridge from the JAX package's flat checkpoint format.

Parameters are nested dicts and lists of tensors with the JAX tree's layout
and names (weights input-major ``(d_in, d_out)``), so a dotted name such as
``visual.blocks.0.attn.w_qkv`` means the same leaf in both packages.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path, unflatten


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    image_resolution: int = 224
    vision_layers: object = 12
    vision_width: int = 768
    vision_patch_size: int = 16
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def is_vit(self) -> bool:
        return isinstance(self.vision_layers, int)

    @property
    def vision_heads(self) -> int:
        if self.is_vit:
            return self.vision_width // 64
        return self.vision_width * 32 // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2


def tiny_test_config() -> CLIPConfig:
    """A miniature CLIP for fast CPU tests (head width 64, as CLIP)."""
    return CLIPConfig(
        embed_dim=64,
        image_resolution=32,
        vision_layers=3,
        vision_width=128,
        vision_patch_size=16,
        context_length=77,
        vocab_size=49408,
        transformer_width=128,
        transformer_heads=2,
        transformer_layers=3,
    )


# The ViT backbones of the JAX package's table; the ResNet ones wait for
# models/resnet.py's port.
BACKBONE_CONFIGS = {
    "ViT-B/16": CLIPConfig(),
    "ViT-B/32": CLIPConfig(vision_patch_size=32),
    "ViT-L/14": CLIPConfig(
        embed_dim=768,
        vision_layers=24,
        vision_width=1024,
        vision_patch_size=14,
        transformer_width=768,
        transformer_heads=12,
        transformer_layers=12,
    ),
    "Tiny": tiny_test_config(),
}


# -- dtype policy ------------------------------------------------------------

COMPUTE_DTYPE = torch.bfloat16

_NORM_NAMES = ("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final")


def apply_dtype_policy(params, compute_dtype=COMPUTE_DTYPE):
    """Matmul weights to ``compute_dtype``; LayerNorm params and the logit
    scale stay fp32."""

    def cast(name, leaf):
        if any(n in name for n in _NORM_NAMES) or "logit_scale" in name:
            return leaf.to(torch.float32)
        return leaf.to(compute_dtype)

    return tree_map_with_path(cast, params)


# -- random initialization (CLIP scheme) -------------------------------------


def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen) * std


def _init_block(gen, width: int, n_layers: int) -> dict:
    attn_std = width ** -0.5
    # residual projections scale with the tower's depth: (2 L) ** -0.5
    proj_std = attn_std * (2 * n_layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    return {
        "ln_1": {"scale": torch.ones(width), "bias": torch.zeros(width)},
        "attn": {
            "w_qkv": _normal(gen, (width, 3 * width), attn_std),
            "b_qkv": torch.zeros(3 * width),
            "w_out": _normal(gen, (width, width), proj_std),
            "b_out": torch.zeros(width),
        },
        "ln_2": {"scale": torch.ones(width), "bias": torch.zeros(width)},
        "mlp": {
            "w_fc": _normal(gen, (width, 4 * width), fc_std),
            "b_fc": torch.zeros(4 * width),
            "w_proj": _normal(gen, (4 * width, width), proj_std),
            "b_proj": torch.zeros(width),
        },
    }


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator = None,
                     dtype_policy: bool = True) -> dict:
    """Random CLIP-shaped ViT parameters on the CPU (the numbers follow
    ``CLIP.initialize_parameters``; a ``torch.Generator`` does not give
    ``jax.random``'s numbers, so tests carry weights across with
    :func:`load_jax_params`)."""
    if not cfg.is_vit:
        raise NotImplementedError("ResNet backbones are not ported yet")
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    w = cfg.vision_width
    scale = w ** -0.5
    patch_dim = cfg.vision_patch_size ** 2 * 3
    visual = {
        "conv1": {"w": _normal(gen, (patch_dim, w), patch_dim ** -0.5)},
        "class_embedding": _normal(gen, (w,), scale),
        "positional_embedding": _normal(gen, (cfg.num_patches + 1, w), scale),
        "ln_pre": {"scale": torch.ones(w), "bias": torch.zeros(w)},
        "blocks": [_init_block(gen, w, cfg.vision_layers)
                   for _ in range(cfg.vision_layers)],
        "ln_post": {"scale": torch.ones(w), "bias": torch.zeros(w)},
        "proj": _normal(gen, (w, cfg.embed_dim), scale),
    }
    d = cfg.transformer_width
    text = {
        "token_embedding": _normal(gen, (cfg.vocab_size, d), 0.02),
        "positional_embedding": _normal(gen, (cfg.context_length, d), 0.01),
        "blocks": [_init_block(gen, d, cfg.transformer_layers)
                   for _ in range(cfg.transformer_layers)],
        "ln_final": {"scale": torch.ones(d), "bias": torch.zeros(d)},
        "text_projection": _normal(gen, (d, cfg.embed_dim), d ** -0.5),
    }
    params = {
        "visual": visual,
        "text": text,
        "logit_scale": torch.tensor(math.log(1.0 / 0.07), dtype=torch.float32),
    }
    if dtype_policy:
        params = apply_dtype_policy(params)
    return params


# -- weight bridge from the JAX package --------------------------------------


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # torch.from_numpy rejects ml_dtypes' bfloat16; fp32 holds it exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def load_jax_params(flat, device=None):
    """Nested tensors from a flat ``{dotted name: numpy array}`` dict in the
    JAX package's ``engine/checkpoint.py::flatten_params`` format (e.g.
    ``clip.visual.blocks.0.attn.w_qkv``). Dtypes are kept, bf16 included;
    ``device=None`` means ``"cuda"``."""
    from federated_multi_modal_tpu_torch.device import resolve_device

    device = resolve_device(device)
    return unflatten({k: _to_tensor(v).to(device) for k, v in flat.items()})
