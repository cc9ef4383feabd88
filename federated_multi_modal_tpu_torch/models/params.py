"""CLIP parameter construction for the port (counterpart of
``federated_multi_modal_tpu/models/params.py``): architecture config, random
init in CLIP's scheme from a ``torch.Generator``, the dtype policy, the
weight bridge from the JAX package's flat checkpoint format, and the loading
of an OpenAI CLIP state dict, ViT or ModifiedResNet (``load_clip_backbone``).

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
from federated_multi_modal_tpu_torch.models.resnet import (
    ResNetConfig,
    convert_torch_resnet,
    export_torch_resnet,
    init_resnet_params,
)


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

    def resnet_config(self) -> ResNetConfig:
        return ResNetConfig(
            layers=tuple(self.vision_layers),
            output_dim=self.embed_dim,
            width=self.vision_width,
            input_resolution=self.image_resolution,
        )


@dataclasses.dataclass(frozen=True)
class EvaCLIPConfig(CLIPConfig):
    """EVA02-CLIP (``eva_vit_model.py`` of github.com/baaivision/EVA with
    ``rope``, ``subln`` and ``naiveswiglu``): CLIP's sizes, and a vision block
    with 2-D rotary q.k on the patch rows, biases on q and v only, a LayerNorm
    between attention and its out-projection, a SwiGLU MLP of
    ``vision_mlp_width`` with a LayerNorm on its hidden, LayerNorms at
    ``vision_ln_eps``; no ``ln_pre``, biases on the patch embedding and the
    head; OpenCLIP's text tower, whose MLP takes exact GELU."""

    vision_mlp_width: int = 2730
    vision_ln_eps: float = 1e-6

    @property
    def vision_mlp_padded(self) -> int:
        """The MLP width the port's kernels run: the hidden padded with zero
        weights to a multiple of 8 (2730 -> 2736)."""
        return -(-self.vision_mlp_width // 8) * 8


def is_eva(cfg) -> bool:
    """Whether ``cfg`` (the port's or the JAX package's) is EVA-CLIP's."""
    return isinstance(cfg, EvaCLIPConfig)


def eva02_config(**kw) -> EvaCLIPConfig:
    """EVA02-CLIP-L/14 (``EVA02-CLIP-L-14.json``: vision 24 x 1024, heads of 64,
    patch 14 at 224, mlp_ratio 2.6667 (2730), LayerNorm eps 1e-6; text 12 x
    768; embed 768), or a narrower copy with ``kw`` changed."""
    base = dict(embed_dim=768, vision_layers=24, vision_width=1024, vision_patch_size=14,
                transformer_width=768, transformer_heads=12, transformer_layers=12)
    base.update(kw)
    return EvaCLIPConfig(**base)


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


# The JAX package's table: OpenAI's backbones and the miniature one.
BACKBONE_CONFIGS = {
    "ViT-B/16": CLIPConfig(),
    "ViT-B/32": CLIPConfig(vision_patch_size=32),
    "RN50": CLIPConfig(
        embed_dim=1024, vision_layers=(3, 4, 6, 3), vision_width=64,
        vision_patch_size=0,
    ),
    "RN101": CLIPConfig(
        embed_dim=512, vision_layers=(3, 4, 23, 3), vision_width=64,
        vision_patch_size=0,
    ),
    # the EfficientNet-style scaled ResNets
    "RN50x4": CLIPConfig(
        embed_dim=640, image_resolution=288,
        vision_layers=(4, 6, 10, 6), vision_width=80, vision_patch_size=0,
        transformer_width=640, transformer_heads=10,
    ),
    "RN50x16": CLIPConfig(
        embed_dim=768, image_resolution=384,
        vision_layers=(6, 8, 18, 8), vision_width=96, vision_patch_size=0,
        transformer_width=768, transformer_heads=12,
    ),
    "Tiny": tiny_test_config(),
    "ViT-L/14": CLIPConfig(
        embed_dim=768,
        vision_layers=24,
        vision_width=1024,
        vision_patch_size=14,
        transformer_width=768,
        transformer_heads=12,
        transformer_layers=12,
    ),
    "EVA02-CLIP-L/14": eva02_config(),
}


# -- dtype policy ------------------------------------------------------------

COMPUTE_DTYPE = torch.bfloat16

_NORM_NAMES = ("ln_1", "ln_2", "ln_pre", "ln_post", "ln_final", "ln_inner", "ln_ffn")


def _is_norm_name(name: str) -> bool:
    """A LayerNorm leaf, or a ResNet BatchNorm one (a path segment starting
    with ``bn``: ``bn1``-``bn3``, ``downsample.bn``)."""
    if any(n in name for n in _NORM_NAMES):
        return True
    return any(seg.startswith("bn") for seg in name.split("."))


def apply_dtype_policy(params, compute_dtype=COMPUTE_DTYPE):
    """Matmul and conv weights to ``compute_dtype``; LayerNorm and
    BatchNorm params and the logit scale stay fp32."""

    def cast(name, leaf):
        if _is_norm_name(name) or "logit_scale" in name:
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


def interleave_gate(w1: torch.Tensor, w2: torch.Tensor, padded: int) -> torch.Tensor:
    """SwiGLU's ``w1``, ``w2`` (``(..., H)``, input-major or biases) as one
    ``(..., 2 * padded)`` tensor whose columns ``2 j, 2 j + 1`` are ``w1[...,
    j]``, ``w2[..., j]``, zero past ``H``: the gate epilogue's layout."""
    H = w1.shape[-1]
    out = w1.new_zeros(*w1.shape[:-1], padded, 2)
    out[..., :H, 0] = w1
    out[..., :H, 1] = w2
    return out.reshape(*w1.shape[:-1], 2 * padded)


def split_gate(w12: torch.Tensor, H: int) -> tuple:
    """The inverse of :func:`interleave_gate`: ``(w1, w2)`` of width ``H``."""
    pairs = w12.reshape(*w12.shape[:-1], -1, 2)
    return pairs[..., :H, 0], pairs[..., :H, 1]


def pad_last(t: torch.Tensor, padded: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``padded``."""
    return torch.nn.functional.pad(t, (0, padded - t.shape[-1]))


def _ln(width: int, padded: int = None) -> dict:
    return {"scale": pad_last(torch.ones(width), padded or width),
            "bias": torch.zeros(padded or width)}


def _init_eva_block(gen, width: int, hidden: int, padded: int, layer_id: int) -> dict:
    """EVA's initialisation (``eva_vit_model.py``: linear weights ~ N(0, 0.02),
    biases 0, the out-projection and ``w3`` rescaled by ``1 / sqrt(2 *
    layer_id)``), in the port's layout: q, k, v side by side, ``w1``/``w2``
    interleaved and the hidden padded (:func:`interleave_gate`)."""
    rescale = (2.0 * layer_id) ** -0.5
    return {
        "ln_1": _ln(width),
        "attn": {
            "w_qkv": _normal(gen, (width, 3 * width), 0.02),
            "q_bias": torch.zeros(width),
            "v_bias": torch.zeros(width),
            "ln_inner": _ln(width),
            "w_out": _normal(gen, (width, width), 0.02 * rescale),
            "b_out": torch.zeros(width),
        },
        "ln_2": _ln(width),
        "mlp": {
            "w12": interleave_gate(_normal(gen, (width, hidden), 0.02),
                                   _normal(gen, (width, hidden), 0.02), padded),
            "b12": torch.zeros(2 * padded),
            "ln_ffn": _ln(hidden, padded),
            "w3": pad_last(_normal(gen, (hidden, width), 0.02 * rescale).T, padded).T.contiguous(),
            "b3": torch.zeros(width),
        },
    }


def _init_eva_visual(cfg: CLIPConfig, gen) -> dict:
    w = cfg.vision_width
    patch_dim = cfg.vision_patch_size ** 2 * 3
    return {
        "conv1": {"w": _normal(gen, (patch_dim, w), 0.02), "b": torch.zeros(w)},
        "class_embedding": _normal(gen, (w,), 0.02),
        "positional_embedding": _normal(gen, (cfg.num_patches + 1, w), 0.02),
        "blocks": [_init_eva_block(gen, w, cfg.vision_mlp_width, cfg.vision_mlp_padded, i + 1)
                   for i in range(cfg.vision_layers)],
        "ln_post": _ln(w),
        "proj": _normal(gen, (w, cfg.embed_dim), 0.02),
        "proj_bias": torch.zeros(cfg.embed_dim),
    }


def init_clip_params(cfg: CLIPConfig, generator: torch.Generator = None,
                     dtype_policy: bool = True) -> dict:
    """Random CLIP-shaped parameters on the CPU, ViT or ModifiedResNet
    (the numbers follow ``CLIP.initialize_parameters``; a
    ``torch.Generator`` does not give ``jax.random``'s numbers, so tests
    carry weights across with :func:`load_jax_params`)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    if is_eva(cfg):
        visual = _init_eva_visual(cfg, gen)
    elif cfg.is_vit:
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
    else:
        visual = init_resnet_params(cfg.resnet_config(), gen)
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


# -- OpenAI CLIP state dicts --------------------------------------------------


def infer_config_from_state_dict(sd) -> CLIPConfig:
    """The architecture of an OpenAI CLIP state dict, ViT or ModifiedResNet,
    from its shapes (``clip.build_model``), or of an EVA-CLIP one
    (:func:`infer_eva_config`)."""
    if "visual.patch_embed.proj.weight" in sd:
        return infer_eva_config(sd)
    if "visual.proj" in sd:
        vision_width = sd["visual.conv1.weight"].shape[0]
        vision_layers = len(
            [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
        vision_patch_size = sd["visual.conv1.weight"].shape[-1]
        grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
        image_resolution = vision_patch_size * grid
    else:
        vision_layers = tuple(
            len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}")})
            for b in (1, 2, 3, 4))
        vision_width = sd["visual.layer1.0.conv1.weight"].shape[0]
        out_width = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
        vision_patch_size = 0
        image_resolution = out_width * 32
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=image_resolution,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=transformer_width,
        transformer_heads=transformer_width // 64,
        transformer_layers=len(
            {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")}),
    )


def infer_eva_config(sd) -> EvaCLIPConfig:
    """The architecture of an EVA-CLIP state dict (``EVA02_CLIP_L_psz14_s4B.pt``'s
    keys: ``visual.patch_embed.proj``, ``visual.blocks.{i}.attn.q_proj`` ...,
    ``text.transformer.resblocks.{i}`` ...) from its shapes; the text tower
    is OpenCLIP's with exact GELU."""
    patch = sd["visual.patch_embed.proj.weight"]
    width, P = patch.shape[0], patch.shape[-1]
    grid = round((sd["visual.pos_embed"].shape[-2] - 1) ** 0.5)
    layers = len({k.split(".")[2] for k in sd if k.startswith("visual.blocks.")})
    text_width = sd["text.ln_final.weight"].shape[0]
    return EvaCLIPConfig(
        embed_dim=sd["text.text_projection"].shape[1],
        image_resolution=P * grid,
        vision_layers=layers,
        vision_width=width,
        vision_patch_size=P,
        context_length=sd["text.positional_embedding"].shape[0],
        vocab_size=sd["text.token_embedding.weight"].shape[0],
        transformer_width=text_width,
        transformer_heads=text_width // 64,
        transformer_layers=len({k.split(".")[3] for k in sd
                                if k.startswith("text.transformer.resblocks.")}),
        vision_mlp_width=sd["visual.blocks.0.mlp.w1.weight"].shape[0],
    )


def _f32(t) -> torch.Tensor:
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.asarray(t, dtype=np.float32))
    return t.detach().cpu().float()


def _convert_block(sd, prefix: str) -> dict:
    def get(name):
        return _f32(sd[f"{prefix}.{name}"])

    return {
        "ln_1": {"scale": get("ln_1.weight"), "bias": get("ln_1.bias")},
        "attn": {
            "w_qkv": get("attn.in_proj_weight").T.contiguous(),
            "b_qkv": get("attn.in_proj_bias"),
            "w_out": get("attn.out_proj.weight").T.contiguous(),
            "b_out": get("attn.out_proj.bias"),
        },
        "ln_2": {"scale": get("ln_2.weight"), "bias": get("ln_2.bias")},
        "mlp": {
            "w_fc": get("mlp.c_fc.weight").T.contiguous(),
            "b_fc": get("mlp.c_fc.bias"),
            "w_proj": get("mlp.c_proj.weight").T.contiguous(),
            "b_proj": get("mlp.c_proj.bias"),
        },
    }


def convert_torch_state_dict(sd, cfg: CLIPConfig = None, dtype_policy: bool = True) -> dict:
    """An OpenAI CLIP state dict as the port's parameter tree, on the CPU:
    every tensor read as fp32, linear weights transposed to input-major;
    for a ViT the patchify conv ``(O, 3, P, P)`` reshaped to the ``(P * P *
    3, O)`` matmul kernel in ``(ky, kx, channel)`` order, for a
    ModifiedResNet :func:`~federated_multi_modal_tpu_torch.models.resnet.convert_torch_resnet`;
    then the dtype policy."""
    if cfg is None:
        cfg = infer_config_from_state_dict(sd)
    if is_eva(cfg):
        return convert_eva_state_dict(sd, cfg, dtype_policy)
    if cfg.is_vit:
        conv_w = _f32(sd["visual.conv1.weight"])  # (O, I, kH, kW)
        conv_w = conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0]).contiguous()
        visual = {
            "conv1": {"w": conv_w},
            "class_embedding": _f32(sd["visual.class_embedding"]),
            "positional_embedding": _f32(sd["visual.positional_embedding"]),
            "ln_pre": {"scale": _f32(sd["visual.ln_pre.weight"]),
                       "bias": _f32(sd["visual.ln_pre.bias"])},
            "blocks": [_convert_block(sd, f"visual.transformer.resblocks.{i}")
                       for i in range(cfg.vision_layers)],
            "ln_post": {"scale": _f32(sd["visual.ln_post.weight"]),
                        "bias": _f32(sd["visual.ln_post.bias"])},
            "proj": _f32(sd["visual.proj"]),
        }
    else:
        visual = convert_torch_resnet(sd, cfg.resnet_config())
    text = {
        "token_embedding": _f32(sd["token_embedding.weight"]),
        "positional_embedding": _f32(sd["positional_embedding"]),
        "blocks": [_convert_block(sd, f"transformer.resblocks.{i}")
                   for i in range(cfg.transformer_layers)],
        "ln_final": {"scale": _f32(sd["ln_final.weight"]), "bias": _f32(sd["ln_final.bias"])},
        "text_projection": _f32(sd["text_projection"]),
    }
    params = {"visual": visual, "text": text,
              "logit_scale": _f32(sd["logit_scale"]).reshape(())}
    if dtype_policy:
        params = apply_dtype_policy(params)
    return params


def _convert_eva_block(sd, prefix: str, padded: int) -> dict:
    def get(name):
        return _f32(sd[f"{prefix}.{name}"])

    def ln(name, pad=None):
        return {"scale": pad_last(get(name + ".weight"), pad or get(name + ".weight").shape[0]),
                "bias": pad_last(get(name + ".bias"), pad or get(name + ".bias").shape[0])}

    return {
        "ln_1": ln("norm1"),
        "attn": {
            "w_qkv": torch.cat([get(f"attn.{n}_proj.weight") for n in "qkv"]).T.contiguous(),
            "q_bias": get("attn.q_bias"),
            "v_bias": get("attn.v_bias"),
            "ln_inner": ln("attn.inner_attn_ln"),
            "w_out": get("attn.proj.weight").T.contiguous(),
            "b_out": get("attn.proj.bias"),
        },
        "ln_2": ln("norm2"),
        "mlp": {
            "w12": interleave_gate(get("mlp.w1.weight").T, get("mlp.w2.weight").T, padded),
            "b12": interleave_gate(get("mlp.w1.bias"), get("mlp.w2.bias"), padded),
            "ln_ffn": ln("mlp.ffn_ln", padded),
            "w3": pad_last(get("mlp.w3.weight"), padded).T.contiguous(),
            "b3": get("mlp.w3.bias"),
        },
    }


def convert_eva_state_dict(sd, cfg: CLIPConfig = None, dtype_policy: bool = True) -> dict:
    """An EVA-CLIP state dict (:func:`infer_eva_config`'s keys) as the port's
    parameter tree, on the CPU: q, k and v stacked into ``w_qkv``, ``w1`` and
    ``w2`` interleaved into ``w12`` and the hidden zero-padded
    (:func:`interleave_gate`), EVA's final ``norm`` as ``ln_post`` and its
    ``head`` as ``proj`` and ``proj_bias``; the ``rope.freqs_*`` buffers
    ignored (the port computes the table); then the dtype policy."""
    if cfg is None:
        cfg = infer_eva_config(sd)
    patch = _f32(sd["visual.patch_embed.proj.weight"])
    visual = {
        "conv1": {"w": patch.permute(2, 3, 1, 0).reshape(-1, patch.shape[0]).contiguous(),
                  "b": _f32(sd["visual.patch_embed.proj.bias"])},
        "class_embedding": _f32(sd["visual.cls_token"]).reshape(-1),
        "positional_embedding": _f32(sd["visual.pos_embed"]).reshape(cfg.num_patches + 1, -1),
        "blocks": [_convert_eva_block(sd, f"visual.blocks.{i}", cfg.vision_mlp_padded)
                   for i in range(cfg.vision_layers)],
        "ln_post": {"scale": _f32(sd["visual.norm.weight"]), "bias": _f32(sd["visual.norm.bias"])},
        "proj": _f32(sd["visual.head.weight"]).T.contiguous(),
        "proj_bias": _f32(sd["visual.head.bias"]),
    }
    text_sd = {k[len("text."):]: v for k, v in sd.items() if k.startswith("text.")}
    text = {
        "token_embedding": _f32(text_sd["token_embedding.weight"]),
        "positional_embedding": _f32(text_sd["positional_embedding"]),
        "blocks": [_convert_block(text_sd, f"transformer.resblocks.{i}")
                   for i in range(cfg.transformer_layers)],
        "ln_final": {"scale": _f32(text_sd["ln_final.weight"]),
                     "bias": _f32(text_sd["ln_final.bias"])},
        "text_projection": _f32(text_sd["text_projection"]),
    }
    params = {"visual": visual, "text": text,
              "logit_scale": _f32(sd["logit_scale"]).reshape(())}
    if dtype_policy:
        params = apply_dtype_policy(params)
    return params


def export_eva_state_dict(params, cfg: CLIPConfig, dtype=torch.float32) -> dict:
    """The inverse of :func:`convert_eva_state_dict`: EVA-CLIP's keys, the
    padding dropped, every tensor in ``dtype`` (contiguous, on the CPU)."""
    v, t = params["visual"], params["text"]
    H, P, D = cfg.vision_mlp_width, cfg.vision_patch_size, cfg.vision_width
    sd = {
        "visual.patch_embed.proj.weight": v["conv1"]["w"].reshape(P, P, 3, -1).permute(3, 2, 0, 1),
        "visual.patch_embed.proj.bias": v["conv1"]["b"],
        "visual.cls_token": v["class_embedding"].reshape(1, 1, -1),
        "visual.pos_embed": v["positional_embedding"][None],
        "visual.norm.weight": v["ln_post"]["scale"],
        "visual.norm.bias": v["ln_post"]["bias"],
        "visual.head.weight": v["proj"].T,
        "visual.head.bias": v["proj_bias"],
    }
    for i, b in enumerate(v["blocks"]):
        pre = f"visual.blocks.{i}."
        a, m = b["attn"], b["mlp"]
        w1, w2 = split_gate(m["w12"], H)
        b1, b2 = split_gate(m["b12"], H)
        sd.update({
            pre + "norm1.weight": b["ln_1"]["scale"], pre + "norm1.bias": b["ln_1"]["bias"],
            pre + "attn.q_proj.weight": a["w_qkv"][:, :D].T,
            pre + "attn.k_proj.weight": a["w_qkv"][:, D:2 * D].T,
            pre + "attn.v_proj.weight": a["w_qkv"][:, 2 * D:].T,
            pre + "attn.q_bias": a["q_bias"], pre + "attn.v_bias": a["v_bias"],
            pre + "attn.inner_attn_ln.weight": a["ln_inner"]["scale"],
            pre + "attn.inner_attn_ln.bias": a["ln_inner"]["bias"],
            pre + "attn.proj.weight": a["w_out"].T, pre + "attn.proj.bias": a["b_out"],
            pre + "norm2.weight": b["ln_2"]["scale"], pre + "norm2.bias": b["ln_2"]["bias"],
            pre + "mlp.w1.weight": w1.T, pre + "mlp.w1.bias": b1,
            pre + "mlp.w2.weight": w2.T, pre + "mlp.w2.bias": b2,
            pre + "mlp.ffn_ln.weight": m["ln_ffn"]["scale"][:H],
            pre + "mlp.ffn_ln.bias": m["ln_ffn"]["bias"][:H],
            pre + "mlp.w3.weight": m["w3"][:H].T, pre + "mlp.w3.bias": m["b3"],
        })
    sd.update({
        "text.token_embedding.weight": t["token_embedding"],
        "text.positional_embedding": t["positional_embedding"],
        "text.ln_final.weight": t["ln_final"]["scale"],
        "text.ln_final.bias": t["ln_final"]["bias"],
        "text.text_projection": t["text_projection"],
        "logit_scale": params["logit_scale"],
    })
    for i, block in enumerate(t["blocks"]):
        sd.update({"text." + k: x for k, x in
                   _export_block(block, f"transformer.resblocks.{i}").items()})
    return {k: x.detach().cpu().to(dtype).contiguous() for k, x in sd.items()}


def _export_block(block: dict, prefix: str) -> dict:
    return {
        f"{prefix}.ln_1.weight": block["ln_1"]["scale"],
        f"{prefix}.ln_1.bias": block["ln_1"]["bias"],
        f"{prefix}.attn.in_proj_weight": block["attn"]["w_qkv"].T,
        f"{prefix}.attn.in_proj_bias": block["attn"]["b_qkv"],
        f"{prefix}.attn.out_proj.weight": block["attn"]["w_out"].T,
        f"{prefix}.attn.out_proj.bias": block["attn"]["b_out"],
        f"{prefix}.ln_2.weight": block["ln_2"]["scale"],
        f"{prefix}.ln_2.bias": block["ln_2"]["bias"],
        f"{prefix}.mlp.c_fc.weight": block["mlp"]["w_fc"].T,
        f"{prefix}.mlp.c_fc.bias": block["mlp"]["b_fc"],
        f"{prefix}.mlp.c_proj.weight": block["mlp"]["w_proj"].T,
        f"{prefix}.mlp.c_proj.bias": block["mlp"]["b_proj"],
    }


def export_openai_state_dict(params, cfg: CLIPConfig, dtype=torch.float16) -> dict:
    """The inverse of :func:`convert_torch_state_dict`: a parameter tree of
    the port, ViT or ModifiedResNet, as an OpenAI CLIP state dict (OpenAI's
    key layout, every tensor in ``dtype``, fp16 as OpenAI ships it;
    contiguous, on the CPU); EVA-CLIP's layout for an EVA backbone
    (:func:`export_eva_state_dict`)."""
    if is_eva(cfg):
        return export_eva_state_dict(params, cfg, dtype)
    v, t = params["visual"], params["text"]
    if cfg.is_vit:
        P = cfg.vision_patch_size
        sd = {
            "visual.conv1.weight": v["conv1"]["w"].reshape(P, P, 3, -1).permute(3, 2, 0, 1),
            "visual.class_embedding": v["class_embedding"],
            "visual.positional_embedding": v["positional_embedding"],
            "visual.ln_pre.weight": v["ln_pre"]["scale"],
            "visual.ln_pre.bias": v["ln_pre"]["bias"],
            "visual.ln_post.weight": v["ln_post"]["scale"],
            "visual.ln_post.bias": v["ln_post"]["bias"],
            "visual.proj": v["proj"],
        }
        for i, block in enumerate(v["blocks"]):
            sd.update(_export_block(block, f"visual.transformer.resblocks.{i}"))
    else:
        sd = export_torch_resnet(v)
    sd.update({
        "token_embedding.weight": t["token_embedding"],
        "positional_embedding": t["positional_embedding"],
        "ln_final.weight": t["ln_final"]["scale"],
        "ln_final.bias": t["ln_final"]["bias"],
        "text_projection": t["text_projection"],
        "logit_scale": params["logit_scale"],
    })
    for i, block in enumerate(t["blocks"]):
        sd.update(_export_block(block, f"transformer.resblocks.{i}"))
    return {k: x.detach().cpu().to(dtype).contiguous() for k, x in sd.items()}


def load_torch_state_dict(path: str):
    """A torch checkpoint (TorchScript archive, as OpenAI ships CLIP, or a
    plain state dict) as a flat name -> tensor dict, on the CPU."""
    try:
        return torch.jit.load(path, map_location="cpu").eval().state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return sd


def load_clip_backbone(cfg_model, generator: torch.Generator = None):
    """``(CLIPConfig, params)`` of the backbone, on the CPU: the OpenAI state
    dict at ``MODEL.BACKBONE.WEIGHTS_PATH`` when set, else a random init in
    CLIP's scheme for ``MODEL.BACKBONE.NAME`` (from ``generator``, seed 0
    when ``None``; not the JAX package's numbers: ``jax.random`` is another
    generator)."""
    name = cfg_model.BACKBONE.NAME
    path = getattr(cfg_model.BACKBONE, "WEIGHTS_PATH", "")
    if path:
        sd = load_torch_state_dict(path)
        arch = infer_config_from_state_dict(sd)
        return arch, convert_torch_state_dict(sd, arch)
    if name not in BACKBONE_CONFIGS:
        raise KeyError(
            f"Unknown backbone {name!r}; known: {sorted(BACKBONE_CONFIGS)} "
            "(or set MODEL.BACKBONE.WEIGHTS_PATH)")
    arch = BACKBONE_CONFIGS[name]
    if name != "Tiny":
        print(f"[clip] No local weights for {name}; initializing randomly "
              "(set MODEL.BACKBONE.WEIGHTS_PATH to an OpenAI checkpoint for "
              "pretrained features).")
    return arch, init_clip_params(arch, generator)
