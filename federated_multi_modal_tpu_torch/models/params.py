"""CLIP parameter construction for the port (counterpart of
``federated_multi_modal_tpu/models/params.py``): architecture config, random
init in CLIP's scheme from a ``torch.Generator``, the dtype policy, the
weight bridge from the JAX package's flat checkpoint format, and the loading
of an OpenAI CLIP (ViT) state dict (``load_clip_backbone``).

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


_RESNET_NOT_PORTED = ("ResNet backbones are not ported yet (models/resnet.py, "
                      "ROADMAP.md module item 6)")


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
        raise NotImplementedError(_RESNET_NOT_PORTED)
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


# -- OpenAI CLIP state dicts --------------------------------------------------


def infer_config_from_state_dict(sd) -> CLIPConfig:
    """The architecture of an OpenAI CLIP (ViT) state dict, from its shapes
    (``clip.build_model``). A ModifiedResNet state dict raises until
    ``models/resnet.py`` is ported."""
    if "visual.proj" not in sd:
        raise NotImplementedError(_RESNET_NOT_PORTED)
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len(
        [k for k in sd if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")])
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    transformer_width = sd["ln_final.weight"].shape[0]
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid,
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
    """An OpenAI CLIP (ViT) state dict as the port's parameter tree, on the
    CPU: every tensor read as fp32, linear weights transposed to input-major,
    the patchify conv ``(O, 3, P, P)`` reshaped to the ``(P * P * 3, O)``
    matmul kernel in ``(ky, kx, channel)`` order; then the dtype policy."""
    if cfg is None:
        cfg = infer_config_from_state_dict(sd)
    if not cfg.is_vit:
        raise NotImplementedError(_RESNET_NOT_PORTED)
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
    """The inverse of :func:`convert_torch_state_dict`: a ViT parameter tree
    of the port as an OpenAI CLIP state dict (OpenAI's key layout, every
    tensor in ``dtype``, fp16 as OpenAI ships it; contiguous, on the CPU)."""
    if not cfg.is_vit:
        raise NotImplementedError(_RESNET_NOT_PORTED)
    v, t = params["visual"], params["text"]
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
        "token_embedding.weight": t["token_embedding"],
        "positional_embedding": t["positional_embedding"],
        "ln_final.weight": t["ln_final"]["scale"],
        "ln_final.bias": t["ln_final"]["bias"],
        "text_projection": t["text_projection"],
        "logit_scale": params["logit_scale"],
    }
    for i, block in enumerate(v["blocks"]):
        sd.update(_export_block(block, f"visual.transformer.resblocks.{i}"))
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
        if name in ("RN50", "RN101", "RN50x4", "RN50x16"):
            raise NotImplementedError(_RESNET_NOT_PORTED)
        raise KeyError(
            f"Unknown backbone {name!r}; known: {sorted(BACKBONE_CONFIGS)} "
            "(or set MODEL.BACKBONE.WEIGHTS_PATH)")
    arch = BACKBONE_CONFIGS[name]
    if name != "Tiny":
        print(f"[clip] No local weights for {name}; initializing randomly "
              "(set MODEL.BACKBONE.WEIGHTS_PATH to an OpenAI checkpoint for "
              "pretrained features).")
    return arch, init_clip_params(arch, generator)
