"""ModifiedResNet image tower, CLIP's RN50, RN101, RN50x4 and RN50x16 (port
of ``federated_multi_modal_tpu/models/resnet.py``).

A 3-conv stem with an average pool, anti-aliased bottlenecks (every conv
has stride 1; a strided block average-pools after ``conv2`` and before the
downsample conv) and the QKV attention pool over the spatial tokens and
their mean. BatchNorm runs on frozen statistics as an affine, as in the
JAX package: the trainers never train this tower.

The parameter tree keeps the JAX tree's layout and names (``stem.conv1.w``
HWIO, ``layers.<stage>.<block>.downsample.conv.w``, ``attnpool.q_proj.w``
input-major), so checkpoints and ``load_jax_params`` carry it name for
name. Activations are NHWC, as the JAX package's; each convolution hands
``F.conv2d`` the NCHW view of that memory (channels-last, which cuDNN takes
as it is) and an OIHW channels-last copy of the HWIO kernel.

The rounding points are JAX's: the images cast to the stem weight's dtype;
each conv in that dtype; BN's affine computed in fp32 and its result cast
back; the attention pool's mean summed in fp32, its scores fp32 products
times ``1/sqrt(head_dim)``, its softmax cast to the activations' dtype, the
features fp32.

Derived weights: a convolution's OIHW kernel and a BatchNorm's fp32
``(scale, bias)`` are built once per source tensor and kept, weakly keyed
by that tensor, while every source is the very tensor they were built
from (held by weak reference), at the same version, and the wanted dtype
is unchanged (:func:`_derived`); a source that requires a gradient under
autograd is derived afresh on every call, so its gradient flows.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from federated_multi_modal_tpu_torch.ops.primitives import linear


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    output_dim: int = 1024
    width: int = 64
    input_resolution: int = 224

    @property
    def heads(self) -> int:
        return self.width * 32 // 64

    @property
    def embed_dim(self) -> int:
        return self.width * 32


# -- derived weights ------------------------------------------------------------

_DERIVED = WeakIdKeyDictionary()


def _derived(key: torch.Tensor, sources, tag, build):
    """``build()`` kept for ``key`` while ``sources`` are the same tensors
    (held by weak reference) at the same versions and ``tag`` is unchanged;
    rebuilt (and not kept) when a source requires a gradient under
    autograd."""
    if torch.is_grad_enabled() and any(s.requires_grad for s in sources):
        return build()
    hit = _DERIVED.get(key)
    if (hit is not None and hit[0] == tag and len(hit[1]) == len(sources)
            and all(ref() is s and version == s._version
                    for (ref, version), s in zip(hit[1], sources))):
        return hit[2]
    with torch.no_grad():
        value = build()
    _DERIVED[key] = (tag, tuple((weakref.ref(s), s._version) for s in sources), value)
    return value


def conv_weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """The HWIO kernel ``w`` as an OIHW channels-last tensor of ``dtype``."""
    return _derived(w, (w,), dtype, lambda: w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last))


def bn_affine(p) -> tuple:
    """Frozen BatchNorm's fp32 ``(scale, bias)``: ``scale / sqrt(var +
    1e-5)`` and ``bias - mean * scale``."""
    def build():
        scale = (p["scale"].float() / torch.sqrt(p["var"].float() + 1e-5))
        return scale, p["bias"].float() - p["mean"].float() * scale

    return _derived(p["scale"], (p["scale"], p["bias"], p["mean"], p["var"]), None, build)


# -- the tower ------------------------------------------------------------------


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = None) -> torch.Tensor:
    """NHWC conv with an HWIO kernel in ``x``'s dtype; ``padding=None`` is
    lax's ``"SAME"`` at stride 1 (``k // 2``)."""
    if padding is None:
        padding = w.shape[0] // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), conv_weight(w, x.dtype), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def bn(x: torch.Tensor, p, relu: bool = False) -> torch.Tensor:
    """Frozen-statistics BatchNorm as an fp32 affine, cast back to ``x``'s
    dtype (``relu`` applied before the cast: the same values)."""
    scale, bias = bn_affine(p)
    y = torch.addcmul(bias, x, scale)
    if relu:
        y = y.relu_()
    return y.to(x.dtype)


def avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """NHWC average over non-overlapping ``k x k`` windows (VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def bottleneck(x: torch.Tensor, p, stride: int) -> torch.Tensor:
    """Anti-aliased bottleneck: every conv stride 1, the spatial reduction
    an average pool after ``conv2`` (and before the downsample conv)."""
    out = bn(conv2d(x, p["conv1"]["w"]), p["bn1"], relu=True)
    out = bn(conv2d(out, p["conv2"]["w"]), p["bn2"], relu=True)
    if stride > 1:
        out = avg_pool(out, stride)
    out = bn(conv2d(out, p["conv3"]["w"]), p["bn3"])

    identity = x
    if "downsample" in p:
        if stride > 1:
            identity = avg_pool(identity, stride)
        identity = bn(conv2d(identity, p["downsample"]["conv"]["w"]), p["downsample"]["bn"])
    return torch.relu(out + identity)


def mean_token(tokens: torch.Tensor) -> torch.Tensor:
    """``(B, T, C)`` -> ``(B, 1, C)``: the mean over the tokens, summed in
    fp32, in the tokens' dtype."""
    return tokens.float().mean(dim=1, keepdim=True).to(tokens.dtype)


def attention_pool2d(x: torch.Tensor, p, n_head: int) -> torch.Tensor:
    """QKV attention pooling: the mean token (in front of the spatial
    tokens, then the positional embedding added) queries every token.
    ``x``: ``(B, H, W, C)`` -> ``(B, output_dim)`` in ``x``'s dtype."""
    B, H, W, C = x.shape
    dtype = x.dtype
    tokens = x.reshape(B, H * W, C)
    tokens = torch.cat([mean_token(tokens), tokens], dim=1)  # (B, HW + 1, C)
    tokens = tokens + p["positional_embedding"].to(dtype)[None]

    def proj(t, name):
        return linear(t, p[name]["w"], p[name]["b"])

    head_dim = C // n_head

    def heads(t):
        return t.reshape(B, t.shape[1], n_head, head_dim).transpose(1, 2)

    q = heads(proj(tokens[:, :1], "q_proj"))  # the query is the mean token only
    k = heads(proj(tokens, "k_proj"))
    v = heads(proj(tokens, "v_proj"))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(head_dim))
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.matmul(probs, v)                      # (B, n_head, 1, head_dim)
    out = out.transpose(1, 2).reshape(B, C)
    return proj(out, "c_proj")


def encode_image_resnet(params, cfg: ResNetConfig, images: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, 3)`` images -> ``(B, output_dim)`` fp32 features."""
    stem = params["stem"]
    x = images.to(stem["conv1"]["w"].dtype)
    # explicit (1, 1) padding at stride 2, as torch's Conv2d(padding=1)
    x = bn(conv2d(x, stem["conv1"]["w"], stride=2, padding=1), stem["bn1"], relu=True)
    x = bn(conv2d(x, stem["conv2"]["w"]), stem["bn2"], relu=True)
    x = bn(conv2d(x, stem["conv3"]["w"]), stem["bn3"], relu=True)
    x = avg_pool(x, 2)

    for li, blocks in enumerate(params["layers"]):
        stride = 1 if li == 0 else 2
        for bi, blk in enumerate(blocks):
            x = bottleneck(x, blk, stride if bi == 0 else 1)

    return attention_pool2d(x, params["attnpool"], cfg.heads).float()


# -- init and the OpenAI state dict ----------------------------------------------


def _conv_init(gen, kh, kw, cin, cout):
    return torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c),
            "mean": torch.zeros(c), "var": torch.ones(c)}


def init_resnet_params(cfg: ResNetConfig, generator: torch.Generator = None) -> dict:
    """Random tower parameters on the CPU, fp32 (He-normal convs, unit BN,
    attention pool at ``embed_dim ** -0.5``), drawn from ``generator`` (seed
    0 when ``None``) in the JAX package's order."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    w = cfg.width
    stem = {
        "conv1": {"w": _conv_init(gen, 3, 3, 3, w // 2)}, "bn1": _bn_init(w // 2),
        "conv2": {"w": _conv_init(gen, 3, 3, w // 2, w // 2)}, "bn2": _bn_init(w // 2),
        "conv3": {"w": _conv_init(gen, 3, 3, w // 2, w)}, "bn3": _bn_init(w),
    }
    layers = []
    inplanes = w
    for li, n_blocks in enumerate(cfg.layers):
        planes = w * 2 ** li
        blocks = []
        for bi in range(n_blocks):
            cin = inplanes if bi == 0 else planes * 4
            blk = {
                "conv1": {"w": _conv_init(gen, 1, 1, cin, planes)}, "bn1": _bn_init(planes),
                "conv2": {"w": _conv_init(gen, 3, 3, planes, planes)}, "bn2": _bn_init(planes),
                "conv3": {"w": _conv_init(gen, 1, 1, planes, planes * 4)},
                "bn3": _bn_init(planes * 4),
            }
            # the first block of a strided stage, or of one that widens
            if bi == 0 and (li > 0 or cin != planes * 4):
                blk["downsample"] = {"conv": {"w": _conv_init(gen, 1, 1, cin, planes * 4)},
                                     "bn": _bn_init(planes * 4)}
            blocks.append(blk)
        layers.append(blocks)
        inplanes = planes * 4

    C = cfg.embed_dim
    std = C ** -0.5
    spacial = cfg.input_resolution // 32

    def normal(*shape):
        return torch.randn(shape, generator=gen) * std

    attnpool = {"positional_embedding": normal(spacial ** 2 + 1, C)}
    for name in ("q_proj", "k_proj", "v_proj"):
        attnpool[name] = {"w": normal(C, C), "b": torch.zeros(C)}
    attnpool["c_proj"] = {"w": normal(C, cfg.output_dim), "b": torch.zeros(cfg.output_dim)}
    return {"stem": stem, "layers": layers, "attnpool": attnpool}


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().float()


_ATTNPOOL_PROJ = ("q_proj", "k_proj", "v_proj", "c_proj")


def convert_torch_resnet(sd, cfg: ResNetConfig) -> dict:
    """The ``visual.*`` half of an OpenAI ModifiedResNet CLIP state dict as
    the tower's tree, fp32 on the CPU: conv kernels OIHW -> HWIO,
    ``downsample.0/.1`` as ``downsample.conv/.bn``, the attention pool's
    linear weights transposed to input-major."""
    def conv(name):
        return {"w": _f32(sd[name]).permute(2, 3, 1, 0).contiguous()}

    def norm(prefix):
        return {"scale": _f32(sd[f"{prefix}.weight"]), "bias": _f32(sd[f"{prefix}.bias"]),
                "mean": _f32(sd[f"{prefix}.running_mean"]),
                "var": _f32(sd[f"{prefix}.running_var"])}

    stem = {}
    for i in (1, 2, 3):
        stem[f"conv{i}"] = conv(f"visual.conv{i}.weight")
        stem[f"bn{i}"] = norm(f"visual.bn{i}")
    layers = []
    for li, n_blocks in enumerate(cfg.layers):
        blocks = []
        for bi in range(n_blocks):
            pre = f"visual.layer{li + 1}.{bi}"
            blk = {}
            for i in (1, 2, 3):
                blk[f"conv{i}"] = conv(f"{pre}.conv{i}.weight")
                blk[f"bn{i}"] = norm(f"{pre}.bn{i}")
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {"conv": conv(f"{pre}.downsample.0.weight"),
                                     "bn": norm(f"{pre}.downsample.1")}
            blocks.append(blk)
        layers.append(blocks)
    attnpool = {"positional_embedding": _f32(sd["visual.attnpool.positional_embedding"])}
    for name in _ATTNPOOL_PROJ:
        attnpool[name] = {"w": _f32(sd[f"visual.attnpool.{name}.weight"]).T.contiguous(),
                          "b": _f32(sd[f"visual.attnpool.{name}.bias"])}
    return {"stem": stem, "layers": layers, "attnpool": attnpool}


def export_torch_resnet(visual) -> dict:
    """The inverse of :func:`convert_torch_resnet`: the tower's tree as the
    ``visual.*`` half of an OpenAI state dict (OpenAI's key layout, the
    tree's dtypes). A BatchNorm's ``num_batches_tracked`` is not kept by
    the tree and is not written."""
    sd = {}

    def conv(name, w):
        sd[name] = w.permute(3, 2, 0, 1)

    def norm(prefix, p):
        sd.update({f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
                   f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"]})

    for i in (1, 2, 3):
        conv(f"visual.conv{i}.weight", visual["stem"][f"conv{i}"]["w"])
        norm(f"visual.bn{i}", visual["stem"][f"bn{i}"])
    for li, blocks in enumerate(visual["layers"]):
        for bi, blk in enumerate(blocks):
            pre = f"visual.layer{li + 1}.{bi}"
            for i in (1, 2, 3):
                conv(f"{pre}.conv{i}.weight", blk[f"conv{i}"]["w"])
                norm(f"{pre}.bn{i}", blk[f"bn{i}"])
            if "downsample" in blk:
                conv(f"{pre}.downsample.0.weight", blk["downsample"]["conv"]["w"])
                norm(f"{pre}.downsample.1", blk["downsample"]["bn"])
    ap = visual["attnpool"]
    sd["visual.attnpool.positional_embedding"] = ap["positional_embedding"]
    for name in _ATTNPOOL_PROJ:
        sd[f"visual.attnpool.{name}.weight"] = ap[name]["w"].T
        sd[f"visual.attnpool.{name}.bias"] = ap[name]["b"]
    return sd
