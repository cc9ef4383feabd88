"""The port's ModifiedResNet backbones (``models/resnet.py``, the ResNet half
of ``models/params.py``, ``encode_image_auto``) and its ``clip_api.py``
against the JAX package's, on the CPU, on seeded numpy inputs.

Tolerances: in fp32 the port agrees with JAX to 1e-5 of the largest value
for a single function and to 5e-5 for the whole tower (the convolutions
sum in another order; the readings are ~1e-6, and 1.9e-5 over RN50's 16
blocks); under the bf16 policy the port's distance from the fp32 result of
the same weights is at most ``BF16_ERROR_RATIO`` times the JAX package's
(ROADMAP §3, "Not faults": XLA keeps fused elementwise chains in fp32,
PyTorch rounds after each op). The trainers run on ``TinyRN`` (``tests/test_resnet.py``'s
miniature ResNet CLIP), registered in both catalogs for each test.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.clip_api as jax_api
import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
import federated_multi_modal_tpu.trainers  # noqa: F401 - registers the trainers
import federated_multi_modal_tpu.trainers.zsclip as jax_zsclip
from federated_multi_modal_tpu.config import get_cfg_default
from federated_multi_modal_tpu.engine import build_trainer
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.models import resnet as jax_resnet
from federated_multi_modal_tpu_torch import clip_api as port_api
from federated_multi_modal_tpu_torch.config import get_cfg_default as port_cfg_default
from federated_multi_modal_tpu_torch.engine import build_trainer as port_build
from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path, unflatten
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.models import resnet as port_resnet
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.trainers import cocoop as port_cocoop
from federated_multi_modal_tpu_torch.trainers import zsclip as port_zsclip
from test_torch_cli import COOP_OPTS, _argv, _init_weights, run_jax, run_port

FP32_TOL = 1e-5
# the whole tower: 16 blocks of reordered fp32 sums (reads 7e-7 on TinyRN,
# 1.9e-5 on RN50's layout)
FP32_TOWER_TOL = 5e-5
BF16_ERROR_RATIO = 2.0
TINY_RN = dict(embed_dim=64, vision_layers=(1, 1, 1, 1), vision_width=16, vision_patch_size=0,
               image_resolution=64, transformer_width=128, transformer_heads=2,
               transformer_layers=2)
# RN50's block layout at a narrow width (heads of 64, as every catalog ResNet)
DEEP_RN = dict(TINY_RN, vision_layers=(3, 4, 6, 3), vision_width=8, embed_dim=32)
COOP_RN50_YAML = "configs/trainers/CoOp/rn50.yaml"
RN_INPUT = ["MODEL.BACKBONE.NAME", "TinyRN", "INPUT.SIZE", "(64, 64)",
            "INPUT.CANVAS_SIZE", "72"]


def _configs(fields):
    return jax_params.CLIPConfig(**fields), port_params.CLIPConfig(**fields)


@pytest.fixture
def tiny_rn(monkeypatch):
    """``TinyRN`` in both packages' backbone tables, for this test."""
    jax_arch, port_arch = _configs(TINY_RN)
    monkeypatch.setitem(jax_params.BACKBONE_CONFIGS, "TinyRN", jax_arch)
    monkeypatch.setitem(port_params.BACKBONE_CONFIGS, "TinyRN", port_arch)
    return port_arch


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dataroot")


def _rel_err(got, ref):
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if hasattr(got, "detach") else np.asarray(got, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _as_bf16_values(tree):
    """The tree with every float leaf rounded to bf16 and held in fp32."""
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16).astype(jnp.float32), tree)


def _torch_tree(np_tree, dtype=None):
    def conv(x):
        t = torch.from_numpy(np.asarray(x, np.float32).copy())
        return t if dtype is None else t.to(dtype)
    return jax.tree.map(conv, np_tree)


def _rand_bn(rng, c):
    return {"scale": rng.standard_normal(c).astype(np.float32) * 0.1 + 1.0,
            "bias": rng.standard_normal(c).astype(np.float32) * 0.1,
            "mean": rng.standard_normal(c).astype(np.float32) * 0.1,
            "var": np.abs(rng.standard_normal(c).astype(np.float32)) * 0.1 + 1.0}


def _rand_conv(rng, k, cin, cout):
    return {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32) * (2.0 / (k * k * cin)) ** 0.5}


# -- the tower's functions -------------------------------------------------------

BOTTLENECKS = [(16, 4, 1, False), (8, 4, 1, True), (8, 4, 2, True)]


@pytest.mark.parametrize("cin,planes,stride,down", BOTTLENECKS,
                         ids=["stride1", "stride1-downsample", "stride2-downsample"])
def test_bottleneck_matches_jax(cin, planes, stride, down):
    """fp32, seeded BN statistics and affines: the three kinds of block
    (RN50's layer-1 block 0 is the downsample without a pool)."""
    rng = np.random.default_rng(3)
    p = {"conv1": _rand_conv(rng, 1, cin, planes), "bn1": _rand_bn(rng, planes),
         "conv2": _rand_conv(rng, 3, planes, planes), "bn2": _rand_bn(rng, planes),
         "conv3": _rand_conv(rng, 1, planes, planes * 4), "bn3": _rand_bn(rng, planes * 4)}
    if down:
        p["downsample"] = {"conv": _rand_conv(rng, 1, cin, planes * 4),
                           "bn": _rand_bn(rng, planes * 4)}
    x = rng.standard_normal((2, 10, 10, cin)).astype(np.float32)
    ref = jax_resnet.bottleneck(jnp.asarray(x), p, stride)
    got = port_resnet.bottleneck(torch.from_numpy(x), _torch_tree(p), stride)
    assert got.shape == ref.shape
    assert _rel_err(got, ref) < FP32_TOL


def _attnpool_params(rng, C, out, n_tokens):
    def lin(i, o):
        return {"w": rng.standard_normal((i, o)).astype(np.float32) * i ** -0.5,
                "b": rng.standard_normal(o).astype(np.float32) * 0.1}
    return {"positional_embedding": rng.standard_normal((n_tokens, C)).astype(np.float32) * 0.1,
            "q_proj": lin(C, C), "k_proj": lin(C, C), "v_proj": lin(C, C), "c_proj": lin(C, out)}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_pool2d_matches_jax(dtype):
    """The mean token in front, q from it only, fp32 scores and softmax:
    fp32 to 1e-5; bf16 no further from the fp32 result than twice JAX."""
    rng = np.random.default_rng(5)
    C, heads = 128, 2
    p = _attnpool_params(rng, C, 48, 3 * 3 + 1)
    x = rng.standard_normal((3, 3, 3, C)).astype(np.float32)
    if dtype == "fp32":
        ref = jax_resnet.attention_pool2d(jnp.asarray(x), p, heads)
        got = port_resnet.attention_pool2d(torch.from_numpy(x), _torch_tree(p), heads)
        assert _rel_err(got, ref) < FP32_TOL
        return
    p16, x16 = _as_bf16_values(p), jnp.asarray(x, jnp.bfloat16)
    exact = jax_resnet.attention_pool2d(x16.astype(jnp.float32), p16, heads)
    ref = jax_resnet.attention_pool2d(x16, jax.tree.map(lambda a: a.astype(jnp.bfloat16), p16),
                                      heads)
    got = port_resnet.attention_pool2d(torch.from_numpy(x).to(torch.bfloat16),
                                       _torch_tree(p16, torch.bfloat16), heads)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got, exact) <= BF16_ERROR_RATIO * _rel_err(ref, exact)


def _seeded_bn(tree, rng):
    """``tree`` with every BatchNorm's statistics and affine seeded, so that
    each BN is more than the identity."""
    if isinstance(tree, list):
        return [_seeded_bn(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    return {k: (jax.tree.map(jnp.asarray, _rand_bn(rng, v["scale"].shape[0]))
                if k.startswith("bn") else _seeded_bn(v, rng)) for k, v in tree.items()}


_jax_tower = jax.jit(jax_resnet.encode_image_resnet, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _tower_case(layout):
    fields = TINY_RN if layout == "tiny" else DEEP_RN
    jax_arch, port_arch = _configs(fields)
    # the JAX tree's layout (the port's init has the same names and shapes),
    # drawn by the port: JAX's eager init of a 16-block tower takes seconds
    tree = port_params.init_clip_params(port_arch, torch.Generator().manual_seed(1),
                                        dtype_policy=False)
    visual = _seeded_bn(jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree["visual"]),
                        np.random.default_rng(11))
    images = np.random.default_rng(2).standard_normal((3, 64, 64, 3)).astype(np.float32)
    return jax_arch, port_arch, visual, images


@pytest.mark.parametrize("layout", ["tiny", "rn50-layout"])
@pytest.mark.parametrize("dtype_policy", [False, True], ids=["fp32", "bf16"])
def test_encode_image_resnet_matches_jax(layout, dtype_policy):
    """The whole tower on ``load_jax_params`` of the JAX tree, seeded BNs:
    fp32 to 1e-5; under the bf16 policy the port no further from the fp32
    features of the same (bf16-valued) weights than twice the JAX package."""
    jax_arch, port_arch, visual, images = _tower_case(layout)
    if dtype_policy:
        visual = jax_params.apply_dtype_policy({"visual": visual})["visual"]
    ref = _jax_tower(visual, jax_arch.resnet_config(), jnp.asarray(images))
    tree = port_params.load_jax_params(flatten_params(visual), device="cpu")
    got = port_resnet.encode_image_resnet(tree, port_arch.resnet_config(),
                                          torch.from_numpy(images))
    assert got.dtype == torch.float32 and got.shape == (3, port_arch.embed_dim)
    if not dtype_policy:
        assert _rel_err(got, ref) < FP32_TOWER_TOL
        return
    exact = _jax_tower(jax.tree.map(lambda a: a.astype(jnp.float32), visual),
                       jax_arch.resnet_config(), jnp.asarray(images))
    assert _rel_err(got, exact) <= BF16_ERROR_RATIO * _rel_err(ref, exact)


def test_derived_bn_affine_follows_a_replaced_leaf():
    """The kept fp32 affine is rebuilt when a statistic is replaced by a
    fresh tensor (same scale, same version 0) or written in place."""
    rng = np.random.default_rng(13)
    p = _torch_tree(_rand_bn(rng, 8))
    x = torch.from_numpy(rng.standard_normal((2, 3, 3, 8)).astype(np.float32))
    first = port_resnet.bn(x, p)
    for _ in range(3):  # fresh tensors, so that a freed id may come round again
        p["var"] = p["var"] * 4.0
        p["bias"] = p["bias"] + 1.0
        scale = p["scale"] / torch.sqrt(p["var"] + 1e-5)
        want = x * scale + (p["bias"] - p["mean"] * scale)
        assert torch.allclose(port_resnet.bn(x, p), want, rtol=1e-6, atol=1e-6)
    p["mean"].add_(1.0)
    scale = p["scale"] / torch.sqrt(p["var"] + 1e-5)
    assert torch.allclose(port_resnet.bn(x, p), x * scale + (p["bias"] - p["mean"] * scale),
                          rtol=1e-6, atol=1e-6)
    assert not torch.allclose(first, port_resnet.bn(x, p))


# -- the parameter tree ------------------------------------------------------------


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4", "RN50x16"])
def test_catalog_matches_jax(name):
    jax_arch, port_arch = jax_params.BACKBONE_CONFIGS[name], port_params.BACKBONE_CONFIGS[name]
    for field in jax_params.CLIPConfig.__dataclass_fields__:
        assert getattr(port_arch, field) == getattr(jax_arch, field), field
    assert not port_arch.is_vit and port_arch.vision_heads == jax_arch.vision_heads
    assert (dataclasses.asdict(port_arch.resnet_config())
            == dataclasses.asdict(jax_arch.resnet_config()))
    assert port_arch.resnet_config().heads == jax_arch.resnet_config().heads


@functools.lru_cache(maxsize=None)
def _jax_tiny_rn_tree():
    """JAX's ``init_clip_params`` of TinyRN under the dtype policy, made once
    for the module (jitted: eager, it dispatches each leaf's ops alone)."""
    jax_arch, _ = _configs(TINY_RN)
    return jax.jit(jax_params.init_clip_params, static_argnums=0)(jax_arch, jax.random.PRNGKey(4))


def test_init_tree_matches_jax_names_shapes_and_dtypes():
    """TinyRN under the dtype policy: the same dotted names, shapes and
    dtypes as JAX's ``init_clip_params``; every BatchNorm leaf fp32."""
    _, port_arch = _configs(TINY_RN)
    ref = {k: np.asarray(v) for k, v in flatten_params(_jax_tiny_rn_tree()).items()}
    got = flatten(port_params.init_clip_params(port_arch, torch.Generator().manual_seed(0)))
    assert set(got) == set(ref)
    for k, v in got.items():
        assert tuple(v.shape) == ref[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == ref[k].dtype.name, k
    bn = [k for k in got if ".bn" in k]
    assert len(bn) == 4 * (3 + 4 * 3 + 4) and all(got[k].dtype == torch.float32 for k in bn)
    assert got["visual.stem.conv1.w"].dtype == torch.bfloat16


def test_load_jax_params_gives_the_same_features():
    """JAX's TinyRN tree as ``init_clip_params`` makes it (bf16 policy),
    carried into the port by its flat names: ``encode_image_auto`` as far
    from the fp32 features as the bf16 rule allows."""
    jax_arch, port_arch = _configs(TINY_RN)
    tree = _jax_tiny_rn_tree()
    images = np.random.default_rng(8).standard_normal((2, 64, 64, 3)).astype(np.float32)
    encode = jax.jit(jax_clip.encode_image_auto, static_argnums=1)
    ref = encode(tree["visual"], jax_arch, jnp.asarray(images))
    exact = encode(jax.tree.map(lambda a: a.astype(jnp.float32), tree["visual"]), jax_arch,
                   jnp.asarray(images))
    port_tree = port_params.load_jax_params(flatten_params(tree), device="cpu")
    got = port_clip.encode_image_auto(port_tree["visual"], port_arch, torch.from_numpy(images),
                                      inference=True)
    assert _rel_err(got, exact) <= BF16_ERROR_RATIO * _rel_err(ref, exact)


@functools.lru_cache(maxsize=None)
def _tiny_rn_state_dict():
    _, port_arch = _configs(TINY_RN)
    tree = port_params.init_clip_params(port_arch, torch.Generator().manual_seed(6),
                                        dtype_policy=False)
    return tree, port_params.export_openai_state_dict(tree, port_arch)


def _same_bits(port_tree, jax_tree):
    got, ref = flatten(port_tree), {k: np.asarray(v) for k, v in flatten_params(jax_tree).items()}
    assert set(got) == set(ref)
    for k, v in got.items():
        assert str(v.dtype).removeprefix("torch.") == ref[k].dtype.name, k
        np.testing.assert_array_equal(v.float().numpy(), ref[k].astype(np.float32), err_msg=k)


def test_state_dict_infer_convert_and_export_match_jax():
    """A TinyRN OpenAI state dict (fp16, OpenAI's keys): both packages infer
    the same architecture and convert it to the same tree bit for bit;
    export then convert is the identity."""
    tree, sd = _tiny_rn_state_dict()
    assert "visual.layer1.0.downsample.0.weight" in sd and "visual.attnpool.c_proj.bias" in sd
    assert all(v.dtype == torch.float16 for v in sd.values())
    port_arch = port_params.infer_config_from_state_dict(sd)
    jax_arch = jax_params.infer_config_from_state_dict(sd)
    assert port_arch == port_params.CLIPConfig(**TINY_RN)
    assert jax_arch == jax_params.CLIPConfig(**TINY_RN)
    _same_bits(port_params.convert_torch_state_dict(sd, port_arch),
               jax_params.convert_torch_state_dict(sd, jax_arch))
    sd32 = port_params.export_openai_state_dict(tree, port_arch, torch.float32)
    back = flatten(port_params.convert_torch_state_dict(sd32, port_arch, dtype_policy=False))
    for k, v in flatten(tree).items():
        assert torch.equal(back[k], v), k


# -- encode_image_auto ---------------------------------------------------------------


def test_encode_image_auto_remat_gives_the_same_features_and_input_gradient():
    _, port_arch = _configs(TINY_RN)
    tree = port_params.init_clip_params(port_arch, torch.Generator().manual_seed(2))
    images = torch.from_numpy(
        np.random.default_rng(9).standard_normal((2, 64, 64, 3)).astype(np.float32))
    out = {}
    for remat in (False, True):
        x = images.clone().requires_grad_(True)
        feats = port_clip.encode_image_auto(tree["visual"], port_arch, x, remat=remat,
                                            inference=True)
        (grad,) = torch.autograd.grad(feats.square().sum(), x)
        out[remat] = (feats.detach(), grad)
    assert torch.equal(out[False][0], out[True][0])
    assert float(out[False][1].abs().max()) > 0
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("prompt", ["shallow_prompts", "deep_prompts", "extra_tokens"])
def test_encode_image_auto_refuses_visual_prompts_on_a_resnet(prompt):
    _, port_arch = _configs(TINY_RN)
    tree = port_params.init_clip_params(port_arch)
    with pytest.raises(ValueError, match="Visual prompting requires a ViT backbone"):
        port_clip.encode_image_auto(tree["visual"], port_arch, torch.zeros(1, 64, 64, 3),
                                    **{prompt: torch.zeros(1, 2, 16)})


# -- clip_api -------------------------------------------------------------------------


def test_available_models_match_jax():
    assert port_api.available_models() == jax_api.available_models()
    assert port_api._MODELS == jax_api._MODELS


@pytest.mark.parametrize("backbone", ["Tiny", "TinyRN"])
def test_load_of_a_local_file_matches_jax(backbone, tmp_path):
    if backbone == "TinyRN":
        _, sd = _tiny_rn_state_dict()
    else:
        arch = port_params.BACKBONE_CONFIGS["Tiny"]
        sd = port_params.export_openai_state_dict(
            port_params.init_clip_params(arch, torch.Generator().manual_seed(3),
                                         dtype_policy=False), arch)
    path = tmp_path / f"{backbone}.pt"
    torch.save(sd, path)
    port_arch, port_tree = port_api.load(str(path), device="cpu")
    jax_arch, jax_tree = jax_api.load(str(path))
    assert {f: getattr(port_arch, f) for f in port_arch.__dataclass_fields__} == {
        f: getattr(jax_arch, f) for f in jax_arch.__dataclass_fields__}
    _same_bits(port_tree, jax_tree)


def test_load_falls_back_to_random_only_when_the_download_fails(tiny_rn, monkeypatch, tmp_path):
    """A known name whose download fails gives a random init, with a
    warning, or re-raises under ``allow_random=False``; a file that was
    obtained but does not convert raises; an unknown name raises
    ``RuntimeError``."""
    monkeypatch.setitem(port_api._MODELS, "TinyRN", "https://example.invalid/x/TinyRN.pt")

    def offline(url, root=None):
        raise OSError("no network")

    monkeypatch.setattr(port_api, "_download", offline)
    with pytest.warns(UserWarning, match="Could not obtain weights for TinyRN"):
        arch, tree = port_api.load("TinyRN", device="cpu")
    assert arch == tiny_rn
    ref = flatten(port_params.init_clip_params(tiny_rn))
    assert all(torch.equal(v, ref[k]) for k, v in flatten(tree).items())
    with pytest.raises(OSError, match="no network"):
        port_api.load("TinyRN", allow_random=False, device="cpu")

    broken = tmp_path / "TinyRN.pt"
    broken.write_bytes(b"not a checkpoint")
    monkeypatch.setattr(port_api, "_download", lambda url, root=None: str(broken))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(Exception) as err:
            port_api.load("TinyRN", device="cpu")
    assert not isinstance(err.value, UserWarning)

    with pytest.raises(RuntimeError, match="Model RN18 not found"):
        port_api.load("RN18", device="cpu")


# -- the trainers on TinyRN -------------------------------------------------------------


def _cfg(root, out_dir, trainer, overrides=None, defaults=get_cfg_default):
    cfg = defaults()
    cfg.DATASET.ROOT = str(root)
    cfg.DATASET.NAME = "Synthetic"
    cfg.MODEL.BACKBONE.NAME = "TinyRN"
    cfg.INPUT.SIZE = (64, 64)
    cfg.INPUT.CANVAS_SIZE = 72
    cfg.DATALOADER.TRAIN_X.BATCH_SIZE = 4
    cfg.DATALOADER.TEST.BATCH_SIZE = 8
    cfg.TRAINER.NAME = trainer
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SEED = 1
    cfg.VERBOSE = False
    for key, value in (overrides or {}).items():
        node = cfg
        *parents, last = key.split(".")
        for k in parents:
            node = node[k]
        node[last] = value
    return cfg


def _build_jax(cfg, monkeypatch):
    for module, name in ((jax_prim, "_ATTENTION_IMPL"), (jax_prim, "_VISION_ATTN_WGRAD_BLOCKS"),
                         (jax_clip, "_TEXT_PACK_DEFAULT")):
        monkeypatch.setattr(module, name, getattr(module, name))
    return build_trainer(cfg)


def _build_port(cfg, monkeypatch):
    for module, attr in ((port_prim, "_ATTENTION_IMPL"), (port_clip, "_TEXT_PACK_DEFAULT")):
        monkeypatch.setattr(module, attr, getattr(module, attr))
    return port_build(cfg, device="cpu")


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


def _port_fp32(tree):
    return tree_map_with_path(lambda _, t: t.float() if t.is_floating_point() else t, tree)


def _port_tree(jax_tree):
    return port_params.load_jax_params(flatten_params(jax_tree), device="cpu")


def test_coop_command_line_fp32_matches_jax(tiny_rn, tmp_path, data_root):
    """CoOp with ``rn50.yaml`` on TinyRN through both ``train.py``s, one
    epoch of four steps in fp32, the context from the JAX trainer: the
    epoch's mean loss within 1e-4 relative, the same accuracy."""
    _, sd = _tiny_rn_state_dict()
    weights = tmp_path / "tiny_rn.pt"
    torch.save(sd, weights)
    opts = COOP_OPTS + ["TRAINER.COOP.PREC", "fp32"] + RN_INPUT
    init = _init_weights(tmp_path, data_root, weights, "CoOp", COOP_RN50_YAML, opts)
    opts += ["MODEL.BACKBONE.WEIGHTS_PATH", str(weights), "MODEL.INIT_WEIGHTS", str(init)]
    ref = run_jax(_argv("CoOp", COOP_RN50_YAML, tmp_path / "jax", data_root, opts))
    port = run_port(_argv("CoOp", COOP_RN50_YAML, tmp_path / "port", data_root, opts))
    assert not port["trainer"].arch.is_vit
    assert len(port["losses"]) == len(ref["losses"]) == 1
    assert abs(port["losses"][0] - ref["losses"][0]) <= 1e-4 * abs(ref["losses"][0])
    assert [r["accuracy"] for r in port["tests"]] == [r["accuracy"] for r in ref["tests"]]


def test_cocoop_loss_gradients_and_logits_match_jax(tiny_rn, data_root, tmp_path, monkeypatch):
    """CoCoOp on TinyRN in fp32 (``vis_dim`` is the ResNet's ``embed_dim``):
    the loss, the gradients of the context and of both meta-net layers and
    the eval logits of a seeded batch, against the JAX trainer."""
    cfg = _cfg(data_root, tmp_path, "CoCoOp", {"TRAINER.COCOOP.N_CTX": 2,
                                              "TRAINER.COCOOP.PREC": "fp32"})
    trainer = _build_jax(cfg, monkeypatch)
    trainable, frozen = _fp32(trainer.trainable), _fp32(trainer.frozen)
    # the random tower's features are alike and the meta-net's four hidden
    # units start dead on all of them: a positive first bias opens them, so
    # that every leaf has a gradient
    meta = trainable["prompt_learner"]["meta_net"]
    meta["linear1"]["b"] = jnp.full_like(meta["linear1"]["b"], 0.1)
    rng = np.random.default_rng(7)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, len(trainer.dm.dataset.classnames), 4).astype(np.int32)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    (loss0, _), grads0 = jax.jit(jax.value_and_grad(
        lambda tr: trainer.loss_fn(tr, frozen, batch), has_aux=True))(trainable)
    logits0 = jax.jit(trainer.logits_fn)(trainable, frozen, batch["image"])

    fns = port_cocoop.make_cocoop_fns(tiny_rn, trainer.const.text_len)
    leaves = {k: v.requires_grad_(True) for k, v in flatten(_port_tree(trainable)).items()}
    port_frozen = _port_tree(frozen)
    port_batch = {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)}
    loss, _ = fns["loss_fn"](unflatten(leaves), port_frozen, port_batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    ref_grads = flatten_params(grads0)
    assert abs(loss.item() - float(loss0)) <= 2e-6 * abs(float(loss0))
    assert set(grads) == set(ref_grads) and len(grads) == 5
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, name
        assert _rel_err(g, ref_grads[name]) < 5e-5, name
    with torch.no_grad():
        logits = fns["logits_fn"](unflatten(leaves), port_frozen, port_batch["image"])
    assert _rel_err(logits, logits0) < FP32_TOL


@pytest.mark.parametrize("trainer_name", ["ZeroshotCLIP", "ZeroshotCLIP2"])
def test_zeroshot_test_accuracy_and_logits_match_jax(trainer_name, tiny_rn, data_root, tmp_path,
                                                     monkeypatch):
    """Both packages' trainers on one TinyRN OpenAI state dict, their CLIP
    weights cast to fp32: the class features and the logits of a seeded
    batch to 1e-5, and ``test()``'s accuracy equal."""
    _, sd = _tiny_rn_state_dict()
    weights = tmp_path / "tiny_rn.pt"
    torch.save(sd, weights)
    load_jax, load_port = jax_zsclip.load_clip_backbone, port_zsclip.load_clip_backbone
    monkeypatch.setattr(jax_zsclip, "load_clip_backbone",
                        lambda m: (lambda a, p: (a, _fp32(p)))(*load_jax(m)))
    monkeypatch.setattr(port_zsclip, "load_clip_backbone",
                        lambda m: (lambda a, p: (a, _port_fp32(p)))(*load_port(m)))
    overrides = {"MODEL.BACKBONE.WEIGHTS_PATH": str(weights)}
    ref = _build_jax(_cfg(data_root, tmp_path / "jax", trainer_name, overrides), monkeypatch)
    got = _build_port(_cfg(data_root, tmp_path / "port", trainer_name, overrides,
                           defaults=port_cfg_default), monkeypatch)
    assert got.arch == tiny_rn
    assert _rel_err(got.text_features, ref.text_features) < FP32_TOL
    images = np.random.default_rng(12).standard_normal((5, 64, 64, 3)).astype(np.float32)
    logits = got.model_inference(torch.from_numpy(images))
    assert _rel_err(logits, ref.model_inference(jnp.asarray(images))) < FP32_TOL
    assert got.test()["accuracy"] == ref.test()["accuracy"]


@pytest.mark.parametrize("trainer_name", ["MaPLe", "VPT", "IVLP"])
def test_vision_prompt_trainers_refuse_a_resnet_as_jax_does(trainer_name, tiny_rn, data_root,
                                                            tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="ViT"):
        _build_jax(_cfg(data_root, tmp_path / "jax", trainer_name), monkeypatch)
    with pytest.raises(ValueError, match="ViT"):
        _build_port(_cfg(data_root, tmp_path / "port", trainer_name, defaults=port_cfg_default),
                    monkeypatch)
