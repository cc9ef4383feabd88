"""The port's ViT-L/14 and ViT-B/32 backbones against the JAX package, on the
CPU, at each backbone's widths, heads and patch size but two vision and two
text blocks and small images (56 pixels: a 4 x 4 grid of 14-pixel patches;
64 pixels: 2 x 2 of 32). Each test installs the narrow configuration under
the catalog's name in both packages' ``BACKBONE_CONFIGS`` (restored
afterwards), so the programs are built by name as a user builds them.

What the narrow configurations keep from the full ones: vision width 1024
with 16 heads of 64 and a 4096-wide MLP and a text tower 768 wide with 12
heads (ViT-L/14), 768 with 12 heads and a text tower 512 wide with 8
(ViT-B/32); MaPLe's projections between the two widths (768 <-> 1024 at
ViT-L/14) and ``caption_proj`` into the vision width; the embedding width. The full layouts
are held by ``infer_config_from_state_dict`` on full-size OpenAI state dicts
(shapes only).

JAX's eval runs its towers through its Pallas kernels in interpret mode
(``_ATTENTION_IMPL = "pallas"``); its fp32 train step, the reference of the
loss and gradients, runs its XLA route (``"xla"``: its plain formulation of
the same blocks), built and differentiated once a backbone under ``jax.jit``
to keep the file within a minute. The port runs each kernel's plain version
on CPU tensors, through the same routing as on the card; weights cross with
``load_jax_params``.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
from federated_multi_modal_tpu import flagship as jax_flagship
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.ops import preprocess as jax_pre
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import preprocess as port_pre
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as port_fb
from federated_multi_modal_tpu_torch.trainers import coop as port_coop
from federated_multi_modal_tpu_torch.trainers.common import DEFAULT_CLASSNAMES
from test_torch_slice import TOL_LOGITS, TOL_TXT_N
from test_torch_train import GRAD_TOL, LOSS_RTOL
from test_torch_trainers import _build_jax_trainer

BACKBONES = ("ViT-L/14", "ViT-B/32")
# the narrow configurations: two blocks a tower, 56 and 64 pixels
NARROW = {"ViT-L/14": {"vision_layers": 2, "transformer_layers": 2, "image_resolution": 56},
          "ViT-B/32": {"vision_layers": 2, "transformer_layers": 2, "image_resolution": 64}}
DEPTH = 2  # MaPLe's prompt depth: the shallow prompts and one deep layer
N_IMAGES = 3


def narrow_configs(name):
    """The JAX and the port's catalog entry of ``name``, cut to ``NARROW``."""
    cut = NARROW[name]
    return (dataclasses.replace(jax_params.BACKBONE_CONFIGS[name], **cut),
            dataclasses.replace(port_params.BACKBONE_CONFIGS[name], **cut))


@contextlib.contextmanager
def narrow_catalogs(name):
    """Both packages' catalog entry ``name`` replaced by the narrow one, and
    the JAX module globals its programs set restored, for the block only."""
    jax_arch, port_arch = narrow_configs(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_params.BACKBONE_CONFIGS, name, jax_arch)
        mp.setitem(port_params.BACKBONE_CONFIGS, name, port_arch)
        mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
        mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", jax_prim._VISION_ATTN_WGRAD_BLOCKS)
        mp.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)
        yield jax_arch, port_arch


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: the error each test reads."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# -- the full layouts ---------------------------------------------------------


def full_state_dict_shapes(name):
    """The key -> shape table of a full-size OpenAI state dict of ``name``:
    the port's export of a one-block-a-tower tree at the catalog's widths,
    its block keys repeated for every block of the catalog's depth."""
    arch = port_params.BACKBONE_CONFIGS[name]
    one = dataclasses.replace(arch, vision_layers=1, transformer_layers=1)
    tree = port_params.init_clip_params(one, torch.Generator().manual_seed(0),
                                        dtype_policy=False)
    sd = {k: tuple(t.shape) for k, t in port_params.export_openai_state_dict(tree, one).items()}
    shapes = {}
    for key, shape in sd.items():
        for prefix, layers in (("visual.transformer.resblocks.0.", arch.vision_layers),
                               ("transformer.resblocks.0.", arch.transformer_layers)):
            if key.startswith(prefix):
                rest = key[len(prefix):]
                shapes.update({f"{prefix[:-2]}{i}.{rest}": shape for i in range(layers)})
                break
        else:
            shapes[key] = shape
    return shapes


@pytest.mark.parametrize("name", BACKBONES)
def test_infer_config_from_full_state_dict_matches_jax(name):
    """``infer_config_from_state_dict`` on a full-size OpenAI-format state
    dict (24 vision blocks of 1024 at patch 14, or 12 of 768 at patch 32;
    12 text blocks of 768): shapes only, as zero-stride numpy views for JAX
    and meta tensors for the port. Both give the catalog's entry."""
    shapes = full_state_dict_shapes(name)
    layers = [k for k in shapes if k.endswith(".attn.in_proj_weight")]
    arch = port_params.BACKBONE_CONFIGS[name]
    assert len(layers) == arch.vision_layers + arch.transformer_layers
    jax_sd = {k: np.broadcast_to(np.float16(0), s) for k, s in shapes.items()}
    port_sd = {k: torch.empty(s, dtype=torch.float16, device="meta") for k, s in shapes.items()}
    got = port_params.infer_config_from_state_dict(port_sd)
    want = jax_params.infer_config_from_state_dict(jax_sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == arch and want == jax_params.BACKBONE_CONFIGS[name]
    assert (got.vision_heads, got.grid_size) == (
        (16, 16) if name == "ViT-L/14" else (12, 7))


@pytest.mark.parametrize("name", BACKBONES)
def test_narrow_state_dict_round_trip_matches_jax(name):
    """The narrow tree exported by the port reads back in both packages: the
    inferred configs equal, and the JAX converter's tree equals the port's
    at every leaf, bit for bit in fp16."""
    with narrow_catalogs(name) as (jax_arch, port_arch):
        tree = port_params.init_clip_params(port_arch, torch.Generator().manual_seed(3),
                                            dtype_policy=False)
        sd = port_params.export_openai_state_dict(tree, port_arch, torch.float16)
        np_sd = {k: v.numpy() for k, v in sd.items()}
        assert port_params.infer_config_from_state_dict(sd) == port_arch
        assert jax_params.infer_config_from_state_dict(np_sd) == jax_arch
        ref = flatten_params(jax_params.convert_torch_state_dict(np_sd, jax_arch))
        got = flatten(port_params.convert_torch_state_dict(sd, port_arch))
        assert set(got) == set(ref)
        for k, t in got.items():
            np.testing.assert_array_equal(t.float().numpy(), np.asarray(ref[k], np.float32), k)


# -- MaPLe ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_maple(name):
    """The JAX MaPLe program at the narrow ``name``: the eval logits and text
    features under the bf16 policy (its Pallas kernels in interpret mode),
    and in fp32 the loss and every gradient of one batch with captions (its
    XLA route), each jitted. Built once a process."""
    with narrow_catalogs(name) as (arch, _):
        res = arch.image_resolution
        out = {}
        prog = jax_flagship.build_maple_program(backbone=name, depth=DEPTH, seed=0)
        rng = np.random.default_rng(11)
        canvas = rng.integers(0, 256, (N_IMAGES, res + 8, res + 8, 3), np.uint8)
        boxes, flips = jax_pre.center_boxes(N_IMAGES, res + 8, res)
        images = jax_pre.crop_resize_flip_normalize(
            jnp.asarray(canvas), jnp.asarray(boxes), jnp.asarray(flips), out_size=res)
        prep = jax.jit(prog["eval_prepare_fn"])(prog["trainable"], prog["frozen"])
        logits = jax.jit(prog["eval_apply_fn"])(prog["trainable"], prog["frozen"], images, prep)
        out["eval"] = {"flat_trainable": flatten_params(prog["trainable"]),
                       "flat_frozen": flatten_params(prog["frozen"]["model"]),
                       "prompt_const": {k: np.asarray(v)
                                        for k, v in prog["frozen"]["prompt_const"].items()},
                       "canvas": canvas, "boxes": boxes, "flips": flips,
                       "txt_n": np.asarray(prep["txt_n"]), "logits": np.asarray(logits)}
        trainable, frozen = _fp32(prog["trainable"]), _fp32(prog["frozen"])
        batch = jax_flagship.example_batch(arch, batch_size=N_IMAGES, n_cls=10)
        batch["image"] = batch["image"].astype(jnp.float32)
        out["train"] = {"flat_trainable": flatten_params(trainable),
                        "flat_frozen": flatten_params(frozen["model"]),
                        "prompt_const": {k: np.asarray(v)
                                         for k, v in frozen["prompt_const"].items()},
                        "batch": {k: np.asarray(v) for k, v in batch.items()}}
        jax_prim._ATTENTION_IMPL = "xla"
        loss, grads = jax.jit(jax.value_and_grad(
            lambda t: prog["loss_fn"](t, frozen, batch)[0]))(trainable)
        out["train"].update(loss=float(loss), grads=flatten_params(grads))
        return out


def port_maple(name, ref, remat=False):
    """The port's MaPLe program at the narrow ``name`` on JAX's state:
    ``(prog, trainable, frozen)`` on the CPU."""
    with narrow_catalogs(name):
        prog = port_flagship.build_maple_program(name, depth=DEPTH, seed=0, remat=remat,
                                                 device="cpu")
    trainable = port_params.load_jax_params(ref["flat_trainable"], device="cpu")
    frozen = {"model": port_params.load_jax_params(ref["flat_frozen"], device="cpu"),
              "prompt_const": port_params.load_jax_params(ref["prompt_const"], device="cpu")}
    return prog, trainable, frozen


@pytest.mark.parametrize("name", BACKBONES)
def test_maple_state_at_backbone_widths(name):
    """The port's MaPLe state at the narrow widths: the projections and the
    coupler run between the text width (768 or 512) and the vision width
    (1024 or 768), the caption projection into the vision width, and every
    leaf's name and shape equal the JAX program's."""
    ref = jax_maple(name)["eval"]
    with narrow_catalogs(name) as (_, arch):
        prog = port_flagship.build_maple_program(name, depth=DEPTH, seed=0, device="cpu")
    got = {k: tuple(t.shape) for k, t in flatten(prog["trainable"]).items()}
    assert got == {k: tuple(np.shape(v)) for k, v in ref["flat_trainable"].items()}
    pl = prog["trainable"]["prompt_learner"]
    d_txt, d_vis = arch.transformer_width, arch.vision_width
    assert (d_txt, d_vis) == ((768, 1024) if name == "ViT-L/14" else (512, 768))
    assert tuple(pl["caption_proj"]["w"].shape) == (d_txt, d_vis)
    assert tuple(pl["proj_lang_to_vis"]["w"].shape) == (d_txt, d_vis)
    assert tuple(pl["proj_vis_to_lang"]["w"].shape) == (d_vis, d_txt)
    assert [tuple(c["w"].shape) for c in pl["couplers"]] == [(d_txt, d_vis)]
    assert prog["remat"] is False


@pytest.mark.parametrize("name", BACKBONES)
def test_maple_eval_matches_jax(name):
    """The prompt-cached eval at the narrow widths (bf16 policy): the
    normalized text features and the logits at ``test_torch_slice.py``'s
    ``TOL_TXT_N`` and ``TOL_LOGITS``, the vision blocks on K5 and the text
    blocks on K1 (T = 19 at ViT-L/14's 4 x 4 grid, 7 at ViT-B/32's 2 x 2)."""
    ref = jax_maple(name)["eval"]
    prog, trainable, frozen = port_maple(name, ref)
    calls = {"k1": 0, "k5": 0}

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attn, "packed_attention_masked",
                   counted("k1", port_attn.packed_attention_masked))
        mp.setattr(port_fb, "fused_block_residual", counted("k5", port_fb.fused_block_residual))
        res = prog["arch"].image_resolution
        images = port_pre.crop_resize_flip_normalize(
            torch.from_numpy(ref["canvas"]), torch.from_numpy(ref["boxes"]),
            torch.from_numpy(ref["flips"]), out_size=res)
        prep = prog["eval_prepare_fn"](trainable, frozen)
        logits = prog["eval_apply_fn"](trainable, frozen, images, prep)
    assert calls == {"k1": 2, "k5": 2}
    assert logits.shape == (N_IMAGES, len(DEFAULT_CLASSNAMES))
    np.testing.assert_allclose(prep["txt_n"].numpy(), ref["txt_n"], atol=TOL_TXT_N, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=TOL_LOGITS, rtol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", BACKBONES)
def test_maple_loss_and_every_gradient_match_jax(name, remat):
    """The fp32 MaPLe loss (captions on) and the gradient of every trainable
    leaf, with remat (each block under ``torch.utils.checkpoint``) and
    without, against the JAX program's at ``test_torch_train.py``'s
    ``LOSS_RTOL`` and ``GRAD_TOL``; vision block 0 on K3, block 1 on K4,
    each text block on K1 (each forward twice under remat)."""
    ref = jax_maple(name)["train"]
    prog, trainable, frozen = port_maple(name, ref, remat)
    assert prog["remat"] is remat
    batch = port_params.load_jax_params(ref["batch"], device="cpu")
    calls = {"k1": 0, "k3": 0, "k4": 0}

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attn, "packed_attention_masked",
                   counted("k1", port_attn.packed_attention_masked))
        mp.setattr(port_fb, "fused_block_train", counted("k3", port_fb.fused_block_train))
        mp.setattr(port_fb, "fused_block_train_dw", counted("k4", port_fb.fused_block_train_dw))
        tr = tree_map_with_path(lambda _, t: t.requires_grad_(True), trainable)
        flat = flatten(tr)
        loss, _ = prog["loss_fn"](tr, frozen, batch)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    fwd = 2 if remat else 1
    assert calls == {"k1": 2 * fwd, "k3": fwd, "k4": fwd}
    want = ref
    assert abs(loss.item() - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert set(flat) == set(want["grads"])
    errs = {}
    for key, g in zip(flat, grads):
        if g is None:  # a leaf the loss never reaches
            assert not np.asarray(want["grads"][key]).any(), key
            continue
        errs[key] = _rel_err(g, want["grads"][key])
    assert "prompt_learner.caption_proj.w" in errs and "clip.visual.blocks.1.attn.w_qkv" in errs
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])


# -- CoOp ViT-B/32 -------------------------------------------------------------


def test_coop_vit_b32_loss_and_ctx_gradient_match_jax(tmp_path):
    """CoOp at the narrow ViT-B/32 (``configs/trainers/CoOp/vit_b32.yaml``'s
    16 context tokens at the end, shared), the JAX trainer built by
    ``build_trainer`` on Synthetic, both in fp32: the loss, the accuracy and
    the ctx gradient at ``test_torch_trainers.py``'s limits (loss 2e-6
    relative, gradient 5e-5 of its largest value), and the eval logits at
    1e-5; every vision block on K5 (T = 5), every text block on K1."""
    name = "ViT-B/32"
    with narrow_catalogs(name) as (arch, _):
        res = arch.image_resolution
        trainer = _build_jax_trainer(
            tmp_path, tmp_path / "coop", "CoOp",
            **{"MODEL.BACKBONE.NAME": name, "INPUT.SIZE": (res, res),
               "INPUT.CANVAS_SIZE": res + 8, "TRAINER.COOP.N_CTX": 16})
        trainable, frozen = _fp32(trainer.trainable), _fp32(trainer.frozen)
        rng = np.random.default_rng(12)
        n_cls = len(trainer.dm.dataset.classnames)
        batch = {"image": jnp.asarray(rng.standard_normal((4, res, res, 3)).astype(np.float32)),
                 "label": jnp.asarray(rng.integers(0, n_cls, 4).astype(np.int32))}
        (loss0, aux0), grads0 = jax.value_and_grad(
            lambda tr: trainer.loss_fn(tr, frozen, batch), has_aux=True)(trainable)
        logits0 = trainer.eval_apply_fn(trainable, frozen, batch["image"],
                                        trainer.eval_prepare_fn(trainable, frozen))
        prog = port_coop.build_coop_program(name, classnames=trainer.dm.dataset.classnames,
                                            n_ctx=16, device="cpu")
    assert prog["arch"].grid_size == 2 and prog["arch"].vision_patch_size == 32
    pc = frozen["prompt_const"]
    port_frozen = {
        "clip": port_params.load_jax_params(flatten_params(frozen["clip"]), device="cpu"),
        "prompt_const": dict(
            port_params.load_jax_params({k: np.asarray(pc[k]) for k in
                                         ("full_embedding", "eot_index")}, device="cpu"),
            layout=prog["frozen"]["prompt_const"]["layout"])}
    ctx = port_params.load_jax_params(
        flatten_params(trainable), device="cpu")["prompt_learner"]["ctx"].requires_grad_(True)
    port_batch = port_params.load_jax_params({k: np.asarray(v) for k, v in batch.items()},
                                             device="cpu")
    calls = {"k1": 0, "k5": 0}

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attn, "packed_attention_masked",
                   counted("k1", port_attn.packed_attention_masked))
        mp.setattr(port_fb, "fused_block_residual", counted("k5", port_fb.fused_block_residual))
        loss, aux = prog["loss_fn"]({"prompt_learner": {"ctx": ctx}}, port_frozen, port_batch)
        (grad,) = torch.autograd.grad(loss, ctx)
    assert calls == {"k1": 2, "k5": 2}
    assert abs(loss.item() - float(loss0)) <= 2e-6 * abs(float(loss0))
    assert float(aux["acc"]) == pytest.approx(float(aux0["acc"]))
    assert _rel_err(grad, grads0["prompt_learner"]["ctx"]) < 5e-5
    with torch.no_grad():
        tr = {"prompt_learner": {"ctx": ctx.detach()}}
        logits = prog["eval_apply_fn"](tr, port_frozen, port_batch["image"],
                                       prog["eval_prepare_fn"](tr, port_frozen))
    assert _rel_err(logits, logits0) < 1e-5
