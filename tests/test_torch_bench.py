"""The port's bench (``python -m federated_multi_modal_tpu_torch.bench``)
against the repository's root ``bench.py`` on the CPU, at the Tiny backbone
(width 128, 3 blocks a tower).

Each step of a bench mode runs on the same inputs in both packages, the
weights built once by the JAX package and carried across with
``load_jax_params``: ``bench.py``'s step functions are closures of its
``main`` and ``run_*``, so the JAX side here is their body, line for line.
JAX runs its ``"pallas"`` implementation (the kernels in interpret mode) and
the port its kernel routes (each kernel's plain version on CPU tensors).
Then the command line: each mode prints one line, with ``bench.py``'s keys
and ``device`` and ``power_limit_w`` (through ``main`` in this process, and
the train mode once as a process of its own beside one root ``bench.py``
process); the secondaries' budget and failures; no fallback to the CPU. The
step ``--dispatch scan`` captures over several devices runs here eagerly over
two CPU devices, against ``bench.py``'s body over two of the JAX CPU
devices. The CUDA graphs of ``--dispatch scan`` run only on the card
(``tests/test_torch_cuda.py``).
"""

import functools
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench as jax_bench
import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
from federated_multi_modal_tpu.config import get_cfg_default as jax_cfg_default
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.engine.optim import build_optimizer as jax_build_optimizer
from federated_multi_modal_tpu.flagship import build_fed_optimizer as jax_fed_optimizer
from federated_multi_modal_tpu.flagship import build_maple_program as jax_maple_program
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.ops import preprocess as jax_pre
from federated_multi_modal_tpu.parallel import (
    build_parallel_fed_step as jax_fed_step,
    fedavg_over_clients as jax_fedavg,
    make_client_mesh as jax_client_mesh,
    stack_client_trees as jax_stack,
)
from federated_multi_modal_tpu.tokenizer import tokenize as jax_tokenize
from federated_multi_modal_tpu.trainers import common as jax_common
from federated_multi_modal_tpu_torch import bench
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.trainer import loss_grads_and_aux
from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_multi
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.parallel import (
    build_parallel_fed_step as port_fed_step,
    fedavg_over_clients as port_fedavg,
    make_client_mesh as port_client_mesh,
    stack_client_trees as port_stack,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_CLS, DEPTH, STEPS = 4, 4, 3, 3
CLASSNAMES = [f"class {i}" for i in range(N_CLS)]

# The tolerances of the tests they repeat: the flagship step's loss,
# relative, in fp32 (tests/test_torch_train.py::LOSS_RTOL, 2e-6; the port's
# bench step reads at most 6e-7 over three steps here) and the whole eval
# slice's logits under the bf16 policy (tests/test_torch_slice.py::TOL_LOGITS,
# 0.1 absolute at logit scale 14.29).
LOSS_RTOL = 2e-6
TOL_LOGITS = 0.1


@pytest.fixture(autouse=True)
def _module_globals(monkeypatch):
    """Both packages' attention implementation and text packing, restored
    after each test (the port's ``main`` sets them from its flags)."""
    monkeypatch.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", jax_prim._VISION_ATTN_WGRAD_BLOCKS)
    monkeypatch.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)
    monkeypatch.setattr(port_prim, "_ATTENTION_IMPL", "pallas")
    monkeypatch.setattr(port_clip, "_TEXT_PACK_DEFAULT", True)


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


def _carried(tree):
    return port_params.load_jax_params(flatten_params(tree), device="cpu")


def _inputs(batch_shape=(B,)):
    """``bench.py``'s draws from ``np.random.default_rng(0)``: the uint8
    canvases, the labels, then (python dispatch) the crop boxes and flips."""
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 255, batch_shape + (256, 256, 3), np.uint8)
    labels = rng.integers(0, N_CLS, batch_shape).astype(np.int32)
    n = int(np.prod(batch_shape))
    boxes, flips = jax_pre.sample_rrc_boxes(rng, n)
    return canvas, labels, boxes, flips


def _rel(got, ref):
    return abs(got - ref) / abs(ref)


# -- the train step --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_prog():
    """The one JAX Tiny MaPLe program of the module (captions on), its
    trees under the dtype policy; the train, fed-step and eval cases share
    it."""
    return jax_maple_program(backbone="Tiny", classnames=CLASSNAMES, depth=DEPTH,
                             use_captions=True)


@pytest.fixture(scope="module")
def jax_train(jax_prog):
    """Three steps of ``bench.py``'s ``one_step`` (SGD lr 0.0026, clip 1.0)
    on the Tiny MaPLe program in fp32, with the boxes drawn once, as its
    python dispatch does."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
        mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", jax_prim._VISION_ATTN_WGRAD_BLOCKS)
        prog = jax_prog
        trainable, frozen = _fp32(prog["trainable"]), _fp32(prog["frozen"])
        cfg = jax_cfg_default()
        cfg.OPTIM.LR = 0.0026
        cfg.OPTIM.GRAD_CLIP_NORM = 1.0
        tx = jax_build_optimizer(cfg.OPTIM)
        loss_fn = prog["loss_fn"]
        out_size = prog["arch"].image_resolution

        def one_step(trainable, frozen, opt_state, canvas, boxes, flips, labels,
                     caption_tokens, tx=tx):
            images = jax_pre.crop_resize_flip_normalize(canvas, boxes, flips,
                                                        out_size=out_size)
            batch = {"image": images, "label": labels, "caption_tokens": caption_tokens}

            def wrapped(tr):
                return loss_fn(tr, frozen, batch)

            (loss, _), grads = jax.value_and_grad(wrapped, has_aux=True)(trainable)
            updates, opt_state = tx.update(grads, opt_state, trainable)
            trainable = jax.tree_util.tree_map(
                lambda p, u: p if u is None else p + u,
                trainable, updates, is_leaf=lambda x: x is None)
            return trainable, opt_state, loss

        canvas, labels, boxes, flips = _inputs()
        captions = jax_tokenize(["a satellite photo of a scene"] * B)
        step = jax.jit(one_step)
        tr, st, losses = trainable, tx.init(trainable), []
        for _ in range(STEPS):
            tr, st, loss = step(tr, frozen, st, canvas, boxes, flips, labels, captions)
            losses.append(float(loss))
        return {"trainable": trainable, "frozen": frozen, "losses": losses,
                "final": flatten_params(tr), "inputs": (canvas, labels, boxes, flips),
                "captions": captions, "loss_fn": loss_fn, "out_size": out_size,
                "one_step": one_step, "tx": tx}


def _port_prog(jax_run, use_captions=True):
    prog = port_flagship.build_maple_program(backbone="Tiny", classnames=CLASSNAMES,
                                             depth=DEPTH, use_captions=use_captions,
                                             device="cpu")
    prog["trainable"] = _carried(jax_run["trainable"])
    prog["frozen"] = _carried(jax_run["frozen"])
    return prog


def test_train_step_matches_bench_py(jax_train):
    """The port bench's ``one_step`` on the carried weights and the same
    canvases, boxes, labels and captions: each of three losses within
    ``LOSS_RTOL`` of ``bench.py``'s, the trained leaves within 5e-5 of their
    largest value (``tests/test_torch_train.py``'s ``PARAM_TOL``)."""
    prog = _port_prog(jax_train)
    tx = build_optimizer(lr=0.0026, clip=1.0)
    one_step = bench.make_one_step(prog, tx, use_captions=True)
    canvas, labels, boxes, flips = (torch.from_numpy(np.asarray(a)) for a in jax_train["inputs"])
    captions = torch.from_numpy(np.asarray(jax_train["captions"]))
    tr, st, losses = prog["trainable"], tx.init(prog["trainable"]), []
    for _ in range(STEPS):
        tr, st, loss = one_step(tr, prog["frozen"], st, canvas, boxes, flips, labels, captions)
        losses.append(float(loss))
    for got, ref in zip(losses, jax_train["losses"]):
        assert _rel(got, ref) < LOSS_RTOL, (losses, jax_train["losses"])
    final = flatten(tr)
    assert set(final) == set(jax_train["final"])
    for name, ref in jax_train["final"].items():
        ref = np.asarray(ref, np.float32)
        err = np.abs(final[name].numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < 5e-5, (name, err)


def test_forward_only_step_matches_the_loss(jax_train):
    """``--fwd-only``: the loss of the first step, the state untouched."""
    prog = _port_prog(jax_train)
    tx = build_optimizer(lr=0.0026, clip=1.0)
    one_step = bench.make_one_step(prog, tx, use_captions=True, fwd_only=True)
    canvas, labels, boxes, flips = (torch.from_numpy(np.asarray(a)) for a in jax_train["inputs"])
    st = tx.init(prog["trainable"])
    tr, st2, loss = one_step(prog["trainable"], prog["frozen"], st, canvas, boxes, flips,
                             labels, torch.from_numpy(np.asarray(jax_train["captions"])))
    assert tr is prog["trainable"] and st2 is st and not loss.requires_grad
    assert _rel(float(loss), jax_train["losses"][0]) < LOSS_RTOL


def test_data_parallel_grads_over_two_devices_match_one():
    """``data_parallel_grads`` over two devices (two CPU devices here; the
    multi-card branch of ``--dispatch python``) on the port's own seeded
    weights in fp32, as the carried-weight cases run: each device takes half
    the batch with the trees replicated to it, and the averaged loss and
    gradients equal the one-device call on the whole batch (the loss is a
    mean over the images) within 1e-6 relative and 5e-5 of each gradient's
    largest value (at most 1e-5 here; under the bf16 policy the two halves'
    separate roundings in the text tower's backward reach 0.09)."""
    prog = port_flagship.build_maple_program(backbone="Tiny", classnames=CLASSNAMES,
                                             depth=DEPTH, use_captions=True, device="cpu")
    frozen = tree_map_multi(lambda t: t.float() if t.is_floating_point() else t, prog["frozen"])
    canvas, labels, boxes, flips = (torch.from_numpy(a) for a in _inputs())
    batch = {"image": crop_resize_flip_normalize(canvas, boxes, flips, out_size=32),
             "label": labels,
             "caption_tokens": torch.from_numpy(
                 np.asarray(jax_tokenize(["a satellite photo of a scene"] * B)))}
    cpu = torch.device("cpu")
    (l1, g1), (l2, g2) = (
        bench.data_parallel_grads(prog["loss_fn"], devices)(prog["trainable"], frozen, batch)
        for devices in ([cpu], [cpu, cpu]))
    assert _rel(float(l2), float(l1)) < 1e-6
    g1, g2 = flatten(g1), flatten(g2)
    assert set(g1) == set(g2)
    for name, ref in g1.items():
        assert float((g2[name] - ref).abs().max()) <= 5e-5 * float(ref.abs().max()), name


# -- eval ----------------------------------------------------------------------------


def test_eval_step_matches_bench_py(jax_prog):
    """``bench.py``'s eval body on the program's trees under the dtype policy
    (bf16): two steps of the centre crops, the canvas rolled between them;
    the port's logits of each step within ``TOL_LOGITS`` of JAX's, its
    correct count its own logits'."""
    prog = jax_prog
    canvas, labels, _, _ = _inputs()
    out_size = prog["arch"].image_resolution
    boxes, flips = jax_pre.center_boxes(B, 256, out_size)
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    ref, c = [], jnp.asarray(canvas)
    for _ in range(2):
        images = jax_pre.crop_resize_flip_normalize(c, boxes, flips, out_size=out_size)
        ref.append(np.asarray(prog["eval_apply_fn"](prog["trainable"], prog["frozen"],
                                                    images, prep)))
        c = jnp.roll(c, 1, axis=0)

    port = _port_prog(prog)
    port_prep = port["eval_prepare_fn"](port["trainable"], port["frozen"])
    got = []
    apply_fn = port["eval_apply_fn"]

    def recorded(*args):
        got.append(apply_fn(*args))
        return got[-1]

    port["eval_apply_fn"] = recorded
    labels_t = torch.from_numpy(labels)
    apply = bench.make_eval_step(port, port_prep, torch.from_numpy(boxes),
                                 torch.from_numpy(flips), labels_t)
    state = (torch.zeros((), dtype=torch.int32), torch.from_numpy(canvas))
    for _ in range(2):
        state, correct = apply(state, ())
    assert torch.equal(state[1], torch.from_numpy(np.roll(canvas, 2, axis=0)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.float().numpy(), r, atol=TOL_LOGITS, rtol=0)
    assert int(correct) == sum(int((g.argmax(-1) == labels_t).sum()) for g in got)


# -- the parallel federated step at one client --------------------------------------


def test_fed_step_matches_bench_py(jax_train):
    """``bench.py``'s ``measure_fed_step`` body at one client on one device
    (the JAX mesh on one of its CPU devices): three steps of
    ``build_parallel_fed_step`` with the crop in the loss, then FedAvg; the
    losses within ``LOSS_RTOL``, the averaged leaves within 5e-5."""
    loss_fn, out_size = jax_train["loss_fn"], jax_train["out_size"]
    tx = jax_fed_optimizer()
    canvas, labels, boxes, flips = _inputs((1, B))
    cap = jax_tokenize(["a satellite photo of a scene"] * B)[None]
    batch = {"canvas": canvas, "label": labels, "caption_tokens": cap,
             "boxes": boxes.reshape(1, B, 4), "flips": flips.reshape(1, B)}
    trainable, frozen = jax_train["trainable"], jax_train["frozen"]

    def bench_loss(trainable, frozen, b):
        images = jax_pre.crop_resize_flip_normalize(b["canvas"], b["boxes"], b["flips"],
                                                    out_size=out_size)
        return loss_fn(trainable, frozen, {"image": images, "label": b["label"],
                                           "caption_tokens": b["caption_tokens"]})

    step = jax_fed_step(bench_loss, tx, jax_client_mesh(1, jax.devices()[:1]))
    stacked, opt, ref_losses = jax_stack([trainable]), jax_stack([tx.init(trainable)]), []
    for _ in range(STEPS):
        stacked, opt, losses = step(stacked, frozen, opt, batch)
        ref_losses.append(float(losses[0]))
    ref_final = flatten_params(jax_fedavg(stacked))

    port = _port_prog(jax_train)
    port_tx = port_flagship.build_fed_optimizer()
    fed = bench.make_fed_loss(port)
    mesh = port_client_mesh(1, [torch.device("cpu")])
    port_step = port_fed_step(fed, port_tx, mesh)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    st = (port_stack([port["trainable"]]), port_stack([port_tx.init(port["trainable"])]))
    got = []
    for _ in range(STEPS):
        s, o, losses = port_step(st[0], port["frozen"], st[1], b)
        st = (s, o)
        got.append(float(losses[0]))
    for g, r in zip(got, ref_losses):
        assert _rel(g, r) < LOSS_RTOL, (got, ref_losses)
    final = flatten(port_fedavg(st[0]))
    for name, ref in ref_final.items():
        ref = np.asarray(ref, np.float32)
        err = np.abs(final[name].numpy() - ref).max() / max(np.abs(ref).max(), 1e-30)
        assert err < 5e-5, (name, err)


# -- CoCoOp ----------------------------------------------------------------------------


def _jax_cocoop(loop: bool):
    """``bench.py``'s ``run_cocoop`` state and ``loss_fn`` at Tiny in fp32."""
    arch = jax_params.BACKBONE_CONFIGS["Tiny"]
    key = jax.random.PRNGKey(0)
    clip_params = jax_params.init_clip_params(arch, key, dtype_policy=False)
    n_ctx = 4
    const = jax_common.build_prompt_constants(clip_params["text"], CLASSNAMES, "X X X X",
                                              n_ctx)
    ctx_dim, vis_dim = arch.transformer_width, arch.embed_dim
    k_ctx, k1, k2 = jax.random.split(key, 3)
    trainable = {
        "ctx": jax.random.normal(k_ctx, (n_ctx, ctx_dim)) * 0.02,
        "meta_net": {"linear1": jax_common.linear_params(k1, vis_dim, vis_dim // 16),
                     "linear2": jax_common.linear_params(k2, vis_dim // 16, ctx_dim)},
    }
    frozen = {"clip": clip_params, "prefix": const.token_prefix,
              "suffix": const.token_suffix, "eot": const.eot_index}
    text_len = const.text_len
    n_cls = N_CLS

    def per_image_text(frozen, ctx_shift_i):
        prefix, suffix = frozen["prefix"], frozen["suffix"]
        ctx_i = jnp.broadcast_to(ctx_shift_i[None].astype(prefix.dtype),
                                 (n_cls, n_ctx, ctx_dim))
        prompts = jnp.concatenate([prefix, ctx_i, suffix], axis=1)
        txt = jax_clip.encode_text_embedded(frozen["clip"]["text"], arch, prompts,
                                            frozen["eot"], max_len=text_len)
        return jax_prim.l2_normalize(txt)

    def logits_fn(trainable, frozen, images):
        img = jax_clip.encode_image(frozen["clip"]["visual"], arch, images)
        img_n = jax_prim.l2_normalize(img)
        h = jax.nn.relu(jax_common.apply_linear(trainable["meta_net"]["linear1"], img_n))
        bias = jax_common.apply_linear(trainable["meta_net"]["linear2"], h)
        ctx_shift = trainable["ctx"][None] + bias[:, None, :]
        scale = jnp.exp(frozen["clip"]["logit_scale"].astype(jnp.float32))
        if loop:
            body = jax.checkpoint(lambda c: per_image_text(frozen, c))
            txt_n = jax.lax.map(body, ctx_shift)
            return scale * jnp.einsum("bd,bcd->bc", img_n, txt_n)
        Bi = images.shape[0]
        prefix = jnp.broadcast_to(frozen["prefix"][None], (Bi,) + frozen["prefix"].shape)
        suffix = jnp.broadcast_to(frozen["suffix"][None], (Bi,) + frozen["suffix"].shape)
        ctx_b = jnp.broadcast_to(ctx_shift[:, None].astype(prefix.dtype),
                                 (Bi, n_cls, n_ctx, ctx_dim))
        prompts = jnp.concatenate([prefix, ctx_b, suffix], axis=2)
        prompts = prompts.reshape(Bi * n_cls, arch.context_length, ctx_dim)
        eot = jnp.tile(frozen["eot"], Bi)
        txt = jax_clip.encode_text_embedded(frozen["clip"]["text"], arch, prompts, eot,
                                            max_len=text_len)
        txt_n = jax_prim.l2_normalize(txt).reshape(Bi, n_cls, -1)
        return scale * jnp.einsum("bd,bcd->bc", img_n, txt_n)

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, batch["label"]).mean()

    return arch, trainable, frozen, text_len, loss_fn


@pytest.fixture(scope="module")
def jax_cocoop():
    """Three SGD steps (lr 0.002) of ``bench.py``'s CoCoOp body, batched and
    looped, on the same canvases and boxes."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
        for loop in (False, True):
            arch, trainable, frozen, text_len, loss_fn = _jax_cocoop(loop)
            cfg = jax_cfg_default()
            cfg.OPTIM.LR = 0.002
            tx = jax_build_optimizer(cfg.OPTIM)
            canvas, labels, boxes, flips = _inputs()

            @jax.jit
            def step(trainable, opt_state):
                images = jax_pre.crop_resize_flip_normalize(
                    canvas, boxes, flips, out_size=arch.image_resolution)
                loss, grads = jax.value_and_grad(
                    lambda tr: loss_fn(tr, frozen, {"image": images, "label": labels}))(
                    trainable)
                updates, opt_state = tx.update(grads, opt_state, trainable)
                return optax.apply_updates(trainable, updates), opt_state, loss

            tr, st, losses = trainable, tx.init(trainable), []
            for _ in range(STEPS):
                tr, st, loss = step(tr, st)
                losses.append(float(loss))
            out[loop] = {"trainable": trainable, "frozen": frozen, "text_len": text_len,
                         "losses": losses, "final": flatten_params(tr)}
    return out


def _port_cocoop_run(ref, loop):
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    trainable, frozen = _carried(ref["trainable"]), _carried(ref["frozen"])
    tx = build_optimizer(lr=0.002)
    canvas, labels, boxes, flips = (torch.from_numpy(a) for a in _inputs())
    apply = bench.make_cocoop_step(arch, tx, bench.make_cocoop_loss(arch, ref["text_len"], loop),
                                   frozen, canvas, labels)
    state, losses = (trainable, tx.init(trainable)), []
    for _ in range(STEPS):
        state, loss = apply(state, (boxes, flips))
        losses.append(float(loss))
    return losses, flatten(state[0])


@pytest.mark.parametrize("loop", [False, True], ids=["batched", "loop"])
def test_cocoop_step_matches_bench_py(jax_cocoop, loop):
    """Three steps of the port bench's CoCoOp body (``B x n_cls`` text rows
    in one pass, or one pass per image under ``torch.utils.checkpoint``) on
    the carried fp32 weights: the losses within ``LOSS_RTOL`` of
    ``bench.py``'s, the trained context and meta-net within 5e-5."""
    ref = jax_cocoop[loop]
    losses, final = _port_cocoop_run(ref, loop)
    for g, r in zip(losses, ref["losses"]):
        assert _rel(g, r) < LOSS_RTOL, (losses, ref["losses"])
    for name, r in ref["final"].items():
        r = np.asarray(r, np.float32)
        err = np.abs(final[name].numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err < 5e-5, (name, err)


def test_cocoop_loop_equals_batched_pass(jax_cocoop):
    """The port's two formulations on the same state agree with each other
    (the JAX package shows the same of its own, tests/test_reference_golden.py):
    the loss within 1e-6 relative and every gradient within 1e-5 of its
    largest value."""
    ref = jax_cocoop[False]
    arch = port_params.BACKBONE_CONFIGS["Tiny"]
    trainable, frozen = _carried(ref["trainable"]), _carried(ref["frozen"])
    canvas, labels, boxes, flips = (torch.from_numpy(a) for a in _inputs())
    batch = {"image": crop_resize_flip_normalize(canvas, boxes, flips, out_size=32),
             "label": labels}
    out = [loss_grads_and_aux(bench.make_cocoop_loss(arch, ref["text_len"], loop),
                              trainable, frozen, batch) for loop in (False, True)]
    (l_b, g_b, _), (l_l, g_l, _) = out
    assert _rel(float(l_l), float(l_b)) < 1e-6
    for name, gb in flatten(g_b).items():
        gl = flatten(g_l)[name]
        assert float((gl - gb).abs().max()) <= 1e-5 * float(gb.abs().max()), name


# -- the flop count --------------------------------------------------------------------


@pytest.mark.parametrize("backbone, fwd_only, tflops", [
    ("ViT-B/16", False, 42.29), ("ViT-B/16", True, 20.09),
    ("ViT-L/14", False, 182.74), ("ViT-B/32", False, 13.55),
], ids=["default", "fwd_only", "ViT-L/14", "ViT-B/32"])
def test_step_flops_equal_bench_py(backbone, fwd_only, tflops):
    """``estimate_train_step_flops`` equals ``bench.py``'s at batch 512,
    1000 classes and the 24-token text rows."""
    got = port_flagship.estimate_train_step_flops(
        port_params.BACKBONE_CONFIGS[backbone], 512, 1000, 24, fwd_only=fwd_only)
    ref = jax_bench.estimate_train_step_flops(
        jax_params.BACKBONE_CONFIGS[backbone], 512, 1000, 24, fwd_only=fwd_only)
    assert got == ref
    assert round(got / 1e12, 2) == tflops


# -- the command line ------------------------------------------------------------------

CLI = ["--platform", "cpu", "--backbone", "Tiny", "--depth", str(DEPTH), "--batch-size",
       str(B), "--n-cls", str(N_CLS), "--steps", "2", "--warmup", "1", "--dispatch", "python"]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_includes_dataloading",
             "this_run_host_free"}
CARD_KEYS = {"device", "power_limit_w"}


def _run(argv, env=None, module=("-m", "federated_multi_modal_tpu_torch.bench")):
    proc = subprocess.run([sys.executable, *module, *argv], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc, lines


def _main_line(capsys, argv):
    """``bench.main(argv)`` in this process: its exit code, its one JSON
    line and its stderr."""
    rc = bench.main(argv)
    captured = capsys.readouterr()
    lines = [ln for ln in captured.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, captured.out
    return rc, json.loads(lines[0]), captured.err


@pytest.mark.parametrize("mode", [
    ["--mode", "eval"], ["--mode", "fed-step", "--no-captions"],
    ["--mode", "loader", "--loader-images", "8"], ["--mode", "cocoop"],
    ["--mode", "cocoop", "--cocoop-loop"],
], ids=["eval", "fed-step", "loader", "cocoop", "cocoop-loop"])
def test_command_line_mode_prints_one_line(mode, tmp_path, capsys, monkeypatch):
    """Each mode other than train, through ``main`` in this process, prints
    exactly one JSON line, with ``bench.py``'s keys for it and the device's
    two, and its launches (the loader's JPEG corpus under the test's own
    temporary directory)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc, rec, err = _main_line(capsys, CLI + mode)
    assert rc == 0
    assert set(rec) == LINE_KEYS | CARD_KEYS
    assert rec["value"] > 0 and rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["this_run_host_free"] is (mode[1] != "loader")
    assert "# launches: " in err


def test_command_line_train_keys_equal_bench_py(tmp_path):
    """``python -m federated_multi_modal_tpu_torch.bench train
    --no-secondary`` prints one line whose keys are those of one root
    ``bench.py`` run with the same arguments, and ``device`` and
    ``power_limit_w`` (the MFU is the H100's, so ``null`` on the CPU). Both
    processes keep their temporary files, and ``bench.py`` its JAX
    compilation cache, under the test's own temporary directory."""
    env = dict(os.environ, TMPDIR=str(tmp_path),
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"))
    argv = CLI + ["--no-secondary", "--attention", "xla"]
    proc, lines = _run(argv, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref_proc, ref_lines = _run(argv, env=env, module=(os.path.join(REPO, "bench.py"),))
    assert ref_proc.returncode == 0, ref_proc.stderr[-2000:]
    assert len(lines) == 1 and len(ref_lines) == 1
    rec, ref = json.loads(lines[0]), json.loads(ref_lines[0])
    assert set(rec) == set(ref) | CARD_KEYS
    assert rec["metric"] == ref["metric"] and rec["mfu"] is None
    assert rec["step_tflops"] == ref["step_tflops"]


def test_secondary_budget_spent_gives_error_fields_and_exit_0(capsys, monkeypatch):
    """``FMM_BENCH_SECONDARY_BUDGET=0``: both secondaries are skipped with
    their error fields, the train number stays, and the run exits 0."""
    monkeypatch.setenv("FMM_BENCH_SECONDARY_BUDGET", "0")
    rc, rec, _ = _main_line(capsys, CLI)
    assert rc == 0
    assert "budget exhausted" in rec["fed_step_error"]
    assert "budget exhausted" in rec["eval_error"]
    assert "eval_images_per_sec" not in rec and rec["train_step_ms"] > 0


def test_secondary_that_raises_gives_its_error_field_and_a_failing_exit(capsys, monkeypatch):
    """A secondary that fails still leaves its error field on the one line,
    beside the other's number, and the run exits 1. Each child gets every
    flag its mode reads (``--dispatch``, ``--warmup`` included)."""
    seen = []

    def run_secondary(mode, args, timeout_s, children):
        seen.append(bench.secondary_argv(mode, args))
        if mode == "eval":
            raise RuntimeError("eval child failed")
        return 12.5

    monkeypatch.setattr(bench, "run_secondary", run_secondary)
    rc, rec, _ = _main_line(capsys, CLI)
    assert rc == 1
    assert rec["fed_step_images_per_sec"] == 12.5
    assert rec["eval_error"] == "RuntimeError: eval child failed"
    for argv in seen:
        for flag, value in (("--dispatch", "python"), ("--warmup", "1"), ("--steps", "2"),
                            ("--batch-size", str(B)), ("--platform", "cpu")):
            assert argv[argv.index(flag) + 1] == value


class _RecordingTx:
    """The port's optimizer, its state also holding the last gradients it
    was given (``(state, grads)``), so that a step's gradients come back
    through its optimizer state."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params), tree_map_multi(torch.zeros_like, params)

    def update(self, grads, state, params):
        updates, inner = self.tx.update(grads, state[0], params)
        return updates, (inner, grads)


def _jax_recording_tx(tx):
    """:class:`_RecordingTx` for an optax transformation."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.mark.parametrize("mode", ["train", "fed-step"])
def test_several_device_step_matches_jax(jax_train, mode):
    """The step ``--dispatch scan`` captures over several devices, run
    eagerly over two CPU devices (``[cpu, cpu]``), against the root
    ``bench.py`` body over two of the JAX CPU devices, on the carried fp32
    weights: ``train``'s batch of 4 split over the two devices (the JAX
    batch sharded along a 1-D ``data`` mesh), ``fed-step``'s two clients of
    4 images (``test_fed_step_matches_bench_py``'s client; at 2 images the
    two packages' crops round a few pixels apart, which
    ``test_two_image_client_gap_is_the_crops_rounding`` shows) on a
    ``(client, data)`` mesh of ``(2, 1)`` (the JAX stacked trees sharded
    along ``client``, the batch along ``client`` and ``data``), which also
    gives the same bits as both clients on one device. The loss (each
    client's) within 1e-6 relative; every gradient the optimizer was given
    (each client's) within 5e-5 of its
    largest value, as ``test_data_parallel_grads_over_two_devices_match_one``
    holds them (each side's optimizer state records them)."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    cpu = torch.device("cpu")
    two = jax.devices()[:2]
    trainable, frozen = jax_train["trainable"], jax_train["frozen"]
    port = _port_prog(jax_train)
    if mode == "train":
        canvas, labels, boxes, flips = jax_train["inputs"]
        captions = jax_train["captions"]
        sharding = NamedSharding(Mesh(np.asarray(two), ("data",)), P("data"))
        put = [jax.device_put(jnp.asarray(a), sharding)
               for a in (canvas, boxes, flips, labels, captions)]
        tx = _jax_recording_tx(jax_train["tx"])
        step = jax.jit(functools.partial(jax_train["one_step"], tx=tx))
        _, state, loss = step(trainable, frozen, tx.init(trainable), *put)
        ref_losses, ref_grads = [float(loss)], flatten_params(state[1])

        port_tx = _RecordingTx(build_optimizer(lr=0.0026, clip=1.0))
        one_step = bench.make_one_step(port, port_tx, use_captions=True, devices=[cpu, cpu])
        _, state, loss = one_step(port["trainable"], port["frozen"],
                                  port_tx.init(port["trainable"]),
                                  *(torch.from_numpy(np.asarray(a))
                                    for a in (canvas, boxes, flips, labels, captions)))
        got_losses, got_grads = [float(loss)], flatten(state[1])
    else:
        C, Bc = 2, B
        loss_fn, out_size = jax_train["loss_fn"], jax_train["out_size"]
        tx = _jax_recording_tx(jax_fed_optimizer())
        canvas, labels, boxes, flips = _inputs((C, Bc))
        cap = np.broadcast_to(jax_tokenize(["a satellite photo of a scene"] * Bc)[None],
                              (C, Bc, 77)).copy()
        batch = {"canvas": canvas, "label": labels, "caption_tokens": cap,
                 "boxes": boxes.reshape(C, Bc, 4), "flips": flips.reshape(C, Bc)}

        def bench_loss(trainable, frozen, b):
            images = jax_pre.crop_resize_flip_normalize(b["canvas"], b["boxes"], b["flips"],
                                                        out_size=out_size)
            return loss_fn(trainable, frozen, {"image": images, "label": b["label"],
                                               "caption_tokens": b["caption_tokens"]})

        mesh = jax_client_mesh(C, two)

        def shard(tree, spec):
            return jax.tree.map(lambda x: jax.device_put(x, NamedSharding(mesh, spec)), tree)

        step = jax_fed_step(bench_loss, tx, mesh)
        _, state, losses = step(shard(jax_stack([trainable] * C), P("client")),
                                shard(frozen, P()),
                                shard(jax_stack([tx.init(trainable)] * C), P("client")),
                                shard({k: jnp.asarray(v) for k, v in batch.items()},
                                      P("client", "data")))
        ref_losses, ref_grads = [float(x) for x in np.asarray(losses)], flatten_params(state[1])

        port_tx = _RecordingTx(port_flagship.build_fed_optimizer())
        runs = []
        for devices in ([cpu, cpu], [cpu]):
            port_step = port_fed_step(bench.make_fed_loss(port), port_tx,
                                      port_client_mesh(C, devices))
            runs.append(port_step(
                port_stack([port["trainable"]] * C), port["frozen"],
                port_stack([port_tx.init(port["trainable"])] * C),
                {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}))
        # each client's step alone on its device: the same bits as both
        # clients on one device
        assert bench.held_bitwise(runs[0], runs[1])["bit_for_bit"]
        _, state, losses = runs[0]
        got_losses, got_grads = losses.tolist(), flatten(state[1])
    assert len(got_losses) == len(ref_losses)
    for g, r in zip(got_losses, ref_losses):
        assert _rel(g, r) < 1e-6, (got_losses, ref_losses)
    assert set(got_grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        ref = np.asarray(ref, np.float32)
        assert got_grads[name].shape == ref.shape, name
        err = np.abs(got_grads[name].numpy() - ref).max()
        assert err <= 5e-5 * np.abs(ref).max(), (name, err, np.abs(ref).max())


def _crop_fp64(canvas, boxes, flips, out_size):
    """The port's crop of ``canvas`` with its fp32 resampling weights, summed
    and normalised in fp64 (no bf16 rounding)."""
    from federated_multi_modal_tpu_torch.ops import preprocess as port_pre

    boxes = torch.from_numpy(boxes)
    wy = port_pre._resample_matrix(256, out_size, boxes[:, 0], boxes[:, 2]).double()
    wx = port_pre._resample_matrix(256, out_size, boxes[:, 1], boxes[:, 3]).double()
    imgs = torch.from_numpy(canvas).double() / 255.0
    out = torch.einsum("bwt,botc->bowc", wx, torch.einsum("bos,bshc->bohc", wy, imgs))
    out = torch.where(torch.from_numpy(flips)[:, None, None, None], out.flip(2), out)
    mean = torch.tensor(port_pre.CLIP_MEAN, dtype=torch.float64)
    std = torch.tensor(port_pre.CLIP_STD, dtype=torch.float64)
    return ((out - mean) / std).numpy(), port_pre.CLIP_STD


def test_two_image_client_gap_is_the_crops_rounding(jax_train):
    """Why ``test_several_device_step_matches_jax``'s fed-step clients hold 4
    images: at 2 a client's gradient from the port sits up to 7.1e-5 of its
    largest value from the JAX package's (``clip.visual.blocks.2.attn.w_qkv``,
    client 0), above that test's 5e-5, on one device and on two alike. The
    cause is the crop, not the model or the devices: both packages resample
    in fp32 and round to bf16, their fp32 sums differ in the last place, and
    the few pixels that lie within about one fp32 unit of a bf16 rounding
    midpoint round apart; at 2 images each such pixel weighs twice as much
    in the mean as at 4. Held for both clients of 2 images: (a) the two
    crops differ by at most one bf16 unit, only at pixels within two units
    of 2^-24 (at the pixel's [0, 1] scale) of a bf16 midpoint of the crop
    summed in fp64; (b) given the JAX package's images, the port's
    gradients are within 5e-5 of each leaf's largest value of the JAX
    package's."""
    C, Bc = 2, 2
    loss_fn, out_size = jax_train["loss_fn"], jax_train["out_size"]
    trainable, frozen = jax_train["trainable"], jax_train["frozen"]
    port = _port_prog(jax_train)
    canvas, labels, boxes, flips = _inputs((C, Bc))
    boxes, flips = boxes.reshape(C, Bc, 4), flips.reshape(C, Bc)
    captions = jax_tokenize(["a satellite photo of a scene"] * Bc)

    @jax.jit
    def jax_grads(tr, images, label):
        def loss(t):
            return loss_fn(t, frozen, {"image": images, "label": label,
                                       "caption_tokens": captions})[0]
        return jax.grad(loss)(tr)

    for c in range(C):
        jax_images = jax_pre.crop_resize_flip_normalize(canvas[c], boxes[c], flips[c],
                                                        out_size=out_size)
        ref = np.asarray(jax_images).astype(np.float32)
        got = crop_resize_flip_normalize(torch.from_numpy(canvas[c]), torch.from_numpy(boxes[c]),
                                         torch.from_numpy(flips[c]),
                                         out_size=out_size).float().numpy()
        exact, std = _crop_fp64(canvas[c], boxes[c], flips[c], out_size)
        for i in map(tuple, np.argwhere(got != ref)):
            unit = 2.0 ** (np.floor(np.log2(abs(exact[i]))) - 7)
            midpoint = (np.floor(exact[i] / unit) + 0.5) * unit
            assert abs(got[i] - ref[i]) <= unit, (c, i, got[i], ref[i])
            assert abs(exact[i] - midpoint) * std[i[-1]] <= 2 * 2.0 ** -24, (c, i, exact[i])

        want = flatten_params(jax_grads(trainable, jax_images, labels[c]))
        batch = {"image": torch.from_numpy(ref).to(torch.bfloat16),
                 "label": torch.from_numpy(labels[c]),
                 "caption_tokens": torch.from_numpy(np.asarray(captions))}
        grads = flatten(loss_grads_and_aux(port["loss_fn"], port["trainable"], port["frozen"],
                                           batch)[1])
        assert set(grads) == set(want)
        for name, w in want.items():
            w = np.asarray(w, np.float32)
            err = np.abs(grads[name].numpy() - w).max()
            assert err <= 5e-5 * np.abs(w).max(), (c, name, err, np.abs(w).max())


def test_no_fallback_to_the_cpu():
    """``--platform default`` without CUDA raises, and so does ``--dispatch
    scan`` (a CUDA graph) on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--backbone", "Tiny"])
    with pytest.raises(ValueError, match="needs the card"):
        bench.main(CLI[:-2] + ["--no-secondary"])
