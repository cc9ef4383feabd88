"""The port's MaPLe train step against the JAX package, module by module and
as a whole, on the CPU at the Tiny width (width 128, 2 heads, 3 vision
blocks: blocks 0-1 take the frozen-weight train kernel K3 and block 2 the
trainable one K4; the text rows pack five prompts of 24 tokens to a row of
120 and take K1 and K1b).

JAX runs with ``_ATTENTION_IMPL = "pallas"`` and the ``"last"`` wgrad policy
(which its ``build_maple_program`` sets), so that its towers reach their
Pallas kernels in interpret mode; the port runs each kernel's plain version
on CPU tensors. Every JAX module global a test sets is restored through
``monkeypatch``. Weights cross from JAX with ``load_jax_params``; inputs are
made with numpy from a seed and handed to both.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
from federated_multi_modal_tpu import flagship as jax_flagship
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.ops import preprocess as jax_pre
from federated_multi_modal_tpu.trainers import maple as jax_maple
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
from federated_multi_modal_tpu_torch.engine.tree import flatten, merge_trees, tree_map_with_path
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import preprocess as port_pre
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as port_fb
from federated_multi_modal_tpu_torch.trainers import maple as port_maple

CFG = jax_params.tiny_test_config()


def _jax_globals(mp):
    mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
    mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", "last")
    mp.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x,
        tree)


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: the error each test reads."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def test_caption_tokens_to_extra_matches_jax(monkeypatch):
    """The pooled caption token, from the program's own (bf16 policy)
    embedding table: fp32 pooling on both sides reads 1.2e-7; tolerance
    1e-5."""
    _jax_globals(monkeypatch)
    prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3)
    pl = prog["trainable"]["prompt_learner"]
    text = prog["frozen"]["model"]["clip"]["text"]
    tokens = np.array(jax_flagship.example_batch(prog["arch"], 3)["caption_tokens"])
    ref = jax_maple.caption_tokens_to_extra(pl, text, tokens)

    pl_t = port_params.load_jax_params(flatten_params(pl), device="cpu")
    text_t = port_params.load_jax_params(flatten_params(text), device="cpu")
    pl_t = tree_map_with_path(lambda _, t: t.requires_grad_(True), pl_t)
    got = port_maple.caption_tokens_to_extra(
        pl_t, text_t, torch.from_numpy(tokens))
    assert got.shape == (3, 1, CFG.vision_width) and got.dtype == torch.float32
    assert _rel_err(got, ref) < 1e-5
    got.sum().backward()  # the caption parameters train, the embeddings do not
    assert pl_t["caption_pool_w"].grad is not None
    assert text_t["token_embedding"].grad is None


@pytest.fixture(scope="module")
def tiny_fp32():
    jp = jax_params.init_clip_params(CFG, jax.random.PRNGKey(3), dtype_policy=False)
    return jp, port_params.load_jax_params(flatten_params(jp), device="cpu")


def test_encode_image_train_path_matches_jax(monkeypatch, tiny_fp32):
    """The vision tower's train path (every block through a train kernel)
    with shallow and deep prompts and two extra tokens re-injected after
    every deep prompt, fp32: T = 1 + 4 + 2 + 2 = 9, which the JAX kernels
    pad to 16. Reads 4.8e-7; tolerance 1e-5."""
    _jax_globals(monkeypatch)
    jp, tp = tiny_fp32
    rng = np.random.default_rng(21)
    w = CFG.vision_width
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    shallow = (rng.standard_normal((2, w)) * 0.1).astype(np.float32)
    deep = [(rng.standard_normal((2, w)) * 0.1).astype(np.float32) for _ in range(2)]
    extra = (rng.standard_normal((3, 2, w)) * 0.1).astype(np.float32)

    ref = jax_clip.encode_image(
        jp["visual"], CFG, jnp.asarray(images), shallow_prompts=jnp.asarray(shallow),
        deep_prompts=[jnp.asarray(p) for p in deep], extra_tokens=jnp.asarray(extra))
    got = port_clip.encode_image(
        tp["visual"], CFG, torch.from_numpy(images),
        shallow_prompts=torch.from_numpy(shallow),
        deep_prompts=[torch.from_numpy(p) for p in deep],
        extra_tokens=torch.from_numpy(extra))
    assert _rel_err(got, ref) < 1e-5


# The whole step at the Tiny width in fp32, where the point is the
# algorithm: the same weights, batch (captions on) and optimizer in both
# packages. The errors read, as max |error| over max |value| of each leaf:
# the loss at most 3.6e-7 (relative), the gradients at most 4.5e-6 (biases of
# the last text block), the params over three SGD steps at most 6.0e-6 and
# the momentum 6.0e-6 (``text.ln_final.bias``, whose values are the
# smallest). Tolerances about ten times that:
LOSS_RTOL = 2e-6
GRAD_TOL = 5e-5
PARAM_TOL = 5e-5
TRACE_TOL = 5e-5


@pytest.fixture(scope="module")
def jax_step():
    return run_jax_step()


def run_jax_step():
    """The JAX program on Tiny in fp32 under the pallas implementation: its
    weights, a batch, the loss and gradients of the first step, and three
    SGD steps of ``engine/trainer.py::_train_step``'s arithmetic."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_globals(mp)
        prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0)
        trainable, frozen = _fp32(prog["trainable"]), _fp32(prog["frozen"])
        batch = jax_flagship.example_batch(prog["arch"], batch_size=4, n_cls=10)
        batch["image"] = batch["image"].astype(jnp.float32)
        tx = jax_flagship.build_fed_optimizer()
        opt_state = tx.init(trainable)

        def wrapped(tr):
            return prog["loss_fn"](tr, frozen, batch)[0]

        loss0, grads0 = jax.value_and_grad(wrapped)(trainable)
        logits0 = prog["logits_fn"](trainable, frozen, batch["image"])

        @jax.jit
        def step(tr, st):  # engine/trainer.py:534-568
            loss, grads = jax.value_and_grad(wrapped)(tr)
            gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                                 for g in jax.tree_util.tree_leaves(grads)))
            finite = jnp.isfinite(gnorm) & jnp.isfinite(loss)
            updates, new_st = tx.update(grads, st, tr)
            tr = jax.tree_util.tree_map(
                lambda p, u: p if u is None else jnp.where(finite, p + u, p),
                tr, updates, is_leaf=lambda x: x is None)
            st = jax.tree_util.tree_map(
                lambda new, old: jnp.where(finite, new, old)
                if hasattr(new, "shape") else new, new_st, st)
            return tr, st, loss

        states, losses = [], []
        tr, st = trainable, opt_state
        for _ in range(3):
            tr, st, loss = step(tr, st)
            losses.append(float(loss))
            trace = next(s.trace for s in st.inner_state if hasattr(s, "trace"))
            states.append((flatten_params(tr), flatten_params(trace)))
        return {
            "flat_trainable": flatten_params(trainable),
            "flat_frozen": flatten_params(frozen["model"]),
            "prompt_const": {k: np.asarray(v) for k, v in frozen["prompt_const"].items()},
            "batch": {k: np.asarray(v) for k, v in batch.items()},
            "loss0": float(loss0), "grads0": flatten_params(grads0),
            "logits0": np.asarray(logits0), "losses": losses, "states": states,
        }


def _port_program(jax_step, fn="loss_fn"):
    """The port's program on the JAX weights, constants and batch of
    ``jax_step``: ``(prog[fn], trainable, frozen, batch)`` on the CPU."""
    prog = port_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0,
                                             device="cpu")
    trainable = port_params.load_jax_params(jax_step["flat_trainable"], device="cpu")
    frozen = {
        "model": port_params.load_jax_params(jax_step["flat_frozen"], device="cpu"),
        "prompt_const": port_params.load_jax_params(jax_step["prompt_const"], device="cpu"),
    }
    batch = port_params.load_jax_params(jax_step["batch"], device="cpu")
    return prog[fn], trainable, frozen, batch


def test_logits_fn_matches_jax(jax_step):
    """The cosine logits of the batch's images against every class, fp32:
    reads 1.4e-6 of the largest logit; tolerance 1e-5."""
    logits_fn, trainable, frozen, batch = _port_program(jax_step, "logits_fn")
    got = logits_fn(trainable, frozen, batch["image"])
    assert got.shape == (4, 10)
    assert _rel_err(got, jax_step["logits0"]) < 1e-5


def test_loss_and_every_gradient_match_jax(jax_step, monkeypatch):
    """Loss and the gradient of every trainable leaf (prompt learner with the
    caption branch, every LayerNorm, the last block of each tower), with
    the kernels' routes counted: K1/K1b in the three text blocks, K3 in
    vision blocks 0-1, K4 in block 2."""
    loss_fn, trainable, frozen, batch = _port_program(jax_step)
    calls = {"k1": 0, "k3": 0, "k4": 0}

    def counted(key, fn):
        def wrapper(*args):
            calls[key] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(port_attn, "packed_attention_masked",
                        counted("k1", port_attn.packed_attention_masked))
    monkeypatch.setattr(port_fb, "fused_block_train",
                        counted("k3", port_fb.fused_block_train))
    monkeypatch.setattr(port_fb, "fused_block_train_dw",
                        counted("k4", port_fb.fused_block_train_dw))
    tr = tree_map_with_path(lambda _, t: t.requires_grad_(True), trainable)
    flat = flatten(tr)
    loss, _ = loss_fn(tr, frozen, batch)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    assert calls == {"k1": 3, "k3": 2, "k4": 1}

    assert abs(loss.item() - jax_step["loss0"]) <= LOSS_RTOL * abs(jax_step["loss0"])
    ref = jax_step["grads0"]
    assert set(flat) == set(ref)
    errs = {}
    for name, g in zip(flat, grads):
        if g is None:  # a leaf the loss never reaches (proj_vis_to_lang)
            assert not np.asarray(ref[name]).any(), name
            continue
        errs[name] = _rel_err(g, ref[name])
    assert "prompt_learner.caption_proj.w" in errs
    assert "clip.visual.blocks.2.attn.w_qkv" in errs and "clip.text.blocks.2.mlp.w_fc" in errs
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_text_pack_switch_matches_jax(jax_step, monkeypatch, pack):
    """``set_text_pack`` in both packages: the Tiny MaPLe text features
    (``eval_prepare_fn``), the loss and every trainable gradient against
    JAX's under the same setting, fp32, at the whole step's tolerances
    (``LOSS_RTOL``, ``GRAD_TOL``; the text features at 1e-5 of their
    largest value, as the logits). Unpacked, the 24-token rows take the
    plain attention on both sides (T < 32) and no K1 wrapper runs; packed,
    each text block runs K1 once. ``pack=None`` follows the module
    default."""
    _jax_globals(monkeypatch)
    monkeypatch.setattr(jax_clip, "_TEXT_PACK_DEFAULT", jax_clip._TEXT_PACK_DEFAULT)
    monkeypatch.setattr(port_clip, "_TEXT_PACK_DEFAULT", port_clip._TEXT_PACK_DEFAULT)
    jax_clip.set_text_pack(pack)
    port_clip.set_text_pack(pack)

    prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0)
    trainable, frozen = _fp32(prog["trainable"]), _fp32(prog["frozen"])
    batch = {k: jnp.asarray(v) for k, v in jax_step["batch"].items()}
    loss_ref, grads_ref = jax.value_and_grad(
        lambda t: prog["loss_fn"](t, frozen, batch)[0])(trainable)
    txt_ref = prog["eval_prepare_fn"](trainable, frozen)["txt_n"]
    grads_ref = flatten_params(grads_ref)

    calls = []
    real_k1 = port_attn.packed_attention_masked

    def spy(*args):
        calls.append(args[0].shape)
        return real_k1(*args)

    monkeypatch.setattr(port_attn, "packed_attention_masked", spy)
    loss_fn, tr, fr, batch_t = _port_program(jax_step)
    prepare = port_flagship.build_maple_program(
        backbone="Tiny", depth=3, seed=0, device="cpu")["eval_prepare_fn"]
    txt = prepare(tr, fr)["txt_n"]
    assert len(calls) == (CFG.transformer_layers if pack else 0)
    assert _rel_err(txt, txt_ref) < 1e-5

    tr = tree_map_with_path(lambda _, t: t.requires_grad_(True), tr)
    flat = flatten(tr)
    calls.clear()
    loss, _ = loss_fn(tr, fr, batch_t)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    assert len(calls) == (CFG.transformer_layers if pack else 0)
    assert abs(loss.item() - float(loss_ref)) <= LOSS_RTOL * abs(float(loss_ref))
    errs = {name: _rel_err(g, grads_ref[name]) for name, g in zip(flat, grads)
            if g is not None}
    assert "clip.text.blocks.2.attn.w_qkv" in errs
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])

    # pack=None follows the module default; an explicit pack overrides it
    text = merge_trees(tr, fr["model"])["clip"]["text"]
    rng = np.random.default_rng(8)
    prompts = torch.from_numpy((rng.standard_normal((7, 77, CFG.transformer_width))
                                * 0.1).astype(np.float32))
    eot = torch.from_numpy(rng.integers(4, 24, 7))
    calls.clear()
    with torch.no_grad():
        default = port_clip.encode_text_embedded(text, CFG, prompts, eot, max_len=24)
        assert len(calls) == (CFG.transformer_layers if pack else 0)
        calls.clear()
        explicit = port_clip.encode_text_embedded(text, CFG, prompts, eot, max_len=24,
                                                  pack=pack)
        other = port_clip.encode_text_embedded(text, CFG, prompts, eot, max_len=24,
                                               pack=not pack)
    assert len(calls) == CFG.transformer_layers
    assert torch.equal(default, explicit)
    assert _rel_err(other, explicit.numpy()) < 1e-5


def test_three_sgd_steps_match_jax(jax_step):
    """Three steps of ``train_step`` with the federated optimizer (SGD,
    momentum 0.9, weight decay 5e-4, clip 1.0): every leaf of the params and
    of the momentum after each step."""
    loss_fn, trainable, frozen, batch = _port_program(jax_step)
    tx = port_flagship.build_fed_optimizer()
    step = make_train_step(loss_fn, tx)
    opt_state = tx.init(trainable)
    for i, (ref_params, ref_trace) in enumerate(jax_step["states"]):
        trainable, opt_state, loss, gnorm = step(trainable, frozen, opt_state, batch)
        assert abs(float(loss) - jax_step["losses"][i]) <= LOSS_RTOL * abs(jax_step["losses"][i])
        assert float(gnorm) > 1.0  # the clip is active
        for name, t in flatten(trainable).items():
            assert _rel_err(t, ref_params[name]) < PARAM_TOL, (i, name)
        for name, t in flatten(opt_state["trace"]).items():
            assert _rel_err(t, ref_trace[name]) < TRACE_TOL, (i, name)


def test_sgd_steps_from_jax_momentum_match_jax(jax_step):
    """The port resumes from the JAX step-1 params and momentum (the same
    flat dicts, carried across with ``load_jax_params``) and must reach the
    JAX steps 2 and 3."""
    loss_fn, _, frozen, batch = _port_program(jax_step)
    tx = port_flagship.build_fed_optimizer()
    step = make_train_step(loss_fn, tx)
    params, trace = jax_step["states"][0]
    trainable = port_params.load_jax_params(params, device="cpu")
    opt_state = {"trace": port_params.load_jax_params(trace, device="cpu")}
    for ref_params, ref_trace in jax_step["states"][1:]:
        trainable, opt_state, _, _ = step(trainable, frozen, opt_state, batch)
        for name, t in flatten(trainable).items():
            assert _rel_err(t, ref_params[name]) < PARAM_TOL, name
        for name, t in flatten(opt_state["trace"]).items():
            assert _rel_err(t, ref_trace[name]) < TRACE_TOL, name


# The loss and gradients again under the dtype policy the card runs (frozen
# weights and activations bf16, trainable leaves fp32), on the same weights
# and batch as ``jax_step``, whose fp32 results are exact by comparison. In
# bf16 the two packages round at other points (XLA keeps fused elementwise
# chains in fp32, PyTorch rounds after every operation), and both land
# 1 % to 11 % of a leaf's largest gradient away from the fp32 result. The
# test holds the port to being no further from it than JAX is: it reads at
# most 1.32 times JAX's error on any leaf, and 0.34 times on the loss.
BF16_ERROR_RATIO = 2.0


def test_loss_and_every_gradient_bf16_as_close_as_jax(jax_step, monkeypatch):
    _jax_globals(monkeypatch)
    prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0)
    batch = jax_flagship.example_batch(prog["arch"], batch_size=4, n_cls=10)
    np.testing.assert_array_equal(np.asarray(batch["image"], np.float32),
                                  jax_step["batch"]["image"])
    loss_jax, grads_jax = jax.value_and_grad(
        lambda t: prog["loss_fn"](t, prog["frozen"], batch)[0])(prog["trainable"])
    flat_jax = flatten_params(grads_jax)

    loss_fn, trainable, frozen, batch_t = _port_program({
        "flat_trainable": flatten_params(prog["trainable"]),
        "flat_frozen": flatten_params(prog["frozen"]["model"]),
        "prompt_const": {k: np.asarray(v) for k, v in prog["frozen"]["prompt_const"].items()},
        "batch": {k: np.asarray(v) for k, v in batch.items()},
    })
    assert batch_t["image"].dtype == torch.bfloat16
    assert frozen["model"]["clip"]["visual"]["blocks"][0]["attn"]["w_qkv"].dtype == torch.bfloat16
    tr = tree_map_with_path(lambda _, t: t.requires_grad_(True), trainable)
    flat = flatten(tr)
    loss, _ = loss_fn(tr, frozen, batch_t)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)

    exact = jax_step["loss0"]
    assert abs(loss.item() - exact) <= BF16_ERROR_RATIO * abs(float(loss_jax) - exact)
    ref = jax_step["grads0"]
    for name, g in zip(flat, grads):
        if g is None:
            continue
        jax_err = _rel_err(torch.from_numpy(np.asarray(flat_jax[name], np.float32)), ref[name])
        assert _rel_err(g, ref[name]) <= BF16_ERROR_RATIO * jax_err, name


def test_non_finite_step_changes_nothing(jax_step):
    """A NaN image makes the loss non-finite: the step must leave the params
    and the momentum bit for bit as they were."""
    loss_fn, trainable, frozen, batch = _port_program(jax_step)
    tx = port_flagship.build_fed_optimizer()
    step = make_train_step(loss_fn, tx)
    trainable, opt_state, _, _ = step(trainable, frozen, tx.init(trainable), batch)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][1, 3, 4, 0] = float("nan")
    new_params, new_state, loss, gnorm = step(trainable, frozen, opt_state, bad)
    assert not torch.isfinite(loss)
    for old, new in ((trainable, new_params), (opt_state, new_state)):
        flat_old, flat_new = flatten(old), flatten(new)
        assert flat_old.keys() == flat_new.keys()
        for name in flat_old:
            assert torch.equal(flat_old[name], flat_new[name]), name


def test_sample_rrc_boxes_match_jax():
    """The numpy sampler is a copy: the same draws from the same generator.
    The torch sampler draws the same distribution from other numbers: its
    boxes lie on the canvas with integer sides, as the JAX one's do."""
    ref = jax_pre.sample_rrc_boxes(np.random.default_rng(5), 64, 96)
    got = port_pre.sample_rrc_boxes(np.random.default_rng(5), 64, 96)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    boxes, flips = port_pre.sample_rrc_boxes_torch(torch.Generator().manual_seed(5), 512, 96)
    jboxes, _ = jax_pre.sample_rrc_boxes_jax(jax.random.PRNGKey(5), 512, 96)
    assert boxes.shape == (512, 4) and flips.dtype == torch.bool
    for b in (boxes.numpy(), np.asarray(jboxes)):
        y0, x0, h, w = b.T
        assert (h >= 1).all() and (w >= 1).all()
        assert (y0 >= 0).all() and (y0 + h <= 96).all() and (x0 + w <= 96).all()
        np.testing.assert_array_equal(b, np.round(b))


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["momentum", "nesterov"])
def test_sgd_chain_matches_optax(nesterov, clip):
    """The port's SGD chain against the JAX package's ``tx_with_lr`` (optax:
    clip_by_global_norm, add_decayed_weights, trace, scale) over three
    updates of a small tree whose gradients' norm is ~8, so the clip acts:
    every update and the momentum, fp32. Reads 0 (the same fp32 operations
    in the same order); tolerance 1e-6 of each leaf's largest value."""
    from federated_multi_modal_tpu.engine.optim import tx_with_lr
    from federated_multi_modal_tpu_torch.engine.optim import build_optimizer

    lr, wd, momentum = 0.01, 5e-4, 0.9
    cfg = types.SimpleNamespace(NAME="sgd", WEIGHT_DECAY=wd, MOMENTUM=momentum,
                                SGD_NESTEROV=nesterov)
    tx_jax = tx_with_lr(cfg, lr, clip)
    tx = build_optimizer(lr=lr, momentum=momentum, weight_decay=wd,
                         nesterov=nesterov, clip=clip)
    rng = np.random.default_rng(31)
    params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
              "blk": {"b": rng.standard_normal(5).astype(np.float32)}}
    p_jax = jax.tree.map(jnp.asarray, params)
    p_t = {"w": torch.from_numpy(params["w"]), "blk": {"b": torch.from_numpy(params["blk"]["b"])}}
    st_jax, st = tx_jax.init(p_jax), tx.init(p_t)
    for _ in range(3):
        g = {"w": (rng.standard_normal((6, 4)) * 2).astype(np.float32),
             "blk": {"b": (rng.standard_normal(5) * 2).astype(np.float32)}}
        u_jax, st_jax = tx_jax.update(jax.tree.map(jnp.asarray, g), st_jax, p_jax)
        u, st = tx.update({"w": torch.from_numpy(g["w"]),
                           "blk": {"b": torch.from_numpy(g["blk"]["b"])}}, st, p_t)
        trace_jax = next(s.trace for s in st_jax if hasattr(s, "trace"))
        for ref, got in ((u_jax, u), (trace_jax, st["trace"])):
            assert _rel_err(got["w"], ref["w"]) < 1e-6
            assert _rel_err(got["blk"]["b"], ref["blk"]["b"]) < 1e-6
        p_jax = jax.tree.map(lambda p, d: p + d, p_jax, u_jax)
        p_t = {"w": p_t["w"] + u["w"], "blk": {"b": p_t["blk"]["b"] + u["blk"]["b"]}}


def test_train_step_flops_match_bench():
    """The port's copy of the analytic FLOP count equals ``bench.py``'s."""
    arch = port_params.BACKBONE_CONFIGS["ViT-B/16"]
    jarch = jax_params.BACKBONE_CONFIGS["ViT-B/16"]
    for kw in ({}, {"use_captions": False}):
        assert port_flagship.estimate_train_step_flops(arch, 512, 1000, 24, **kw) == \
            bench.estimate_train_step_flops(jarch, 512, 1000, 24, **kw)
    assert round(port_flagship.estimate_train_step_flops(arch, 512, 1000, 24) / 1e12, 1) == 42.3
