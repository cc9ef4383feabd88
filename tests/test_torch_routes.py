"""The port's routing gates against the JAX package's, on the CPU at the Tiny
width (width 128, 2 heads of 64, 3 vision blocks; in training blocks 0-1
are frozen and block 2 trains, as MaPLe's unfreeze policy has it).

The JAX package reads its gates (``FMM_TPU_FUSED``, ``FMM_TPU_FUSED_BLOCK``,
``FMM_TPU_FUSED_TRAIN``, ``FMM_TPU_FUSED_TRAIN_BLOCK``,
``FMM_TPU_FUSED_TRAIN_DW``) while it traces, so each test sets them with
``monkeypatch.setenv`` first, then clears JAX's caches and builds fresh
programs, so that no trace of another route is reused. The JAX kernels run
in interpret mode and the port's wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import federated_multi_modal_tpu.models.clip_model as jax_clip
import federated_multi_modal_tpu.ops.primitives as jax_prim
from federated_multi_modal_tpu import flagship as jax_flagship
from federated_multi_modal_tpu.engine.checkpoint import flatten_params
from federated_multi_modal_tpu.engine.trainer import merge_trees
from federated_multi_modal_tpu.models import params as jax_params
from federated_multi_modal_tpu.ops.pallas import attention as jax_attn
from federated_multi_modal_tpu.ops.pallas import fused_block as jax_fb
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path
from federated_multi_modal_tpu_torch.engine.tree import merge_trees as merge_port_trees
from federated_multi_modal_tpu_torch.models import clip_model as port_clip
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as port_fb

CFG = jax_params.tiny_test_config()

# The six gate settings and, per vision block, the kernels each package
# calls (the port's wrappers carry the JAX functions' names): eval blocks,
# then train blocks 0, 1 (frozen) and 2 (trainable).
K2, K5, K6 = ["packed_attention"], ["fused_block_residual"], [
    "fused_ln_attention_residual", "fused_ln_mlp_residual"]
K3, K4, K7 = ["fused_block_train"], ["fused_block_train_dw"], ["fused_ln_attention"]
GATES = {
    "defaults": ({}, [K5] * 3, [K3, K3, K4]),
    "fused_block_0": ({"FMM_TPU_FUSED_BLOCK": "0"}, [K6] * 3, [K3, K3, K4]),
    "sublayer_train": ({"FMM_TPU_FUSED_TRAIN": "1", "FMM_TPU_FUSED_TRAIN_BLOCK": "0"},
                       [K5] * 3, [K7, K7, K4]),
    "no_train_gates": ({"FMM_TPU_FUSED_TRAIN": "0", "FMM_TPU_FUSED_TRAIN_BLOCK": "0"},
                       [K5] * 3, [K4, K4, K4]),
    "train_dw_0": ({"FMM_TPU_FUSED_TRAIN_DW": "0"}, [K5] * 3, [K3, K3, K2]),
    "unfused": ({"FMM_TPU_FUSED": "0"}, [K2] * 3, [K2, K2, K2]),
}
SPIED = {
    jax_attn: ("packed_attention", "packed_attention_masked", "fused_attention_diff"),
    jax_fb: ("fused_block_residual", "fused_ln_attention_residual",
             "fused_ln_mlp_residual", "fused_block_train", "fused_block_train_dw",
             "fused_ln_attention"),
}
PORT_SPIED = {
    port_attn: ("packed_attention", "packed_attention_masked", "fused_attention_diff"),
    port_fb: ("fused_block_residual", "fused_ln_attention_residual",
              "fused_ln_mlp_residual", "fused_block_train", "fused_block_train_dw",
              "fused_ln_attention"),
}


def _gates(mp, name):
    """Set the JAX globals its trainers set (the pallas implementation, the
    "last" wgrad policy of ``build_maple_program``) and ``name``'s gates;
    restored through ``mp``."""
    mp.setattr(jax_prim, "_ATTENTION_IMPL", "pallas")
    mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", "last")
    mp.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)
    for var in ("FMM_TPU_FUSED", "FMM_TPU_FUSED_BLOCK", "FMM_TPU_FUSED_TRAIN",
                "FMM_TPU_FUSED_TRAIN_BLOCK", "FMM_TPU_FUSED_TRAIN_DW", "FMM_TPU_FUSED_NBLK"):
        mp.delenv(var, raising=False)
    for var, value in GATES[name][0].items():
        mp.setenv(var, value)
    jax.clear_caches()


def _spy(mp, spied):
    """Record, in order, each call of the functions named in ``spied``."""
    calls = []

    def wrap(name, fn):
        def spy(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return spy

    for module, names in spied.items():
        for name in names:
            mp.setattr(module, name, wrap(name, getattr(module, name)))
    return calls


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: the error each test reads."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def tower_inputs(programs):
    """The programs' fp32 vision weights in both packages, and seeded
    images, prompts (two shallow, two deep) and one caption token per
    image."""
    (_, trainable, frozen, _), (_, st) = programs
    rng = np.random.default_rng(70)
    w = CFG.vision_width
    return {
        "jax": merge_trees(trainable, frozen["model"])["clip"]["visual"],
        "port": merge_port_trees(st["trainable"], st["frozen"]["model"])["clip"]["visual"],
        "images": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
        "shallow": (rng.standard_normal((2, w)) * 0.1).astype(np.float32),
        "deep": [(rng.standard_normal((2, w)) * 0.1).astype(np.float32) for _ in range(2)],
        "extra": (rng.standard_normal((2, 1, w)) * 0.1).astype(np.float32),
    }


def _jax_tower_calls(mp, inp, inference):
    calls = _spy(mp, SPIED)
    kw = {} if inference else {"extra_tokens": jnp.asarray(inp["extra"])}
    jax.eval_shape(lambda: jax_clip.encode_image(
        inp["jax"], CFG, jnp.asarray(inp["images"]),
        shallow_prompts=jnp.asarray(inp["shallow"]),
        deep_prompts=[jnp.asarray(p) for p in inp["deep"]], inference=inference, **kw))
    return calls


def _port_tower_calls(mp, inp, inference):
    calls = _spy(mp, PORT_SPIED)
    params = inp["port"]
    if not inference:  # MaPLe trains every LayerNorm and the last block
        last = len(params["blocks"]) - 1
        params = tree_map_with_path(
            lambda path, t: t.detach().requires_grad_(
                "ln_" in path or path.startswith(f"blocks.{last}.")), params)
    kw = {} if inference else {"extra_tokens": torch.from_numpy(inp["extra"])}
    out = port_clip.encode_image(
        params, CFG, torch.from_numpy(inp["images"]),
        shallow_prompts=torch.from_numpy(inp["shallow"]),
        deep_prompts=[torch.from_numpy(p) for p in inp["deep"]], inference=inference, **kw)
    if not inference:
        out.sum().backward()
    return calls


@pytest.mark.parametrize("gates", list(GATES))
def test_every_vision_block_takes_the_jax_kernel(gates, tower_inputs, monkeypatch):
    """For each gate setting, the kernel the JAX package calls for each
    vision block, in eval and in training, against the port's counterpart,
    block by block, and both against the table ``GATES``."""
    _gates(monkeypatch, gates)
    _, want_eval, want_train = GATES[gates]
    for inference, want in ((True, want_eval), (False, want_train)):
        with monkeypatch.context() as mp:
            jax_calls = _jax_tower_calls(mp, tower_inputs, inference)
        with monkeypatch.context() as mp:
            port_calls = _port_tower_calls(mp, tower_inputs, inference)
        assert jax_calls == [k for block in want for k in block], (inference, jax_calls)
        assert port_calls == jax_calls, (inference, port_calls)


# The grouped eval tower (``FMM_TPU_FUSED_NBLK > 1``: K9 with the deep
# prompts and the caption token injected inside each group) against the JAX
# package's ``encode_image`` under the same gate, on Tiny CLIP weights with
# two deep prompts and one extra token per image, as max |error| over max
# |value| of the image features. fp32 reads 4.7e-7 under both group sizes.
# bf16 reads 1.4e-3 (NBLK=2) and 2.5e-3 (NBLK=3), a flipped bf16 rounding of
# an intermediate; the per-block path, which rounds the stream to bf16 at
# every block boundary where the group keeps it in fp32 (the port's fault
# before K9), reads 4.3e-3 and 5.1e-3 against the same JAX features, so the
# bf16 tolerance of 2**-8 (3.9e-3) tells the two apart.
TOL_GROUP = {"float32": 1e-5, "bfloat16": 2 ** -8}


@pytest.fixture(scope="module")
def clip_weights():
    """Tiny CLIP in fp32 and under the bf16 policy, in both packages."""
    out = {}
    for dtype, policy in (("float32", False), ("bfloat16", True)):
        jp = jax_params.init_clip_params(CFG, jax.random.PRNGKey(1), dtype_policy=policy)
        out[dtype] = (jp, port_params.load_jax_params(flatten_params(jp), device="cpu"))
    return out


def test_group_gate_is_refused_on_the_card(tower_inputs, monkeypatch):
    """The group route is refused where the JAX package refuses it, on the
    card as on the CPU, and both packages then run the blocks one by one:
    without ``FMM_TPU_FUSED_NBLK``, with per-sample deep prompts (K5 per
    block) and under ``FMM_TPU_FUSED_BLOCK=0`` (no whole-block kernel, no
    group: K6a and K6b per block). The predicate takes batch-shared deep
    prompts at the whole-block shapes."""
    inp = tower_inputs
    w, heads, hidden = CFG.vision_width, CFG.vision_heads, 4 * CFG.vision_width
    shared = [torch.zeros(2, w)]
    _gates(monkeypatch, "defaults")
    assert not port_fb.fused_block_group_eligible(2, 7, w, heads, hidden, shared)
    monkeypatch.setenv("FMM_TPU_FUSED_NBLK", "2")
    assert port_fb.fused_block_group_eligible(2, 7, w, heads, hidden, shared)
    assert not port_fb.fused_block_group_eligible(2, 7, w, heads, hidden, [shared[0][None]])

    per_sample = [np.repeat(p[None], 2, axis=0) for p in inp["deep"]]
    # the group route calls none of these (JAX's fused_block_residual is
    # itself a group of one, so the group function is not spied)
    spied = ("fused_block_residual", "fused_ln_attention_residual", "fused_ln_mlp_residual")
    for gates, deep, want in (("defaults", per_sample, K5 * 3),
                              ("fused_block_0", inp["deep"], K6 * 3)):
        _gates(monkeypatch, gates)
        monkeypatch.setenv("FMM_TPU_FUSED_NBLK", "2")
        with monkeypatch.context() as mp:
            calls = _spy(mp, {jax_fb: spied})
            jax.eval_shape(lambda: jax_clip.encode_image(
                inp["jax"], CFG, jnp.asarray(inp["images"]),
                shallow_prompts=jnp.asarray(inp["shallow"]),
                deep_prompts=[jnp.asarray(p) for p in deep], inference=True))
        assert calls == want, (gates, calls)
        with monkeypatch.context() as mp:
            calls = _spy(mp, {port_fb: spied})
            port_clip.encode_image(
                inp["port"], CFG, torch.from_numpy(inp["images"]),
                shallow_prompts=torch.from_numpy(inp["shallow"]),
                deep_prompts=[torch.from_numpy(p) for p in deep], inference=True)
        assert calls == want, (gates, calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nblk", ["2", "3"])
def test_grouped_tower_matches_jax(nblk, dtype, clip_weights, tower_inputs, monkeypatch):
    """Under ``FMM_TPU_FUSED_NBLK``, both packages call the group kernel once
    per group of the three blocks (groups 0-1 and 2, or 0-2), and the port's
    image features match JAX's (the port's plain group version on the CPU,
    JAX's kernel in interpret mode)."""
    jp, pp = clip_weights[dtype]
    inp = tower_inputs
    _gates(monkeypatch, "defaults")
    monkeypatch.setenv("FMM_TPU_FUSED_NBLK", nblk)
    jax.clear_caches()

    def port_tower():
        return port_clip.encode_image(
            pp["visual"], CFG, torch.from_numpy(inp["images"]),
            shallow_prompts=torch.from_numpy(inp["shallow"]),
            deep_prompts=[torch.from_numpy(p) for p in inp["deep"]],
            extra_tokens=torch.from_numpy(inp["extra"]), inference=True)

    groups = ["fused_block_group_residual"] * (2 if nblk == "2" else 1)
    with monkeypatch.context() as mp:
        calls = _spy(mp, {jax_fb: ("fused_block_residual", "fused_block_group_residual")})
        ref = jax_clip.encode_image(
            jp["visual"], CFG, jnp.asarray(inp["images"]),
            shallow_prompts=jnp.asarray(inp["shallow"]),
            deep_prompts=[jnp.asarray(p) for p in inp["deep"]],
            extra_tokens=jnp.asarray(inp["extra"]), inference=True)
    assert calls == groups, calls
    with monkeypatch.context() as mp:
        calls = _spy(mp, {port_fb: ("fused_block_residual", "fused_block_group_residual")})
        got = port_tower()
    assert calls == groups, calls
    assert _rel_err(got, ref) < TOL_GROUP[dtype]
    if dtype == "bfloat16":
        monkeypatch.setenv("FMM_TPU_FUSED_NBLK", "1")
        assert _rel_err(port_tower(), ref) > TOL_GROUP[dtype]


def test_unpackable_heads_take_fused_attention_diff(monkeypatch):
    """``multi_head_attention`` with 32-wide heads, 3 of them (no 128-lane
    packing): at T >= 32 both packages call ``fused_attention_diff`` (K8),
    with and without a causal mask, and the outputs and the input gradient
    match (fp32: at most 6.1e-7 and 7.3e-7; tolerance 1e-5); at T < 32
    both take the plain formulation."""
    from federated_multi_modal_tpu_torch.ops import primitives as port_prim

    _gates(monkeypatch, "defaults")
    rng = np.random.default_rng(71)
    D, n_head = 96, 3
    p = {"w_qkv": rng.standard_normal((D, 3 * D)) * D ** -0.5,
         "b_qkv": rng.standard_normal(3 * D) * 0.1,
         "w_out": rng.standard_normal((D, D)) * D ** -0.5, "b_out": rng.standard_normal(D) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    for T, masked, want in ((40, False, ["fused_attention_diff"]),
                            (40, True, ["fused_attention_diff"]), (20, True, [])):
        x = rng.standard_normal((2, T, D)).astype(np.float32)
        g = rng.standard_normal((2, T, D)).astype(np.float32)
        mask = port_prim.build_causal_mask(T) if masked else None
        with monkeypatch.context() as mp:
            calls = _spy(mp, {jax_attn: ("fused_attention_diff",)})
            out_ref, vjp = jax.vjp(lambda x_: jax_prim.multi_head_attention(
                x_, {k: jnp.asarray(v) for k, v in p.items()}, n_head,
                None if mask is None else jnp.asarray(mask.numpy())), jnp.asarray(x))
            (dx_ref,) = vjp(jnp.asarray(g))
        assert calls == want, (T, masked, calls)
        with monkeypatch.context() as mp:
            calls = _spy(mp, {port_attn: ("fused_attention_diff",)})
            xt = torch.from_numpy(x).requires_grad_(True)
            out = port_prim.multi_head_attention(
                xt, {k: torch.from_numpy(v) for k, v in p.items()}, n_head, mask)
            (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
        assert calls == want, (T, masked, calls)
        assert _rel_err(out, out_ref) < 1e-5
        assert _rel_err(dx, dx_ref) < 1e-5


# The Tiny MaPLe program in fp32, where the point is the algorithm: the same
# weights, batch (captions on) and constants in both packages, under the
# same gates. The errors read, as max |error| over max |value|: the loss
# 3.8e-7 (relative) under both train routes, the gradients at most 8.0e-6
# (unfused) and 8.5e-6 (sublayer train), both on
# ``prompt_learner.caption_pool_w``; the eval logits 1.3e-6 (unfused) and
# 1.4e-6 (two-kernel block). The tolerances are those of
# ``test_torch_train.py``, five to seven times the readings:
LOSS_RTOL = 2e-6
GRAD_TOL = 5e-5
LOGITS_TOL = 1e-5


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x,
        tree)


@pytest.fixture(scope="module")
def programs():
    """The Tiny programs of both packages on the JAX weights, in fp32, and a
    batch. Built once: the gates are read when a program is traced (JAX) or
    run (the port), not when it is built."""
    with pytest.MonkeyPatch.context() as mp:
        _gates(mp, "defaults")
        prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0)
    trainable, frozen = _fp32(prog["trainable"]), _fp32(prog["frozen"])
    batch = jax_flagship.example_batch(prog["arch"], batch_size=3, n_cls=10)
    batch["image"] = batch["image"].astype(jnp.float32)
    port = port_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0, device="cpu")
    port_state = {
        "trainable": port_params.load_jax_params(flatten_params(trainable), device="cpu"),
        "frozen": {
            "model": port_params.load_jax_params(flatten_params(frozen["model"]), device="cpu"),
            "prompt_const": port_params.load_jax_params(
                {k: np.asarray(v) for k, v in frozen["prompt_const"].items()}, device="cpu"),
        },
        "batch": port_params.load_jax_params(
            {k: np.asarray(v) for k, v in batch.items()}, device="cpu"),
    }
    return (prog, trainable, frozen, batch), (port, port_state)


@pytest.mark.parametrize("gates,kernel", [("unfused", K2), ("sublayer_train", K7)])
def test_loss_and_every_gradient_match_jax(gates, kernel, programs, monkeypatch):
    """The loss and the gradient of every trainable leaf under the two new
    train routes, with the port's vision blocks counted: the unfused route
    sends all three through the plain block and ``packed_attention``; the
    sublayer route sends blocks 0-1 through ``fused_ln_attention`` and
    block 2 through ``fused_block_train_dw``. The JAX step is traced anew
    under the gates (``jax.jit`` of a fresh function, caches cleared)."""
    (prog, trainable, frozen, batch), (port, st) = programs
    _gates(monkeypatch, gates)
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda t: prog["loss_fn"](t, frozen, batch)[0]))(trainable)
    ref = flatten_params(grads_ref)

    calls = _spy(monkeypatch, {port_fb: ("fused_ln_attention", "fused_block_train_dw"),
                               port_attn: ("packed_attention",)})
    tr = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), st["trainable"])
    flat = flatten(tr)
    loss, _ = port["loss_fn"](tr, st["frozen"], st["batch"])
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    assert calls == (kernel * 3 if gates == "unfused" else K7 * 2 + K4), calls

    assert abs(loss.item() - float(loss_ref)) <= LOSS_RTOL * abs(float(loss_ref))
    assert set(flat) == set(ref)
    errs = {}
    for name, g in zip(flat, grads):
        if g is None:  # a leaf the loss never reaches (proj_vis_to_lang)
            assert not np.asarray(ref[name]).any(), name
            continue
        errs[name] = _rel_err(g, ref[name])
    assert "clip.visual.blocks.0.ln_1.scale" in errs
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("gates,kernels", [("unfused", K2), ("fused_block_0", K6)])
def test_eval_logits_match_jax(gates, kernels, programs, monkeypatch):
    """The prompt-cached eval path (text features once, then the image
    tower with ``inference=True``) under the two new eval routes."""
    (prog, trainable, frozen, batch), (port, st) = programs
    _gates(monkeypatch, gates)
    prep = jax.jit(prog["eval_prepare_fn"])(trainable, frozen)
    ref = jax.jit(prog["eval_apply_fn"])(trainable, frozen, batch["image"], prep)

    calls = _spy(monkeypatch, PORT_SPIED)
    prep_t = port["eval_prepare_fn"](st["trainable"], st["frozen"])
    calls.clear()
    got = port["eval_apply_fn"](st["trainable"], st["frozen"], st["batch"]["image"], prep_t)
    assert calls == kernels * CFG.vision_layers, calls
    assert got.shape == (3, 10)
    assert _rel_err(got, ref) < LOGITS_TOL
