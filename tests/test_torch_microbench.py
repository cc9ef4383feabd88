"""The port of ``tools/attn_microbench.py`` against the JAX tool, and the
port's ``"xla"`` attention implementation against the JAX package's, on the
CPU at small sizes.

The prototypes P1-P3 run as the JAX package's own tests run them: in
interpret mode on the CPU (``tests/test_pallas.py``), imported from
``tools/``; the port's wrappers run their plain versions on CPU tensors.
Inputs are made with numpy from a seed and handed to both.
"""

import sys
from pathlib import Path

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
from federated_multi_modal_tpu.ops.pallas import attention as jax_attn
from federated_multi_modal_tpu.ops.pallas import fused_block as jax_fb
from federated_multi_modal_tpu_torch import flagship as port_flagship
from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path
from federated_multi_modal_tpu_torch.models import params as port_params
from federated_multi_modal_tpu_torch.ops import primitives as port_prim
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as port_fb
from federated_multi_modal_tpu_torch.ops.kernels import prototypes as port_proto
from federated_multi_modal_tpu_torch.tools import attn_microbench as port_bench

sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))
import attn_microbench as jax_bench  # noqa: E402

CFG = jax_params.tiny_test_config()
TOL = 2e-5  # the JAX tests' own tolerance for the prototypes in fp32


def _lnqkv_inputs(seed, B=8, T=16, D=128):
    r = np.random.default_rng(seed)
    f = np.float32
    return {"x": r.standard_normal((B, T, D)).astype(f),
            "scale": (r.standard_normal(D) * 0.1 + 1).astype(f),
            "bias": (r.standard_normal(D) * 0.1).astype(f),
            "w": (r.standard_normal((D, 3 * D)) * 0.05).astype(f),
            "b": (r.standard_normal(3 * D) * 0.05).astype(f),
            "dy": r.standard_normal((B, T, D)).astype(f)}


def _as_jax(inp, dtype=jnp.float32):
    return ({k: jnp.asarray(v, dtype) for k, v in inp.items() if k not in ("scale", "bias")},
            {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])})


def _as_port(inp, dtype=torch.float32):
    return ({k: torch.from_numpy(v).to(dtype) for k, v in inp.items()
             if k not in ("scale", "bias")},
            {"scale": torch.from_numpy(inp["scale"]), "bias": torch.from_numpy(inp["bias"])})


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def test_p1_plain_matches_jax_interpret():
    """P1's plain version against ``fused_lnqkv_attention(..., interpret=True)``
    at B 8, T 16, D 128, 2 heads: fp32 at 2e-5; bf16 no further from the
    fp32 result (on the same bf16 inputs) than twice JAX's own distance."""
    inp = _lnqkv_inputs(0)
    jt, jl = _as_jax(inp)
    pt, pl = _as_port(inp)
    ref = jax_bench.fused_lnqkv_attention(jt["x"], jl, jt["w"], jt["b"], 2, GB=4, interpret=True)
    got = port_proto.fused_lnqkv_attention(pt["x"], pl, pt["w"], pt["b"], 2, GB=4)
    np.testing.assert_allclose(_f32(got), np.asarray(ref), atol=TOL, rtol=TOL)

    jb, _ = _as_jax(inp, jnp.bfloat16)
    exact = np.asarray(jax_bench.fused_lnqkv_attention(
        *(jb[k].astype(jnp.float32) for k in ("x",)), jl, jb["w"].astype(jnp.float32),
        jb["b"].astype(jnp.float32), 2, interpret=True))
    jax_bf16 = np.asarray(jax_bench.fused_lnqkv_attention(
        jb["x"], jl, jb["w"], jb["b"], 2, interpret=True), np.float32)
    pb, _ = _as_port(inp, torch.bfloat16)
    port_bf16 = port_proto.fused_lnqkv_attention(pb["x"], pl, pb["w"], pb["b"], 2)
    assert port_bf16.dtype == torch.bfloat16
    jax_err = np.abs(jax_bf16 - exact).max()
    assert 0 < jax_err and np.abs(_f32(port_bf16) - exact).max() <= 2 * jax_err


def test_p2_plain_matches_jax_interpret():
    """P2's plain version (dx only, recomputed from x) against
    ``fused_lnqkv_attention_bwd_dx(..., interpret=True)``, fp32 at 2e-5."""
    inp = _lnqkv_inputs(1)
    jt, jl = _as_jax(inp)
    pt, pl = _as_port(inp)
    ref = jax_bench.fused_lnqkv_attention_bwd_dx(jt["x"], jl, jt["w"], jt["b"], jt["dy"], 2,
                                                 GB=4, interpret=True)
    got = port_proto.fused_lnqkv_attention_bwd_dx(pt["x"], pl, pt["w"], pt["b"], pt["dy"], 2)
    np.testing.assert_allclose(_f32(got), np.asarray(ref), atol=TOL, rtol=TOL)


def test_autograd_function_dx_matches_jax_custom_vjp():
    """dx of :class:`FusedLnQkvAttention` (P1 forward, P2 backward) against
    ``jax.grad`` through ``make_fused_lnqkv_attention_fb``, fp32 at 2e-5."""
    inp = _lnqkv_inputs(2, B=4)
    jt, jl = _as_jax(inp)
    pt, pl = _as_port(inp)
    fused = jax_bench.make_fused_lnqkv_attention_fb(2, GB=2, interpret=True)
    ref = jax.grad(lambda x: jnp.sum(fused(x, jl, jt["w"], jt["b"]) * jt["dy"]))(jt["x"])
    x = pt["x"].requires_grad_(True)
    out = port_proto.make_fused_lnqkv_attention_fb(2, GB=2)(x, pl, pt["w"], pt["b"])
    (got,) = torch.autograd.grad(out, x, pt["dy"])
    np.testing.assert_allclose(_f32(got), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("leaf", ["scale", "w", "b"])
def test_autograd_function_refuses_trainable_parameters(leaf):
    """The JAX custom VJP returns zeros for the LayerNorm, ``w`` and ``b``;
    the port refuses any of them that requires a gradient."""
    pt, pl = _as_port(_lnqkv_inputs(3, B=4))
    if leaf == "scale":
        pl["scale"].requires_grad_(True)
    else:
        pt[leaf].requires_grad_(True)
    op = port_proto.make_fused_lnqkv_attention_fb(2, GB=2)
    with pytest.raises(ValueError, match="no gradient"):
        op(pt["x"].requires_grad_(True), pl, pt["w"], pt["b"])


@pytest.mark.parametrize("fn", ["fwd", "bwd_dx"])
@pytest.mark.parametrize("B,T,GB", [(8, 12, 4), (6, 16, 4)], ids=["T%8", "B%GB"])
def test_prototype_asserts_raise_where_jax_does(fn, B, T, GB):
    inp = _lnqkv_inputs(4, B=B, T=T)
    jt, jl = _as_jax(inp)
    pt, pl = _as_port(inp)
    if fn == "fwd":
        jax_call = lambda: jax_bench.fused_lnqkv_attention(  # noqa: E731
            jt["x"], jl, jt["w"], jt["b"], 2, GB=GB, interpret=True)
        port_call = lambda: port_proto.fused_lnqkv_attention(  # noqa: E731
            pt["x"], pl, pt["w"], pt["b"], 2, GB=GB)
    else:
        jax_call = lambda: jax_bench.fused_lnqkv_attention_bwd_dx(  # noqa: E731
            jt["x"], jl, jt["w"], jt["b"], jt["dy"], 2, GB=GB, interpret=True)
        port_call = lambda: port_proto.fused_lnqkv_attention_bwd_dx(  # noqa: E731
            pt["x"], pl, pt["w"], pt["b"], pt["dy"], 2, GB=GB)
    with pytest.raises(AssertionError):
        jax_call()
    with pytest.raises(ValueError, match="T % 8 == 0 and B % GB == 0"):
        port_call()


@pytest.mark.parametrize("T,tpad", [(16, 8), (16, 16), (13, 8), (13, 16)])
def test_p3_plain_matches_jax_interpret(T, tpad, monkeypatch):
    """P3's plain version against ``_build_packed4d(tpad=...)`` in interpret
    mode, fp32 at 2e-5. The JAX tool calls ``_pick_gb`` without its ``hp``
    argument, which the function has since gained (a fault of the JAX tool:
    its ``packed4d`` lines fail); the test supplies ``hp``, which chooses the
    TPU tiling only."""
    pick_gb = jax_attn._pick_gb
    monkeypatch.setattr(jax_attn, "_pick_gb",
                        lambda B, Tp, dtype, hp=2: pick_gb(B, Tp, dtype, hp))
    r = np.random.default_rng(5)
    qkv = r.standard_normal((4, T, 3 * 256)).astype(np.float32)
    ref = jax_bench._build_packed4d(tpad=tpad)(jnp.asarray(qkv), 4)
    got = port_proto.packed4d_attention(torch.from_numpy(qkv), 4, tpad)
    assert got.shape == (4, T, 256)
    np.testing.assert_allclose(_f32(got), np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("hd,T", [(32, 16), (32, 13), (128, 16), (128, 13)])
def test_p3_plain_matches_jax_interpret_head_widths(hd, T, monkeypatch):
    """P3's plain version against ``_build_packed4d()`` in interpret mode at
    head widths 32 and 128 (four heads of 32 or one of 128 to each 128-lane
    group, two groups), fp32 at 2e-5, the widths the CUDA kernel's warps
    split a group into. The test supplies ``_pick_gb``'s missing ``hp`` (as
    above) as ``_packed_hp`` gives it for the width."""
    n_head = 256 // hd
    hp = jax_attn._packed_hp(256, n_head)
    assert hp == 128 // hd
    pick_gb = jax_attn._pick_gb
    monkeypatch.setattr(jax_attn, "_pick_gb",
                        lambda B, Tp, dtype, hp=hp: pick_gb(B, Tp, dtype, hp))
    r = np.random.default_rng(hd + T)
    qkv = r.standard_normal((2, T, 3 * 256)).astype(np.float32)
    ref = jax_bench._build_packed4d()(jnp.asarray(qkv), n_head)
    got = port_proto.packed4d_attention(torch.from_numpy(qkv), n_head)
    assert got.shape == (2, T, 256)
    np.testing.assert_allclose(_f32(got), np.asarray(ref), atol=TOL, rtol=TOL)


def test_jax_tool_packed4d_misses_hp():
    """The fault the P3 test works around, pinned so that a repaired JAX tool
    shows here."""
    qkv = jnp.zeros((4, 16, 3 * 256), jnp.float32)
    with pytest.raises(TypeError, match="hp"):
        jax_bench._build_packed4d()(qkv, 4)


# -- the "xla" attention implementation -----------------------------------------

ALL_WRAPPERS = {
    port_attn: ("packed_attention", "packed_attention_masked", "fused_attention",
                "fused_attention_diff"),
    port_fb: ("fused_block_residual", "fused_ln_attention_residual", "fused_ln_mlp_residual",
              "fused_block_train", "fused_block_train_dw", "fused_ln_attention",
              "fused_block_group_residual"),
    port_proto: ("fused_lnqkv_attention", "fused_lnqkv_attention_bwd_dx",
                 "packed4d_attention"),
}


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
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _jax_globals(mp, impl):
    mp.setattr(jax_prim, "_ATTENTION_IMPL", impl)
    mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", "last")
    mp.setattr(jax_clip, "_TEXT_PACK_DEFAULT", True)
    for var in ("FMM_TPU_FUSED", "FMM_TPU_FUSED_BLOCK", "FMM_TPU_FUSED_TRAIN",
                "FMM_TPU_FUSED_TRAIN_BLOCK", "FMM_TPU_FUSED_TRAIN_DW", "FMM_TPU_FUSED_NBLK"):
        mp.delenv(var, raising=False)
    jax.clear_caches()


def _fp32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.inexact) else x, tree)


@pytest.fixture(scope="module")
def xla_results():
    """The Tiny MaPLe program of the JAX package under ``"xla"``: the loss,
    every gradient and the eval logits, in fp32 (where the point is the
    algorithm) and under the bf16 policy, on one batch; and its weights."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _jax_globals(mp, "xla")
        prog = jax_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0)
        batch = jax_flagship.example_batch(prog["arch"], batch_size=3, n_cls=10)
        for dtype in ("float32", "bfloat16"):
            tr, fr, bt = prog["trainable"], prog["frozen"], dict(batch)
            if dtype == "float32":
                tr, fr = _fp32(tr), _fp32(fr)
                bt["image"] = bt["image"].astype(jnp.float32)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda t, f, b: prog["loss_fn"](t, f, b)[0]))(tr, fr, bt)
            prep = jax.jit(prog["eval_prepare_fn"])(tr, fr)
            logits = jax.jit(prog["eval_apply_fn"])(tr, fr, bt["image"], prep)
            out[dtype] = {
                "flat_trainable": flatten_params(tr), "flat_frozen": flatten_params(fr["model"]),
                "prompt_const": {k: np.asarray(v) for k, v in fr["prompt_const"].items()},
                "batch": {k: np.asarray(v) for k, v in bt.items()},
                "loss": float(loss), "grads": flatten_params(grads),
                "logits": np.asarray(logits, np.float32)}
        mp.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", None)
    return out


def _port_run(res):
    """The port's Tiny program on ``res``'s weights and batch: the loss,
    every gradient and the eval logits."""
    prog = port_flagship.build_maple_program(backbone="Tiny", depth=3, seed=0, device="cpu")
    tr = port_params.load_jax_params(res["flat_trainable"], device="cpu")
    fr = {"model": port_params.load_jax_params(res["flat_frozen"], device="cpu"),
          "prompt_const": port_params.load_jax_params(res["prompt_const"], device="cpu")}
    batch = port_params.load_jax_params(res["batch"], device="cpu")
    tr = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), tr)
    flat = flatten(tr)
    loss, _ = prog["loss_fn"](tr, fr, batch)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    prep = prog["eval_prepare_fn"](tr, fr)
    logits = prog["eval_apply_fn"](tr, fr, batch["image"], prep)
    return loss, dict(zip(flat, grads)), logits


# fp32 tolerances of tests/test_torch_routes.py; in bf16 the port is held to
# no more than twice JAX's distance from the fp32 result, as in
# tests/test_torch_train.py (XLA keeps fused elementwise chains in fp32,
# PyTorch rounds after each operation). The loss is one scalar, and JAX's
# distance on it one draw: on this batch 2.4e-4 against the port's 3.9e-3
# (1.2e-3 relative, the same under "pallas"), so it is held to the larger of
# twice JAX's distance and one bf16 step of its value (2**-8 relative). The
# logits read 0.91 and the gradients at most 1.86 times JAX's distance.
LOSS_RTOL = 2e-6
GRAD_TOL = 5e-5
LOGITS_TOL = 1e-5
BF16_ERROR_RATIO = 2.0
BF16_LOSS_RTOL = 2.0 ** -8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_route_matches_jax_and_calls_no_kernel(dtype, xla_results, monkeypatch):
    """Under ``set_attention_impl("xla")`` the Tiny MaPLe loss, every
    trainable gradient and the eval logits match the JAX package's under
    its ``"xla"``, and no kernel wrapper of the port is called."""
    monkeypatch.setattr(port_prim, "_ATTENTION_IMPL", port_prim.attention_impl())
    port_prim.set_attention_impl("xla")
    calls = _spy(monkeypatch, ALL_WRAPPERS)
    res = xla_results[dtype]
    loss, grads, logits = _port_run(res)
    assert calls == []
    assert logits.shape == (3, 10)
    if dtype == "float32":
        assert abs(loss.item() - res["loss"]) <= LOSS_RTOL * abs(res["loss"])
        assert _rel_err(logits, res["logits"]) < LOGITS_TOL
        errs = {k: _rel_err(g, res["grads"][k]) for k, g in grads.items() if g is not None}
        assert "clip.visual.blocks.2.attn.w_qkv" in errs
        worst = max(errs, key=errs.get)
        assert errs[worst] < GRAD_TOL, (worst, errs[worst])
        return
    exact = xla_results["float32"]
    assert abs(loss.item() - exact["loss"]) <= max(
        BF16_ERROR_RATIO * abs(res["loss"] - exact["loss"]), BF16_LOSS_RTOL * abs(exact["loss"]))
    jax_err = _rel_err(torch.from_numpy(res["logits"]), exact["logits"])
    assert _rel_err(logits, exact["logits"]) <= BF16_ERROR_RATIO * jax_err
    for name, g in grads.items():
        if g is None:
            continue
        ref = exact["grads"][name]
        jax_err = _rel_err(torch.from_numpy(np.asarray(res["grads"][name], np.float32)), ref)
        assert _rel_err(g, ref) <= BF16_ERROR_RATIO * jax_err, name


def test_attention_impl_defaults_to_pallas():
    """The port's default is ``"pallas"`` (the JAX package's module default
    is ``"xla"``); other names raise."""
    assert port_prim.attention_impl() == "pallas"
    assert jax_prim._ATTENTION_IMPL in ("xla", "pallas")
    with pytest.raises(ValueError, match="xla"):
        port_prim.set_attention_impl("flash")


# -- the microbench's routes and lines -------------------------------------------


def test_microbench_block_and_tower_take_k4_as_jax(monkeypatch):
    """The JAX tool's ``block`` line calls ``residual_block(x, p, H)`` and its
    ``tower`` line ``encode_image`` with no frozen-weight declaration, so
    each mask-free block takes ``fused_block_train_dw`` (K4); the port's
    microbench routes its ``block`` and ``tower`` lines there too, and never
    to K3 or K5."""
    _jax_globals(monkeypatch, "pallas")
    monkeypatch.setattr(jax_prim, "_VISION_ATTN_WGRAD_BLOCKS", None)
    jp = jax_params.init_clip_params(CFG, jax.random.PRNGKey(0))
    spied = ("fused_block_train", "fused_block_train_dw", "fused_block_residual")
    with monkeypatch.context() as mp:
        calls = _spy(mp, {jax_fb: spied})
        x = jnp.zeros((4, 16, CFG.vision_width), jnp.bfloat16)
        jax.eval_shape(lambda: jax_prim.residual_block(x, jp["visual"]["blocks"][0], 2))
        jax.eval_shape(lambda: jax_clip.encode_image(
            jp["visual"], CFG, jnp.zeros((2, 32, 32, 3), jnp.bfloat16),
            shallow_prompts=jnp.zeros((2, CFG.vision_width)),
            deep_prompts=[jnp.zeros((2, CFG.vision_width))] * 8))
    assert calls == ["fused_block_train_dw"] * (1 + CFG.vision_layers), calls

    args = port_bench.parse_args("--mode block --batch 4 --t 16 --d 128 --heads 2 --iters 1 "
                                 "--only block,tower --fwd-only".split())
    with monkeypatch.context() as mp:
        calls = _spy(mp, {port_fb: spied})
        assert port_bench.run_block(args, torch.device("cpu"), CFG) == []
    # block: a warm-up and a timed chain of one block; tower: the same of
    # Tiny's three blocks
    assert calls == ["fused_block_train_dw"] * (2 + 2 * CFG.vision_layers), calls


def test_microbench_attn_runs_every_variant_on_the_cpu(capsys):
    args = port_bench.parse_args("--batch 4 --t 16 --d 128 --heads 2 --iters 1".split())
    assert port_bench.run_attn(args, torch.device("cpu")) == []
    out = capsys.readouterr().out
    for name in ("null", "xla", "packed", "packed4d", "packed4d_par", "pad208", "pad256",
                 "flash"):
        assert f"\n{name:14s} fwd " in out, name
    assert "FAILED" not in out
    assert out.count("fwd+bwd") == 4


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_microbench_block_runs_every_line_on_the_cpu(impl, capsys, monkeypatch):
    monkeypatch.setattr(port_prim, "_ATTENTION_IMPL", port_prim.attention_impl())
    args = port_bench.parse_args(f"--mode block --batch 4 --t 16 --d 128 --heads 2 --iters 1 "
                                 f"--attention {impl}".split())
    assert port_bench.run_block(args, torch.device("cpu"), CFG) == []
    out = capsys.readouterr().out
    for name in ("ln", "gelu", "mlp", "attn_sub", "block", "block_noln", "block_lnfuse",
                 "attn_path", "attn_fusedp", "attn_fused", "block12", "block12u", "inject",
                 "block12i", "tower", "patchify"):
        assert f"\n{name:12s} fwd " in out, name
    assert "attn_fused max|diff| vs attn_path" in out
    assert "FAILED" not in out


def test_microbench_reports_a_failed_line(capsys, monkeypatch):
    """A variant that raises prints its ``FAILED`` line, the others still
    run, and ``main`` exits non-zero."""
    def broken(qkv, n_head, tpad=8):
        raise RuntimeError("planted")

    monkeypatch.setattr(port_proto, "packed4d_attention", broken)
    rc = port_bench.main("--platform cpu --batch 4 --t 16 --d 128 --heads 2 --iters 1 "
                         "--variants null,packed4d,packed".split())
    out = capsys.readouterr().out
    assert rc == 1
    assert "packed4d       fwd FAILED: RuntimeError: planted" in out
    assert "\npacked         fwd " in out


def test_microbench_parts_runs_on_the_cpu(capsys, monkeypatch):
    """``parts`` at Tiny: every line, with MaPLe's vision blocks on K3 and
    the last on K4 in the training lines."""
    args = port_bench.parse_args("--mode parts --batch 2 --n-cls 4 --iters 1".split())
    with monkeypatch.context() as mp:
        calls = _spy(mp, {port_fb: ("fused_block_train", "fused_block_train_dw")})
        assert port_bench.run_parts(args, torch.device("cpu"), backbone="Tiny", depth=3) == []
    out = capsys.readouterr().out
    for label in ("preproc", "vision fwd", "vision fwd+bwd", "text fwd+bwd", "full loss fwd",
                  "full loss fwd+bwd"):
        assert f"\n{label} " in "\n" + out, label
    assert "FAILED" not in out
    assert calls[:3] == ["fused_block_train", "fused_block_train", "fused_block_train_dw"]
