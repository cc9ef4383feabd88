"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode (the CPU backend selects it, ``attention.py:194-197``),
as ``tests/test_pallas.py`` runs them. Inputs are made with numpy from a
seed and handed to both.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from federated_multi_modal_tpu.ops.pallas import attention as jax_attn
from federated_multi_modal_tpu.ops.pallas import fused_block as jax_fb
from federated_multi_modal_tpu.ops.primitives import (
    build_block_causal_mask as jax_block_causal_mask,
)
from federated_multi_modal_tpu_torch.models.params import tiny_test_config
from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as port_fb
from federated_multi_modal_tpu_torch.ops.primitives import build_block_causal_mask


@pytest.mark.parametrize("P,Tb", [(4, 8), (3, 10)], ids=["T32", "T30"])
def test_packed_attention_masked_matches_jax(P, Tb):
    """K1 in fp32; T=30 is not a multiple of 8, so the JAX kernel pads and
    masks keys while the port needs no padding. Tolerance 2e-4 as
    ``test_pallas.py``'s masked packed-attention test."""
    rng = np.random.default_rng(0)
    d, n_head, B = 128, 2, 4
    T = P * Tb
    qkv = rng.standard_normal((B, T, 3 * d)).astype(np.float32)
    mask = build_block_causal_mask(P, Tb)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jax_block_causal_mask(P, Tb)))

    ref = jax_attn.attention_packed_fwd_masked(
        jnp.asarray(qkv), jnp.asarray(mask.numpy()), n_head)
    got = port_attn.packed_attention_masked(torch.from_numpy(qkv), mask, n_head)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def _block(rng, D):
    def vec(n, s=0.05):
        return (rng.standard_normal(n) * s).astype(np.float32)

    def mat(shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return {
        "ln_1": {"scale": vec(D, 0.1) + 1, "bias": vec(D, 0.1)},
        "ln_2": {"scale": vec(D, 0.1) + 1, "bias": vec(D, 0.1)},
        "attn": {"w_qkv": mat((D, 3 * D)), "b_qkv": vec(3 * D),
                 "w_out": mat((D, D)), "b_out": vec(D)},
        "mlp": {"w_fc": mat((D, 4 * D)), "b_fc": vec(4 * D),
                "w_proj": mat((4 * D, D)), "b_proj": vec(D)},
    }


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _bf16(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("T", [8, 13])
def test_fused_block_residual_matches_jax_fp32(T):
    """K5 in fp32 at D=128, 2 heads, hidden 512; T=13 makes the JAX kernel
    pad to 16. Tolerance 2e-5 as ``test_pallas.py``'s whole-block test."""
    rng = np.random.default_rng(1)
    B, D, H = 4, 128, 2
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    p = _block(rng, D)

    ref = jax_fb.fused_block_residual(jnp.asarray(x), _map(jnp.asarray, p), H)
    got = port_fb.fused_block_residual(
        torch.from_numpy(x), _map(torch.from_numpy, p), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_fused_block_residual_matches_jax_bf16():
    """K5 with bf16 activations and weights (LayerNorm params fp32), as the
    eval path runs it. Both sides round qkv, the attention output, both LN
    outputs and the hidden activation to bf16 at the same points, but sum
    in different orders, so a rounding can flip; a flip at the output is
    one bf16 step, 2**-8 relative (0.0039 x |value|). Tolerance: two steps
    relative, 2**-7, plus 2**-7 absolute for values near zero."""
    rng = np.random.default_rng(2)
    B, T, D, H = 2, 13, 128, 2
    x = _bf16(rng.standard_normal((B, T, D)))
    p = _block(rng, D)
    p_bf16 = {k: (v if k.startswith("ln") else _map(_bf16, v)) for k, v in p.items()}

    ref = jax_fb.fused_block_residual(jnp.asarray(x), _map(jnp.asarray, p_bf16), H)

    def to_torch(a):
        t = torch.from_numpy(np.asarray(a, np.float32))
        return t.to(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else t

    got = port_fb.fused_block_residual(to_torch(x), _map(to_torch, p_bf16), H)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2 ** -7, rtol=2 ** -7)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers call their plain versions: no launch is
    counted and no kernel library is built."""
    rng = np.random.default_rng(3)
    counters = (port_attn.packed_attention_masked, port_fb.fused_block_residual,
                port_attn.fused_attention, port_fb.fused_block_group_residual)
    before = ([fn.launches for fn in counters], dict(_build.LAUNCHES))
    qkv = torch.from_numpy(rng.standard_normal((2, 32, 384)).astype(np.float32))
    mask = build_block_causal_mask(4, 8)
    torch.testing.assert_close(
        port_attn.packed_attention_masked(qkv, mask, 2),
        port_attn.packed_attention_masked_reference(qkv, mask, 2),
        rtol=0, atol=0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(np.float32))
    p = _map(torch.from_numpy, _block(rng, 128))
    torch.testing.assert_close(port_fb.fused_block_residual(x, p, 2),
                               port_fb.fused_block_residual_reference(x, p, 2),
                               rtol=0, atol=0)
    q = qkv[..., :128]
    torch.testing.assert_close(port_attn.fused_attention(q, q, q, 2, mask),
                               port_attn.fused_attention_reference(q, q, q, 2, mask),
                               rtol=0, atol=0)
    prompt = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    torch.testing.assert_close(
        port_fb.fused_block_group_residual(x, [p, p], 2, (False, True), [prompt]),
        port_fb.fused_block_group_residual_reference(x, [p, p], 2, (False, True), [prompt]),
        rtol=0, atol=0)
    after = ([fn.launches for fn in counters], dict(_build.LAUNCHES))
    assert after == before
    assert _build._lib is None


def test_wrappers_refuse_gradients():
    """The inference block has no backward, like the TPU kernel: an ``x``
    that needs a gradient is refused. The text attention now has its
    backward (K1b), so a ``qkv`` that needs a gradient goes through its
    autograd function, whose backward is the plain one on the CPU."""
    qkv = torch.zeros(1, 32, 384, requires_grad=True)
    out = port_attn.packed_attention_masked(qkv, build_block_causal_mask(4, 8), 2)
    assert type(out.grad_fn).__name__ == "_PackedAttentionBackward"
    x = torch.zeros(1, 8, 128, requires_grad=True)
    p = _map(torch.from_numpy, _block(np.random.default_rng(4), 128))
    with pytest.raises(NotImplementedError):
        port_fb.fused_block_residual(x, p, 2)


def _to_torch(a):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if np.asarray(a).dtype == ml_dtypes.bfloat16 else t


def _rel_err(got, ref):
    """max |got - ref| over max |ref|: the error each test reads."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# K1b, the masked attention backward: the JAX kernel's d(QKV) against the
# plain version's on the same qkv, cotangent and mask, as max |error| over
# max |value|. fp32 reads 2.0e-7 (sums in other orders); bf16 reads 6.6e-4
# (both round dS and P at the same points, so only a flipped rounding
# differs, a fraction of one bf16 step, 2**-8 = 3.9e-3, of the largest
# value). Tolerances about ten times that.
TOL_K1B = {"float32": 2e-6, "bfloat16": 2 ** -8}


@pytest.mark.parametrize("P,Tb,dtype", [(4, 8, "float32"), (3, 10, "float32"),
                                        (5, 24, "bfloat16")],
                         ids=["T32", "T30", "T120_bf16"])
def test_packed_attention_masked_bwd_matches_jax(P, Tb, dtype):
    """T=30 is not a multiple of 8: the JAX kernel pads the tokens and sets
    the padded keys to -inf; the port needs no padding."""
    rng = np.random.default_rng(11)
    d, n_head, B = 128, 2, 3
    T = P * Tb
    qkv = rng.standard_normal((B, T, 3 * d)).astype(np.float32)
    g = rng.standard_normal((B, T, d)).astype(np.float32)
    if dtype == "bfloat16":
        qkv, g = _bf16(qkv), _bf16(g)
    mask = build_block_causal_mask(P, Tb)

    ref = jax_attn.attention_packed_bwd_masked(
        jnp.asarray(qkv), jnp.asarray(g), jnp.asarray(mask.numpy()), n_head)
    _, vjp = jax.vjp(lambda t: jax_attn.packed_attention_masked(
        t, jnp.asarray(mask.numpy()), n_head), jnp.asarray(qkv))
    np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0], np.float32),
                                  np.asarray(ref, np.float32))

    qkv_t = _to_torch(qkv).requires_grad_(True)
    out = port_attn.packed_attention_masked(qkv_t, mask, n_head)
    (got,) = torch.autograd.grad(out, qkv_t, _to_torch(g))
    assert got.dtype == qkv_t.dtype
    assert _rel_err(got, ref) < TOL_K1B[dtype]


# K1b and K2b at the head widths the CUDA backward opened (it was built for
# 64 only): four heads of 32 and two of 128, whole 128-lane groups as the
# JAX kernels' ``_packed_hp`` requires, masked (block-causal, three packed
# prompts of 8 and 10 tokens) and not, T = 24 and 30 (off the multiple of
# 8: the JAX kernel pads the tokens and masks the padded keys). The port's
# plain backward through ``packed_attention(_masked)``'s autograd against
# ``attention_packed_bwd(_masked)`` in interpret mode, at TOL_K1B: the
# same rounding points, sums in other orders (see TOL_K1B above).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["K2b", "K1b"])
@pytest.mark.parametrize("hd", [32, 128])
def test_packed_attention_bwd_head_widths_32_128_match_jax(hd, masked, dtype):
    rng = np.random.default_rng(hd + 3 * masked)
    n_head = 256 // hd
    P, Tb = (3, 8) if hd == 32 else (3, 10)
    T = P * Tb
    qkv = rng.standard_normal((2, T, 3 * 256)).astype(np.float32)
    g = rng.standard_normal((2, T, 256)).astype(np.float32)
    if dtype == "bfloat16":
        qkv, g = _bf16(qkv), _bf16(g)
    qkv_t = _to_torch(qkv).requires_grad_(True)
    if masked:
        mask = build_block_causal_mask(P, Tb)
        ref = jax_attn.attention_packed_bwd_masked(
            jnp.asarray(qkv), jnp.asarray(g), jnp.asarray(mask.numpy()), n_head)
        out = port_attn.packed_attention_masked(qkv_t, mask, n_head)
    else:
        ref = jax_attn.attention_packed_bwd(jnp.asarray(qkv), jnp.asarray(g), n_head)
        out = port_attn.packed_attention(qkv_t, n_head)
    (got,) = torch.autograd.grad(out, qkv_t, _to_torch(g))
    assert got.dtype == qkv_t.dtype and got.shape == (2, T, 3 * 256)
    err = _rel_err(got, ref)
    assert err < TOL_K1B[dtype], err


# K3 and K4, the whole-block train kernels, at D=128, 2 heads, hidden 512:
# the output, dx and every parameter gradient of the JAX kernel's VJP
# against the port's plain version, as max |error| over max |value|. fp32
# reads at most 5.0e-7. bf16 reads 9.9e-4 on K3's dx (a flipped rounding
# of one bf16 intermediate, a quarter of a bf16 step of the largest value)
# and at most 3.4e-5 on the fp32 parameter gradients, which sum bf16
# products over the rows. Tolerances: (activations, parameter gradients).
# The planted fault below reads 2.0e-3 to 5.1e-3 on the parameter
# gradients and 4.0e-3 on dx.
TOL_TRAIN = {"float32": (5e-6, 5e-6), "bfloat16": (2 ** -8, 2e-4)}


def _train_case(T, dtype, wgrad):
    rng = np.random.default_rng(12 + T)
    B, D = 2, 128
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dy = rng.standard_normal((B, T, D)).astype(np.float32)
    p = _block(rng, D)
    if dtype == "bfloat16":
        x, dy = _bf16(x), _bf16(dy)
        if not wgrad:  # frozen blocks hold bf16 weights, trainable ones fp32
            p = {k: (v if k.startswith("ln") else _map(_bf16, v)) for k, v in p.items()}
    return x, dy, p


@functools.lru_cache(maxsize=None)
def _jax_train_block(T, dtype, wgrad):
    """The JAX kernel's output and VJP (interpret mode on the CPU)."""
    x, dy, p = _train_case(T, dtype, wgrad)
    fn = jax_fb.fused_block_train_dw if wgrad else jax_fb.fused_block_train
    out, vjp = jax.vjp(lambda x_, p_: fn(x_, p_, 2), jnp.asarray(x), _map(jnp.asarray, p))
    dx, dp = vjp(jnp.asarray(dy))
    grads = {(a, b): np.asarray(dp[a][b], np.float32) for a, b in port_fb.BLOCK_LEAVES}
    return np.asarray(out, np.float32), np.asarray(dx, np.float32), grads


def _port_train_block(T, dtype, wgrad):
    x, dy, p = _train_case(T, dtype, wgrad)
    xt = _to_torch(x).requires_grad_(True)
    pt = {k: {n: _to_torch(a).requires_grad_(k.startswith("ln") or wgrad)
              for n, a in v.items()} for k, v in p.items()}
    fn = port_fb.fused_block_train_dw if wgrad else port_fb.fused_block_train
    out = fn(xt, pt, 2)
    names = [(a, b) for a, b in port_fb.BLOCK_LEAVES if pt[a][b].requires_grad]
    got = torch.autograd.grad(out, [xt] + [pt[a][b] for a, b in names], _to_torch(dy))
    assert got[0].dtype == xt.dtype
    return out, got[0], dict(zip(names, got[1:]))


@pytest.mark.parametrize("T,dtype", [(13, "bfloat16"), (8, "float32")])
@pytest.mark.parametrize("wgrad", [False, True], ids=["K3", "K4"])
def test_fused_block_train_matches_jax(T, dtype, wgrad):
    """T=13 makes the JAX kernels pad to 16 and mask the padded keys. K3
    gives LayerNorm gradients only (the JAX VJP gives zeros for the
    weights); K4 all twelve."""
    ref_out, ref_dx, ref_grads = _jax_train_block(T, dtype, wgrad)
    out, dx, grads = _port_train_block(T, dtype, wgrad)
    assert len(grads) == (12 if wgrad else 4)
    if not wgrad:
        assert all(not ref_grads[name].any() for name in port_fb.WEIGHT_LEAVES)
    tol_act, tol_param = TOL_TRAIN[dtype]
    act = {"out": _rel_err(out, ref_out), "dx": _rel_err(dx, ref_dx)}
    param = {".".join(n): _rel_err(g, ref_grads[n]) for n, g in grads.items()}
    assert max(act.values()) < tol_act, act
    assert max(param.values()) < tol_param, param


def _round_h_for_quick_gelu_grad(gemm):
    def faulty(*args, dgelu_of=None, **kwargs):
        if dgelu_of is not None:
            dgelu_of = dgelu_of.to(torch.bfloat16)
        return gemm(*args, dgelu_of=dgelu_of, **kwargs)
    return faulty


def test_fused_block_train_dw_comparison_sees_planted_fault(monkeypatch):
    """K4 reads QuickGELU' of the fp32 h it recomputes (K3 of the bf16 h it
    saved). Planting K3's rounding into K4's plain version must break the
    comparison with JAX at the bf16 tolerance."""
    monkeypatch.setattr(port_fb, "PLAIN_STEPS", port_fb.PLAIN_STEPS._replace(
        gemm=_round_h_for_quick_gelu_grad(port_fb.gemm_epilogue_reference)))
    ref_out, ref_dx, ref_grads = _jax_train_block(13, "bfloat16", True)
    _, _, grads = _port_train_block(13, "bfloat16", True)
    errs = {".".join(n): _rel_err(g, ref_grads[n]) for n, g in grads.items()}
    assert max(errs.values()) > TOL_TRAIN["bfloat16"][1], errs


def test_frozen_weight_kernel_refuses_trainable_weights():
    """K3 returns no weight gradients, so it refuses a block whose attention
    or MLP weights require one (the TPU kernel would silently return
    zeros); the routing sends such a block to K4."""
    from federated_multi_modal_tpu_torch.ops.primitives import residual_block

    rng = np.random.default_rng(5)
    p = _map(torch.from_numpy, _block(rng, 128))
    p["mlp"]["b_fc"].requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="fused_block_train_dw"):
        port_fb.fused_block_train(x, p, 2)
    out = residual_block(x, p, 2)
    assert type(out.grad_fn).__name__ == "_FusedBlockTrainBackward"
    (g,) = torch.autograd.grad(out.sum(), p["mlp"]["b_fc"])
    assert g.abs().sum() > 0


def test_cuda_steps_are_kernels_only():
    """The CUDA path of the train blocks runs hand-written kernels only: no
    step of it is a plain version."""
    for step in port_fb.CUDA_STEPS:
        assert step.__name__.endswith("_cuda"), step.__name__
    for step in port_fb.PLAIN_STEPS:
        assert step.__name__.endswith("_reference"), step.__name__


# K2 and K2b, the mask-free packed attention of the unfused vision route:
# the JAX kernel's output and VJP against the port's plain version on the
# same qkv and cotangent, as max |error| over max |value|. T=7 and T=13 are
# off the multiple of 8, so the JAX kernels pad the tokens and set the
# padded keys to -inf; the port needs no padding. fp32 reads at most
# 3.8e-7 (sums in another order); bf16 reads 0 on both (P and dS rounded at
# the same points). Tolerances: about ten times the fp32 reading, and in
# bf16 one bf16 step (2**-8) of the largest value, for a flipped rounding.
TOL_K2 = {"float32": 5e-6, "bfloat16": 2 ** -8}


def _attention_case(T, dtype, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((3, T, 3 * 128)).astype(np.float32)
    g = rng.standard_normal((3, T, 128)).astype(np.float32)
    if dtype == "bfloat16":
        qkv, g = _bf16(qkv), _bf16(g)
    return qkv, g


@pytest.mark.parametrize("T,dtype", [(7, "float32"), (8, "float32"), (13, "bfloat16")])
def test_packed_attention_matches_jax(T, dtype):
    qkv, g = _attention_case(T, dtype, 40 + T)
    out_ref, vjp = jax.vjp(lambda t: jax_attn.packed_attention(t, 2), jnp.asarray(qkv))
    (dqkv_ref,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(
        np.asarray(out_ref, np.float32),
        np.asarray(jax_attn.attention_packed_fwd(jnp.asarray(qkv), 2), np.float32))

    qkv_t = _to_torch(qkv).requires_grad_(True)
    out = port_attn.packed_attention(qkv_t, 2)
    (dqkv,) = torch.autograd.grad(out, qkv_t, _to_torch(g))
    assert out.dtype == dqkv.dtype == qkv_t.dtype
    errs = {"out": _rel_err(out, out_ref), "dqkv": _rel_err(dqkv, dqkv_ref)}
    assert max(errs.values()) < TOL_K2[dtype], errs


# The forward at the shapes the tensor-core attention_core.cu opened on the
# card: T past its earlier 512-token cap, and head widths 32 and 128 (four
# heads of 32, one or two of 128, so that the heads fill whole 128-lane
# groups as the JAX kernels' ``_packed_hp`` requires). The card holds the
# kernel to attention_core_reference; here that plain version is held to
# ``attention_packed_fwd`` and ``attention_packed_fwd_masked`` in interpret
# mode, as max |error| over max |value|, at TOL_K2: fp32 reads at most
# 9.9e-7 (sums in another order), bf16 1.2e-3 (p rounded at the same point,
# a flipped rounding where the fp32 softmax differs in its last bits). T =
# 517 is off the multiple of 8, so the JAX kernel pads the tokens and masks
# the keys.
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("T,n_head,hd,dtype", [
    (520, 4, 32, "float32"), (517, 2, 128, "float32"), (520, 1, 128, "bfloat16"),
    (517, 4, 32, "bfloat16")])
def test_attention_core_reference_matches_jax_past_the_old_limits(T, n_head, hd, dtype, masked):
    rng = np.random.default_rng(T + hd)
    qkv = rng.standard_normal((1, T, 3 * n_head * hd)).astype(np.float32)
    if dtype == "bfloat16":
        qkv = _bf16(qkv)
    if masked:
        mask = np.triu(np.full((T, T), -np.inf, np.float32), k=1)
        ref = jax_attn.attention_packed_fwd_masked(jnp.asarray(qkv), jnp.asarray(mask), n_head)
        got = port_attn.attention_core_reference(_to_torch(qkv), n_head, torch.from_numpy(mask))
    else:
        ref = jax_attn.attention_packed_fwd(jnp.asarray(qkv), n_head)
        got = port_attn.attention_core_reference(_to_torch(qkv), n_head)
    assert got.shape == (1, T, n_head * hd)
    err = _rel_err(got, ref)
    assert err < TOL_K2[dtype], err


# K6a and K6b, the two-kernel eval block, at D=128, 2 heads, hidden 512, as
# max |error| over max |value|: fp32 reads at most 2.3e-7. In bf16 both
# round qkv, the attention output, LN2's output and the hidden activation
# at the same points and the output once; K6a reads 9.7e-4 (a flipped
# rounding, a quarter of one bf16 step of the largest value) and K6b 0.
# Tolerances: about twenty times the fp32 reading; two bf16 steps.
TOL_K6 = {"float32": 5e-6, "bfloat16": 2 ** -7}


def _frozen_block(rng, D, dtype):
    p = _block(rng, D)
    if dtype == "bfloat16":
        p = {k: (v if k.startswith("ln") else _map(_bf16, v)) for k, v in p.items()}
    return p


@pytest.mark.parametrize("T,dtype", [(13, "float32"), (7, "bfloat16")])
def test_two_kernel_block_matches_jax(T, dtype):
    rng = np.random.default_rng(50 + T)
    x = rng.standard_normal((3, T, 128)).astype(np.float32)
    x = _bf16(x) if dtype == "bfloat16" else x
    p = _frozen_block(rng, 128, dtype)
    pj, pt = _map(jnp.asarray, p), _map(_to_torch, p)

    y_ref = jax_fb.fused_ln_attention_residual(jnp.asarray(x), pj["ln_1"], pj["attn"], 2)
    out_ref = jax_fb.fused_ln_mlp_residual(y_ref, pj["ln_2"], pj["mlp"])
    y = port_fb.fused_ln_attention_residual(_to_torch(x), pt["ln_1"], pt["attn"], 2)
    # K6b alone on the JAX kernel's y, so its error is its own
    out = port_fb.fused_ln_mlp_residual(_to_torch(np.asarray(y_ref)), pt["ln_2"], pt["mlp"])
    assert y.dtype == out.dtype == _to_torch(x).dtype
    errs = {"K6a": _rel_err(y, y_ref), "K6b": _rel_err(out, out_ref)}
    assert max(errs.values()) < TOL_K6[dtype], errs


# K7, the sublayer train kernel: the output and dx, d gamma, d beta of the
# JAX kernel's VJP against the port's plain version, as max |error| over max
# |value|. fp32 reads at most 5.8e-7. bf16 reads 0 on the output, 1.6e-4
# on dx (a flipped rounding of a bf16 d(QKV) term) and 1.4e-7 on the fp32
# LayerNorm gradients, sums over the rows that average such flips out.
# Tolerances (output and dx, LayerNorm gradients): about ten times the fp32
# reading; in bf16 two bf16 steps of the largest value and 1e-4.
TOL_K7 = {"float32": (5e-6, 5e-6), "bfloat16": (2 ** -7, 1e-4)}


def _ln_attention_case(T, dtype):
    rng = np.random.default_rng(60 + T)
    x = rng.standard_normal((2, T, 128)).astype(np.float32)
    dy = rng.standard_normal((2, T, 128)).astype(np.float32)
    p = _frozen_block(rng, 128, dtype)
    if dtype == "bfloat16":
        x, dy = _bf16(x), _bf16(dy)
    return x, dy, p


@pytest.mark.parametrize("T,dtype", [(7, "float32"), (13, "bfloat16")])
def test_fused_ln_attention_matches_jax(T, dtype):
    x, dy, p = _ln_attention_case(T, dtype)
    pj = _map(jnp.asarray, p)
    out_ref, vjp = jax.vjp(
        lambda x_, ln_: jax_fb.fused_ln_attention(
            x_, ln_, pj["attn"]["w_qkv"], pj["attn"]["b_qkv"], 2),
        jnp.asarray(x), pj["ln_1"])
    dx_ref, dln_ref = vjp(jnp.asarray(dy))

    pt = _map(_to_torch, p)
    xt = _to_torch(x).requires_grad_(True)
    ln = {k: v.requires_grad_(True) for k, v in pt["ln_1"].items()}
    out = port_fb.fused_ln_attention(xt, ln, pt["attn"]["w_qkv"], pt["attn"]["b_qkv"], 2)
    dx, dg, db = torch.autograd.grad(out, [xt, ln["scale"], ln["bias"]], _to_torch(dy))
    assert dx.dtype == xt.dtype and dg.dtype == db.dtype == torch.float32
    tol_act, tol_ln = TOL_K7[dtype]
    act = {"out": _rel_err(out, out_ref), "dx": _rel_err(dx, dx_ref)}
    ln_errs = {"scale": _rel_err(dg, dln_ref["scale"]), "bias": _rel_err(db, dln_ref["bias"])}
    assert max(act.values()) < tol_act, act
    assert max(ln_errs.values()) < tol_ln, ln_errs


def test_fused_ln_attention_refuses_trainable_qkv():
    """K7 returns no gradient for w_qkv and b_qkv (the TPU kernel returns
    zeros), so it refuses either when it requires one."""
    x, _, p = _ln_attention_case(7, "float32")
    pt = _map(torch.from_numpy, p)
    for leaf in ("w_qkv", "b_qkv"):
        w, b = pt["attn"]["w_qkv"].clone(), pt["attn"]["b_qkv"].clone()
        (w if leaf == "w_qkv" else b).requires_grad_(True)
        with pytest.raises(ValueError, match="fused_block_train_dw"):
            port_fb.fused_ln_attention(torch.from_numpy(x), pt["ln_1"], w, b, 2)


def test_two_kernel_block_refuses_gradients():
    """K6a and K6b are forward-only, like the TPU kernels."""
    p = _map(torch.from_numpy, _block(np.random.default_rng(7), 128))
    x = torch.zeros(1, 8, 128, requires_grad=True)
    with pytest.raises(NotImplementedError):
        port_fb.fused_ln_attention_residual(x, p["ln_1"], p["attn"], 2)
    with pytest.raises(NotImplementedError):
        port_fb.fused_ln_mlp_residual(x, p["ln_2"], p["mlp"])


# K9, the block-group eval kernel: JAX's kernel in interpret mode against
# the port's plain version over the schedule of ``test_pallas.py``'s group
# tests (six blocks at D=128, 2 heads, hidden 512, four deep prompts of two
# rows, groups of ``G`` blocks, the last possibly shorter), as max |error|
# over max |value|. fp32 reads at most 4.4e-7; in bf16 (activations and
# weights, LayerNorms fp32) both keep the stream in fp32 inside a group and
# round at the same points, and flipped roundings read 2.9e-3 and 2.5e-3.
# The tolerances are those of the K5 tests: 2e-5 in fp32, 2**-7 in bf16.
TOL_K9 = {"float32": 2e-5, "bfloat16": 2 ** -7}


def _group_case(T, dtype, n_extra, seed):
    rng = np.random.default_rng(seed)
    B, D, N, n_ctx, dp = 4, 128, 6, 2, 4
    blocks = [_frozen_block(rng, D, dtype) for _ in range(N)]
    prompts = [(rng.standard_normal((n_ctx, D)) * 0.3).astype(np.float32) for _ in range(dp)]
    extra = (rng.standard_normal((B, n_extra, D)) * 0.3).astype(np.float32) if n_extra else None
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    return x, blocks, prompts, extra


@pytest.mark.parametrize("T,G,dtype,n_extra", [
    (16, 3, "float32", 0), (16, 2, "float32", 0), (10, 2, "float32", 0),
    (16, 2, "float32", 1), (10, 2, "bfloat16", 0), (16, 3, "bfloat16", 1)])
def test_fused_block_group_matches_jax(T, G, dtype, n_extra):
    """T=10 makes the JAX kernel pad to 16; ``n_extra`` per-sample rows are
    re-injected with every deep prompt (the caption branch)."""
    x, blocks, prompts, extra = _group_case(T, dtype, n_extra, 80 + T + G)
    xj, xt = jnp.asarray(x), _to_torch(x)
    for s in range(0, len(blocks), G):
        grp = blocks[s:s + G]
        flags = tuple(1 <= s + j <= len(prompts) for j in range(len(grp)))
        pvs = [prompts[s + j - 1] for j in range(len(grp)) if flags[j]]
        ex = extra if any(flags) else None
        xj = jax_fb.fused_block_group_residual(
            xj, tuple(_map(jnp.asarray, b) for b in grp), 2, inject_flags=flags,
            prompts=tuple(jnp.asarray(p) for p in pvs),
            extra=None if ex is None else jnp.asarray(ex))
        xt = port_fb.fused_block_group_residual(
            xt, [_map(_to_torch, b) for b in grp], 2, flags,
            [torch.from_numpy(p) for p in pvs], None if ex is None else torch.from_numpy(ex))
    assert xt.dtype == _to_torch(x).dtype
    assert _rel_err(xt, xj) < TOL_K9[dtype]


def test_fused_block_group_checks_its_arguments():
    """As the JAX kernel: ``extra`` without a True flag and a prompt count
    other than the flags' raise; an ``x`` that needs a gradient is refused
    (forward-only)."""
    x, blocks, prompts, extra = _group_case(8, "float32", 1, 90)
    xt = torch.from_numpy(x)
    bt = [_map(torch.from_numpy, b) for b in blocks[:2]]
    pt = [torch.from_numpy(p) for p in prompts]
    with pytest.raises(ValueError, match="extra"):
        port_fb.fused_block_group_residual(xt, bt, 2, (False, False), (),
                                           torch.from_numpy(extra))
    with pytest.raises(ValueError, match="prompts"):
        port_fb.fused_block_group_residual(xt, bt, 2, (False, True), pt[:2])
    with pytest.raises(NotImplementedError):
        port_fb.fused_block_group_residual(xt.requires_grad_(True), bt, 2)


def test_inject_rows_reference_writes_the_tail():
    """The trailing ``n_ctx + n_extra`` rows take the prompt (every sample)
    then the extra rows, widened to fp32; the rows before stay."""
    stream = torch.zeros(3, 9, 16)
    prompt = torch.randn(2, 16).to(torch.bfloat16)
    extra = torch.randn(3, 1, 16).to(torch.bfloat16)
    port_fb.inject_rows_reference(stream, prompt, extra)
    assert not stream[:, :6].any()
    torch.testing.assert_close(stream[:, 6:8], prompt.float()[None].expand(3, 2, 16))
    torch.testing.assert_close(stream[:, 8:], extra.float())


# K8, split-head attention: JAX's ``fused_attention`` in interpret mode
# against the port's plain version on the same q, k and v, with heads of 96
# and 80 (no 128-lane packing), T=77 (the JAX kernel pads to 80 and masks the
# padded keys) and T=199, with the causal mask and without, as max |error|
# over max |value|. fp32 reads at most 7.2e-7 on the output and 1.0e-6 on the
# gradients of ``fused_attention_diff`` (the plain formulation's VJP on both
# sides); bf16 at most 1.5e-3 and 1.8e-3 (a flipped rounding of p or of a
# bf16 cotangent term). Tolerances: about twenty times the fp32 reading, and
# two bf16 steps.
TOL_K8 = {"float32": 2e-5, "bfloat16": 2 ** -7}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("T,hd,dtype", [(77, 96, "float32"), (199, 80, "float32"),
                                        (77, 80, "bfloat16"), (199, 96, "bfloat16")])
def test_fused_attention_matches_jax(T, hd, dtype, masked):
    from federated_multi_modal_tpu.ops.primitives import build_causal_mask as jax_causal_mask

    rng = np.random.default_rng(100 + T + hd)
    B, n_head = 2, 2
    q, k, v, g = (rng.standard_normal((B, T, n_head * hd)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    mask = jax_causal_mask(T) if masked else None
    qj, kj, vj = (jnp.asarray(t) for t in (q, k, v))
    ref = jax_attn.fused_attention(qj, kj, vj, n_head, mask)
    out_ref, vjp = jax.vjp(lambda a, b, c: jax_attn.fused_attention_diff(a, b, c, n_head, mask),
                           qj, kj, vj)
    np.testing.assert_array_equal(np.asarray(out_ref, np.float32), np.asarray(ref, np.float32))
    grads_ref = vjp(jnp.asarray(g))

    mask_t = None if mask is None else torch.from_numpy(np.asarray(mask))
    qt, kt, vt = (_to_torch(t).requires_grad_(True) for t in (q, k, v))
    got = port_attn.fused_attention(*(t.detach() for t in (qt, kt, vt)), n_head, mask_t)
    out = port_attn.fused_attention_diff(qt, kt, vt, n_head, mask_t)
    torch.testing.assert_close(out, got, rtol=0, atol=0)
    grads = torch.autograd.grad(out, (qt, kt, vt), _to_torch(g))
    assert all(gr.dtype == qt.dtype for gr in grads)
    errs = {"out": _rel_err(got, ref),
            **{n: _rel_err(gr, r) for n, gr, r in zip("qkv", grads, grads_ref)}}
    assert max(errs.values()) < TOL_K8[dtype], errs


def test_multi_head_attention_pallas_matches_jax():
    """The drop-in over ``fused_attention`` (fp32, 2 heads of 80, T=40,
    causal): reads 4.0e-7; tolerance 1e-5."""
    from federated_multi_modal_tpu.ops.primitives import build_causal_mask as jax_causal_mask

    rng = np.random.default_rng(120)
    D, T = 160, 40
    p = {"w_qkv": rng.standard_normal((D, 3 * D)) * D ** -0.5, "b_qkv": rng.standard_normal(3 * D),
         "w_out": rng.standard_normal((D, D)) * D ** -0.5, "b_out": rng.standard_normal(D)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    mask = jax_causal_mask(T)
    ref = jax_attn.multi_head_attention_pallas(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, 2, mask)
    got = port_attn.multi_head_attention_pallas(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, 2,
        torch.from_numpy(np.asarray(mask)))
    assert _rel_err(got, ref) < 1e-5


def test_fused_attention_refuses_gradients():
    """``fused_attention`` is forward-only, like the TPU kernel;
    ``fused_attention_diff`` is its differentiable form."""
    q = torch.zeros(1, 8, 80, requires_grad=True)
    with pytest.raises(NotImplementedError, match="fused_attention_diff"):
        port_attn.fused_attention(q, q, q, 1)
    out = port_attn.fused_attention_diff(q, q, q, 1)
    assert type(out.grad_fn).__name__ == "_FusedAttentionDiffBackward"


# The products a block hands to gemm_epilogue.cu: the plain steps with the
# product recorded as ``GemmProduct.key`` has it, at tiny_test_config()'s
# vision width (D 128, 2 heads, hidden 512) in bf16, against the table of
# ``block_gemm_products`` that chip_smoke.py's product phase times at
# ViT-B/16's widths.
def _recording_steps(records):
    def gemm(a, w, bias=None, residual=None, gelu=False, out_dtype=None, trans_w=False,
             dgelu_of=None, pre_dtype=None):
        M, K = a.shape
        N = w.shape[0] if trans_w else w.shape[1]
        records.append((port_fb._NT if trans_w else port_fb._NN, M, N, K, port_fb.epilogue_code(
            bias is not None, gelu, pre_dtype, port_fb._dtype(dgelu_of),
            port_fb._dtype(residual), out_dtype or a.dtype)))
        return port_fb.gemm_epilogue_reference(a, w, bias, residual, gelu, out_dtype, trans_w,
                                               dgelu_of, pre_dtype)

    def gemm_tn(a, b):
        records.append((port_fb._TN, a.shape[1], b.shape[1], a.shape[0],
                        port_fb.epilogue_code(out=torch.float32)))
        return port_fb.gemm_tn_reference(a, b)

    return port_fb.PLAIN_STEPS._replace(gemm=gemm, gemm_tn=gemm_tn)


@pytest.mark.parametrize("run", ["eval", "forward", "forward_save_h", "backward",
                                 "backward_wgrad"])
def test_block_products_are_the_table(run):
    """Each pass of the block runs exactly the table's products, in order,
    with its layouts, widths and epilogues; the forward comes to 24 M D^2
    operations, K3's backward to 26 and K4's to 58 (out-projection and fc
    recomputed: 2 + 8; dh, dxn2, da, dyln1: 8 + 8 + 2 + 6; the weight
    gradients: 6 + 2 + 8 + 8); every product is a built instance."""
    arch = tiny_test_config()
    D, H, hidden = arch.vision_width, arch.vision_heads, 4 * arch.vision_width
    B, T = 2, arch.num_patches + 1
    M = B * T
    rng = np.random.default_rng(0)
    p = _map(lambda a: torch.from_numpy(a).to(torch.bfloat16), _block(rng, D))
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).to(torch.bfloat16)
    records = []
    steps = _recording_steps(records)
    if run == "eval":
        port_fb._block(x, p, H, steps.layernorm, steps.gemm, steps.attention)
    else:
        wgrad = run == "backward_wgrad"
        _, qkv, h = port_fb.block_train_forward(x, p, H, steps,
                                                save_h=run == "forward_save_h" or run == "backward")
        if run.startswith("backward"):
            records.clear()
            port_fb.block_train_backward(x, dy, p, H, qkv, h, steps, wgrad)
    table = port_fb.block_gemm_products(M, D, hidden)["forward" if run == "eval" else run]
    assert records == [prod.key for prod in table]
    per_md2 = {"eval": 24, "forward": 24, "forward_save_h": 24, "backward": 26,
               "backward_wgrad": 58}[run]
    assert sum(prod.flops for prod in table) == per_md2 * M * D * D
    assert all((prod.layout, prod.code) in port_fb.GEMM_INSTANCES for prod in table)


@pytest.mark.parametrize("M,N,K,plan", [
    (768, 2304, 102400, (7, 14656)), (768, 768, 102400, (7, 14656)),
    (768, 3072, 102400, (9, 11392)), (3072, 768, 102400, (9, 11392)),
    (768, 3072, 5000, (1, 5056)), (8, 8, 37, (1, 64)), (136, 264, 1000, (8, 128)),
    (1024, 3072, 133120, (8, 16640)), (1024, 1024, 133120, (8, 16640)),
    (1024, 4096, 133120, (5, 26624)), (4096, 1024, 133120, (5, 26624))])
def test_tn_split_plan(M, N, K, plan):
    """The weight gradient's split of its contraction at the kernel's K step
    of 64: every split but the last is whole steps, the splits cover K and
    none is empty. The four ViT-B/16 weight gradients (102,400 rows) take 7 and 9 splits
    on 132 SMs; ViT-L/14's (133,120 rows) 8 and 5, no split chaining more
    than ``_MAX_SPLIT_STEPS`` steps (one split of 2,080 would fill the card
    as well, 128 tiles on 132 SMs)."""
    splits, k_per = port_fb.tn_split_plan(M, N, K, 132)
    assert (splits, k_per) == plan
    assert k_per % port_fb._BK == 0 and splits * k_per >= K > (splits - 1) * k_per
    assert k_per <= port_fb._MAX_SPLIT_STEPS * port_fb._BK


@pytest.mark.parametrize("rows,sms,per_sm,blocks", [
    (102400, 132, 2, 264), (102400, 132, 3, 396), (102401, 132, 2, 264), (3, 132, 2, 1),
    (513, 132, 2, 129), (1, 1, 1, 1), (2000, 7, 5, 35)])
def test_ln_bwd_plan(rows, sms, per_sm, blocks):
    """The LayerNorm backward's persistent grid: one wave of every block that
    fits (whole waves on 132 SMs at the main path's 102,400 rows), fewer
    where the rows do not fill them; warp w of the grid takes rows w, w +
    stride, ..., so every row is covered exactly once, and each block
    writes one partial."""
    got, stride = port_fb.ln_bwd_plan(rows, sms, per_sm)
    assert got == blocks and stride == blocks * port_fb._LN_WARPS
    covered = np.zeros(rows, np.int64)
    for w in range(stride):
        covered[w::stride] += 1
    assert (covered == 1).all()
    if rows >= sms * per_sm * port_fb._LN_WARPS:
        assert blocks == sms * per_sm and blocks % sms == 0
    with pytest.raises(ValueError):
        port_fb.ln_bwd_plan(rows, sms, 0)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("instance", ["LN2", "LN1"])
def test_layernorm_bwd_rows_reference_matches_jax(instance, residual):
    """The plain LayerNorm backward against the JAX package's LayerNorm
    (``ops/primitives.py::layer_norm`` on fp32 x) differentiated by
    ``jax.vjp``, plus the residual branch: LN2's dtypes (fp32 x, bf16 dres,
    fp32 dx and its bf16 copy) and LN1's (bf16 x, fp32 dres, bf16 dx). The
    closed form and autodiff round differently in fp32: 2e-5 on fp32 dx; a
    bf16 output may flip one rounding (2**-8 relative): 2**-7; d gamma and
    d beta, sums over the 52 rows, 1e-4."""
    from federated_multi_modal_tpu.ops.primitives import layer_norm as jax_layer_norm

    rng = np.random.default_rng(7)
    B, T, D = 4, 13, 128
    x_bf16 = instance == "LN1"
    x = rng.standard_normal((B, T, D)).astype(np.float32) * 3 + 1
    x = _bf16(x) if x_bf16 else x
    dxn = rng.standard_normal((B, T, D)).astype(np.float32)
    dres = rng.standard_normal((B, T, D)).astype(np.float32)
    dres = (dres if x_bf16 else _bf16(dres)) if residual else None
    gamma = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
    beta = (rng.standard_normal(D) * 0.1).astype(np.float32)

    x32 = jnp.asarray(np.asarray(x, np.float32))
    _, vjp = jax.vjp(lambda x_, p_: jax_layer_norm(x_, p_), x32,
                     {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)})
    dx_ref, dp = vjp(jnp.asarray(dxn))
    dx_ref = np.asarray(dx_ref) + (0 if dres is None else np.asarray(dres, np.float32))

    def to_torch(a):
        t = torch.from_numpy(np.asarray(a, np.float32)).reshape(B * T, D)
        return t.to(torch.bfloat16) if a.dtype == ml_dtypes.bfloat16 else t

    out_dtype = torch.bfloat16 if x_bf16 else torch.float32
    dx, copy, dg, db = port_fb.layernorm_bwd_rows_reference(
        to_torch(x), to_torch(dxn), None if dres is None else to_torch(dres),
        torch.from_numpy(gamma), out_dtype, copy_bf16=not x_bf16)
    assert dx.dtype == out_dtype
    tol = 2 ** -7 if x_bf16 else 2e-5
    np.testing.assert_allclose(dx.float().numpy(), dx_ref.reshape(B * T, D), atol=tol, rtol=tol)
    if not x_bf16:
        np.testing.assert_allclose(copy.float().numpy(), dx_ref.reshape(B * T, D),
                                   atol=2 ** -7, rtol=2 ** -7)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dp["scale"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(dp["bias"]), atol=1e-4, rtol=1e-4)
