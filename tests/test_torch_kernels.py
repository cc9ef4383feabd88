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
    before = (port_attn.packed_attention_masked.launches,
              port_fb.fused_block_residual.launches, dict(_build.LAUNCHES))
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
    after = (port_attn.packed_attention_masked.launches,
             port_fb.fused_block_residual.launches, dict(_build.LAUNCHES))
    assert after == before
    assert _build._lib is None


def test_wrappers_refuse_gradients():
    """The inference block has no backward, like the TPU kernel: an ``x``
    that needs a gradient is refused. The text attention now has its
    backward (K1b), so a ``qkv`` that needs a gradient goes through its
    autograd function, whose backward is the plain one on the CPU."""
    qkv = torch.zeros(1, 32, 384, requires_grad=True)
    out = port_attn.packed_attention_masked(qkv, build_block_causal_mask(4, 8), 2)
    assert type(out.grad_fn).__name__ == "_PackedAttentionMaskedBackward"
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
