"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX kernels run
in interpret mode (the CPU backend selects it, ``attention.py:194-197``),
as ``tests/test_pallas.py`` runs them. Inputs are made with numpy from a
seed and handed to both.
"""

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
    """Neither kernel has a backward in the port yet: a tensor that needs a
    gradient is refused rather than differentiated through the plain
    version."""
    qkv = torch.zeros(1, 32, 384, requires_grad=True)
    with pytest.raises(NotImplementedError):
        port_attn.packed_attention_masked(qkv, build_block_causal_mask(4, 8), 2)
    x = torch.zeros(1, 8, 128, requires_grad=True)
    p = _map(torch.from_numpy, _block(np.random.default_rng(4), 128))
    with pytest.raises(NotImplementedError):
        port_fb.fused_block_residual(x, p, 2)
