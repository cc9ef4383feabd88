"""The shapes the JAX package's kernels take and the port's CUDA kernels once
refused, on the CPU: the port's plain versions against the JAX kernels in
interpret mode (or the JAX tool's prototypes), and the CUDA wrappers'
head-width padding around the plain kernels. One case per shape.

* K1, K1b, K2, K2b at head widths 1, 2 and 4 (the divisors of 128 below 8
  that ``_packed_hp`` admits): ``pad_heads`` in the routed wrappers around
  the plain kernel (which, like the CUDA kernel, is handed widths that are
  multiples of 8 only) against the plain kernel unpadded, and the plain
  versions against ``packed_attention`` and ``packed_attention_masked``;
* K8 at head widths 12, 30, 80, 96, 160 and 272 against ``fused_attention``;
* P1 and P2 at head widths 16, 30, 32, 128 and 160 and at T = 264 against
  ``tools/attn_microbench.py``'s prototypes;
* P3 at heads of 8 and 16 against ``_build_packed4d`` (with ``_pick_gb``'s
  missing ``hp`` supplied, as ``tests/test_torch_microbench.py`` does).

Inputs are made with numpy from a seed and handed to both packages. Batches
and widths are small: interpret mode runs each grid step in Python.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from federated_multi_modal_tpu.ops.pallas import attention as jax_attn
from federated_multi_modal_tpu.ops.primitives import build_block_causal_mask as jax_block_mask
from federated_multi_modal_tpu.ops.primitives import build_causal_mask as jax_causal_mask
from federated_multi_modal_tpu_torch.ops.kernels import attention as port_attn
from federated_multi_modal_tpu_torch.ops.kernels import prototypes as port_proto

sys.path.insert(0, str(Path(__file__).parents[1] / "tools"))
import attn_microbench as jax_bench  # noqa: E402

# the existing cases' tolerances (tests/test_torch_kernels.py,
# tests/test_torch_microbench.py): max |got - ref| over max |ref|
TOL_K2 = {"float32": 5e-6, "bfloat16": 2 ** -8}
TOL_K1B = {"float32": 2e-6, "bfloat16": 2 ** -8}
TOL_K8 = {"float32": 2e-5, "bfloat16": 2 ** -7}
TOL_PROTO = 2e-5  # the JAX tool's own tests, fp32, elementwise
# the padded plain kernel against the unpadded one: the same fp32 products,
# summed over extra zero columns
TOL_PAD = 1e-6


def _bf16(a):
    return np.asarray(a).astype(ml_dtypes.bfloat16)


def _to_torch(a):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if np.asarray(a).dtype == ml_dtypes.bfloat16 else t


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# -- K1, K1b, K2, K2b at head widths 1, 2 and 4 --------------------------------

SMALL_HEADS = [1, 2, 4]


def _small_head_case(hd, masked, dtype, seed):
    """128 columns (whole 128-lane groups, as ``_packed_hp`` wants) of heads
    of ``hd``; block-causal over three prompts of 8 tokens when masked, else
    T = 13 (off the multiple of 8)."""
    rng = np.random.default_rng(seed)
    n_head, B = 128 // hd, 1
    T = 24 if masked else 13
    qkv = rng.standard_normal((B, T, 3 * 128)).astype(np.float32)
    g = rng.standard_normal((B, T, 128)).astype(np.float32)
    if dtype == "bfloat16":
        qkv, g = _bf16(qkv), _bf16(g)
    mask = np.asarray(jax_block_mask(3, 8)) if masked else None
    return qkv, g, mask, n_head


def _kernel_standins(monkeypatch):
    """``attention_core_cuda`` and ``attention_core_bwd_cuda`` replaced by
    their plain versions, refusing (as the kernels do) head widths that are
    not multiples of 8 up to 128; the calls they get are recorded."""
    calls = []

    def width(qkv, n_head):
        hd = qkv.shape[-1] // (3 * n_head)
        assert hd % 8 == 0 and hd <= 128, hd
        return hd

    def core(qkv, n_head, mask=None, valid_T=None, scale=None):
        calls.append(("fwd", width(qkv, n_head), scale))
        return port_attn.attention_core_reference(qkv, n_head, mask, scale)

    def core_bwd(qkv, g, n_head, mask=None, scale=None):
        calls.append(("bwd", width(qkv, n_head), scale))
        assert g.shape[-1] * 3 == qkv.shape[-1]
        return port_attn.attention_core_bwd_reference(qkv, g, n_head, mask, scale)

    monkeypatch.setattr(port_attn, "attention_core_cuda", core)
    monkeypatch.setattr(port_attn, "attention_core_bwd_cuda", core_bwd)
    return calls


@pytest.mark.parametrize("masked", [False, True], ids=["K2", "K1"])
@pytest.mark.parametrize("hd", SMALL_HEADS)
def test_pad_heads_around_the_plain_kernel(hd, masked, monkeypatch):
    """The routed wrappers' CUDA steps (``_fwd_cuda``, ``_bwd_launch``) pad a
    head of 1, 2 or 4 to 8 with the true width's scale and slice back: with
    the plain kernel standing in for the CUDA one, forward and d(QKV) equal
    the plain kernel's on the unpadded heads (fp32, 1e-6)."""
    calls = _kernel_standins(monkeypatch)
    qkv, g, mask, n_head = _small_head_case(hd, masked, "float32", 70 + hd)
    qkv, g = _to_torch(qkv), _to_torch(g)
    mask = None if mask is None else torch.from_numpy(mask)
    out = port_attn._fwd_cuda(qkv, mask, n_head)
    dqkv = port_attn._bwd_launch(qkv, g, n_head, mask)
    assert out.shape == g.shape and dqkv.shape == qkv.shape
    assert calls == [("fwd", 8, 1 / math.sqrt(hd)), ("bwd", 8, 1 / math.sqrt(hd))]
    ref_out = port_attn.attention_core_reference(qkv, n_head, mask)
    ref_dqkv = port_attn.attention_core_bwd_reference(qkv, g, n_head, mask)
    assert _rel_err(out, ref_out) < TOL_PAD
    assert _rel_err(dqkv, ref_dqkv) < TOL_PAD
    # the padding is all zeros and the slice its exact inverse
    padded = port_attn.pad_heads(qkv, n_head, 8)
    assert padded.shape == (*qkv.shape[:2], 3 * n_head * 8)
    assert not padded.reshape(*qkv.shape[:2], 3, n_head, 8)[..., hd:].any()
    torch.testing.assert_close(port_attn.unpad_heads(padded, n_head, hd), qkv, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["K2", "K1"])
@pytest.mark.parametrize("hd,dtype", [(1, "float32"), (2, "float32"), (4, "float32"),
                                      (4, "bfloat16")])
def test_small_heads_match_jax(hd, dtype, masked):
    """The port's plain K2/K2b (no mask) and K1/K1b (block-causal) at heads
    of 1, 2 and 4 against ``packed_attention`` and
    ``packed_attention_masked`` in interpret mode, forward and VJP, at the
    existing cases' tolerances; bf16 at heads of 4 only (interpret mode
    traces every one of the 128 or 64 heads of the narrower widths)."""
    qkv, g, mask, n_head = _small_head_case(hd, masked, dtype, 80 + hd)
    assert jax_attn._packed_hp(128, n_head) == 128 // hd
    if masked:
        fn = lambda t: jax_attn.packed_attention_masked(t, jnp.asarray(mask), n_head)  # noqa: E731
    else:
        fn = lambda t: jax_attn.packed_attention(t, n_head)  # noqa: E731
    out_ref, vjp = jax.vjp(fn, jnp.asarray(qkv))
    (dqkv_ref,) = vjp(jnp.asarray(g))

    qkv_t = _to_torch(qkv).requires_grad_(True)
    if masked:
        out = port_attn.packed_attention_masked(qkv_t, torch.from_numpy(mask), n_head)
    else:
        out = port_attn.packed_attention(qkv_t, n_head)
    (dqkv,) = torch.autograd.grad(out, qkv_t, _to_torch(g))
    assert out.dtype == dqkv.dtype == qkv_t.dtype
    assert _rel_err(out, out_ref) < TOL_K2[dtype]
    assert _rel_err(dqkv, dqkv_ref) < (TOL_K1B if masked else TOL_K2)[dtype]


def test_packed_head_widths_that_need_padding():
    """Which widths the routed wrappers pad: every divisor of 128 that
    ``_packed_hp`` admits below 8, to 8; multiples of 8 run as they are."""
    admitted = [hd for hd in (1, 2, 4, 8, 16, 32, 64, 128)
                if jax_attn._packed_hp(256, 256 // hd) is not None]
    assert admitted == [1, 2, 4, 8, 16, 32, 64, 128]
    assert {hd: port_attn.kernel_head_width(hd) for hd in admitted} == {
        1: 8, 2: 8, 4: 8, 8: 8, 16: 16, 32: 32, 64: 64, 128: 128}


# -- K8 at any head width ----------------------------------------------------------

SPLIT_WIDTHS = [12, 30, 80, 96, 160, 272]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "causal"])
@pytest.mark.parametrize("hd", SPLIT_WIDTHS)
def test_fused_attention_head_widths_match_jax(hd, masked):
    """The plain K8 and its VJP against ``fused_attention`` and
    ``fused_attention_diff`` in interpret mode, fp32 at K8's 2e-5, T = 40
    (off the multiple of 8 in the padded tile, past the routing's 32); the
    width the CUDA wrapper runs it at is the next multiple of 8 up to 128,
    then of 32."""
    rng = np.random.default_rng(200 + hd)
    B, n_head, T = 2, 2, 40
    q, k, v, g = (rng.standard_normal((B, T, n_head * hd)).astype(np.float32) for _ in range(4))
    mask = jax_causal_mask(T) if masked else None
    qj, kj, vj = (jnp.asarray(t) for t in (q, k, v))
    ref = jax_attn.fused_attention(qj, kj, vj, n_head, mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_attn.fused_attention_diff(a, b, c, n_head, mask),
                     qj, kj, vj)
    grads_ref = vjp(jnp.asarray(g))

    mask_t = None if mask is None else torch.from_numpy(np.asarray(mask))
    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    out = port_attn.fused_attention_diff(qt, kt, vt, n_head, mask_t)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    errs = {"out": _rel_err(out, ref),
            **{n: _rel_err(gr, r) for n, gr, r in zip("qkv", grads, grads_ref)}}
    assert max(errs.values()) < TOL_K8["float32"], errs
    kd = port_attn.split_head_width(hd)
    assert kd >= hd and (kd % 8 == 0 if hd <= 128 else kd % 32 == 0)
    assert kd <= port_attn.MAX_SPLIT_HEAD_DIM


def test_padded_split_heads_equal_the_unpadded_plain_kernel():
    """K8's padding (each head of q, k and v zero-padded to the kernel's
    width, the true width's scale, the output sliced) around the plain
    kernel equals the plain kernel, at each width of the list that pads."""
    rng = np.random.default_rng(9)
    for hd in SPLIT_WIDTHS:
        kd = port_attn.split_head_width(hd)
        if kd == hd:
            continue
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2 * hd)).astype(np.float32))
                   for _ in range(3))
        padded = [port_attn.pad_heads(t, 2, kd, parts=1) for t in (q, k, v)]
        got = port_attn.unpad_heads(
            port_attn.fused_attention_reference(*padded, 2, None, 1 / math.sqrt(hd)), 2, hd,
            parts=1)
        ref = port_attn.fused_attention_reference(q, k, v, 2)
        assert _rel_err(got, ref) < TOL_PAD, hd


# -- P1 and P2 at any head width and T ------------------------------------------------

LNQKV_SHAPES = [(16, 16), (30, 16), (32, 16), (128, 16), (160, 16), (64, 264)]


def _lnqkv_inputs(seed, B, T, D):
    r = np.random.default_rng(seed)
    f = np.float32
    return {"x": r.standard_normal((B, T, D)).astype(f),
            "scale": (r.standard_normal(D) * 0.1 + 1).astype(f),
            "bias": (r.standard_normal(D) * 0.1).astype(f),
            "w": (r.standard_normal((D, 3 * D)) * D ** -0.5).astype(f),
            "b": (r.standard_normal(3 * D) * 0.05).astype(f),
            "dy": r.standard_normal((B, T, D)).astype(f)}


@pytest.mark.parametrize("fn", ["P1", "P2"])
@pytest.mark.parametrize("hd,T", LNQKV_SHAPES, ids=[f"hd{hd}-T{T}" for hd, T in LNQKV_SHAPES])
def test_lnqkv_prototypes_match_the_jax_tool(hd, T, fn):
    """P1's and P2's plain versions against the JAX tool's
    ``fused_lnqkv_attention`` and ``fused_lnqkv_attention_bwd_dx`` in
    interpret mode, fp32 at the tool's own 2e-5: two heads (D = 2 hd, off
    the CUDA kernels' 64-column contraction step at 16, 30 and 160, which
    the wrapper pads), B = 2, GB = 2; the stage width the CUDA wrapper runs
    a head at, and whether it streams."""
    n_head, B = 2, 2
    D = n_head * hd
    inp = _lnqkv_inputs(300 + hd + T, B, T, D)
    jl = {"scale": jnp.asarray(inp["scale"]), "bias": jnp.asarray(inp["bias"])}
    pl = {"scale": torch.from_numpy(inp["scale"]), "bias": torch.from_numpy(inp["bias"])}
    j = {k: jnp.asarray(inp[k]) for k in ("x", "w", "b", "dy")}
    p = {k: torch.from_numpy(inp[k]) for k in ("x", "w", "b", "dy")}
    if fn == "P1":
        ref = jax_bench.fused_lnqkv_attention(j["x"], jl, j["w"], j["b"], n_head, GB=2,
                                              interpret=True)
        got = port_proto.fused_lnqkv_attention(p["x"], pl, p["w"], p["b"], n_head, GB=2)
    else:
        ref = jax_bench.fused_lnqkv_attention_bwd_dx(j["x"], jl, j["w"], j["b"], j["dy"],
                                                     n_head, GB=2, interpret=True)
        got = port_proto.fused_lnqkv_attention_bwd_dx(p["x"], pl, p["w"], p["b"], p["dy"],
                                                      n_head, GB=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_PROTO, rtol=TOL_PROTO)
    kd = port_proto.lnqkv_head_width(hd)
    assert kd in port_proto.LNQKV_HEAD_DIMS and kd >= hd
    assert port_proto.lnqkv_fused(kd, T) == (kd <= 64 and T <= 256)


def test_lnqkv_head_widths_past_the_widest_stage_raise():
    with pytest.raises(ValueError, match="heads up to 160"):
        port_proto.lnqkv_head_width(161)
    assert [port_proto.lnqkv_head_width(hd) for hd in (1, 16, 17, 33, 65, 129)] == [
        16, 16, 32, 64, 128, 160]


# -- P3 at heads of 8 and 16 -----------------------------------------------------------


@pytest.mark.parametrize("hd,T", [(8, 16), (8, 13), (16, 16), (16, 13)])
def test_p3_plain_matches_jax_at_small_heads(hd, T, monkeypatch):
    """P3's plain version against ``_build_packed4d()`` in interpret mode at
    heads of 8 and 16 (16 and 8 heads to each 128-lane group, two groups),
    fp32 at 2e-5, with ``_pick_gb``'s missing ``hp`` supplied as
    ``_packed_hp`` gives it."""
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
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_PROTO, rtol=TOL_PROTO)
