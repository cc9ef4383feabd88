"""EVA-CLIP's vision block on the port's kernels (``eva_vit_model.py`` of
github.com/baaivision/EVA with ``rope``, ``subln`` and ``naiveswiglu``):

    qkv = LN1(x) . [Wq Wk Wv] + [bq 0 bv], q and k turned by 2-D RoPE
    a   = softmax(q . k^T / sqrt(hd)) . v
    y   = x + LN_inner(a) . Wo + bo
    out = y + LN_ffn(silu(LN2(y) . W1 + b1) * (LN2(y) . W2 + b2)) . W3 + b3

composed over ``fused_block.py``'s :class:`BlockSteps` and five steps of its
own (:class:`EvaSteps`), so that on the CPU the same sequence runs on the
plain versions (``EVA_PLAIN_STEPS``):

* ``gemm_rope``: the QKV product with the rotation in its epilogue
  (``gemm_epilogue.cu``'s RoPE instance): each thread holds adjacent column
  pairs, which are EVA's rotation pairs ``(2 i, 2 i + 1)``; a ``(T, hd / 2)``
  table of ``(cos, sin)`` by ``row % T`` turns the q and k columns, its
  identity rows leaving CLS and MaPLe's prompt and caption rows as they are;
* ``gemm_gate``: the SwiGLU product (the gate instance): ``W1`` and ``W2``
  interleaved so that a thread's pair is ``(x1_j, x2_j)``; it writes
  ``silu(x1_j) * x2_j`` to column ``j`` and, for the backward, the pair
  itself;
* ``layernorm_ld``: ``LN_ffn`` over the hidden's 2730 valid columns at a
  stride of 2736 (``eva_rows.cu``), zeros past them;
* ``layernorm_bwd_gate``: ``LN_ffn``'s backward and the gate's in one pass
  over the saved pair (``eva_rows.cu``), ``d(x1, x2)`` interleaved, and the
  partial column sums of ``d gamma`` and ``d beta``;
* ``rope_rows``: the inverse rotation of d(QKV)'s q and k columns after the
  attention backward (``eva_rows.cu``).

The hidden is padded from 2730 to 2736 with zero weights, since the GEMM
takes widths that are multiples of 8; the padding's gradients are zero, so
it stays zero under SGD. The forward keeps ``x``, the rotated ``qkv`` and
the gate's pair (``pre``); the backward recomputes the attention output,
``y`` and, for the trainable block, LN1's and LN2's outputs and the gate's
``LN_ffn`` output. The SwiGLU half runs inside span ``vision_mlp``
(``vision_mlp.backward`` in the backward).

Bound on the H100: operations. At EVA02-CLIP-L/14 (M = 124,800 rows of
1024, hidden 2736) a frozen block's forward is 4.2 TFLOP of products plus
0.14 of attention (~4.4 ms at 989 TFLOP/s), its backward as many again and
attention's twice; the sub-LNs and the gate add ~2.7 GB of traffic a pass
(~0.8 ms at 3.35 TB/s).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels import fused_block as fb
from federated_multi_modal_tpu_torch.utils.profiling import span

ROPE_THETA = 10000.0


def rope_table(T: int, grid: int, head_dim: int, device=None) -> torch.Tensor:
    """``(T, head_dim / 2, 2)`` fp32 ``(cos, sin)`` of each rotation pair of a
    head at each row of a ``T``-row sequence: rows ``1 .. grid^2`` are the
    patches (grid row ``r // grid``, column ``r % grid`` of patch ``r``),
    whose pairs in the head's first half turn with the grid row and in its
    second half with the grid column, pair ``i`` of a half by ``pos *
    10000^(-2 i / (head_dim / 2))`` (``VisionRotaryEmbeddingFast`` at
    ``pt_seq_len`` = grid); every other row (CLS, prompts, caption) is the
    identity. Made on ``device`` by device operations."""
    half = head_dim // 2
    freqs = ROPE_THETA ** (-torch.arange(0, half, 2, device=device, dtype=torch.float32) / half)
    patch = torch.arange(grid * grid, device=device)
    pos = torch.stack([torch.div(patch, grid, rounding_mode="floor"), patch % grid])
    angles = (pos.float()[:, :, None] * freqs).permute(1, 0, 2).reshape(grid * grid, half)
    table = torch.zeros(T, half, 2, device=device)
    table[:, :, 0] = 1.0
    table[1:1 + grid * grid, :, 0] = torch.cos(angles)
    table[1:1 + grid * grid, :, 1] = torch.sin(angles)
    return table


def apply_rope(t: torch.Tensor, table: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """``t (B, T, n * head_dim)`` with every head turned by ``table``
    (:func:`rope_table`), by ``-theta`` with ``inverse``: EVA's ``t * cos +
    rotate_half(t) * sin`` with its interleaved ``rotate_half``, in fp32."""
    B, T, W = t.shape
    half = table.shape[1]
    x = t.float().reshape(B, T, W // (2 * half), half, 2)
    c = table[None, :, None, :, 0]
    s = table[None, :, None, :, 1] * (-1.0 if inverse else 1.0)
    x0, x1 = x[..., 0], x[..., 1]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], -1).reshape(B, T, W)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# -- the steps: plain versions -----------------------------------------------


def rope_rows_reference(qkv: torch.Tensor, table: torch.Tensor, inverse: bool = False):
    """Plain ``rope_rows``: ``qkv (B, T, 3D)`` with its q and k columns turned
    (back with ``inverse``), in ``qkv``'s dtype, rounded once."""
    D = qkv.shape[-1] // 3
    qk = apply_rope(qkv[..., :2 * D], table, inverse).to(qkv.dtype)
    return torch.cat([qk, qkv[..., 2 * D:]], -1)


def gemm_rope_reference(a, w, bias, table):
    """``a (M, K) @ w + bias`` (fp32 products of the storage values, the bias
    rounded to it) with q and k turned in fp32, rounded once to ``a``'s
    dtype; ``M`` is a multiple of ``table``'s ``T``."""
    T = table.shape[0]
    acc = fb.gemm_epilogue_reference(a, w, bias, out_dtype=torch.float32)
    D = acc.shape[-1] // 3
    acc = acc.reshape(-1, T, 3 * D)
    qk = apply_rope(acc[..., :2 * D], table)
    return torch.cat([qk, acc[..., 2 * D:]], -1).reshape(-1, 3 * D).to(a.dtype)


def gemm_gate_reference(a, w12, b12, pre: bool = False):
    """The SwiGLU product: ``u = a @ w12 + b12`` (fp32 products, the bias
    rounded to the storage dtype), the pair ``(x1_j, x2_j) = (u[2 j], u[2 j +
    1])`` rounded to the storage dtype, ``g_j = silu(x1_j) * x2_j`` in fp32
    rounded once. Returns ``g (M, N / 2)``, or ``(g, u rounded)`` with
    ``pre``."""
    u = fb.gemm_epilogue_reference(a, w12, b12, out_dtype=a.dtype)
    pair = u.float().reshape(u.shape[0], -1, 2)
    g = (silu(pair[..., 0]) * pair[..., 1]).to(a.dtype)
    return (g, u) if pre else g


def layernorm_ld_reference(x, gamma, beta, valid: int, eps: float):
    """LayerNorm of ``x (rows, ld)``'s first ``valid`` columns (fp32 moments
    over them alone), in ``x``'s dtype, zeros past them."""
    out = torch.zeros_like(x)
    out[:, :valid] = fb.layernorm_rows_reference(x[:, :valid], gamma[:valid], beta[:valid],
                                                 x.dtype, eps)
    return out


def layernorm_bwd_gate_reference(pre, dgn, gamma, valid: int, eps: float):
    """The backward of ``LN_ffn(silu(x1) * x2)`` over the saved pair ``pre (rows,
    2 ld)`` (bf16, interleaved) for the fp32 cotangent ``dgn (rows, ld)`` of
    LN_ffn's output: ``g`` recomputed from the pair as the gate product
    rounded it; LN's backward over the first ``valid`` columns; then ``dx1 =
    dg * x2 * silu'(x1)``, ``dx2 = dg * silu(x1)``. Returns ``(d pair (rows, 2
    ld) in pre's dtype, d gamma (ld,), d beta (ld,))``, zero past ``valid``."""
    rows, ld = dgn.shape
    pair = pre.float().reshape(rows, ld, 2)[:, :valid]
    x1, x2 = pair[..., 0], pair[..., 1]
    g = (silu(x1) * x2).to(pre.dtype)
    dg, _, dgamma, dbeta = fb.layernorm_bwd_rows_reference(
        g, dgn[:, :valid], None, gamma[:valid], torch.float32, eps=eps)
    s = torch.sigmoid(x1)
    dpair = torch.zeros(rows, ld, 2, device=pre.device)
    dpair[:, :valid, 0] = dg * x2 * (s + x1 * s * (1.0 - s))
    dpair[:, :valid, 1] = dg * x1 * s
    pad = ld - valid
    return (dpair.reshape(rows, 2 * ld).to(pre.dtype),
            torch.nn.functional.pad(dgamma, (0, pad)), torch.nn.functional.pad(dbeta, (0, pad)))


# -- the steps: CUDA kernels ---------------------------------------------------

# gemm_epilogue.cu's code bits of the EVA epilogues, above the shared ones
ROPE_BIT, GATE_BIT = 1 << 9, 1 << 10


def _eva_launch(a, w, bias, out, pre=None, table=None, T=0, gate=False):
    M, K = a.shape
    N = w.shape[1]
    code = fb.epilogue_code(bias=True, pre=None if pre is None else pre.dtype,
                            out=out.dtype) | (ROPE_BIT if table is not None else 0) \
        | (GATE_BIT if gate else 0)
    fb.GEMM_LAUNCHES[(fb._NN, M, N, K, code)] += 1
    _build.launch("fmm_gemm_epilogue_eva", a.data_ptr(), w.data_ptr(), M, N, K,
                  bias.data_ptr(), fb._ptr(pre), fb._ptr(table), T,
                  2 * (N // 3) if table is not None else 0, int(gate), out.data_ptr())


def _gemm_args(a, w, bias):
    w = w.to(torch.bfloat16).contiguous()
    bias = bias.to(torch.bfloat16).contiguous()
    fb._check_cuda("gemm_epilogue_eva a", a, (torch.bfloat16,))
    fb._check_cuda("gemm_epilogue_eva w", w, (torch.bfloat16,))
    M, K = a.shape
    if w.shape[0] != K or K % 8 or w.shape[1] % 16 or bias.shape != (w.shape[1],):
        raise ValueError(f"gemm_epilogue_eva: a {tuple(a.shape)} @ w {tuple(w.shape)} "
                         "needs matching K, K % 8 == 0, N % 16 == 0 and a bias of N")
    return w, bias


def gemm_rope_cuda(a, w, bias, table):
    """Launch ``gemm_epilogue.cu``'s RoPE instance: bf16 ``a (M, K) @ w (K,
    3D) + bias`` with q and k turned by ``table`` (``(T, hd / 2, 2)`` fp32,
    ``M`` a multiple of ``T``), bf16 out."""
    w, bias = _gemm_args(a, w, bias)
    table = table.to(torch.float32).contiguous()
    M = a.shape[0]
    T = table.shape[0]
    if M % T or table.shape[1] != 32 or w.shape[1] % 3:
        raise ValueError("gemm_rope: rows a multiple of T, heads of 64, 3D columns")
    out = torch.empty(M, w.shape[1], dtype=torch.bfloat16, device=a.device)
    _eva_launch(a, w, bias, out, table=table, T=T)
    return out


def gemm_gate_cuda(a, w12, b12, pre: bool = False):
    """Launch ``gemm_epilogue.cu``'s gate instance: ``g (M, N / 2)`` bf16 of
    :func:`gemm_gate_reference`, and the bf16 pair ``(M, N)`` with ``pre``."""
    w12, b12 = _gemm_args(a, w12, b12)
    M, N = a.shape[0], w12.shape[1]
    out = torch.empty(M, N // 2, dtype=torch.bfloat16, device=a.device)
    u = torch.empty(M, N, dtype=torch.bfloat16, device=a.device) if pre else None
    _eva_launch(a, w12, b12, out, pre=u, gate=True)
    return (out, u) if pre else out


def layernorm_ld_cuda(x, gamma, beta, valid: int, eps: float):
    """Launch ``eva_rows.cu``'s ``layernorm_rows_ld``: bf16 ``x (rows, ld)``."""
    fb._check_cuda("layernorm_ld x", x, (torch.bfloat16,))
    rows, ld = x.shape
    if not 0 < valid <= ld or ld % 8:
        raise ValueError(f"layernorm_ld: {valid} valid columns of {ld} (a multiple of 8)")
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    _build.launch("fmm_layernorm_rows_ld", x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  out.data_ptr(), rows, valid, ld, eps)
    return out


GATE_BWD_BLOCKS_PER_SM = 2  # eva_rows.cu's persistent grid: resident blocks an SM


def layernorm_bwd_gate_cuda(pre, dgn, gamma, valid: int, eps: float):
    """Launch ``eva_rows.cu``'s ``layernorm_bwd_gate`` (a persistent grid, one
    row a block at a time, one partial of d gamma and d beta a block, added
    by ``column_sum``); the returns of :func:`layernorm_bwd_gate_reference`."""
    fb._check_cuda("layernorm_bwd_gate pre", pre, (torch.bfloat16,))
    fb._check_cuda("layernorm_bwd_gate dgn", dgn, (torch.float32,))
    rows, ld = dgn.shape
    if pre.shape != (rows, 2 * ld) or not 0 < valid <= ld or ld % 8 or ld > 3072:
        raise ValueError(f"layernorm_bwd_gate: pre ({rows}, {2 * ld}), {valid} valid "
                         "columns of at most 3072")
    gamma = gamma.to(torch.float32).contiguous()
    sms = torch.cuda.get_device_properties(pre.device).multi_processor_count
    blocks = min(rows, sms * GATE_BWD_BLOCKS_PER_SM)
    dpair = torch.empty_like(pre)
    partial = torch.empty(blocks, 2 * ld, dtype=torch.float32, device=pre.device)
    _build.launch("fmm_layernorm_bwd_gate", pre.data_ptr(), dgn.data_ptr(), gamma.data_ptr(),
                  dpair.data_ptr(), partial.data_ptr(), rows, valid, ld, blocks, eps)
    sums = fb.column_sum_cuda(partial)
    return dpair, sums[:ld], sums[ld:]


def rope_rows_cuda(qkv, table, inverse: bool = False):
    """Launch ``eva_rows.cu``'s ``rope_rows`` on bf16 ``qkv (B, T, 3D)`` in
    place (heads of 64); returns it."""
    fb._check_cuda("rope_rows qkv", qkv, (torch.bfloat16,))
    table = table.to(torch.float32).contiguous()
    B, T, W = qkv.shape
    if table.shape != (T, 32, 2) or W % 192:
        raise ValueError("rope_rows: a (T, 32, 2) table and heads of 64")
    _build.launch("fmm_rope_rows", qkv.data_ptr(), table.data_ptr(), B * T, T, W // 3,
                  int(inverse))
    return qkv


class EvaSteps(NamedTuple):
    """The steps an EVA block runs: CLIP's (``base``) and its own."""

    base: fb.BlockSteps
    gemm_rope: Callable
    gemm_gate: Callable
    layernorm_ld: Callable
    layernorm_bwd_gate: Callable
    rope_rows: Callable


EVA_PLAIN_STEPS = EvaSteps(fb.PLAIN_STEPS, gemm_rope_reference, gemm_gate_reference,
                           layernorm_ld_reference, layernorm_bwd_gate_reference,
                           rope_rows_reference)
EVA_CUDA_STEPS = EvaSteps(fb.CUDA_STEPS, gemm_rope_cuda, gemm_gate_cuda, layernorm_ld_cuda,
                          layernorm_bwd_gate_cuda, rope_rows_cuda)


# -- the block --------------------------------------------------------------------

# The block's leaves, LayerNorms first: paths into the block's tree.
LN_LEAVES = (("ln_1", "scale"), ("ln_1", "bias"), ("attn", "ln_inner", "scale"),
             ("attn", "ln_inner", "bias"), ("ln_2", "scale"), ("ln_2", "bias"),
             ("mlp", "ln_ffn", "scale"), ("mlp", "ln_ffn", "bias"))
WEIGHT_LEAVES = (("attn", "w_qkv"), ("attn", "q_bias"), ("attn", "v_bias"), ("attn", "w_out"),
                 ("attn", "b_out"), ("mlp", "w12"), ("mlp", "b12"), ("mlp", "w3"),
                 ("mlp", "b3"))
BLOCK_LEAVES = LN_LEAVES + WEIGHT_LEAVES


def _get(p, path):
    for k in path:
        p = p[k]
    return p


def _leaves(p):
    return [_get(p, path) for path in BLOCK_LEAVES]


def _tree(leaves):
    p = {}
    for path, t in zip(BLOCK_LEAVES, leaves):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return p


def qkv_bias(attn) -> torch.Tensor:
    """``[bq, 0, bv]``: EVA's k has no bias."""
    q = attn["q_bias"]
    return torch.cat([q, torch.zeros_like(q), attn["v_bias"].to(q.dtype)])


def _ln(steps, x, lnp, dt, eps):
    return steps.base.layernorm(x, lnp["scale"], lnp["bias"], dt, eps)


def _attention(x2, B, T, p, n_head, table, eps, steps):
    """``(qkv, a, LN_inner(a))`` of the block's attention half over ``x2 (B * T,
    D)``."""
    dt = x2.dtype
    D = x2.shape[1]
    xn1 = _ln(steps, x2, p["ln_1"], dt, eps)
    qkv = steps.gemm_rope(xn1, p["attn"]["w_qkv"], qkv_bias(p["attn"]), table)
    a = steps.base.attention(qkv.reshape(B, T, 3 * D), n_head).reshape(B * T, D)
    return qkv, a, _ln(steps, a, p["attn"]["ln_inner"], dt, eps)


def eva_block_forward(x, p, n_head: int, table, hidden: int, eps: float, steps: EvaSteps,
                      save: bool):
    """The block's forward over ``x (B, T, D)``: ``(out, qkv, pre)``, the rotated
    ``(B * T, 3D)`` QKV and the gate's ``(B * T, 2 padded)`` pair kept with
    ``save`` (else ``None``)."""
    B, T, D = x.shape
    dt = x.dtype
    x2 = x.reshape(B * T, D)
    attn, mlp = p["attn"], p["mlp"]
    qkv, _, an = _attention(x2, B, T, p, n_head, table, eps, steps)
    y = steps.base.gemm(an, attn["w_out"], attn["b_out"], residual=x2, out_dtype=torch.float32)
    with span("vision_mlp"):
        z = _ln(steps, y, p["ln_2"], dt, eps)
        if save:
            g, pre = steps.gemm_gate(z, mlp["w12"], mlp["b12"], pre=True)
        else:
            g, pre = steps.gemm_gate(z, mlp["w12"], mlp["b12"]), None
        gn = steps.layernorm_ld(g, mlp["ln_ffn"]["scale"], mlp["ln_ffn"]["bias"], hidden, eps)
        out = steps.base.gemm(gn, mlp["w3"], mlp["b3"], residual=y, out_dtype=dt)
    return out.reshape(B, T, D), (qkv if save else None), pre


def eva_block_backward(x, dy, p, n_head: int, table, hidden: int, eps: float, qkv, pre,
                       steps: EvaSteps, wgrad: bool):
    """``(dx, grads)`` for the output cotangent ``dy`` from the saved ``qkv`` and
    ``pre``; ``grads`` maps each path of :data:`BLOCK_LEAVES` to its fp32
    gradient: the LayerNorms' always, the weights' with ``wgrad``."""
    B, T, D = x.shape
    dt = x.dtype
    M = B * T
    x2 = x.reshape(M, D)
    attn, mlp = p["attn"], p["mlp"]
    st = steps.base
    dout = dy.reshape(M, D).to(dt).contiguous()
    a = st.attention(qkv.reshape(B, T, 3 * D), n_head).reshape(M, D)
    an = _ln(steps, a, attn["ln_inner"], dt, eps)
    y = st.gemm(an, attn["w_out"], attn["b_out"], residual=x2, out_dtype=torch.float32)
    with span("vision_mlp.backward"):
        dgn = st.gemm(dout, mlp["w3"], trans_w=True, out_dtype=torch.float32)
        dpair, dgf, dbf = steps.layernorm_bwd_gate(pre, dgn, mlp["ln_ffn"]["scale"], hidden,
                                                   eps)
        dz = st.gemm(dpair, mlp["w12"], trans_w=True, out_dtype=torch.float32)
        dyh, dyh_c, dg2, db2 = st.layernorm_bwd(y, dz, dout, p["ln_2"]["scale"], torch.float32,
                                                copy_bf16=dt != torch.float32, eps=eps)
    dyh_c = dyh if dyh_c is None else dyh_c
    dan = st.gemm(dyh_c, attn["w_out"], trans_w=True, out_dtype=torch.float32)
    da, _, dgi, dbi = st.layernorm_bwd(a, dan, None, attn["ln_inner"]["scale"], dt, eps=eps)
    dqkv = st.attention_bwd(qkv.reshape(B, T, 3 * D), da.reshape(B, T, D), n_head)
    dqkv = steps.rope_rows(dqkv.reshape(B, T, 3 * D).contiguous(), table,
                           inverse=True).reshape(M, 3 * D)
    dyln1 = st.gemm(dqkv, attn["w_qkv"], trans_w=True, out_dtype=torch.float32)
    dx, _, dg1, db1 = st.layernorm_bwd(x2, dyln1, dyh, p["ln_1"]["scale"], dt, eps=eps)
    grads = {("ln_1", "scale"): dg1, ("ln_1", "bias"): db1,
             ("attn", "ln_inner", "scale"): dgi, ("attn", "ln_inner", "bias"): dbi,
             ("ln_2", "scale"): dg2, ("ln_2", "bias"): db2,
             ("mlp", "ln_ffn", "scale"): dgf, ("mlp", "ln_ffn", "bias"): dbf}
    if wgrad:
        xn1 = _ln(steps, x2, p["ln_1"], dt, eps)
        z = _ln(steps, y, p["ln_2"], dt, eps)
        g = steps.gemm_gate(z, mlp["w12"], mlp["b12"])
        gn = steps.layernorm_ld(g, mlp["ln_ffn"]["scale"], mlp["ln_ffn"]["bias"], hidden, eps)
        dbqkv = st.column_sum(dqkv)
        grads.update({
            ("attn", "w_qkv"): st.gemm_tn(xn1, dqkv),
            ("attn", "q_bias"): dbqkv[:D],
            ("attn", "v_bias"): dbqkv[2 * D:],
            ("attn", "w_out"): st.gemm_tn(an, dyh_c),
            ("attn", "b_out"): st.column_sum(dyh),
            ("mlp", "w12"): st.gemm_tn(z, dpair),
            ("mlp", "b12"): st.column_sum(dpair),
            ("mlp", "w3"): st.gemm_tn(gn, dout),
            ("mlp", "b3"): st.column_sum(dout),
        })
    return dx.reshape(B, T, D), grads


class _EvaBlockTrain(torch.autograd.Function):
    """One EVA block's forward and backward as given by ``steps``; ``wgrad``
    gives every gradient (else the LayerNorms' alone). ``counter`` is the
    wrapper whose counts of launches to raise, or ``None``."""

    @staticmethod
    def forward(ctx, x, table, n_head, hidden, eps, steps, wgrad, counter, *leaves):
        out, qkv, pre = eva_block_forward(x, _tree(leaves), n_head, table, hidden, eps, steps,
                                          save=True)
        ctx.save_for_backward(x, table, qkv, pre, *leaves)
        ctx.args = (n_head, hidden, eps, steps, wgrad, counter)
        if counter is not None:
            counter.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, table, qkv, pre, *leaves = ctx.saved_tensors
        n_head, hidden, eps, steps, wgrad, counter = ctx.args
        dx, grads = eva_block_backward(x, dy, _tree(leaves), n_head, table, hidden, eps, qkv,
                                       pre, steps, wgrad)
        if counter is not None:
            counter.backward_launches += 1
        leaf_grads = [None if path not in grads or not need
                      else grads[path].to(leaf.dtype).reshape(leaf.shape)
                      for path, leaf, need in zip(BLOCK_LEAVES, leaves, ctx.needs_input_grad[8:])]
        return (dx, None, None, None, None, None, None, None, *leaf_grads)


def _frozen_guard(p):
    trainable = [".".join(path) for path in WEIGHT_LEAVES if _get(p, path).requires_grad]
    if trainable:
        raise ValueError(f"eva_block_train returns no gradient for {trainable}: route the "
                         "block through eva_block_train_dw")


def eva_block_train(x, p, n_head: int, table, hidden: int, eps: float):
    """The EVA block, differentiable in ``x`` and its LayerNorms, for frozen
    weights (raises if any weight requires a gradient); the plain steps on
    a CPU tensor."""
    _frozen_guard(p)
    if x.device.type == "cpu":
        return _EvaBlockTrain.apply(x, table, n_head, hidden, eps, EVA_PLAIN_STEPS, False, None,
                                    *_leaves(p))
    return _EvaBlockTrain.apply(x.contiguous(), table, n_head, hidden, eps, EVA_CUDA_STEPS,
                                False, eva_block_train, *_leaves(p))


def eva_block_train_dw(x, p, n_head: int, table, hidden: int, eps: float):
    """The EVA block, differentiable in ``x`` and every leaf of ``p``."""
    if x.device.type == "cpu":
        return _EvaBlockTrain.apply(x, table, n_head, hidden, eps, EVA_PLAIN_STEPS, True, None,
                                    *_leaves(p))
    return _EvaBlockTrain.apply(x.contiguous(), table, n_head, hidden, eps, EVA_CUDA_STEPS,
                                True, eva_block_train_dw, *_leaves(p))


def eva_block_residual(x, p, n_head: int, table, hidden: int, eps: float):
    """The EVA block's forward alone (eval towers), no gradient."""
    if x.requires_grad:
        raise NotImplementedError("eva_block_residual is forward-only")
    if x.device.type == "cpu":
        return eva_block_forward(x, p, n_head, table, hidden, eps, EVA_PLAIN_STEPS, False)[0]
    out = eva_block_forward(x.contiguous(), p, n_head, table, hidden, eps, EVA_CUDA_STEPS,
                            False)[0]
    eva_block_residual.launches += 1
    return out


eva_block_residual.launches = 0
for _fn in (eva_block_train, eva_block_train_dw):
    _fn.launches = 0
    _fn.backward_launches = 0

