"""The attention microbench's prototype kernels: the port of the three TPU
kernels of ``tools/attn_microbench.py`` that the JAX package's own modules
never call.

* P1 :func:`fused_lnqkv_attention` (``fused_lnqkv_attention``,
  ``pallas_call`` at :110): LN1 -> QKV product -> attention in one kernel,
  QKV never in device memory, both on the tensor cores
  (``csrc/lnqkv_attention.cu``, after a small launch for the LN moments),
  where a head's q, k and v fit in shared memory (head widths up to 64, T up
  to 256); elsewhere streamed: the same LN -> QKV stage into a QKV scratch
  (``fmm_lnqkv_project``), then ``csrc/attention_split.cu`` over it;
* P2 :func:`fused_lnqkv_attention_bwd_dx` (``fused_lnqkv_attention_bwd_dx``,
  :207): dx of P1, recomputed from x alone, in three launches: the LN -> QKV
  recomputation and the attention backward per (row, head) into a packed
  d(QKV) scratch (``csrc/lnqkv_attention_bwd_dx.cu``, which shares P1's LN
  -> QKV stage), ``dxn = d(QKV) . W^T`` on the NT instance of the wgmma
  GEMM (``csrc/gemm_epilogue.cu``), and the LayerNorm backward
  (``csrc/layernorm_bwd_rows.cu``); streamed like P1 where P1 is, with
  ``csrc/attention_core_bwd.cu`` as its attention backward;
  :class:`FusedLnQkvAttention` is P1
  forward and P2 backward, the counterpart of
  ``make_fused_lnqkv_attention_fb``;
* P3 :func:`packed4d_attention` (``_build_packed4d``, :351): K2's forward as
  one unit of work per 128-lane head group (heads of 8, 16, 32, 64 or 128;
  heads of 8 zero-padded to 16), its products on the tensor cores
  (``csrc/attention_pair.cu``).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors it
runs the plain PyTorch version beside it. The plain versions round where the
TPU kernels do. P1's are K7's forward points (LN in fp32 to the storage dtype,
the bias added in fp32 before the QKV product's one rounding, fp32 softmax,
``p`` rounded before P.V), P2's K7's backward points with P1's dx, so both are
built from the plain steps of ``fused_block.py``; P3's are K2's, with the
tokens padded to ``tpad`` and the padded keys at ``-inf``. ``GB`` (batch rows
per TPU grid step) and ``dims_parallel`` are TPU tiling and compiler hints:
the signatures keep ``GB`` and its check, and choose no CUDA grid with it.
"""

from __future__ import annotations

import math

import torch

from federated_multi_modal_tpu_torch.ops.kernels import _build
from federated_multi_modal_tpu_torch.ops.kernels.attention import (
    attention_core_bwd_cuda,
    fused_attention_cuda,
    full_fp32_products,
    pad_heads,
    unpad_heads,
)
from federated_multi_modal_tpu_torch.ops.kernels.fused_block import (
    PLAIN_STEPS,
    layernorm_bwd_rows_cuda,
    ln_attention_backward,
    ln_attention_forward,
)
from federated_multi_modal_tpu_torch.ops.kernels.gemm import gemm_nt_f32_cuda

# The head widths of P1's and P2's LN -> QKV stage (ln_qkv.cuh); a head of
# another width is zero-padded to the next of them.
LNQKV_HEAD_DIMS = (16, 32, 64, 128, 160)
# The fused kernels hold a head's q, k and v in shared memory: at these head
# widths and up to this many tokens (16 warps of 16 query rows); elsewhere
# P1 and P2 stream.
FUSED_LNQKV_HEAD_DIMS = (16, 32, 64)
FUSED_LNQKV_MAX_T = 256
# P3's head widths: those whose 128-lane groups the kernel's warps split
# (every width ``_packed_hp`` gives that the kernel is built for), and
# heads of 8, which it runs padded to 16.
PAIR_HEAD_DIMS = (16, 32, 64, 128)
PAIR_PADDED_HEAD_DIMS = {8: 16}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _prototype_contract(name: str, x: torch.Tensor, GB: int) -> None:
    """The TPU prototypes' asserts: ``T % 8 == 0`` and ``B % GB == 0``."""
    B, T, _ = x.shape
    if T % 8 or B % GB:
        raise ValueError(f"{name} takes T % 8 == 0 and B % GB == 0, got B={B}, T={T}, GB={GB}")


def _check_cuda(name: str, t: torch.Tensor, shape, dtype=torch.bfloat16) -> None:
    if (not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} needs a contiguous 16-byte aligned CUDA {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def lnqkv_head_width(hd: int) -> int:
    """The head width of the LN -> QKV stage that runs a head of ``hd``: the
    smallest of :data:`LNQKV_HEAD_DIMS` that holds it."""
    for kd in LNQKV_HEAD_DIMS:
        if hd <= kd:
            return kd
    raise ValueError(f"the fused LN -> QKV -> attention prototypes take heads up to "
                     f"{LNQKV_HEAD_DIMS[-1]} wide, got {hd}")


def lnqkv_fused(kd: int, T: int) -> bool:
    """Whether P1 and P2 run their fused kernels (else the streamed route)
    at the stage's head width ``kd`` and T tokens."""
    return kd in FUSED_LNQKV_HEAD_DIMS and T <= FUSED_LNQKV_MAX_T


class _LnQkvOperands:
    """x, W, the bias, gamma and beta as the kernels take them: x (B, T, Dk),
    gamma and beta (Dk,) fp32 with zeros past D, W (Dk, 3 n_head kd) and the
    bias (3 n_head kd,) bf16 with each head's columns zero-padded from hd to
    kd (:func:`lnqkv_head_width`); Dk is D rounded up to 64."""

    def __init__(self, x, lnp, w, b, n_head: int):
        _, T, D = x.shape
        if D % n_head:
            raise ValueError(f"fused_lnqkv_attention takes D % n_head == 0, got D={D}, "
                             f"{n_head} heads")
        self.hd = D // n_head
        self.kd = lnqkv_head_width(self.hd)
        self.D, self.Dk, self.Dq = D, _round_up(D, 64), n_head * self.kd
        w = w.to(torch.bfloat16).contiguous()
        b = b.to(torch.bfloat16).contiguous()
        gamma = lnp["scale"].to(torch.float32).contiguous()
        beta = lnp["bias"].to(torch.float32).contiguous()
        for name, t, shape, dtype in (("w", w, (D, 3 * D), torch.bfloat16),
                                      ("b", b, (3 * D,), torch.bfloat16),
                                      ("ln scale", gamma, (D,), torch.float32),
                                      ("ln bias", beta, (D,), torch.float32)):
            _check_cuda(f"fused_lnqkv_attention {name}", t, shape, dtype)
        self.gamma_d = gamma
        if self.kd != self.hd:
            w = pad_heads(w[None], n_head, self.kd)[0]
            b = pad_heads(b[None, None], n_head, self.kd)[0, 0]
        pad = self.Dk - D
        if pad:
            x = torch.nn.functional.pad(x, (0, pad))
            w = torch.nn.functional.pad(w, (0, 0, 0, pad))
            gamma = torch.nn.functional.pad(gamma, (0, pad))
            beta = torch.nn.functional.pad(beta, (0, pad))
        self.x, self.w, self.b, self.gamma, self.beta = x, w, b, gamma, beta
        self.scale = 1.0 / math.sqrt(self.hd)
        self.fused = lnqkv_fused(self.kd, T)

    def args(self):
        """x, W, bias, gamma and beta as pointers."""
        return tuple(t.data_ptr() for t in (self.x, self.w, self.b, self.gamma, self.beta))

    def project(self, stats, n_head: int):
        """Every head's q, k and v, ``(B, T, 3 Dq)`` bf16, by
        ``fmm_lnqkv_project`` (the moments, then the LN -> QKV stage)."""
        B, T, _ = self.x.shape
        qkv = torch.empty(B, T, 3 * self.Dq, dtype=torch.bfloat16, device=self.x.device)
        _build.launch("fmm_lnqkv_project", *self.args(), stats.data_ptr(), qkv.data_ptr(), B, T,
                      self.D, self.Dk, n_head, self.kd)
        return qkv


# -- P1: LN1 -> QKV -> attention --------------------------------------------


def fused_lnqkv_attention_reference(x, lnp, w, b, n_head: int, GB: int = 4):
    """Plain version of :func:`fused_lnqkv_attention`, on any device."""
    _prototype_contract("fused_lnqkv_attention", x, GB)
    return ln_attention_forward(x, lnp, w, b, n_head, PLAIN_STEPS)


def fused_lnqkv_attention_cuda(x, lnp, w, b, n_head: int):
    """P1 on a CUDA bf16 ``x (B, T, D)``, with an fp32 ``(B, T, 2)`` scratch
    for the LN moments of each row: ``lnqkv_attention.cu``'s fused kernel
    where it applies (:func:`lnqkv_fused`), else the streamed route
    (``fmm_lnqkv_project`` into a QKV scratch, then ``attention_split.cu``)."""
    B, T, D = x.shape
    _check_cuda("fused_lnqkv_attention x", x, (B, T, D))
    ops = _LnQkvOperands(x, lnp, w, b, n_head)
    stats = torch.empty(B, T, 2, dtype=torch.float32, device=x.device)
    if ops.fused:
        out = torch.empty(B, T, ops.Dq, dtype=torch.bfloat16, device=x.device)
        _build.launch("fmm_lnqkv_attention", *ops.args(), stats.data_ptr(), out.data_ptr(), B,
                      T, D, ops.Dk, n_head, ops.kd, ops.scale)
    else:
        qkv = ops.project(stats, n_head)
        out = fused_attention_cuda(*qkv.split(ops.Dq, dim=-1), n_head, scale=ops.scale)
    return out if ops.kd == ops.hd else unpad_heads(out, n_head, ops.hd, parts=1)


def fused_lnqkv_attention(x, lnp, w, b, n_head: int, GB: int = 4):
    """``attention(qkv(ln(x)))`` per head, before the out-projection:
    ``x (B, T, D)`` -> ``(B, T, D)`` (``lnp`` holds ``scale, bias``; ``w
    (D, 3D)``, ``b (3D,)``). Forward-only, like the TPU kernel:
    :class:`FusedLnQkvAttention` is its differentiable form."""
    _prototype_contract("fused_lnqkv_attention", x, GB)
    if x.requires_grad:
        raise NotImplementedError("fused_lnqkv_attention is forward-only, like the TPU "
                                  "kernel; use make_fused_lnqkv_attention_fb")
    if x.device.type == "cpu":
        return fused_lnqkv_attention_reference(x, lnp, w, b, n_head, GB)
    out = fused_lnqkv_attention_cuda(x.contiguous(), lnp, w, b, n_head)
    fused_lnqkv_attention.launches += 1
    return out


# -- P2: its dx -----------------------------------------------------------------


def fused_lnqkv_attention_bwd_dx_reference(x, lnp, w, b, dy, n_head: int, GB: int = 4):
    """Plain version of :func:`fused_lnqkv_attention_bwd_dx`, on any device."""
    _prototype_contract("fused_lnqkv_attention_bwd_dx", x, GB)
    return ln_attention_backward(x, dy, lnp, w, b, n_head, PLAIN_STEPS)[0]


def fused_lnqkv_attention_bwd_dx_cuda(x, lnp, w, b, dy, n_head: int):
    """P2 on CUDA bf16 ``x`` and ``dy`` ``(B, T, D)`` in three steps:
    ``lnqkv_attention_bwd_dx.cu`` (the LN moments into an fp32 ``(B, T, 2)``
    scratch, then per (row, head) q, k and v recomputed and the attention
    backward, into a bf16 ``(B, T, 3 Dq)`` d(QKV) scratch; streamed where P1
    is: ``fmm_lnqkv_project`` into a QKV scratch, then
    ``attention_core_bwd.cu``), ``gemm_epilogue.cu``'s NT instance (``dxn =
    d(QKV) . W^T``, fp32) and ``layernorm_bwd_rows.cu`` (dx, no parameter
    gradient)."""
    B, T, D = x.shape
    _check_cuda("fused_lnqkv_attention_bwd_dx x", x, (B, T, D))
    _check_cuda("fused_lnqkv_attention_bwd_dx dy", dy, (B, T, D))
    ops = _LnQkvOperands(x, lnp, w, b, n_head)
    g = dy if ops.kd == ops.hd else pad_heads(dy, n_head, ops.kd, parts=1)
    stats = torch.empty(B, T, 2, dtype=torch.float32, device=x.device)
    if ops.fused:
        dqkv = torch.empty(B, T, 3 * ops.Dq, dtype=torch.bfloat16, device=x.device)
        _build.launch("fmm_lnqkv_attention_bwd_dqkv", *ops.args(), g.data_ptr(),
                      stats.data_ptr(), dqkv.data_ptr(), B, T, D, ops.Dk, n_head, ops.kd,
                      ops.scale)
    else:
        dqkv = attention_core_bwd_cuda(ops.project(stats, n_head), g, n_head, scale=ops.scale)
    dxn = gemm_nt_f32_cuda(dqkv.view(B * T, 3 * ops.Dq), ops.w)
    if ops.Dk != D:
        dxn = dxn[:, :D].contiguous()
    dx = layernorm_bwd_rows_cuda(x.view(B * T, D), dxn, None, ops.gamma_d, x.dtype,
                                 param_grads=False)[0]
    return dx.view(B, T, D)


def fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy, n_head: int, GB: int = 4):
    """dx of :func:`fused_lnqkv_attention` for the output cotangent ``dy``,
    recomputed from ``x``; no parameter gradient, like the TPU kernel."""
    _prototype_contract("fused_lnqkv_attention_bwd_dx", x, GB)
    if x.device.type == "cpu":
        return fused_lnqkv_attention_bwd_dx_reference(x, lnp, w, b, dy, n_head, GB)
    dx = fused_lnqkv_attention_bwd_dx_cuda(x.contiguous(), lnp, w, b,
                                           dy.to(x.dtype).contiguous(), n_head)
    fused_lnqkv_attention_bwd_dx.launches += 1
    return dx


class FusedLnQkvAttention(torch.autograd.Function):
    """P1 forward, P2 backward. Only ``x`` gets a gradient: the caller
    refuses a LayerNorm, ``w`` or ``b`` that requires one (the TPU prototype
    returns zeros for them)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, n_head, GB):
        lnp = {"scale": gamma, "bias": beta}
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.n_head, ctx.GB = n_head, GB
        return fused_lnqkv_attention(x.detach(), lnp, w, b, n_head, GB)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, b = ctx.saved_tensors
        dx = fused_lnqkv_attention_bwd_dx(x, {"scale": gamma, "bias": beta}, w, b,
                                          dy.contiguous(), ctx.n_head, ctx.GB)
        return dx, None, None, None, None, None, None


def make_fused_lnqkv_attention_fb(n_head: int, GB: int = 4):
    """``op(x, lnp, w, b)``: :func:`fused_lnqkv_attention`, differentiable in
    ``x`` through :func:`fused_lnqkv_attention_bwd_dx`. Raises if the
    LayerNorm, ``w`` or ``b`` requires a gradient, where the TPU prototype
    would return zeros for them."""

    def op(x, lnp, w, b):
        trainable = [name for name, t in (("ln scale", lnp["scale"]), ("ln bias", lnp["bias"]),
                                          ("w", w), ("b", b)) if t.requires_grad]
        if trainable:
            raise ValueError(f"the fused LN->QKV->attention prototype returns no gradient for "
                             f"{trainable}, but they require one")
        return FusedLnQkvAttention.apply(x, lnp["scale"], lnp["bias"], w, b, n_head, GB)

    return op


# -- P3: head-pair attention -------------------------------------------------


def packed4d_attention_reference(qkv: torch.Tensor, n_head: int, tpad: int = 8):
    """Plain version of :func:`packed4d_attention`: ``qkv`` padded with zero
    tokens to a multiple of ``tpad``, fp32 scores with the padded keys at
    ``-inf`` and fp32 softmax, ``p`` rounded to the storage dtype before
    P.V, fp32 sums, the output cut back to T."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    hd = D // n_head
    Tp = _round_up(T, tpad)
    dt = qkv.dtype
    padded = torch.cat([qkv, qkv.new_zeros(B, Tp - T, D3)], dim=1) if Tp != T else qkv

    def heads(t):
        return t.reshape(B, Tp, n_head, hd).transpose(1, 2).float()

    q, k, v = (heads(t) for t in padded.split(D, dim=-1))
    with full_fp32_products():
        s = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        s = s.masked_fill(torch.arange(Tp, device=qkv.device) >= T, float("-inf"))
        p = torch.softmax(s, dim=-1).to(dt)
        out = torch.matmul(p.float(), v).to(dt)
    return out.transpose(1, 2).reshape(B, Tp, D)[:, :T]


def packed4d_attention_key_tiles(head_dim: int, valid_T: int) -> int:
    """The key tiles ``attention_pair.cu`` holds in registers at this head
    width and ``valid_T``: 4 (one pass over the key tiles) or 0 (two
    passes). Launches nothing."""
    return _build.library().fmm_attention_pair_key_tiles(head_dim, valid_T)


def packed4d_attention_cuda(qkv: torch.Tensor, n_head: int, valid_T: int | None = None):
    """Launch ``attention_pair.cu`` on a CUDA bf16 ``qkv (B, T, 3D)``, any
    T, heads of 8, 16, 32, 64 or 128 filling whole 128-lane groups (heads of
    8 zero-padded to 16, with their own scale, and the output sliced back);
    keys at or past ``valid_T`` (default T) get ``-inf`` (``valid_T`` past T
    lets the zero rows in between take part: a planted fault)."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    _check_cuda("packed4d_attention qkv", qkv, (B, T, D3))
    hd = D // n_head
    kd = PAIR_PADDED_HEAD_DIMS.get(hd, hd)
    if D3 != 3 * D or D != n_head * hd or kd not in PAIR_HEAD_DIMS or D % 128:
        raise ValueError(f"packed4d_attention runs 128-lane head groups of heads of "
                         f"{(*PAIR_PADDED_HEAD_DIMS, *PAIR_HEAD_DIMS)}: D={D}, {n_head} heads")
    valid_T = T if valid_T is None else valid_T
    if valid_T < 1:
        raise ValueError(f"valid_T must be at least 1, got {valid_T}")
    if kd != hd:
        qkv = pad_heads(qkv, n_head, kd)
    out = torch.empty(B, T, n_head * kd, dtype=qkv.dtype, device=qkv.device)
    _build.launch("fmm_attention_pair", qkv.data_ptr(), out.data_ptr(), B, T, n_head * kd,
                  n_head, valid_T, 1.0 / math.sqrt(hd))
    return out if kd == hd else unpad_heads(out, n_head, hd, parts=1)


def packed4d_attention(qkv: torch.Tensor, n_head: int, tpad: int = 8):
    """softmax(q.k^T / sqrt(hd)).v per head over a packed ``(B, T, 3D)``
    QKV tensor -> ``(B, T, D)``, one unit of work per 128-lane head group.
    Forward-only, like the TPU prototype. The kernel masks the keys past T
    itself; ``tpad`` changes only the plain version's padding, which masks
    the same keys."""
    if qkv.requires_grad:
        raise NotImplementedError("packed4d_attention is forward-only, like the TPU "
                                  "prototype; packed_attention is differentiable")
    if qkv.device.type == "cpu":
        return packed4d_attention_reference(qkv, n_head, tpad)
    out = packed4d_attention_cuda(qkv.contiguous(), n_head)
    packed4d_attention.launches += 1
    return out


for _fn in (fused_lnqkv_attention, fused_lnqkv_attention_bwd_dx, packed4d_attention):
    _fn.launches = 0
