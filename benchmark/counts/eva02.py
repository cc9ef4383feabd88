"""Operations and bytes of one EVA02-CLIP step, counted from the cell's shapes.

As ``counts/flops.py`` counts CLIP's (matmul FLOPs at 2*M*N*K, the backward's
activation gradients once more and attention's twice, the weight gradients
of the one trainable vision block, the text tower at its truncated length
over every class, recomputation not counted; every input read once and every
output written once, in the type the program keeps it), with EVA's vision
block: the linears are q, k, v and the out-projection at D x D each and the
SwiGLU MLP's three products of width H = 2730 (W1 and W2 as one gated
product of 2H columns, W3), 2 T (4 D^2 + 3 D H) a block's forward, not
CLIP's 24 T D^2. The gated product's entries are tagged ``"part":
"swiglu"``; so is a zero-cost entry that carries the gate's backward
(``eva_rows.cu``'s ``layernorm_bwd_gate``: the saved pair and the fp32
cotangent read, the pair's gradient written) in ``part_bytes`` for
``swiglu_roofline.train``, which adds nothing to ``gemm_roofline.train``.
Text tower, crop, projections and attention as ``flops.py``.
"""

from __future__ import annotations

from benchmark.counts import flops as clip
from benchmark.counts.flops import attention_work  # noqa: F401


def _vision_linear(T, D, H):
    return 2 * T * (4 * D * D + 3 * D * H)


def train_step_flops(cfg: dict, mix: dict, text_len: int, fwd_only: bool = False) -> float:
    s = clip.shapes(cfg, mix, text_len)
    H = cfg["vision_mlp_width"]
    B, T, D, L = s["B"], s["T"], s["D"], s["L"]
    lin, attn = _vision_linear(T, D, H), 4 * T * T * D
    vision = L * (lin + attn) if fwd_only else L * (lin + attn) + L * (lin + 2 * attn) + lin
    flops = B * vision + B * 2 * s["grid"] ** 2 * 3 * s["P"] ** 2 * D
    # the text tower as flops.py counts it (no weight gradient)
    Tt, d, Lt = s["Tt"], s["d"], s["Lt"]
    t_lin, t_attn = 24 * Tt * d * d, 4 * Tt * Tt * d
    text = Lt * (t_lin + t_attn) if fwd_only else Lt * (t_lin + t_attn) + Lt * (t_lin + 2 * t_attn)
    return float(flops + s["C"] * text)


def eval_batch_flops(cfg: dict, mix: dict, text_len: int) -> float:
    s = clip.shapes(cfg, mix, text_len)
    T, D = s["T"], s["D"]
    return float(s["B"] * (s["L"] * (_vision_linear(T, D, cfg["vision_mlp_width"])
                                     + 4 * T * T * D)
                           + 2 * s["grid"] ** 2 * 3 * s["P"] ** 2 * D))


def _swiglu(op: dict, **part) -> dict:
    return dict(op, part="swiglu", **part)


def _vision_products(rows, D, H, layers, train):
    """The vision blocks' products: forward; in training each input gradient
    and the trainable block's weight gradients (float32)."""
    mm = clip._mm
    ops = [mm(rows, 3 * D, D, n=layers), mm(rows, D, D, c=4, n=layers)]
    # the gated product reads a row and W1, W2; writes g (rows, H) and, in
    # training, the pair (rows, 2H) kept for the backward
    gate = mm(rows, 2 * H, D, n=layers)
    gate["bytes"] = float(layers * (2 * rows * D + 2 * D * 2 * H + 2 * rows * H
                                    + (2 * rows * 2 * H if train else 0)))
    ops += [_swiglu(gate), mm(rows, D, H, n=layers)]
    if train:
        ops += [mm(rows, D, 3 * D, c=4, n=layers), mm(rows, D, D, c=4, n=layers),
                mm(rows, D, 2 * H, c=4, n=layers), mm(rows, H, D, c=4, n=layers)]
        ops += [mm(D, 3 * D, rows, c=4), mm(D, D, rows, c=4), mm(D, 2 * H, rows, c=4),
                mm(H, D, rows, c=4)]
        ops.append(_swiglu({"flops": 0.0, "bytes": 0.0},
                           part_flops=0.0,
                           part_bytes=float(layers * rows * H * 12)))
    return ops


def gemm_work(cfg: dict, mix: dict, text_len: int) -> list:
    """The step's matrix products but attention's (``flops.gemm_work``'s list
    with EVA's vision blocks and the head's bias)."""
    s = clip.shapes(cfg, mix, text_len)
    B, D, O, S, E, C = s["B"], s["D"], s["O"], s["S"], s["E"], s["C"]
    train = mix["kind"] == "train"
    mm = clip._mm
    ops = [mm(O, S * 3, S, 4, 4, 4, n=B), mm(O, O * 3, S, 4, 4, 4, n=B),
           mm(B * s["grid"] ** 2, D, 3 * s["P"] ** 2)]
    ops += _vision_products(B * s["T"], D, cfg["vision_mlp_width"], s["L"], train)
    ops.append(mm(B, E, D, c=4))
    ops.append(mm(B, C, E, 4, 4, 4))
    if train:
        ops += clip._tower_products(C * s["Tt"], s["d"], s["Lt"], 1, True)
        ops.append(mm(C, E, s["d"], c=4))
        ops += [mm(B, E, C, 4, 4, 4), mm(C, E, B, 4, 4, 4), mm(B, D, E, 4, 4, 4)]
    return ops
