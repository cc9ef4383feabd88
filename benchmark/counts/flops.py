"""Operations and bytes of one step, counted from the cell's shapes.

``train_step_flops`` is a frozen copy of the program's analytic count
(``flagship.py::estimate_train_step_flops``, itself the JAX package's
``bench.py``'s): matmul FLOPs at 2*M*N*K, forward linears 24*T*D^2 and
attention 4*T^2*D a block, the backward's activation gradients once more
and attention's twice, the weight gradient of the one trainable vision
block, the patch embedding forward, the text tower at its truncated length
over every class. Recomputation is not counted.

``attention_work`` and ``gemm_work`` list the step's attention calls and
matrix products, each ``{"flops", "bytes"}``: every input read once, every
output written once, in the type the program keeps it (bfloat16 activations
and frozen weights, float32 crops, features and weight gradients), the
same whatever kernel runs it. Causal text attention counts the half of the
scores it needs.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def bound_seconds(ops) -> float:
    """The least time the card needs for ``ops``, each bound by its
    operations or its bytes."""
    return sum(max(o["flops"] / PEAK_BF16_FLOPS, o["bytes"] / PEAK_HBM_BYTES) for o in ops)


def shapes(cfg: dict, mix: dict, text_len: int) -> dict:
    grid = cfg["image_resolution"] // cfg["vision_patch_size"]
    n_ctx = cfg["maple"]["n_ctx"]
    captions = bool(mix.get("captions")) and mix["kind"] == "train"
    return {"B": mix["batch"], "D": cfg["vision_width"], "L": cfg["vision_layers"],
            "grid": grid, "P": cfg["vision_patch_size"], "E": cfg["embed_dim"],
            "T": 1 + grid * grid + n_ctx + int(captions),
            "d": cfg["transformer_width"], "Lt": cfg["transformer_layers"],
            "Tt": text_len, "C": cfg["n_classes"], "S": mix["canvas"],
            "O": cfg["image_resolution"]}


def train_step_flops(cfg: dict, mix: dict, text_len: int, fwd_only: bool = False) -> float:
    s = shapes(cfg, mix, text_len)

    def tower(rows, T, D, layers, trainable_blocks):
        lin_f = 24 * T * D * D
        attn_f = 4 * T * T * D
        fwd = layers * (lin_f + attn_f)
        if fwd_only:
            return rows * fwd
        return rows * (fwd + layers * (lin_f + 2 * attn_f) + trainable_blocks * lin_f)

    flops = tower(s["B"], s["T"], s["D"], s["L"], 1)
    flops += s["B"] * 2 * s["grid"] ** 2 * 3 * s["P"] ** 2 * s["D"]
    flops += tower(s["C"], s["Tt"], s["d"], s["Lt"], 0)
    return float(flops)


def eval_batch_flops(cfg: dict, mix: dict, text_len: int) -> float:
    """The image tower's forward over one eval batch (the text features are
    made once, before the window)."""
    s = shapes(cfg, mix, text_len)
    T, D = s["T"], s["D"]
    return float(s["B"] * (s["L"] * (24 * T * D * D + 4 * T * T * D)
                           + 2 * s["grid"] ** 2 * 3 * s["P"] ** 2 * D))


def _mm(M, N, K, a=2, b=2, c=2, n=1):
    """``n`` products ``(M, K) @ (K, N)``, operands of ``a`` and ``b`` bytes,
    the result of ``c``."""
    return {"flops": 2.0 * M * N * K * n, "bytes": float(n * (a * M * K + b * K * N + c * M * N))}


def _attn(rows, heads, T, hd, causal, backward):
    """Self-attention of ``rows`` sequences: q, k, v read and the output
    written in bfloat16; the backward reads q, k, v, the output and its
    gradient and writes the three gradients."""
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 4.0 * rows * heads * pairs * hd * (2 if backward else 1)
    tensors = 8 if backward else 4
    return {"flops": flops, "bytes": 2.0 * tensors * rows * heads * T * hd}


def attention_work(cfg: dict, mix: dict, text_len: int) -> list:
    s = shapes(cfg, mix, text_len)
    hd = 64
    train = mix["kind"] == "train"
    ops = [_attn(s["B"], s["D"] // hd, s["T"], hd, False, False)] * s["L"]
    if train:
        ops += [_attn(s["B"], s["D"] // hd, s["T"], hd, False, True)] * s["L"]
        ops += [_attn(s["C"], s["d"] // hd, s["Tt"], hd, True, False)] * s["Lt"]
        ops += [_attn(s["C"], s["d"] // hd, s["Tt"], hd, True, True)] * s["Lt"]
    return ops


def _tower_products(rows, D, layers, trainable_blocks, train):
    """A tower's four linears a block: forward; in training the input
    gradient of each, and the weight gradient (float32) of the trainable
    blocks."""
    dims = [(3 * D, D), (D, D), (4 * D, D), (D, 4 * D)]  # (out, in)
    ops = []
    for out, inp in dims:
        ops.append(_mm(rows, out, inp, n=layers))
        if train:
            ops.append(_mm(rows, inp, out, n=layers))
            if trainable_blocks:
                ops.append(_mm(inp, out, rows, c=4, n=trainable_blocks))
    return ops


def gemm_work(cfg: dict, mix: dict, text_len: int) -> list:
    """The step's matrix products but attention's: the crop's two resampling
    products (float32), the patch embedding, the towers' linears, the
    projections and the logits (float32 features)."""
    s = shapes(cfg, mix, text_len)
    B, D, O, S, E, C = s["B"], s["D"], s["O"], s["S"], s["E"], s["C"]
    train = mix["kind"] == "train"
    ops = [_mm(O, S * 3, S, 4, 4, 4, n=B), _mm(O, O * 3, S, 4, 4, 4, n=B),
           _mm(B * s["grid"] ** 2, D, 3 * s["P"] ** 2)]
    ops += _tower_products(B * s["T"], D, s["L"], 1, train)
    ops.append(_mm(B, E, D, c=4))
    ops.append(_mm(B, C, E, 4, 4, 4))
    if train:
        ops += _tower_products(C * s["Tt"], s["d"], s["Lt"], 1, True)
        ops.append(_mm(C, E, s["d"], c=4))
        ops += [_mm(B, E, C, 4, 4, 4), _mm(C, E, B, 4, 4, 4), _mm(B, D, E, 4, 4, 4)]
    return ops
