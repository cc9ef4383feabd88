#!/usr/bin/env python3
"""Drive the PyTorch port's MaPLe eval path and train step on one NVIDIA GPU
and hold its hand-written CUDA kernels against their plain PyTorch versions.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

What it does, in order (any failure raises and exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels from ``federated_multi_modal_tpu_torch/csrc`` (nvcc,
   ``sm_90a``) and prints the build time and each kernel's resource use;
3. builds the MaPLe program at ViT-B/16 width (random init from a seed,
   1000 classes, n_ctx 2, prompt depth 9, captions on, bf16 policy), runs
   ``eval_prepare_fn`` once and ``eval_apply_fn`` once on a seeded uint8
   canvas batch of 512 through ``crop_resize_flip_normalize``, and checks
   that the logits are finite and that each ported kernel was launched once
   per block (counts set to 0 just before each run, read just after);
4. holds each kernel against its plain version on the inputs the main path
   handed to it (the first text block's qkv and mask, the first vision
   block's x and weights), the block's every step against its plain step,
   the block again with seeded non-zero biases and LayerNorm affines, and
   the whole path against the plain path on 16 images;
5. times each kernel, its plain version and a PyTorch library call that
   computes the same function (``scaled_dot_product_attention`` for the
   text attention, ``TransformerEncoderLayer`` for the block) with CUDA
   events, and the eval path end to end;
6. drives the train step (``loss_fn`` of the same program and
   ``engine/trainer.py::make_train_step`` with the federated SGD) at batch
   512 with random crops and captions: one step with the counts set to 0
   just before and read just after (each text block must launch K1 and
   K1b once, vision blocks 0-10 K3 and block 11 K4), then five timed
   steps (median ms, TFLOP/s against the analytic count, losses, peak
   memory) and one under the profiler (device busy and idle share, device
   ms by kernel);
7. holds K1b, K3 and K4 against their plain versions on the inputs and
   cotangents the first step handed them (forward, saved residuals, every
   gradient), again with a seeded cotangent of unit scale (the blocks also
   with non-zero biases and LayerNorm affines), and one whole 16-image step
   (loss and every trainable gradient) on the kernel path against the
   plain path; plants a fault for each of these limits and fails unless
   the comparison catches it; holds ``logits_fn`` of the trained state
   against the prompt-cached eval path;
8. times K1b, K3 and K4 (forward and backward), their plain versions and
   their library yardsticks (SDPA's backward; ``TransformerEncoderLayer``
   forward and backward with frozen or trainable weights);
9. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
import types

import numpy as np

# H100 SXM data sheet (dense): the least time the card could take is the
# larger of bytes over the memory rate and operations over the peak rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

BATCH = 512
N_CLASSES = 1000
E2E_IMAGES = 16
# Tolerances, |kernel - plain| <= atol + rtol * |plain| elementwise.
# Both sides round to bf16 at the same points; fp32 sums in another order
# may flip a rounding, one bf16 step (2**-8 relative) at an intermediate or
# at the output. K1's output is one rounding after fp32 sums: two steps.
# The block has four bf16 intermediates before its bf16 output: four steps.
TOL_K1 = 2.0 ** -6
TOL_K5 = 2.0 ** -5
# The block's seven steps, each held against its plain step on the same
# inputs: one rounding of a bf16 output (at most 2**-7 of the value), or fp32
# sums in another order for the fp32 y (and for y - x, the attention branch
# alone). The attention step keeps K1's tolerance.
TOL_STEP_BF16 = 2.0 ** -7
TOL_STEP_F32 = 2.0 ** -12
# The block with seeded weights, biases and LayerNorm affines (both branches
# O(1) beside x): the QKV and fc/proj products have gains of ~1.4 and ~2.8,
# so a one-step flip upstream can reach two steps downstream: eight steps.
SEEDED_STD = {"w": 0.05, "b": 0.25, "ln": 0.25}
TOL_K5_SEEDED = 2.0 ** -4
# The library's block (bf16 residual adds and LayerNorm weights) against the
# plain version: a check that its weights were copied right, not a bound.
TOL_LIBRARY = 2.0 ** -3
# End to end: twelve blocks of each tower in bf16, then cosine logits at
# scale exp(log(1/0.07)) = 14.29; 0.1 is 0.7 % of that scale.
TOL_E2E = 0.1

# The train path.
TRAIN_STEPS = 5
STEP_IMAGES = 16
# Gradients are held as max |kernel - plain| over max |plain|, so that a
# cotangent of any scale (the step's are ~1e-6) is held to its own size.
# K1b: dS is rounded to bf16 before the dQ and dK sums, so a flipped
# rounding moves an output by one bf16 step of a term: 2**-5 of the largest
# value. K3 and K4's dx: one bf16 step of the largest value is up to 2**-7
# of it, and four bf16 intermediates upstream may flip too: 2**-5.
TOL_K1B = 2.0 ** -5
TOL_TRAIN_DX = 2.0 ** -5
# K3 and K4's bf16 block output and saved qkv and h at the block's 2**-5
# (four bf16 intermediates, elementwise abs + rel); the fp32 parameter
# gradients, sums over 102,400 rows of bf16 products whose factors may each
# differ by a flipped rounding, at 2**-6 of each gradient's largest value.
TOL_TRAIN_ACT = 2.0 ** -5
TOL_TRAIN_PARAM = 2.0 ** -6
# The seeded blocks (both branches O(1) beside x) at the seeded K5's 2**-4:
# a flipped rounding upstream is amplified by the products' gains.
TOL_TRAIN_SEEDED = 2.0 ** -4
# One whole 16-image step, kernel path against plain path, each trainable
# gradient as max |err| over max |value|. The loss to 2**-8 relative. The
# vision tower's gradients, which the vision kernels (K3, K4) produce, to
# 2**-5; every other leaf (text tower and prompt learner) to 2**-3. Those
# carry rounding noise of 2 to 9 % of their largest value: they reach the
# text tower through the normalized text features, whose gradient is what
# is left of the image features after the normalization's projection, so a
# small change of the image features moves it much more. The script prints
# this comparison's noise floor, the plain path against itself with one
# pixel of each image moved by one bf16 step, and plants faults that each
# limit must catch (see PLANTED_FAULT_ROWS).
TOL_STEP_LOSS = 2.0 ** -8
TOL_STEP_GRAD_VISION = 2.0 ** -5
TOL_STEP_GRAD_OTHER = 2.0 ** -3
# The planted faults drop the last rows of a sum or a write, the usual fault
# of a kernel's ragged tail: 256 rows, one row block of layernorm_bwd_rows.
PLANTED_FAULT_ROWS = 256


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of ``fn`` ending in a synchronize."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: float, flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, ref, tol: float) -> dict:
    d = (got.float() - ref.float()).abs()
    allowed = tol + tol * ref.float().abs()
    return {
        "max_abs_err": float(d.max()),
        "mean_abs_err": float(d.mean()),
        "max_err_over_tol": float((d / allowed).max()),
        "tol": {"atol": tol, "rtol": tol},
        "ok": bool((d <= allowed).all()),
    }


def brief(cmps: dict) -> dict:
    """Each comparison as ``[max |err|, err / tolerance]``."""
    return {k: [float(f"{c['max_abs_err']:.4g}"), float(f"{c['max_err_over_tol']:.4g}")]
            for k, c in cmps.items()}


def compare_scaled(got, ref, tol: float) -> dict:
    """``max |got - ref| <= tol * max |ref|``: for sums whose small entries
    carry no relative accuracy (parameter gradients)."""
    d = (got.float() - ref.float()).abs()
    scale = float(ref.float().abs().max())
    rel = float(d.max()) / max(scale, 1e-30)
    return {
        "max_abs_err": float(d.max()), "max_err_over_max": rel,
        "max_err_over_tol": rel / tol, "tol": {"of_max": tol},
        "ok": rel <= tol,
    }


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; return its kernels in order
    as ``(name, device us)`` and the window's host wall time in us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in kernels], wall_us


def short_name(name: str) -> str:
    for key in ("attention_core_bwd", "attention_core", "gemm_epilogue",
                "layernorm_bwd_rows", "layernorm_rows", "column_sum"):
        if key in name:
            f32_in = "IfE" in name or "<float>" in name
            if key == "gemm_epilogue":
                return key + {"ILi0E": "<NN>", "ILi1E": "<NT>", "ILi2E": "<TN>"}.get(
                    next((t for t in ("ILi0E", "ILi1E", "ILi2E") if t in name), ""), "")
            return key + ("<f32 in>" if key == "layernorm_rows" and f32_in else "")
    return name[:60]


def block_step_by_step(x, p, n_head: int):
    """Run one block through its CUDA steps and hold each step against its
    plain step on the same inputs, so that a fault in one step shows at that
    step's own tolerance and is not hidden under the residual. Returns the
    block's output and the comparisons by step."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    cmps = {}
    names = {"layernorm": iter(("ln_1", "ln_2")),
             "gemm": iter(("qkv", "out_proj_y", "fc_gelu", "proj")),
             "attention": iter(("attention",))}

    def held(kind, cuda_step, plain_step):
        def step(*args, **kwargs):
            got = cuda_step(*args, **kwargs)
            ref = plain_step(*args, **kwargs)
            name = next(names[kind])
            tol = (TOL_K1 if kind == "attention" else
                   TOL_STEP_F32 if got.dtype == torch.float32 else TOL_STEP_BF16)
            cmps[name] = compare(got, ref, tol)
            if name == "out_proj_y":
                x2 = kwargs["residual"].float()
                cmps["attention_branch"] = compare(got - x2, ref - x2, TOL_STEP_F32)
            return got
        return step

    out = k_block._block(
        x.contiguous(), p, n_head,
        held("layernorm", k_block.layernorm_rows_cuda, k_block.layernorm_rows_reference),
        held("gemm", k_block.gemm_epilogue_cuda, k_block.gemm_epilogue_reference),
        held("attention", k_attn.attention_core_cuda, k_attn.attention_core_reference))
    return out, cmps


def seeded_block(blk, seed: int):
    """Weights of ``blk``'s shapes and dtypes with every epilogue live:
    weights N(0, 0.05^2), biases N(0, 0.25^2), LayerNorm scale 1 + N(0,
    0.25^2) and bias N(0, 0.25^2), drawn from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def draw(t, mean, std):
        return (mean + std * torch.randn(t.shape, generator=gen)).to(t.device, t.dtype)

    out = {}
    for part, leaves in blk.items():
        out[part] = {}
        for name, t in leaves.items():
            if part.startswith("ln"):
                out[part][name] = draw(t, float(name == "scale"), SEEDED_STD["ln"])
            else:
                out[part][name] = draw(t, 0.0, SEEDED_STD[name[0]])
    return out


def library_block(blk, n_head: int):
    """``torch.nn.TransformerEncoderLayer`` (pre-LN, QuickGELU, bf16) holding
    ``blk``'s weights: one PyTorch call that computes the whole block. The
    port never calls it; it is the yardstick for ``fused_block_residual``."""
    import torch

    w_fc = blk["mlp"]["w_fc"]
    D, hidden = w_fc.shape
    layer = torch.nn.TransformerEncoderLayer(
        D, n_head, hidden, dropout=0.0,
        activation=lambda t: t * torch.sigmoid(1.702 * t), layer_norm_eps=1e-5,
        batch_first=True, norm_first=True, device=w_fc.device,
        dtype=torch.bfloat16).eval()
    pairs = [
        (layer.self_attn.in_proj_weight, blk["attn"]["w_qkv"].T),
        (layer.self_attn.in_proj_bias, blk["attn"]["b_qkv"]),
        (layer.self_attn.out_proj.weight, blk["attn"]["w_out"].T),
        (layer.self_attn.out_proj.bias, blk["attn"]["b_out"]),
        (layer.linear1.weight, blk["mlp"]["w_fc"].T),
        (layer.linear1.bias, blk["mlp"]["b_fc"]),
        (layer.linear2.weight, blk["mlp"]["w_proj"].T),
        (layer.linear2.bias, blk["mlp"]["b_proj"]),
        (layer.norm1.weight, blk["ln_1"]["scale"]),
        (layer.norm1.bias, blk["ln_1"]["bias"]),
        (layer.norm2.weight, blk["ln_2"]["scale"]),
        (layer.norm2.bias, blk["ln_2"]["bias"]),
    ]
    with torch.no_grad():
        for dst, src in pairs:
            dst.copy_(src)
    return layer


@contextlib.contextmanager
def patched(obj, **attrs):
    """Set attributes of ``obj`` (a module of the port: the kernel modules
    that the primitives call, a kernel step) to stand-ins (recorders, the
    plain versions, planted faults), then put the real ones back."""
    saved = {name: getattr(obj, name) for name in attrs}
    for name, stand_in in attrs.items():
        setattr(obj, name, stand_in)
    try:
        yield
    finally:
        for name, real in saved.items():
            setattr(obj, name, real)


def seeded_cotangent(like, seed: int):
    """A standard-normal tensor of ``like``'s shape, dtype and device, drawn
    on the device from ``seed``: a cotangent of unit scale."""
    import torch

    gen = torch.Generator(device=like.device).manual_seed(seed)
    return torch.randn(like.shape, generator=gen, device=like.device).to(like.dtype)


# -- planted faults: each must break the comparison that should see it ------


def fault_dx_tail_zero(layernorm_bwd):
    """LN1's backward (the one writing the block's bf16 dx) leaves the last
    rows of dx unwritten (zero)."""
    import torch

    def faulty(x, dxn, dres, gamma, out_dtype, copy_bf16=False):
        dx, copy, dg, db = layernorm_bwd(x, dxn, dres, gamma, out_dtype, copy_bf16)
        if out_dtype != torch.float32:
            dx[-PLANTED_FAULT_ROWS:] = 0
        return dx, copy, dg, db
    return faulty


def fault_weight_grad_tail(gemm_tn):
    """The weight-gradient products skip the last rows of the batch."""
    def faulty(a, b):
        return gemm_tn(a[:-PLANTED_FAULT_ROWS], b[:-PLANTED_FAULT_ROWS])
    return faulty


def fault_ln_grad_tail(layernorm_bwd):
    """The LayerNorm backward's d gamma and d beta skip the last rows."""
    def faulty(x, dxn, dres, gamma, out_dtype, copy_bf16=False):
        dx, copy, dg, db = layernorm_bwd(x, dxn, dres, gamma, out_dtype, copy_bf16)
        tail = slice(-PLANTED_FAULT_ROWS, None)
        _, _, dg_t, db_t = layernorm_bwd(x[tail], dxn[tail], dres[tail], gamma, out_dtype)
        return dx, copy, dg - dg_t, db - db_t
    return faulty


def fault_mask_dropped(attention_bwd):
    """The attention backward ignores the mask it is given."""
    def faulty(qkv, g, n_head, mask=None):
        return attention_bwd(qkv, g, n_head, None)
    return faulty


def _detached_block(p, grad_leaves):
    """``p`` detached from the main path's graph; the leaves named in
    ``grad_leaves`` require a gradient again."""
    return {a: {b: t.detach().requires_grad_((a, b) in grad_leaves)
                for b, t in leaves.items()} for a, leaves in p.items()}


def block_train_checks(x, dy, p, n_head: int, wgrad: bool,
                       tol_act: float = TOL_TRAIN_ACT, steps=None) -> dict:
    """K3 (``wgrad=False``) or K4 on ``x``, ``dy`` and ``p``: the CUDA
    forward (output and saved residuals) and backward (dx and every
    gradient, on the kernel's own residuals) against the plain steps,
    bf16 activations at ``tol_act``. ``steps`` replaces the CUDA steps
    (a planted fault)."""
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    cuda, plain = steps or k_block.CUDA_STEPS, k_block.PLAIN_STEPS
    out, qkv, h = k_block.block_train_forward(x, p, n_head, cuda, save_h=not wgrad)
    r_out, r_qkv, r_h = k_block.block_train_forward(x, p, n_head, plain, save_h=not wgrad)
    cmps = {"out": compare(out, r_out, tol_act), "qkv": compare(qkv, r_qkv, tol_act)}
    if not wgrad:
        cmps["h"] = compare(h, r_h, tol_act)
    del r_out, r_qkv, r_h
    dx, grads = k_block.block_train_backward(x, dy, p, n_head, qkv, h, cuda, wgrad)
    r_dx, r_grads = k_block.block_train_backward(x, dy, p, n_head, qkv, h, plain, wgrad)
    cmps["dx"] = compare_scaled(dx, r_dx, TOL_TRAIN_DX)
    for name, g in grads.items():
        cmps[".".join(name)] = compare_scaled(g, r_grads[name], TOL_TRAIN_PARAM)
    return cmps


def step_loss_and_grads(loss_fn, trainable, frozen, batch):
    """The loss of ``batch`` and the gradient of every trainable leaf that
    it reaches, by name."""
    import torch

    from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path

    leaves = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), trainable)
    flat = flatten(leaves)
    loss, _ = loss_fn(leaves, frozen, batch)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return float(loss.detach()), {k: g for k, g in zip(flat, grads) if g is not None}


def hold_step(got, ref) -> dict:
    """One whole step's ``(loss, grads)`` against another's: the loss
    relative error and, for each gradient, max |err| over max |value|, the
    vision tower's leaves at ``TOL_STEP_GRAD_VISION``, the rest at
    ``TOL_STEP_GRAD_OTHER``."""
    (loss, grads), (r_loss, r_grads) = got, ref
    assert grads.keys() == r_grads.keys(), grads.keys() ^ r_grads.keys()
    errs = {k: compare_scaled(g, r_grads[k], 1.0)["max_err_over_max"]
            for k, g in grads.items()}
    loss_rel = abs(loss - r_loss) / abs(r_loss)
    out = {"loss_rel_err": loss_rel, "loss_tol": TOL_STEP_LOSS,
           "ok": loss_rel <= TOL_STEP_LOSS, "grads": len(errs)}
    for part, tol, names in (
            ("vision", TOL_STEP_GRAD_VISION, [k for k in errs if ".visual." in k]),
            ("other", TOL_STEP_GRAD_OTHER, [k for k in errs if ".visual." not in k])):
        worst = max(names, key=errs.get)
        out[part] = {"leaves": len(names), "worst": worst,
                     "worst_err_over_max": errs[worst], "tol_of_max": tol,
                     "max_err_over_tol": errs[worst] / tol, "ok": errs[worst] <= tol}
        out["ok"] &= out[part]["ok"]
    out["max_err_over_tol"] = max(out["vision"]["max_err_over_tol"],
                                  out["other"]["max_err_over_tol"])
    out["errs"] = errs
    return out


def library_block_ms(blk, n_head: int, x, dy, weights_grad: bool) -> tuple:
    """Forward and backward of ``torch.nn.TransformerEncoderLayer`` holding
    ``blk``'s weights (the yardstick of K3 with frozen weights, of K4 with
    trainable ones): median ms by CUDA events."""
    import torch

    layer = library_block(blk, n_head)
    params = [q for q in layer.parameters()]
    for q in params:
        q.requires_grad_(weights_grad)
    wanted = params if weights_grad else []

    def fwd_bwd():
        xr = x.detach().requires_grad_(True)
        torch.autograd.grad(layer(xr), [xr] + wanted, dy)

    ms = cuda_ms(fwd_bwd, 5)
    del layer
    return ms


def check_train_launches(counts: dict, arch) -> None:
    """Each text block launches K1 and K1b once per step, vision blocks
    0-10 K3 (forward and backward) and block 11 K4."""
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    expected = {"K1 packed_attention_masked": n_text,
                "K1b packed_attention_masked_bwd": n_text,
                "K3 fused_block_train": n_vis - 1,
                "K3 fused_block_train (backward)": n_vis - 1,
                "K4 fused_block_train_dw": 1, "K4 fused_block_train_dw (backward)": 1}
    wrong = {k: (counts[k], v) for k, v in expected.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"launches per train step (got, expected): {wrong}")


def train_phase(prog, canvas) -> tuple:
    """The train path: the step with its kernels recorded, the timed steps,
    the kernel checks on the step's own inputs, the whole 16-image step
    against the plain path, and the timings. Returns ``(rows, checks,
    summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
    from federated_multi_modal_tpu_torch.flagship import (
        build_fed_optimizer,
        estimate_train_step_flops,
        example_batch,
    )
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.tokenizer import tokenize

    arch = prog["arch"]
    res = arch.image_resolution
    frozen = prog["frozen"]
    loss_fn = prog["loss_fn"]
    tx = build_fed_optimizer()
    train_step = make_train_step(loss_fn, tx)
    state = {"trainable": prog["trainable"], "opt": tx.init(prog["trainable"])}
    rng = np.random.default_rng(1)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, BATCH)).cuda()
    captions = torch.from_numpy(tokenize(["a satellite photo of a scene"] * BATCH)).cuda()
    gen = torch.Generator(device=canvas.device).manual_seed(2)

    def make_batch():
        boxes, flips = sample_rrc_boxes_torch(gen, BATCH, canvas.shape[1])
        images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=res)
        return {"image": images, "label": labels, "caption_tokens": captions}

    def one_step():
        state["trainable"], state["opt"], loss, gnorm = train_step(
            state["trainable"], frozen, state["opt"], make_batch())
        return loss, gnorm

    # -- the step, with the first inputs and cotangents of each kernel ------
    first = {}

    def keep_cotangent(key, out):
        def hook(g):
            first[key]["dy"] = g.detach().clone()
        out.register_hook(hook)

    def attn_rec(qkv, mask, n_head):
        out = k_attn.packed_attention_masked(qkv, mask, n_head)
        if "k1b" not in first and out.requires_grad:
            first["k1b"] = {"qkv": qkv.detach(), "mask": mask, "n_head": n_head}
            keep_cotangent("k1b", out)
        return out

    def block_rec(key, fn):
        def rec(x, p, n_head):
            out = fn(x, p, n_head)
            if key not in first:
                first[key] = {"x": x.detach(), "p": p, "n_head": n_head}
                keep_cotangent(key, out)
            return out
        return rec

    attn_ns = types.SimpleNamespace(packed_attention_masked=attn_rec)
    block_ns = types.SimpleNamespace(
        fused_block_eligible=k_block.fused_block_eligible,
        WEIGHT_LEAVES=k_block.WEIGHT_LEAVES,
        fused_block_residual=k_block.fused_block_residual,
        fused_block_train=block_rec("k3", k_block.fused_block_train),
        fused_block_train_dw=block_rec("k4", k_block.fused_block_train_dw))
    counters = {"K1 packed_attention_masked": k_attn.packed_attention_masked,
                "K1b packed_attention_masked_bwd": k_attn.packed_attention_masked_bwd,
                "K3 fused_block_train": k_block.fused_block_train,
                "K4 fused_block_train_dw": k_block.fused_block_train_dw}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, "backward_launches"):
                fn.backward_launches = 0
        _build.reset_launches()

    with patched(primitives, _attn_kernels=attn_ns, _block_kernels=block_ns):
        reset_counts()
        t0 = time.perf_counter()
        loss0, gnorm0 = one_step()
        torch.cuda.synchronize()
        first_step_s = time.perf_counter() - t0
        counts = {}
        for name, fn in counters.items():
            counts[name] = fn.launches
            if hasattr(fn, "backward_launches"):
                counts[name + " (backward)"] = fn.backward_launches
        counts.update(_build.LAUNCHES)
    print("launches, one train step:", json.dumps(counts))
    check_train_launches(counts, arch)
    assert bool(torch.isfinite(loss0)), "non-finite first loss"
    print(f"first step (with its recorders): {first_step_s:.2f} s, loss "
          f"{float(loss0):.6f}, gnorm {float(gnorm0):.4f}")

    # -- the timed steps -----------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    median_ms = statistics.median(step_ms)
    flops = estimate_train_step_flops(arch, BATCH, N_CLASSES, prog["text_len"],
                                      use_captions=True)
    print(f"train step: median {median_ms:.2f} ms of {TRAIN_STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{flops / median_ms / 1e9:.2f} TFLOP/s of {flops / 1e12:.2f} TFLOP "
          f"(analytic), {BATCH / median_ms * 1e3:.1f} images/s, peak "
          f"{peak_gib:.2f} GiB")
    print("train losses:", json.dumps(losses))
    assert all(np.isfinite(losses)), losses

    step_kernels, step_wall_us = device_profile(one_step)
    by_name = {}
    for name, us in step_kernels:
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + us
    busy_us = sum(by_name.values())
    print(f"one train step: wall {step_wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / step_wall_us:.3f}")
    print("  device ms by kernel:", json.dumps(
        {k: round(v / 1e3, 3) for k, v in
         sorted(by_name.items(), key=lambda kv: -kv[1])[:14]}))

    # -- K1b, K3 and K4 against their plain versions -----------------------
    # On the main path's own inputs and cotangents, then with a seeded
    # cotangent of unit scale (and, for the blocks, seeded weights), then
    # with a planted fault that the comparison must catch.
    r = first["k1b"]
    qkv, mask, n_t, g = r["qkv"], r["mask"], r["n_head"], r["dy"].contiguous()
    g_unit = seeded_cotangent(g, seed=5)

    def k1b_check(g):
        return compare_scaled(k_attn.packed_attention_masked_bwd(qkv, g, mask, n_t),
                              k_attn.attention_core_bwd_reference(qkv, g, n_t, mask),
                              TOL_K1B)

    k1b_cmp, k1b_unit = k1b_check(g), k1b_check(g_unit)
    with patched(k_attn, attention_core_bwd_cuda=fault_mask_dropped(
            k_attn.attention_core_bwd_cuda)):
        k1b_fault = k1b_check(g_unit)
    print("K1b packed_attention_masked_bwd vs plain, main path's cotangent:",
          json.dumps(k1b_cmp))
    print("K1b vs plain, seeded unit cotangent:", json.dumps(k1b_unit))
    print("K1b planted fault (mask dropped in the backward):", json.dumps(k1b_fault))

    checks = [("K1b", k1b_cmp), ("K1b seeded cotangent", k1b_unit),
              ("K1b planted fault caught", {"ok": not k1b_fault["ok"]})]
    block_cmps = {}
    for key, wgrad in (("k3", False), ("k4", True)):
        r = first[key]
        x, dy, n_v = r["x"], r["dy"].contiguous(), r["n_head"]
        p = _detached_block(r["p"], ())
        cmps = block_train_checks(x, dy, p, n_v, wgrad)
        print(f"{key.upper()} vs plain, main path's inputs, [max |err|, err/tol]:",
              json.dumps(brief(cmps)))
        p_seeded, dy_unit = seeded_block(p, seed=3), seeded_cotangent(dy, seed=4)
        seeded = block_train_checks(x, dy_unit, p_seeded, n_v, wgrad, TOL_TRAIN_SEEDED)
        print(f"{key.upper()} vs plain, seeded block and unit cotangent, "
              "[max |err|, err/tol]:", json.dumps(brief(seeded)))
        checks += [(f"{key.upper()} {n}", c) for n, c in cmps.items()]
        checks += [(f"{key.upper()} seeded {n}", c) for n, c in seeded.items()]
        block_cmps[key] = cmps
        # K3: dx with its last rows unwritten, on the main path's inputs;
        # K4: weight gradients that skip the last rows, on the seeded block.
        if wgrad:
            what = f"weight gradients skip the last {PLANTED_FAULT_ROWS} rows"
            faulty = k_block.CUDA_STEPS._replace(
                gemm_tn=fault_weight_grad_tail(k_block.gemm_tn_cuda))
            fault = block_train_checks(x, dy_unit, p_seeded, n_v, wgrad,
                                       TOL_TRAIN_SEEDED, faulty)
            seen = [k for k in fault if k.endswith(("w_qkv", "w_out", "w_fc", "w_proj"))]
        else:
            what = f"the last {PLANTED_FAULT_ROWS} rows of dx unwritten"
            faulty = k_block.CUDA_STEPS._replace(
                layernorm_bwd=fault_dx_tail_zero(k_block.layernorm_bwd_rows_cuda))
            fault = block_train_checks(x, dy, p, n_v, wgrad, steps=faulty)
            seen = ["dx"]
        print(f"{key.upper()} planted fault ({what}), [max |err|, err/tol]:",
              json.dumps(brief({k: fault[k] for k in seen})))
        checks += [(f"{key.upper()} planted fault caught by {k}", {"ok": not fault[k]["ok"]})
                   for k in seen]
        del p_seeded, dy_unit, seeded, fault
        torch.cuda.empty_cache()

    # -- one whole 16-image step: kernel path against plain path ------------
    small = {k: v[:STEP_IMAGES] for k, v in make_batch().items()}
    tr = state["trainable"]
    kernel_step = step_loss_and_grads(loss_fn, tr, frozen, small)
    plain_attn = types.SimpleNamespace(
        packed_attention_masked=k_attn.packed_attention_masked_reference)
    plain_block = types.SimpleNamespace(
        fused_block_eligible=k_block.fused_block_eligible,
        WEIGHT_LEAVES=k_block.WEIGHT_LEAVES,
        fused_block_residual=k_block.fused_block_residual_reference,
        fused_block_train=k_block.fused_block_train_reference,
        fused_block_train_dw=k_block.fused_block_train_dw_reference)
    with patched(primitives, _attn_kernels=plain_attn, _block_kernels=plain_block):
        plain_step = step_loss_and_grads(loss_fn, tr, frozen, small)
        # The noise floor of this comparison: the plain path again with one
        # pixel of each image moved by one bf16 step.
        nudged = dict(small, image=small["image"].clone())
        px = (torch.arange(STEP_IMAGES), 5, 7, 1)
        nudged["image"][px] = (small["image"][px].float() * (1 + 2 ** -7)).to(
            small["image"].dtype)
        noise_step = step_loss_and_grads(loss_fn, tr, frozen, nudged)
    step_cmp = hold_step(kernel_step, plain_step)
    noise = hold_step(noise_step, plain_step)
    # Planted faults, one for each limit: the vision LayerNorms' gradients
    # skip the last rows (vision limit); K1b ignores the mask (the rest).
    with patched(k_block, CUDA_STEPS=k_block.CUDA_STEPS._replace(
            layernorm_bwd=fault_ln_grad_tail(k_block.layernorm_bwd_rows_cuda))):
        fault_vision = hold_step(step_loss_and_grads(loss_fn, tr, frozen, small), plain_step)
    with patched(k_attn, attention_core_bwd_cuda=fault_mask_dropped(
            k_attn.attention_core_bwd_cuda)):
        fault_text = hold_step(step_loss_and_grads(loss_fn, tr, frozen, small), plain_step)
    errs = step_cmp.pop("errs")
    for c in (noise, fault_vision, fault_text):
        del c["errs"]
    step_cmp["noise_floor"] = noise
    print(f"whole step, {STEP_IMAGES} images, kernel path vs plain path:",
          json.dumps(step_cmp))
    print("  max |err| over max |value| of each trainable gradient:",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    print("  planted fault, vision LayerNorm gradients skip the last "
          f"{PLANTED_FAULT_ROWS} rows:", json.dumps(fault_vision))
    print("  planted fault, K1b ignores the mask:", json.dumps(fault_text))
    checks += [("whole step", step_cmp),
               ("whole step planted fault caught by the vision limit",
                {"ok": not fault_vision["vision"]["ok"]}),
               ("whole step planted fault caught by the other limit",
                {"ok": not fault_text["other"]["ok"]})]
    del kernel_step, plain_step, noise_step, nudged

    # -- logits_fn of the trained state against the prompt-cached eval path --
    images = example_batch(arch, STEP_IMAGES, N_CLASSES, use_captions=False,
                           seed=6, device=canvas.device)["image"]
    with torch.no_grad():
        logits_train = prog["logits_fn"](tr, frozen, images)
        logits_eval = prog["eval_apply_fn"](tr, frozen, images,
                                            prog["eval_prepare_fn"](tr, frozen))
    logits_cmp = compare(logits_train, logits_eval, TOL_E2E)
    print(f"logits_fn (train towers) vs eval path, trained state, {STEP_IMAGES} "
          "images:", json.dumps(logits_cmp))
    checks.append(("logits_fn vs eval path", logits_cmp))
    del small, logits_train, logits_eval, images

    # -- timings ---------------------------------------------------------------
    B1, T1, D3 = qkv.shape
    D1 = D3 // 3
    hd = D1 // n_t
    k1b_ms = cuda_ms(lambda: k_attn.packed_attention_masked_bwd(qkv, g, mask, n_t), 20)
    k1b_plain_ms = cuda_ms(lambda: k_attn.attention_core_bwd_reference(qkv, g, n_t, mask), 10)
    q, k, v = (t.reshape(B1, T1, n_t, hd).transpose(1, 2).detach().requires_grad_(True)
               for t in qkv.split(D1, dim=-1))
    g_heads = g.reshape(B1, T1, n_t, hd).transpose(1, 2)
    sdpa_mask = mask.to(qkv.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(q, k, v, attn_mask=sdpa_mask), (q, k, v), g_heads)

    sdpa_fb_ms = cuda_ms(sdpa_fwd_bwd, 20)
    sdpa_f_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=sdpa_mask), 20)
    k1b_lib_ms = sdpa_fb_ms - sdpa_f_ms
    finite_pairs = int(torch.isfinite(mask).sum())
    k1b_bound = bound(2 * qkv.numel() * 2 + g.numel() * 2 + mask.numel() * 4,
                      10 * B1 * n_t * hd * finite_pairs)

    rows = [{
        "name": "packed_attention_masked_bwd", "route": "cuda",
        "source": "federated_multi_modal_tpu_torch/csrc/attention_core_bwd.cu",
        "replaces": "federated_multi_modal_tpu/ops/pallas/attention.py:533",
        "tpu_function": "attention_packed_bwd_masked",
        "shape": [list(qkv.shape), list(mask.shape), n_t],
        "launches": counts["K1b packed_attention_masked_bwd"],
        "max_abs_err": k1b_cmp["max_abs_err"], "tol": k1b_cmp["tol"],
        "ms": k1b_ms, "plain_ms": k1b_plain_ms,
        "bound_ms": k1b_bound[0], "bound_by": k1b_bound[1],
        "library_ms": k1b_lib_ms,
        "library_call": "torch.nn.functional.scaled_dot_product_attention "
                        "(float mask), forward + backward minus forward",
    }]
    for key, wgrad, name, line, fn, plain in (
            ("k3", False, "fused_block_train", 1236, k_block.fused_block_train,
             k_block.fused_block_train_reference),
            ("k4", True, "fused_block_train_dw", 1307, k_block.fused_block_train_dw,
             k_block.fused_block_train_dw_reference)):
        r = first[key]
        x, dy, n_v = r["x"], r["dy"].contiguous(), r["n_head"]
        grad_leaves = k_block.BLOCK_LEAVES if wgrad else k_block.LN_LEAVES
        p = _detached_block(r["p"], grad_leaves)
        wanted = [p[a][b] for a, b in grad_leaves]

        def fwd_bwd(fn=fn, x=x, p=p, n_v=n_v, dy=dy, wanted=wanted):
            xr = x.detach().requires_grad_(True)
            torch.autograd.grad(fn(xr, p, n_v), [xr] + wanted, dy)

        ms = cuda_ms(fwd_bwd, 10)
        launches, _ = device_profile(fwd_bwd)
        print(f"one {name} forward + backward, device us per launch:",
              json.dumps([[short_name(n), round(us, 1)] for n, us in launches]))
        plain_ms = cuda_ms(lambda: fwd_bwd(fn=plain), 3, 1)
        lib_ms = library_block_ms(_detached_block(r["p"], ()), n_v, x, dy, wgrad)
        B5, T5, D5 = x.shape
        M5 = B5 * T5
        hidden = p["mlp"]["w_fc"].shape[1]
        weight_elems = 4 * D5 * D5 + 2 * D5 * hidden
        hd5 = D5 // n_v
        attn_fwd = 4 * B5 * n_v * hd5 * T5 * T5
        ops = 2 * (2 * M5 * weight_elems) + attn_fwd + 2 * attn_fwd
        n_bytes = 4 * M5 * D5 * 2 + weight_elems * 2 + 8 * D5 * 4
        if wgrad:
            ops += 2 * M5 * weight_elems
            n_bytes += weight_elems * 4 * 2  # fp32 weights in, fp32 gradients out
        b = bound(n_bytes, ops)
        worst = max(block_cmps[key].values(), key=lambda c: c["max_err_over_tol"])
        rows.append({
            "name": name, "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/gemm_epilogue.cu",
            "sources": [f"federated_multi_modal_tpu_torch/csrc/{f}" for f in (
                "layernorm_rows.cu", "gemm_epilogue.cu", "attention_core.cu",
                "attention_core_bwd.cu", "layernorm_bwd_rows.cu")],
            "replaces": f"federated_multi_modal_tpu/ops/pallas/fused_block.py:{line}",
            "tpu_function": "_fbt_fwd_save (:1236) and _fbt_bwd (:1307)"
                            + (", wgrad=True, save_h=False" if wgrad else ", save mode"),
            "shape": [list(x.shape), n_v, hidden],
            "launches": counts[("K4 " if wgrad else "K3 ") + name],
            "backward_launches": counts[("K4 " if wgrad else "K3 ") + name + " (backward)"],
            "max_abs_err": worst["max_abs_err"], "max_err_over_tol": worst["max_err_over_tol"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
            "library_call": "torch.nn.TransformerEncoderLayer (bf16, norm_first, "
                            "QuickGELU), forward + backward, weights "
                            + ("trainable" if wgrad else "frozen"),
            "timed": "forward + backward",
        })
        print(f"{name}: fwd+bwd {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{lib_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]})")
    print(f"packed_attention_masked_bwd: {k1b_ms:.4f} ms, plain {k1b_plain_ms:.4f} ms, "
          f"SDPA backward {k1b_lib_ms:.4f} ms, bound {k1b_bound[0]:.4f} ms")
    summary = {
        "train_step_ms": median_ms, "train_step_ms_all": step_ms,
        "train_tflops": flops / median_ms / 1e9, "train_step_flops": flops,
        "train_images_per_s": BATCH / median_ms * 1e3, "train_losses": losses,
        "train_peak_gib": peak_gib, "train_device_busy_ms": busy_us / 1e3,
        "train_idle_share": 1 - busy_us / step_wall_us,
        "train_launches": counts, "whole_step_vs_plain": step_cmp,
    }
    return rows, checks, summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        center_boxes,
        crop_resize_flip_normalize,
    )

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({_build.build_seconds:.1f} s in nvcc)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # -- 2. the program ------------------------------------------------------
    t0 = time.perf_counter()
    prog = build_maple_program(
        "ViT-B/16", classnames=[f"class {i}" for i in range(N_CLASSES)],
        n_ctx=2, depth=9, use_captions=True, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arch = prog["arch"]
    tr, fr = prog["trainable"], prog["frozen"]
    prepare, apply = prog["eval_prepare_fn"], prog["eval_apply_fn"]
    res = arch.image_resolution
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(
        rng.integers(0, 255, (BATCH, 256, 256, 3), np.uint8)).cuda()
    boxes_np, flips_np = center_boxes(BATCH, 256, res)
    boxes = torch.from_numpy(boxes_np).cuda()
    flips = torch.from_numpy(flips_np).cuda()
    print(f"program: ViT-B/16, {prog['n_cls']} classes, text_len "
          f"{prog['text_len']}, init {init_s:.1f} s")

    # -- 3. the main path, with the first inputs of each kernel recorded ------
    first = {}

    def recorder(key, fn):
        def rec(*args):
            first.setdefault(key, args)
            return fn(*args)
        return rec

    attn_rec = types.SimpleNamespace(packed_attention_masked=recorder(
        "k1", k_attn.packed_attention_masked))
    block_rec = types.SimpleNamespace(
        fused_block_residual=recorder("k5", k_block.fused_block_residual),
        fused_block_eligible=k_block.fused_block_eligible,
        WEIGHT_LEAVES=k_block.WEIGHT_LEAVES)
    with patched(primitives, _attn_kernels=attn_rec, _block_kernels=block_rec):
        k_attn.packed_attention_masked.launches = 0
        k_block.fused_block_residual.launches = 0
        _build.reset_launches()
        prep = prepare(tr, fr)
        torch.cuda.synchronize()
        prep_counts = {"packed_attention_masked":
                       k_attn.packed_attention_masked.launches,
                       "fused_block_residual":
                       k_block.fused_block_residual.launches,
                       **_build.LAUNCHES}

        k_attn.packed_attention_masked.launches = 0
        k_block.fused_block_residual.launches = 0
        _build.reset_launches()
        images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=res)
        logits = apply(tr, fr, images, prep)
        torch.cuda.synchronize()
        apply_counts = {"packed_attention_masked":
                        k_attn.packed_attention_masked.launches,
                        "fused_block_residual":
                        k_block.fused_block_residual.launches,
                        **_build.LAUNCHES}
    print("launches, eval_prepare_fn:", json.dumps(prep_counts))
    print("launches, eval_apply_fn:", json.dumps(apply_counts))
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    assert prep_counts["packed_attention_masked"] == n_text, prep_counts
    assert prep_counts["fmm_attention_core"] == n_text, prep_counts
    assert apply_counts["fused_block_residual"] == n_vis, apply_counts
    assert apply_counts["fmm_gemm_epilogue"] == 4 * n_vis, apply_counts
    assert apply_counts["fmm_layernorm_rows"] == 2 * n_vis, apply_counts
    assert apply_counts["fmm_attention_core"] == n_vis, apply_counts
    assert logits.shape == (BATCH, N_CLASSES), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    print(f"logits {tuple(logits.shape)} finite, |max| "
          f"{float(logits.abs().max()):.4f}")

    # -- 4. kernels against their plain versions, on the main path's inputs ---
    qkv, mask, n_head_t = first["k1"]
    k1_got = k_attn.packed_attention_masked(qkv, mask, n_head_t)
    k1_ref = k_attn.packed_attention_masked_reference(qkv, mask, n_head_t)
    k1_cmp = compare(k1_got, k1_ref, TOL_K1)
    print("K1 packed_attention_masked vs plain:", json.dumps(k1_cmp))

    x, blk, n_head_v = first["k5"]
    k5_got = k_block.fused_block_residual(x, blk, n_head_v)
    k5_ref = k_block.fused_block_residual_reference(x, blk, n_head_v)
    k5_cmp = compare(k5_got, k5_ref, TOL_K5)
    print("K5 fused_block_residual vs plain:", json.dumps(k5_cmp))
    _, k5_steps = block_step_by_step(x, blk, n_head_v)
    print("K5 block 0, each step vs its plain step:", json.dumps(k5_steps))

    # The random init has zero biases and unit LayerNorms; seeded ones
    # exercise every epilogue, with both branches as large as x.
    blk_seeded = seeded_block(blk, seed=1)
    k5s_cmp = compare(k_block.fused_block_residual(x, blk_seeded, n_head_v),
                      k_block.fused_block_residual_reference(x, blk_seeded, n_head_v),
                      TOL_K5_SEEDED)
    print("K5 seeded block vs plain:", json.dumps(k5s_cmp))
    _, k5s_steps = block_step_by_step(x, blk_seeded, n_head_v)
    print("K5 seeded block, each step vs its plain step:", json.dumps(k5s_steps))
    del blk_seeded

    k5_library = library_block(blk, n_head_v)
    with torch.no_grad():
        lib_cmp = compare(k5_library(x), k5_ref, TOL_LIBRARY)
    print("K5 library block (TransformerEncoderLayer) vs plain:", json.dumps(lib_cmp))
    del k1_got, k1_ref, k5_got, k5_ref

    plain_attn = types.SimpleNamespace(
        packed_attention_masked=k_attn.packed_attention_masked_reference)
    plain_block = types.SimpleNamespace(
        fused_block_residual=k_block.fused_block_residual_reference,
        fused_block_eligible=k_block.fused_block_eligible,
        WEIGHT_LEAVES=k_block.WEIGHT_LEAVES)
    with patched(primitives, _attn_kernels=plain_attn, _block_kernels=plain_block):
        prep_plain = prepare(tr, fr)
        logits_plain = apply(tr, fr, images[:E2E_IMAGES], prep_plain)
    e2e_cmp = compare(logits[:E2E_IMAGES], logits_plain, TOL_E2E)
    e2e_cmp["tol"] = {"atol": TOL_E2E, "rtol": TOL_E2E}
    print(f"eval path vs plain path, {E2E_IMAGES} images:", json.dumps(e2e_cmp))
    del prep_plain, logits_plain

    # -- 5. timings ----------------------------------------------------------
    B1, T1, D3 = qkv.shape
    D1 = D3 // 3
    hd = D1 // n_head_t
    k1_ms = cuda_ms(lambda: k_attn.packed_attention_masked(qkv, mask, n_head_t), 20)
    k1_plain_ms = cuda_ms(
        lambda: k_attn.packed_attention_masked_reference(qkv, mask, n_head_t), 10)
    q, k, v = (t.reshape(B1, T1, n_head_t, hd).transpose(1, 2)
               for t in qkv.split(D1, dim=-1))
    sdpa_mask = mask.to(qkv.dtype)
    k1_lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask), 20)
    finite_pairs = int(torch.isfinite(mask).sum())
    k1_bound = bound(
        qkv.numel() * 2 + mask.numel() * 4 + B1 * T1 * D1 * 2,
        4 * B1 * n_head_t * hd * finite_pairs)

    B5, T5, D5 = x.shape
    M5 = B5 * T5
    hidden = blk["mlp"]["w_fc"].shape[1]
    k5_ms = cuda_ms(lambda: k_block.fused_block_residual(x, blk, n_head_v), 10)
    k5_plain_ms = cuda_ms(
        lambda: k_block.fused_block_residual_reference(x, blk, n_head_v), 3, 1)
    with torch.no_grad():
        k5_lib_ms = cuda_ms(lambda: k5_library(x), 10)
    del k5_library
    weight_elems = 4 * D5 * D5 + 2 * D5 * hidden
    k5_bound = bound(
        2 * M5 * D5 * 2 + weight_elems * 2 + (3 * D5 + D5 + hidden + D5) * 2
        + 4 * D5 * 4,
        2 * M5 * weight_elems + 4 * B5 * n_head_v * (D5 // n_head_v) * T5 * T5)

    prepare_ms = wall_ms(lambda: prepare(tr, fr), 3)

    def crop_and_apply():
        imgs = crop_resize_flip_normalize(canvas, boxes, flips, out_size=res)
        return apply(tr, fr, imgs, prep)

    apply_ms = wall_ms(crop_and_apply, 5)
    print(f"eval: prepare {prepare_ms:.2f} ms, apply (crop + towers) "
          f"{apply_ms:.2f} ms per {BATCH} images = "
          f"{BATCH / apply_ms * 1e3:.1f} images/s")

    # -- where the time goes (torch.profiler device times) -------------------
    block_kernels, _ = device_profile(
        lambda: k_block.fused_block_residual(x, blk, n_head_v))
    print("one fused_block_residual, device us per launch:",
          json.dumps([[short_name(n), round(us, 1)] for n, us in block_kernels]))
    apply_kernels, apply_wall_us = device_profile(crop_and_apply)
    by_name = {}
    for name, us in apply_kernels:
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + us
    busy_us = sum(by_name.values())
    print(f"one eval apply: wall {apply_wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / apply_wall_us:.3f}")
    print("  device ms by kernel:", json.dumps(
        {k: round(v / 1e3, 3) for k, v in
         sorted(by_name.items(), key=lambda kv: -kv[1])[:10]}))

    rows = [
        {
            "name": "packed_attention_masked", "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/attention_core.cu",
            "replaces": "federated_multi_modal_tpu/ops/pallas/attention.py:497",
            "tpu_function": "attention_packed_fwd_masked",
            "shape": [list(qkv.shape), list(mask.shape), n_head_t],
            "launches": prep_counts["packed_attention_masked"],
            "max_abs_err": k1_cmp["max_abs_err"], "tol": k1_cmp["tol"],
            "ms": k1_ms, "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
            "library_ms": k1_lib_ms,
            "library_call": "torch.nn.functional.scaled_dot_product_attention",
        },
        {
            "name": "fused_block_residual", "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/gemm_epilogue.cu",
            "sources": [
                "federated_multi_modal_tpu_torch/csrc/layernorm_rows.cu",
                "federated_multi_modal_tpu_torch/csrc/gemm_epilogue.cu",
                "federated_multi_modal_tpu_torch/csrc/attention_core.cu",
            ],
            "replaces": "federated_multi_modal_tpu/ops/pallas/fused_block.py:776",
            "tpu_function": "_fused_block_group_jit (fused_block_residual, G=1)",
            "shape": [list(x.shape), n_head_v, hidden],
            "launches": apply_counts["fused_block_residual"],
            "cuda_launches": {k: apply_counts[k] for k in _build.LAUNCHES},
            "max_abs_err": k5_cmp["max_abs_err"], "tol": k5_cmp["tol"],
            "ms": k5_ms, "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound[0], "bound_by": k5_bound[1],
            "library_ms": k5_lib_ms,
            "library_call": "torch.nn.TransformerEncoderLayer (bf16, norm_first, "
                            "QuickGELU)",
        },
    ]
    summary = {
        "card": card, "build_s": build_s, "init_s": init_s,
        "eval_prepare_ms": prepare_ms, "eval_apply_ms": apply_ms,
        "eval_images_per_s": BATCH / apply_ms * 1e3, "batch": BATCH,
        "eval_apply_device_busy_ms": busy_us / 1e3,
        "eval_apply_idle_share": 1 - busy_us / apply_wall_us,
        "e2e_vs_plain": e2e_cmp,
    }
    del first, images, logits, prep
    torch.cuda.empty_cache()

    # -- 6.-8. the train path --------------------------------------------------
    train_rows, train_checks, train_summary = train_phase(prog, canvas)
    rows[0]["launches_train_step"] = train_summary["train_launches"][
        "K1 packed_attention_masked"]
    rows = rows[:1] + train_rows + rows[1:]
    summary.update(train_summary)
    print("summary:", json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": rows}))
    checks = [("K1", k1_cmp), ("K5", k5_cmp), ("K5 seeded", k5s_cmp),
              ("K5 library yardstick", lib_cmp), ("end to end", e2e_cmp)]
    checks += train_checks
    checks += [(f"K5 block 0 {step}", c) for step, c in k5_steps.items()]
    checks += [(f"K5 seeded {step}", c) for step, c in k5s_steps.items()]
    failed = [name for name, c in checks if not c["ok"]]
    if failed:
        print(f"chip_smoke: over tolerance: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
