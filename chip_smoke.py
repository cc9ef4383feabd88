#!/usr/bin/env python3
"""Drive the PyTorch port's MaPLe eval path on one NVIDIA GPU and hold its
hand-written CUDA kernels against their plain PyTorch versions.

Run from the repository root, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

What it does, in order (any failure raises and exits non-zero):

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels from ``federated_multi_modal_tpu_torch/csrc`` (nvcc,
   ``sm_90a``) and prints the build time and each kernel's resource use;
3. builds the MaPLe eval program at ViT-B/16 width (random init from a
   seed, 1000 classes, n_ctx 2, prompt depth 9, bf16 policy), runs
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
6. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

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
    for key in ("attention_core", "gemm_epilogue", "layernorm_rows"):
        if key in name:
            f32_in = "IfE" in name or "<float>" in name
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
def kernels_seen_by_primitives(**modules):
    """Let the main path's primitives call stand-ins for the kernel modules
    (recorders, or the plain versions), then put the real ones back."""
    from federated_multi_modal_tpu_torch.ops import primitives

    saved = {name: getattr(primitives, name) for name in modules}
    for name, stand_in in modules.items():
        setattr(primitives, name, stand_in)
    try:
        yield
    finally:
        for name, real in saved.items():
            setattr(primitives, name, real)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from federated_multi_modal_tpu_torch.flagship import build_maple_program
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
        n_ctx=2, depth=9, use_captions=False, seed=0)
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
        fused_block_eligible=k_block.fused_block_eligible)
    with kernels_seen_by_primitives(_attn_kernels=attn_rec,
                                    _block_kernels=block_rec):
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
        fused_block_eligible=k_block.fused_block_eligible)
    with kernels_seen_by_primitives(_attn_kernels=plain_attn,
                                    _block_kernels=plain_block):
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
    print("summary:", json.dumps(summary))
    print(json.dumps({"kernels": rows}))
    checks = [("K1", k1_cmp), ("K5", k5_cmp), ("K5 seeded", k5s_cmp),
              ("K5 library yardstick", lib_cmp), ("end to end", e2e_cmp)]
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
