#!/usr/bin/env python3
"""Drive the PyTorch port's MaPLe eval path and train step, CoOp and zero-shot
CLIP, the attention microbench, the training command line, federated MaPLe
(sequential and parallel rounds), VPT, IVLP and CoCoOp base to novel, the
ModifiedResNet backbones and the distributed layer on one NVIDIA GPU and
hold its hand-written CUDA kernels against their plain PyTorch versions.

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
   the whole path against the plain path on 16 images; plants K1's mask
   dropped in the forward and fails unless the comparison catches it;
5. times each kernel, its plain version and a PyTorch library call that
   computes the same function (``scaled_dot_product_attention`` for the
   text attention, ``TransformerEncoderLayer`` for the block) with CUDA
   events (K1 also with one pass and two passes over the key tiles
   forced), and the eval path end to end;
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
   on the kernel path against the plain path (the loss against the fully
   plain path, every trainable gradient against the plain path with an
   exactly rounded attention forward: see ``plain_path``); plants a fault
   for each of these limits and fails unless
   the comparison catches it; holds ``logits_fn`` of the trained state
   against the prompt-cached eval path;
8. times K1b, K3 and K4 (forward and backward), their plain versions and
   their library yardsticks (SDPA's backward; ``TransformerEncoderLayer``
   forward and backward with frozen or trainable weights); then drives the
   train step again under ``set_text_pack(False)`` (``bench.py --no-pack``):
   K1 and K1b 0 in the counted step, its median ms beside the packed one's;
9. the unfused route (``FMM_TPU_FUSED=0``, the JAX package's gate, set for
   the phase only): eval on 512 images (each vision block launches K2 and
   no K5), then the train step at batch 512 (K1, K1b, K2 and K2b 12 each,
   no K3 or K4: one counted step, five timed, one profiled); K2 and K2b
   against their plain versions on the path's inputs and cotangents and on
   seeded unit-scale ones, with a planted fault per limit; 16-image logits
   and a whole 16-image step against the plain path under the same gate;
   K2 and K2b timed beside SDPA, K2 also with one pass and two forced and
   beside ``attention_split.cu`` on the column views of the same qkv; the
   attention backward at head widths 32 and 128 on seeded qkv of K2b's
   shape against its plain version, with a planted fault, timed beside K2b;
10. the two-kernel eval block (``FMM_TPU_FUSED_BLOCK=0``): eval on 512
   images (K6a and K6b 12 each, no K5), K6a and K6b against their plain
   versions on block 0's inputs and on seeded ones, planted faults,
   16-image logits against the plain path, timings beside
   ``F.layer_norm``/``F.linear``/SDPA yardsticks;
11. the sublayer train route (``FMM_TPU_FUSED_TRAIN=1``,
   ``FMM_TPU_FUSED_TRAIN_BLOCK=0``): the train step at batch 512 (K7
   forward and backward 11 each, K4 once, no K3), timed and profiled; K7
   against its plain version on the first frozen block's inputs and
   cotangent and on seeded ones, planted faults, a whole 16-image step
   against the plain path, K7 timed beside its yardstick;
12. the block-group eval kernel K9 on MaPLe's eval (``FMM_TPU_FUSED_NBLK``
   4, then 5): K9 3 launches per apply, ``inject_rows`` one per deep
   prompt, no K5; K9 against its plain version on the first group's inputs
   and on seeded ones with an extra row, a planted fault per limit, the
   16-image logits against the plain path, the apply beside K5's;
13. CoOp (ViT-B/16, 1000 classes, 16 context tokens): the train step at
   batch 32 (K1, K1b and K5 12 each; K9 3 under ``NBLK=4``), a whole
   16-image step against the plain path with a planted fault, the eval at
   512 images under both gates;
14. zero-shot CLIP on the same weights: the text features of one template
   through K1 at 77 tokens (held against its plain version at that new
   shape), the eval at 512 images under both gates;
15. the split-head attention K8 on two test shapes through
   ``multi_head_attention``, held against its plain version (forward and
   gradients), planted faults, times beside SDPA;
16. the attention microbench (``federated_multi_modal_tpu_torch/tools/
   attn_microbench.py``): its ``attn`` lines (every variant) and ``block``
   lines ``attn_path``, ``attn_fusedp``, ``attn_fused`` and ``block`` at
   B = 512, T = 200, two iterations each, with the counts set to 0 just
   before and read just after (P1, P2 and P3 launched, no plain version
   called, no ``FAILED`` line); P1, P2 and P3 against their plain versions
   on the microbench's shapes with ViT-B/16 block 0's ``ln_1`` and QKV
   weights (P2 with the microbench's cotangent and a seeded unit one, bit
   for bit on repeat; P3 also at head widths 32 and 128), P2's GEMM
   against its plain version, a planted fault per limit and per P2 stage,
   P1 against K7 and P3 against K2 printed, and times beside their bounds
   and library yardsticks (P2 by stage, P3 by head width);
17. ``gemm_epilogue.cu`` by product: every product the default train
   step's vision blocks run (``fused_block.block_gemm_products`` at the
   step's M = B T, D and hidden), each one's launches in the counted train
   step of 6. held against the table; each on seeded bf16 inputs against
   its plain version (bf16 outputs at 2**-7, fp32 at 2**-14 of their
   largest value), the same bits on a repeat launch, planted faults (the
   last 64-deep K stage dropped; the epilogue skipped on the last
   256-column tile; for the weight gradients, the last split's partial
   unwritten) that must be caught, and its time beside its bound, its
   launches per step and ``torch.mm`` on the same bf16 operands;
18. ``layernorm_bwd_rows.cu`` by instance: LN2's and LN1's backward (K3,
   K4), K7's (no residual) and P2's (no parameter gradients) at the step's
   102,400 rows of 768 on seeded inputs, each one's launches in the
   counted default step, sublayer step or microbench drive, held against
   its plain version (each output also to a share of its largest value),
   the same bits on repeat and dx the same with either way of keeping rows
   in flight, planted faults (dx's last rows zero, d gamma and d beta
   without the last rows) that must be caught, and its time with either
   design beside its byte bound and ``native_layer_norm_backward``, with
   registers, spills, blocks per SM and waves; ``layernorm_rows.cu`` on
   its two main-path inputs beside ``F.layer_norm``; ``column_sum`` on
   three of the step's sums beside ``torch.sum``;
19. the port's training command line (``python -m
   federated_multi_modal_tpu_torch.train``) at ViT-B/16 on the Synthetic
   dataset from a seeded OpenAI-format fp16 state dict
   (``MODEL.BACKBONE.WEIGHTS_PATH``): MaPLe with its configuration for two
   epochs through the command line's ``main`` in this process (every
   step's and every ``test()``'s launches of K1, K1b, K3, K4 and K5 held
   against what the routing implies; step, epoch, loader-wait, ``test()``
   and checkpoint times; the decoder used), the same run under
   ``TPU.ATTENTION_IMPL xla`` (no kernel launched; the first loss within
   2**-8 of the kernel run's), ``--eval-only --model-dir --load-epoch 2``
   as a subprocess (the same accuracy as the final ``test()``), CoOp for
   one epoch and ZeroshotCLIP ``--eval-only`` through ``main``, their
   launches held the same way (``cli_phase``);
20. federated MaPLe through the command line (``--trainer MaPLeFederated``
   with its configuration) at ViT-B/16 from a seeded OpenAI-format state
   dict, on seeded stand-ins of PatternNet and UC Merced (the clients) and
   EuroSAT (class names only) in their own layout and image sizes, two
   rounds of one local epoch: no failed client or skipped round, every
   local step's and ``test()``'s launches held against the routing, the
   clients' frozen tower one storage, each FedAvg against the fp64 host
   mean, each round checkpoint read back bit for bit, each client's first
   loss within 2**-8 of one round under ``TPU.ATTENTION_IMPL xla``, a NaN
   planted in client 1's weights caught by the validity gate, the peak
   memory beside one client, and the round, epoch, step, FedAvg,
   broadcast, checkpoint and ``test()`` times (``fed_phase``);
21. VPT, IVLP and CoCoOp base to novel through the command line, each with
   its configuration (``B2N_CONFIGS``) at ViT-B/16 from a seeded
   OpenAI-format state dict, on a seeded stand-in of Caltech101 in its own
   layout (102 folders, ~300 x 200 JPEG; 2 shots, one epoch): trained on
   the 50 base classes with every step's, ``test()``'s and the build's
   launches held against the routing (all 12 vision blocks through K3 in
   VPT's and IVLP's step, no K4), one whole 16-image step against the plain
   path with the vision prompts at the vision limit and planted faults, the
   first loss within 2**-8 of the ``xla`` route's, then ``--eval-only`` on
   the 50 novel classes from the base checkpoint (class-conditioned buffers
   dropped, every other leaf loaded, finite logits); step, ``test()`` and
   novel-eval times, a profiled step, peak memory, CoCoOp's text rows
   (``b2n_phase``);
22. the ModifiedResNet backbones (``rn_phase``), each from a seeded
   OpenAI-format fp16 state dict with calibrated BatchNorms: the RN50 tower
   through ``clip_api.load`` on the card (the inferred config equal to the
   catalog's; 16 seeded images under the bf16 policy against the port's
   fp32 run of the same weights on the CPU, each feature row's relative L2
   error within ``TOL_RN_TOWER``, the attention pool's mean token dropped
   as a planted fault; the TF32 flags left as they were; the launches of
   one forward; its ms at batch 32 and 100); CoOp
   with ``rn50.yaml`` through the command line on the Caltech101 stand-in
   (100 classes, 2 shots, one epoch at batch 32: K1 and K1b 12 a step and
   no vision kernel, held against the routing; a profiled step; a whole
   16-image step against the plain path with K1b's mask dropped as a
   planted fault; the first loss within 2**-8 of the ``xla`` route's, which
   launches no kernel); ``ZeroshotCLIP --eval-only`` on the same stand-in
   (100 class prompts, 200 test images at the config's test batch of 100)
   for RN50, RN101, RN50x4 (288) and RN50x16 (384): launches held, finite
   logits, K1 at each text shape (10 and 12 heads at RN50x4 and RN50x16)
   against its plain version with a planted fault and beside SDPA, the
   tower's ms, ``test()`` ms and peak memory;
23. the distributed layer (``dist_phase``): ``--trainer MaPLeFederated``
   through the command line with ``FED.PARALLEL_CLIENTS`` at
   ``FED.NUM_CLIENTS`` 1 (the ``{client: 1, data: 1}`` mesh, the JAX
   package's parallel case on one chip) at ViT-B/16 on the fed phase's
   PatternNet stand-in, one round: its mesh line, every step's and
   ``test()``'s launches held against the routing, FedAvg over the one
   client bit for bit its input, the round checkpoint read back bit for
   bit, the first loss within 2**-8 of the ``xla`` route's, a NaN planted in
   the stacked weights caught by the validity gate, the sequential loop
   resuming the parallel round bit for bit, times and a profiled step's
   idle share beside the fed phase's sequential step; MaPLe's B = 512 step
   with ``remat`` against the step without (whole-step limits, each
   forward kernel launched twice, peak memory and ms of both);
   ``TPU.DATA_PARALLEL_MULTIHOST`` in two processes on the card (Gloo),
   each on half of a MaPLe batch, against this process's step over the
   same halves and beside the whole batch's, then NCCL in a world of one;
   one command-line epoch under ``TRAIN.PROFILE_DIR``, its trace holding
   the port's kernels;
24. prints, for the tensor-core kernels (``attention_core.cu``,
   ``attention_split.cu``, ``attention_core_bwd.cu`` with the unfused
   phase's head-width line at 32 and 128, ``lnqkv_attention.cu``,
   ``lnqkv_attention_bwd_dx.cu``, ``attention_pair.cu``, P2's GEMM and
   the ``gemm_epilogue.cu`` products) at the shapes the phases gave them,
   their registers, spills, shared memory, resident blocks per SM and
   waves;
25. prints ``{"kernels": [...]}`` (``paths``, ``launches_cli``,
   ``launches_fed``, ``launches_b2n``, ``launches_rn`` and
   ``launches_fedpar`` on the kernels the cli, fed, b2n, rn and dist phases
   launched; K1's row also ``rn_text_shapes``)
   and, last, ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --step-sweep N`` instead prints the whole-step
gradient readings of the three train routes on N batches each, for the
kernel path and for attention forwards with exact sums (``step_sweep``).

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
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
# limit must catch (see PLANTED_FAULT_ROWS). The gradients are held against
# the plain path with an exactly rounded attention forward (plain_path); the
# loss against the fully plain path.
TOL_STEP_LOSS = 2.0 ** -8
TOL_STEP_GRAD_VISION = 2.0 ** -5
TOL_STEP_GRAD_OTHER = 2.0 ** -3
# The planted faults drop the last rows of a sum or a write, the usual fault
# of a kernel's ragged tail: the last 256 rows.
PLANTED_FAULT_ROWS = 256
# gemm_epilogue by product: bf16 outputs may differ from the plain version
# by a flipped rounding (2**-7 of the value and absolute, as the card tests
# hold them); fp32 outputs by sums in another order, held to 2**-14 of their
# largest value (as test_gemm_nt_f32).
TOL_GEMM_BF16 = 2.0 ** -7
TOL_GEMM_F32 = 2.0 ** -14
# The block-group kernel K9: G blocks chained with the stream in fp32, each
# block rounding its bf16 intermediates (qkv, attention output, LN outputs,
# hidden) at the same points as the plain version; a flipped rounding in one
# block passes into the next, so twice K5's limit, and with seeded biases and
# LayerNorm affines twice K5's seeded one.
TOL_K9 = 2.0 ** -4
TOL_K9_SEEDED = 2.0 ** -3
GROUP_SIZES = ("4", "5")  # FMM_TPU_FUSED_NBLK: blocks 0-3, 4-7, 8-11; 0-4, 5-9, 10-11
COOP_BATCH = 32  # configs/trainers/CoOp/vit_b16.yaml
ZS_TEMPLATE = "a photo of a {}."  # CUSTOM_TEMPLATES["ImageNet"]
# K8 on two test shapes, since no backbone of the repository reaches it:
# (name, B, T, D, heads, causal mask).
SPLIT_SHAPES = (("a", 64, 257, 1280, 16, False), ("b", 256, 77, 768, 8, True))
# The attention microbench (tools/attn_microbench.py's defaults: T = 200 at
# B = BATCH), driven once with few iterations per line.
MICROBENCH_T = 200
MICROBENCH_ITERS = 2


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
    as ``(name, device us)`` and the window's host wall time in us. A
    small launch and a synchronize come first inside the profiler, outside
    the window (``record_function``): the tracer drops the first launches
    of a trace, and these are the ones it drops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("chip_smoke_window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = next(e for e in events if e.name == "chip_smoke_window").time_range.start
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and e.time_range.start >= start and e.name != "chip_smoke_window"),
                     key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us()) for e in kernels], wall_us


def profile_by_kernel(fn, label: str, top: int = 10) -> dict:
    """One run of ``fn`` under the profiler: wall and device-busy ms, the
    idle share and the ``top`` largest device ms by kernel, printed."""
    kernels, wall_us = device_profile(fn)
    by_name = {}
    for name, us in kernels:
        by_name[short_name(name)] = by_name.get(short_name(name), 0.0) + us
    busy_us = sum(by_name.values())
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1 - busy_us / wall_us,
           "device_ms_by_kernel": {k: round(v / 1e3, 3) for k, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:top]}}
    print(f"one {label}: wall {out['wall_ms']:.2f} ms, device busy "
          f"{out['device_busy_ms']:.2f} ms, idle share {out['idle_share']:.3f}")
    print("  device ms by kernel:", json.dumps(out["device_ms_by_kernel"]))
    return out


ATTN_TILE = 64  # query or key rows per block (am::kTile, csrc/attn_mma.cuh)


def forward_variant_ms(qkv, n_head: int, mask, key_tiles: tuple) -> dict:
    """``attention_core.cu`` at this shape with each variant in
    ``key_tiles`` forced (0: two passes; 2 or 4: one pass with that many key
    tiles in registers), timed in two interleaved rounds, so that the
    spread between rounds shows beside the difference between variants;
    the variant the kernel chooses is marked."""
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    T, hd = qkv.shape[1], qkv.shape[2] // 3 // n_head
    chosen = k_attn.attention_core_key_tiles(hd, T)
    names = {kt: (f"one pass, {kt} key tiles" if kt else "two passes")
             + (" (chosen)" if kt == chosen else "") for kt in key_tiles}
    out = {name: [] for name in names.values()}
    for _ in range(2):
        for kt in key_tiles:
            out[names[kt]].append(cuda_ms(
                lambda kt=kt: k_attn._attention_core_cuda_forced(qkv, n_head, kt, mask), 20))
    return out


def attention_resources(build_log: str, rows: list) -> dict:
    """The tensor-core kernels at the shapes this run's phases gave them
    (the rows of ``attention_core.cu``, ``attention_split.cu``,
    ``attention_core_bwd.cu`` (with its head-width line),
    ``lnqkv_attention.cu``, ``lnqkv_attention_bwd_dx.cu`` (and its GEMM,
    ``gemm_epilogue.cu``'s NT instance), ``attention_pair.cu`` and the
    ``gemm_epilogue.cu`` product rows in ``rows``): for each
    kernel a shape launches, its registers and spills as ``ptxas -v``
    printed them in this build, its dynamic shared memory and resident
    blocks per SM from the CUDA occupancy calculator, and the waves its grid
    takes on this card's SMs (one block per 64-row tile, head and batch row;
    one per head and batch row for ``lnqkv_attention`` and P2's attention
    stage; one per 64-row tile, 128-lane head group and batch row for
    ``attention_pair``; one per 128 x 256 output tile of a GEMM and split
    of a weight gradient, on a persistent grid of one block an SM).
    Printed and kept in the summary; none of it is a measured time, so none
    of it goes into the kernels line."""
    import re

    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    ptxas, entry = {}, None  # (kernel name, template arguments): registers, spills
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(attention_core_bwd_[a-z]+|attention_split|attention_core|"
                          r"attention_pair)_kernelI((?:L[ib]\d+E)+)E", line)
            entry = m and (m[1], tuple(int(v) for v in re.findall(r"L[ib](\d+)E", m[2])))
            g = re.search(r"gemm_epilogue_kernelILi(\d+)ELi(\d+)EE", line)
            if g:
                entry = ("gemm_epilogue", (int(g[1]), int(g[2])))
            for plain in ("lnqkv_attention_bwd", "lnqkv_attention"):
                if not m and f"{plain}_kernel" in line:
                    entry = (plain, ())
                    break
            continue
        if not entry:
            continue
        rec = ptxas.setdefault(entry, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            rec["spill_stores"], rec["spill_loads"] = int(spill[1]), int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rec["registers"] = int(regs[1])

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = {}  # label: (blocks, masked, {kernel: (ptxas key, entry point, variant)})

    def tiles(B, T, H):
        return -(-T // ATTN_TILE) * H * B

    def forward(label, B, T, D, H, masked):
        hd = D // H
        kt = k_attn.attention_core_key_tiles(hd, T)
        variant = f"one pass, {kt} key tiles" if kt else "two passes"
        shapes[label] = (tiles(B, T, H), masked, {f"attention_core<{hd}>, {variant}": (
            ("attention_core", (hd, int(masked), kt)), "fmm_attention_core_blocks_per_sm",
            hd + 256 * kt)})

    for row in rows:
        source = row["source"].rsplit("/", 1)[1]
        if source == "attention_core.cu":
            # [qkv shape, mask shape, heads] (K1) or [qkv shape, heads] (K2)
            for shape in (row["shape"], row.get("zeroshot_shape", {}).get("shape")):
                if shape:
                    (B, T, D3), H = shape[0], shape[-1]
                    forward(f"{row['name']} {[B, T]}, {H} heads", B, T, D3 // 3, H,
                            len(shape) == 3)
        elif source == "attention_split.cu":
            # [[B, T, D], heads, head width, "causal" or "no mask"], shapes (a) and (b)
            for (B, T, _), H, hd, mask in (row["shape"], row["shape_b"]["shape"]):
                masked = mask != "no mask"
                shapes[f"{row['name']} {[B, T]}, {H} heads of {hd}, {mask}"] = (
                    tiles(B, T, H), masked, {f"attention_split<{hd}>": (
                        ("attention_split", (hd, int(masked))),
                        "fmm_attention_split_blocks_per_sm", hd)})
        elif source == "attention_core_bwd.cu":
            # [qkv shape, mask shape, heads] (K1b) or [qkv shape, heads] (K2b),
            # and K2b's head-width line ([qkv shape, heads] each)
            # (K7's row gives x's shape and its head width)
            for shape in [row["shape"]] + row.get("by_head_width", {}).get("shapes", []):
                (B, T, D3), H, masked = shape[0], shape[-1], len(shape) == 3
                hd = (row["head_dim"] if shape is row["shape"] and "head_dim" in row
                      else D3 // 3 // H)
                shapes[f"{row['name']} {[B, T]}, {H} heads of {hd}"] = (tiles(B, T, H), masked, {
                    f"attention_core_bwd<{hd}> {p}": (
                        (f"attention_core_bwd_{p}", (hd, int(masked))),
                        "fmm_attention_core_bwd_blocks_per_sm", hd + 256 * i)
                    for i, p in enumerate(("stats", "dkdv", "dq"), start=1)})
        elif source == "lnqkv_attention.cu":
            (B, T, _), H = row["shape"]
            shapes[f"{row['name']} {[B, T]}, {H} heads"] = (B * H, False, {
                "lnqkv_attention": (("lnqkv_attention", ()),
                                    "fmm_lnqkv_attention_blocks_per_sm", T)})
        elif source == "lnqkv_attention_bwd_dx.cu":
            (B, T, D), H = row["shape"]
            shapes[f"{row['name']} {[B, T]}, {H} heads"] = (B * H, False, {
                "lnqkv_attention_bwd": (("lnqkv_attention_bwd", ()),
                                        "fmm_lnqkv_attention_bwd_dqkv_blocks_per_sm", T)})
            shapes[f"{row['name']} GEMM {[B * T, D, 3 * D]}"] = (
                -(-B * T // 128) * -(-D // GEMM_TILE_N), False, {
                    "gemm_epilogue<NT, 0x100>": (("gemm_epilogue", (1, 0x100)),
                                                 "fmm_gemm_epilogue_blocks_per_sm",
                                                 1 * 512 + 0x100)})
        elif source == "gemm_epilogue.cu" and "product" in row:
            rows_out, cols, k = row["shape"]
            layout = GEMM_LAYOUTS.index(row["layout"])
            splits = (k_block.tn_split_plan(rows_out, cols, k, sms)[0]
                      if row["layout"] == "TN" else 1)
            shapes[f"{row['name']} {row['product']}"] = (
                -(-rows_out // 128) * -(-cols // GEMM_TILE_N) * splits, False, {
                    f"gemm_epilogue<{row['layout']}, {row['epilogue']:#05x}>": (
                        ("gemm_epilogue", (layout, row["epilogue"])),
                        "fmm_gemm_epilogue_blocks_per_sm", layout * 512 + row["epilogue"])})
        elif source == "attention_pair.cu":
            # [qkv shape, heads], and the head-width checks' shapes
            for (B, T, D3), H in [row["shape"]] + row.get("head_width_shapes", []):
                hd = D3 // 3 // H
                kt = row["key_tiles"][str(hd)]
                shapes[f"{row['name']} {[B, T]}, {H} heads of {hd}"] = (
                    -(-T // ATTN_TILE) * (D3 // 3 // 128) * B, False, {
                        f"attention_pair<{hd}>, " + (f"one pass, {kt} key tiles" if kt
                                                     else "two passes"): (
                            ("attention_pair", (hd, kt)), "fmm_attention_pair_blocks_per_sm",
                            hd + 256 * kt)})
    out = {}
    for label, (blocks, masked, kernels) in shapes.items():
        rec = {"masked": masked, "blocks": blocks}
        for name, (key, entry_point, variant) in kernels.items():
            per_sm, smem = _build.blocks_per_sm(entry_point, variant, masked)
            rec[name] = dict(ptxas.get(key, {}), smem_bytes=smem, blocks_per_sm=per_sm,
                             waves=round(blocks / (per_sm * sms), 2))
        out[label] = rec
    print("tensor-core kernels (ptxas, occupancy, waves):", json.dumps(out))
    return out


def short_name(name: str) -> str:
    for key in ("attention_core_bwd", "attention_core", "attention_split", "gemm_epilogue",
                "layernorm_bwd_rows", "layernorm_rows", "column_sum", "inject_rows"):
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


@contextlib.contextmanager
def gates(**env):
    """Set the JAX package's routing gates (environment variables, read by
    the port when it routes a block), then put the environment back."""
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def overlay(module, **attrs):
    """A stand-in for one of the port's kernel modules as the primitives
    see it: all of ``module``'s attributes, with ``attrs`` in place of
    some (recorders, plain versions)."""
    return types.SimpleNamespace(**{**vars(module), **attrs})


def plain_kernels() -> dict:
    """Stand-ins for the primitives' kernel modules under which every
    wrapper runs its plain version: the plain path."""
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    return {
        "_attn_kernels": overlay(
            k_attn, packed_attention_masked=k_attn.packed_attention_masked_reference,
            packed_attention=k_attn.packed_attention_reference,
            fused_attention_diff=k_attn.fused_attention_diff_reference),
        "_block_kernels": overlay(k_block, **{
            name: getattr(k_block, name + "_reference") for name in (
                "fused_block_residual", "fused_block_train", "fused_block_train_dw",
                "fused_ln_attention_residual", "fused_ln_mlp_residual",
                "fused_ln_attention", "fused_block_group_residual")}),
    }


def attention_forward_with(exact_scores: bool, exact_pv: bool):
    """The attention forward ``f(qkv, n_head, mask=None, valid_T=None)``
    (all keys valid) with the plain version's rounding points, the sums of
    q.k and of P.V each either exact before their one rounding to fp32
    (fp64 products and sums) or in fp32 as the plain version's (cuBLAS's,
    TF32 off)."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    def product(a, b, exact):
        return torch.matmul(a.double(), b.double()).float() if exact else torch.matmul(
            a.float(), b.float())

    def forward(qkv, n_head, mask=None, valid_T=None):
        B, T, D3 = qkv.shape
        D = D3 // 3
        hd = D // n_head
        q, k, v = (t.reshape(B, T, n_head, hd).transpose(1, 2) for t in qkv.split(D, dim=-1))
        with k_attn.full_fp32_products():
            s = product(q, k.transpose(-1, -2), exact_scores) * (1.0 / hd ** 0.5)
            if mask is not None:
                s = s + mask.float()
            p = torch.softmax(s, dim=-1).to(qkv.dtype)
            out = product(p, v, exact_pv).to(qkv.dtype)
        return out.transpose(1, 2).reshape(B, T, D)

    return forward


# Every sum exact: the most accurate implementation of the contract, the
# whole-step comparisons' reference forward.
exact_attention_forward = attention_forward_with(True, True)


@contextlib.contextmanager
def plain_path(attention_forward=None):
    """The plain path (:func:`plain_kernels`) under the primitives; with
    ``attention_forward`` (``f(qkv, n_head, mask)``), its attention forward
    (K1, K2 and the forward inside the plain K3, K4 and K7) computed by that
    function instead. The whole-step comparisons hold gradients against the
    plain path with :func:`exact_attention_forward`: a 16-image step through
    twelve random-init blocks turns a change of the scores' last fp32 bit
    (p then flips its bf16 rounding) into gradient differences near the
    vision limit, so the reference's scores are the exact ones, which the
    kernel computes too; the fully plain path's fp32 sums are printed
    beside as the control."""
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(primitives, **plain_kernels()))
        if attention_forward is not None:
            stack.enter_context(patched(
                k_attn, _fwd_reference=lambda qkv, mask, n: attention_forward(qkv, n, mask)))
            stack.enter_context(patched(
                k_block, PLAIN_STEPS=k_block.PLAIN_STEPS._replace(
                    attention=lambda qkv, n, mask=None: attention_forward(qkv, n, mask))))
        yield


def kernel_counters() -> dict:
    """Every ported kernel's wrapper, by the label its counts print under."""
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto

    return {"K1 packed_attention_masked": k_attn.packed_attention_masked,
            "K1b packed_attention_masked_bwd": k_attn.packed_attention_masked_bwd,
            "K2 packed_attention": k_attn.packed_attention,
            "K2b packed_attention_bwd": k_attn.packed_attention_bwd,
            "K3 fused_block_train": k_block.fused_block_train,
            "K4 fused_block_train_dw": k_block.fused_block_train_dw,
            "K5 fused_block_residual": k_block.fused_block_residual,
            "K6a fused_ln_attention_residual": k_block.fused_ln_attention_residual,
            "K6b fused_ln_mlp_residual": k_block.fused_ln_mlp_residual,
            "K7 fused_ln_attention": k_block.fused_ln_attention,
            "K8 fused_attention": k_attn.fused_attention,
            "K9 fused_block_group_residual": k_block.fused_block_group_residual,
            "P1 fused_lnqkv_attention": k_proto.fused_lnqkv_attention,
            "P2 fused_lnqkv_attention_bwd_dx": k_proto.fused_lnqkv_attention_bwd_dx,
            "P3 packed4d_attention": k_proto.packed4d_attention}


def reset_counts() -> None:
    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    for fn in kernel_counters().values():
        fn.launches = 0
        if hasattr(fn, "backward_launches"):
            fn.backward_launches = 0
    _build.reset_launches()
    k_block.GEMM_LAUNCHES.clear()
    k_block.LN_BWD_LAUNCHES.clear()


def read_counts() -> dict:
    """Each wrapper's launches (and backward launches) since the last
    :func:`reset_counts`, then each CUDA entry point's."""
    from federated_multi_modal_tpu_torch.ops.kernels import _build

    counts = {}
    for name, fn in kernel_counters().items():
        counts[name] = fn.launches
        if hasattr(fn, "backward_launches"):
            counts[name + " (backward)"] = fn.backward_launches
    counts.update(_build.LAUNCHES)
    counts["gemm_epilogue by product"] = gemm_launches_by_label()
    counts["layernorm_bwd_rows by instance"] = ln_launches_by_label()
    return counts


GEMM_LAYOUTS = ("NN", "NT", "TN")


def product_label(key) -> str:
    """A product's key in ``fused_block.GEMM_LAUNCHES`` as printed: layout,
    output rows x columns x contraction, epilogue code."""
    layout, rows, cols, k, code = key
    return f"{GEMM_LAYOUTS[layout]} {rows}x{cols}x{k} {code:#05x}"


def gemm_launches_by_label() -> dict:
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    return {product_label(k): n for k, n in sorted(k_block.GEMM_LAUNCHES.items())}


def ln_instance_label(key) -> str:
    """A launch's key in ``fused_block.LN_BWD_LAUNCHES`` as printed."""
    rows, D, x, dres, out, copy, partials = key
    return (f"{rows}x{D} x {x}, dres {dres}, dx {out}" + (" + bf16 copy" if copy else "")
            + (", partials" if partials else ""))


def ln_launches_by_label() -> dict:
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    return {ln_instance_label(k): n for k, n in sorted(
        k_block.LN_BWD_LAUNCHES.items(), key=lambda kv: str(kv[0]))}


def check_counts(counts: dict, expected: dict, what: str) -> None:
    wrong = {k: (counts[k], v) for k, v in expected.items() if counts[k] != v}
    if wrong:
        raise AssertionError(f"launches per {what} (got, expected): {wrong}")


def cotangent_recorder(first: dict, key: str, fn):
    """``fn`` (a kernel wrapper) that keeps the inputs of its first call
    under ``first[key]["args"]`` (tensors detached) and, when its output
    needs a gradient, the cotangent that reaches it under
    ``first[key]["dy"]``."""
    def rec(*args):
        out = fn(*args)
        if key not in first:
            first[key] = {"args": tuple(a.detach() if hasattr(a, "detach") else a
                                        for a in args)}
            if out.requires_grad:
                def hook(g):
                    first[key]["dy"] = g.detach().clone()
                out.register_hook(hook)
        return out
    return rec


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
        _, _, dg_t, db_t = layernorm_bwd(x[tail], dxn[tail],
                                         None if dres is None else dres[tail], gamma, out_dtype)
        return dx, copy, dg - dg_t, db - db_t
    return faulty


def fault_mask_dropped(attention_bwd):
    """The attention backward ignores the mask it is given."""
    def faulty(qkv, g, n_head, mask=None):
        return attention_bwd(qkv, g, n_head, None)
    return faulty


def fault_forward_mask_dropped(attention):
    """The attention forward ignores the mask it is given."""
    def faulty(qkv, n_head, mask=None, valid_T=None):
        return attention(qkv, n_head, None, valid_T)
    return faulty


def fault_attention_tail(attention):
    """A mask-free attention forward leaves the last rows of its output
    unwritten (zero); masked (text) launches stay whole."""
    def faulty(qkv, n_head, mask=None):
        out = attention(qkv, n_head, mask)
        if mask is None:
            out.view(-1, out.shape[-1])[-PLANTED_FAULT_ROWS:] = 0
        return out
    return faulty


def fault_attention_bwd_tail(attention_bwd):
    """A mask-free attention backward leaves the last rows of d(QKV)
    unwritten (zero); masked (text) launches stay whole."""
    def faulty(qkv, g, n_head, mask=None):
        dqkv = attention_bwd(qkv, g, n_head, mask)
        if mask is None:
            dqkv.view(-1, dqkv.shape[-1])[-PLANTED_FAULT_ROWS:] = 0
        return dqkv
    return faulty


def fault_residual_gemm_tail(gemm):
    """A product with a residual epilogue (an out-projection or the MLP's
    proj) leaves the last rows of its output unwritten (zero)."""
    def faulty(*args, **kwargs):
        out = gemm(*args, **kwargs)
        if kwargs.get("residual") is not None:
            out[-PLANTED_FAULT_ROWS:] = 0
        return out
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


def vision_tower_leaf(name: str) -> bool:
    """MaPLe's and CoOp's vision-limit leaves: the vision tower's weights."""
    return ".visual." in name


def hold_step(got, ref, loss_ref=None, vision_leaf=vision_tower_leaf) -> dict:
    """One whole step's ``(loss, grads)`` against another's: the loss
    relative error (against ``loss_ref`` if given) and, for each gradient,
    max |err| over max |value|, the leaves ``vision_leaf`` names (those the
    vision kernels K3 and K4 produce) at ``TOL_STEP_GRAD_VISION``, the rest
    at ``TOL_STEP_GRAD_OTHER``; a limit with no leaf is left out."""
    (loss, grads), (r_loss, r_grads) = got, ref
    r_loss = r_loss if loss_ref is None else loss_ref
    assert grads.keys() == r_grads.keys(), grads.keys() ^ r_grads.keys()
    errs = {k: compare_scaled(g, r_grads[k], 1.0)["max_err_over_max"]
            for k, g in grads.items()}
    loss_rel = abs(loss - r_loss) / abs(r_loss)
    out = {"loss_rel_err": loss_rel, "loss_tol": TOL_STEP_LOSS,
           "ok": loss_rel <= TOL_STEP_LOSS, "grads": len(errs)}
    for part, tol, names in (
            ("vision", TOL_STEP_GRAD_VISION, [k for k in errs if vision_leaf(k)]),
            ("other", TOL_STEP_GRAD_OTHER, [k for k in errs if not vision_leaf(k)])):
        if not names:
            continue
        worst = max(names, key=errs.get)
        out[part] = {"leaves": len(names), "worst": worst,
                     "worst_err_over_max": errs[worst], "tol_of_max": tol,
                     "max_err_over_tol": errs[worst] / tol, "ok": errs[worst] <= tol}
        out["ok"] &= out[part]["ok"]
    out["max_err_over_tol"] = max(out[part]["max_err_over_tol"]
                                  for part in ("vision", "other") if part in out)
    out["errs"] = errs
    return out


def brief_step(c: dict) -> dict:
    """A step comparison as the loss's relative error and, per limit, the
    worst leaf, its error over max |value| and that over the limit."""
    return {"loss_rel_err": c["loss_rel_err"], **{
        part: [c[part]["worst"], float(f"{c[part]['worst_err_over_max']:.4g}"),
               float(f"{c[part]['max_err_over_tol']:.4g}")]
        for part in ("vision", "other") if part in c}}


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
    check_counts(counts, {"K1 packed_attention_masked": n_text,
                          "K1b packed_attention_masked_bwd": n_text,
                          "K3 fused_block_train": n_vis - 1,
                          "K3 fused_block_train (backward)": n_vis - 1,
                          "K4 fused_block_train_dw": 1,
                          "K4 fused_block_train_dw (backward)": 1}, "train step")


def drive_train(prog, canvas, recorders: dict, label: str = "") -> dict:
    """The train step (``loss_fn`` and ``make_train_step`` with the
    federated SGD) at batch ``BATCH`` with random crops and captions: one
    step under ``recorders`` (stand-ins for the primitives' kernel modules)
    with every count set to 0 just before and read just after, then
    ``TRAIN_STEPS`` timed steps and one under the profiler. Returns the
    counts, the numbers, the train state and the batch maker."""
    import torch

    from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
    from federated_multi_modal_tpu_torch.flagship import (
        build_fed_optimizer,
        estimate_train_step_flops,
    )
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.tokenizer import tokenize

    arch = prog["arch"]
    res = arch.image_resolution
    frozen = prog["frozen"]
    tx = build_fed_optimizer()
    train_step = make_train_step(prog["loss_fn"], tx)
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

    with patched(primitives, **recorders):
        reset_counts()
        t0 = time.perf_counter()
        loss0, gnorm0 = one_step()
        torch.cuda.synchronize()
        first_step_s = time.perf_counter() - t0
        counts = read_counts()
    print(f"launches, one train step{label}:", json.dumps(counts))
    assert bool(torch.isfinite(loss0)), "non-finite first loss"
    print(f"first step{label} (with its recorders): {first_step_s:.2f} s, loss "
          f"{float(loss0):.6f}, gnorm {float(gnorm0):.4f}")

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
    print(f"train step{label}: median {median_ms:.2f} ms of {TRAIN_STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{flops / median_ms / 1e9:.2f} TFLOP/s of {flops / 1e12:.2f} TFLOP "
          f"(analytic), {BATCH / median_ms * 1e3:.1f} images/s, peak "
          f"{peak_gib:.2f} GiB")
    print(f"train losses{label}:", json.dumps(losses))
    assert all(np.isfinite(losses)), losses

    prof = profile_by_kernel(one_step, "train step" + label, top=14)
    summary = {
        "train_step_ms": median_ms, "train_step_ms_all": step_ms,
        "train_tflops": flops / median_ms / 1e9, "train_step_flops": flops,
        "train_images_per_s": BATCH / median_ms * 1e3, "train_losses": losses,
        "train_peak_gib": peak_gib, "train_device_busy_ms": prof["device_busy_ms"],
        "train_idle_share": prof["idle_share"], "train_launches": counts,
    }
    return {"counts": counts, "summary": summary, "state": state, "make_batch": make_batch}


def whole_step_vs_plain(loss_fn, tr, frozen, small, vision_fault, other_fault,
                        label: str = "", vision_leaf=vision_tower_leaf) -> list:
    """One whole ``STEP_IMAGES``-image step on the kernel path: its loss
    against the fully plain path, every trainable gradient against the
    plain path with an exactly rounded attention forward
    (``plain_path(exact_attention_forward)``), with the noise floor of the
    comparison and two planted faults, each given as ``(module, {attribute:
    stand-in})``: one the vision limit must catch, one the other limit (a
    limit with no leaf, ``vision_leaf`` naming none or all of them, takes
    ``None``). Printed beside: the kernel path against the fully plain path,
    and the fully plain path against the same reference (the control: the
    plain forward's fp32 sums against exact ones). Returns the checks."""
    import torch

    def hold(got, ref, loss_ref=None):
        return hold_step(got, ref, loss_ref, vision_leaf)

    kernel_step = step_loss_and_grads(loss_fn, tr, frozen, small)
    with plain_path():
        full_plain_step = step_loss_and_grads(loss_fn, tr, frozen, small)
    with plain_path(exact_attention_forward):
        ref_step = step_loss_and_grads(loss_fn, tr, frozen, small)
        # The noise floor of this comparison: the reference again with one
        # pixel of each image moved by one bf16 step.
        nudged = dict(small, image=small["image"].clone())
        px = (torch.arange(STEP_IMAGES), 5, 7, 1)
        nudged["image"][px] = (small["image"][px].float() * (1 + 2 ** -7)).to(
            small["image"].dtype)
        noise_step = step_loss_and_grads(loss_fn, tr, frozen, nudged)
    step_cmp = hold(kernel_step, ref_step, loss_ref=full_plain_step[0])
    noise = hold(noise_step, ref_step)
    full_plain = hold(kernel_step, full_plain_step)
    control = hold(full_plain_step, ref_step)
    planted = [(limit, fault) for limit, fault in (("vision", vision_fault),
                                                   ("other", other_fault)) if fault]
    assert [limit for limit, _ in planted] == [p for p in ("vision", "other")
                                               if p in step_cmp], (planted, step_cmp.keys())
    faults = []
    for _, (module, attrs) in planted:
        with patched(module, **attrs):
            faults.append(hold(step_loss_and_grads(loss_fn, tr, frozen, small), ref_step))
    errs = step_cmp.pop("errs")
    for c in (noise, full_plain, control, *faults):
        del c["errs"]
    step_cmp["noise_floor"] = noise
    step_cmp["vs_fully_plain"] = brief_step(full_plain)
    step_cmp["control_fully_plain_vs_reference"] = brief_step(control)
    print(f"whole step{label}, {STEP_IMAGES} images, kernel path vs the plain path with an "
          f"exact attention forward:", json.dumps(step_cmp))
    print("  printed, not checked: the kernel path against the fully plain path, and the "
          "fully plain path against the reference (the control):",
          json.dumps({"kernel path": step_cmp["vs_fully_plain"],
                      "control": step_cmp["control_fully_plain_vs_reference"]}))
    print("  max |err| over max |value| of each trainable gradient:",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    checks = [(f"whole step{label}", step_cmp)]
    for (limit, (module, attrs)), fault in zip(planted, faults):
        print(f"  planted fault for the {limit} limit ({', '.join(attrs)} of "
              f"{module.__name__.rsplit('.', 1)[-1]}):", json.dumps(fault))
        checks.append((f"whole step{label} planted fault caught by the {limit} limit",
                       {"ok": not fault[limit]["ok"]}))
    return checks


def unpacked_text_step(prog, canvas, packed_ms: float) -> dict:
    """The MaPLe train step under ``set_text_pack(False)`` (put back
    afterwards), as ``bench.py --no-pack`` runs the JAX package: the
    24-token text rows take the plain attention (T < 32), so K1 and K1b
    launch no time in the counted step; its median ms printed beside the
    packed step's."""
    from federated_multi_modal_tpu_torch.models import clip_model

    arch = prog["arch"]
    saved = clip_model._TEXT_PACK_DEFAULT
    clip_model.set_text_pack(False)
    try:
        run = drive_train(prog, canvas, {}, " (text unpacked)")
    finally:
        clip_model.set_text_pack(saved)
    check_counts(run["counts"], {
        "K1 packed_attention_masked": 0, "K1b packed_attention_masked_bwd": 0,
        "K3 fused_block_train": arch.vision_layers - 1,
        "K4 fused_block_train_dw": 1}, "train step (text unpacked)")
    ms = run["summary"]["train_step_ms"]
    print(f"train step, text unpacked: median {ms:.2f} ms beside the packed step's "
          f"{packed_ms:.2f} ms")
    return dict(run["summary"], packed_train_step_ms=packed_ms)


def train_phase(prog, canvas) -> tuple:
    """The train path: the step with its kernels recorded, the timed steps,
    the kernel checks on the step's own inputs, the whole 16-image step
    against the plain path, and the timings. Returns ``(rows, checks,
    summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.flagship import example_batch
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    arch = prog["arch"]
    frozen = prog["frozen"]
    loss_fn = prog["loss_fn"]

    # -- the step, with the first inputs and cotangents of each kernel ------
    first = {}
    run = drive_train(prog, canvas, {
        "_attn_kernels": overlay(k_attn, packed_attention_masked=cotangent_recorder(
            first, "k1b", k_attn.packed_attention_masked)),
        "_block_kernels": overlay(
            k_block,
            fused_block_train=cotangent_recorder(first, "k3", k_block.fused_block_train),
            fused_block_train_dw=cotangent_recorder(first, "k4", k_block.fused_block_train_dw))})
    counts, state, make_batch = run["counts"], run["state"], run["make_batch"]
    check_train_launches(counts, arch)

    # -- K1b, K3 and K4 against their plain versions -----------------------
    # On the main path's own inputs and cotangents, then with a seeded
    # cotangent of unit scale (and, for the blocks, seeded weights), then
    # with a planted fault that the comparison must catch.
    (qkv, mask, n_t), g = first["k1b"]["args"], first["k1b"]["dy"].contiguous()
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
        (x, p_main, n_v), dy = first[key]["args"], first[key]["dy"].contiguous()
        p = _detached_block(p_main, ())
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
    # Planted faults, one for each limit: the vision LayerNorms' gradients
    # skip the last rows (vision limit); K1b ignores the mask (the rest).
    small = {k: v[:STEP_IMAGES] for k, v in make_batch().items()}
    tr = state["trainable"]
    step_checks = whole_step_vs_plain(
        loss_fn, tr, frozen, small,
        (k_block, {"CUDA_STEPS": k_block.CUDA_STEPS._replace(
            layernorm_bwd=fault_ln_grad_tail(k_block.layernorm_bwd_rows_cuda))}),
        (k_attn, {"attention_core_bwd_cuda": fault_mask_dropped(
            k_attn.attention_core_bwd_cuda)}))
    checks += step_checks
    step_cmp = step_checks[0][1]

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
        (x, p_main, n_v), dy = first[key]["args"], first[key]["dy"].contiguous()
        grad_leaves = k_block.BLOCK_LEAVES if wgrad else k_block.LN_LEAVES
        p = _detached_block(p_main, grad_leaves)
        wanted = [p[a][b] for a, b in grad_leaves]

        def fwd_bwd(fn=fn, x=x, p=p, n_v=n_v, dy=dy, wanted=wanted):
            xr = x.detach().requires_grad_(True)
            torch.autograd.grad(fn(xr, p, n_v), [xr] + wanted, dy)

        ms = cuda_ms(fwd_bwd, 10)
        launches, _ = device_profile(fwd_bwd)
        print(f"one {name} forward + backward, device us per launch:",
              json.dumps([[short_name(n), round(us, 1)] for n, us in launches]))
        plain_ms = cuda_ms(lambda: fwd_bwd(fn=plain), 3, 1)
        lib_ms = library_block_ms(_detached_block(p_main, ()), n_v, x, dy, wgrad)
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
    summary = dict(run["summary"], whole_step_vs_plain=step_cmp)
    return rows, checks, summary


# -- the JAX package's other routes -------------------------------------------
#
# Each phase sets the gates of one route for its run only (``gates``), on
# top of the defaults that ``main`` sets for the whole run.

DEFAULT_GATES = {"FMM_TPU_FUSED": "1", "FMM_TPU_FUSED_BLOCK": "1",
                 "FMM_TPU_FUSED_TRAIN": "0", "FMM_TPU_FUSED_TRAIN_BLOCK": "1",
                 "FMM_TPU_FUSED_TRAIN_DW": "1", "FMM_TPU_FUSED_NBLK": "1"}


def eval_counted(prog, canvas, boxes, flips, recorders: dict, label: str) -> tuple:
    """``eval_prepare_fn`` once, then ``eval_apply_fn`` on the ``BATCH``
    centre crops under ``recorders``, with every count set to 0 just before
    the apply and read just after. Returns ``(logits, counts, prep,
    images)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    tr, fr = prog["trainable"], prog["frozen"]
    prep = prog["eval_prepare_fn"](tr, fr)
    with patched(primitives, **recorders):
        reset_counts()
        images = crop_resize_flip_normalize(canvas, boxes, flips,
                                            out_size=prog["arch"].image_resolution)
        logits = prog["eval_apply_fn"](tr, fr, images, prep)
        torch.cuda.synchronize()
        counts = read_counts()
    print(f"launches, eval_apply_fn{label}:", json.dumps(counts))
    assert logits.shape == (BATCH, N_CLASSES), logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    return logits, counts, prep, images


def eval_vs_plain(prog, images, logits, label: str) -> dict:
    """The first ``E2E_IMAGES`` logits against the plain path's."""
    from federated_multi_modal_tpu_torch.ops import primitives

    tr, fr = prog["trainable"], prog["frozen"]
    with patched(primitives, **plain_kernels()):
        logits_plain = prog["eval_apply_fn"](tr, fr, images[:E2E_IMAGES],
                                             prog["eval_prepare_fn"](tr, fr))
    cmp = compare(logits[:E2E_IMAGES], logits_plain, TOL_E2E)
    print(f"eval path{label} vs plain path, {E2E_IMAGES} images:", json.dumps(cmp))
    return cmp


def eval_images_per_s(prog, canvas, boxes, flips, prep, label: str) -> dict:
    """Median wall ms of crop + ``eval_apply_fn`` on ``BATCH`` images."""
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    tr, fr = prog["trainable"], prog["frozen"]

    def crop_and_apply():
        imgs = crop_resize_flip_normalize(canvas, boxes, flips,
                                          out_size=prog["arch"].image_resolution)
        return prog["eval_apply_fn"](tr, fr, imgs, prep)

    ms = wall_ms(crop_and_apply, 5)
    print(f"eval{label}: apply (crop + towers) {ms:.2f} ms per {BATCH} images = "
          f"{BATCH / ms * 1e3:.1f} images/s")
    return {"eval_apply_ms": ms, "eval_images_per_s": BATCH / ms * 1e3}


def backward_head_widths(qkv, g, n_head: int, k2b_ms: float) -> tuple:
    """The attention backward (``attention_core_bwd.cu``) at head widths 32
    and 128 on seeded unit-scale qkv and g of K2b's shape (the vision rows:
    24 heads of 32, 6 of 128): each against its plain version at
    ``TOL_K1B`` of its largest value, the planted fault (the last rows of
    d(QKV) unwritten) that must fail that, and its time beside width 64's
    (K2b on the main path's own inputs, ``k2b_ms``). Returns ``(checks,
    summary)``; the summary's ``shapes`` feed ``attention_resources``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    B, T, D3 = qkv.shape
    D = D3 // 3
    gen = torch.Generator(device=qkv.device).manual_seed(42)
    summary = {"ms": {str(D // n_head): k2b_ms}, "shapes": [], "max_err_over_tol": {},
               "planted_fault_err_over_tol": {}}
    checks = []
    for hd in (32, 128):
        h = D // hd
        q = torch.randn(qkv.shape, generator=gen, device=qkv.device).to(torch.bfloat16)
        gg = torch.randn(g.shape, generator=gen, device=qkv.device).to(torch.bfloat16)
        ref = k_attn.attention_core_bwd_reference(q, gg, h)
        cmp = compare_scaled(k_attn.attention_core_bwd_cuda(q, gg, h), ref, TOL_K1B)
        fault = compare_scaled(fault_attention_bwd_tail(k_attn.attention_core_bwd_cuda)(q, gg, h),
                               ref, TOL_K1B)
        del ref
        summary["ms"][str(hd)] = cuda_ms(lambda: k_attn.attention_core_bwd_cuda(q, gg, h), 10)
        summary["shapes"].append([[B, T, D3], h])
        summary["max_err_over_tol"][str(hd)] = cmp["max_err_over_tol"]
        summary["planted_fault_err_over_tol"][str(hd)] = fault["max_err_over_tol"]
        checks += [(f"attention backward, head width {hd}", cmp),
                   (f"attention backward, head width {hd}, planted fault caught",
                    {"ok": not fault["ok"]})]
        del q, gg
        torch.cuda.empty_cache()
    print(f"attention backward by head width at {[B, T, D3]} (ms; err/tol; planted fault "
          f"err/tol):", json.dumps({k: summary[k] for k in
                                    ("ms", "max_err_over_tol", "planted_fault_err_over_tol")}))
    return checks, summary


def unfused_phase(prog, canvas, boxes, flips) -> tuple:
    """``FMM_TPU_FUSED=0``: eval and the train step with every vision block
    on the plain block and K2 (K2b in the backward); K2 and K2b against
    their plain versions, the 16-image logits and step against the plain
    path, the timings, and the backward at head widths 32 and 128
    (:func:`backward_head_widths`). Returns ``(rows, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    arch = prog["arch"]
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    label = " (unfused)"
    first = {}
    with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED="0")):
        logits, eval_counts, prep, images = eval_counted(
            prog, canvas, boxes, flips, {"_attn_kernels": overlay(
                k_attn, packed_attention=cotangent_recorder(
                    first, "eval", k_attn.packed_attention))}, label)
        check_counts(eval_counts, {"K2 packed_attention": n_vis, "K5 fused_block_residual": 0,
                                   "fmm_attention_core": n_vis, "fmm_gemm_epilogue": 0},
                     "eval apply" + label)
        e2e = eval_vs_plain(prog, images, logits, label)
        summary = eval_images_per_s(prog, canvas, boxes, flips, prep, label)
        del logits, prep, images
        torch.cuda.empty_cache()

        run = drive_train(prog, canvas, {"_attn_kernels": overlay(
            k_attn, packed_attention=cotangent_recorder(
                first, "train", k_attn.packed_attention))}, label)
        counts = run["counts"]
        check_counts(counts, {
            "K1 packed_attention_masked": n_text, "K1b packed_attention_masked_bwd": n_text,
            "K2 packed_attention": n_vis, "K2b packed_attention_bwd": n_vis,
            "K3 fused_block_train": 0, "K3 fused_block_train (backward)": 0,
            "K4 fused_block_train_dw": 0, "K4 fused_block_train_dw (backward)": 0,
            "K5 fused_block_residual": 0}, "train step" + label)
        small = {k: v[:STEP_IMAGES] for k, v in run["make_batch"]().items()}
        # Planted faults: K2b leaves the last rows of the vision blocks'
        # d(QKV) unwritten (vision limit); K1b ignores the mask (the rest).
        checks = whole_step_vs_plain(
            prog["loss_fn"], run["state"]["trainable"], prog["frozen"], small,
            (k_attn, {"attention_core_bwd_cuda": fault_attention_bwd_tail(
                k_attn.attention_core_bwd_cuda)}),
            (k_attn, {"attention_core_bwd_cuda": fault_mask_dropped(
                k_attn.attention_core_bwd_cuda)}), label)
        summary.update(run["summary"], whole_step_vs_plain=checks[0][1],
                       eval_launches=eval_counts)
        del run, small
        torch.cuda.empty_cache()
    checks.insert(0, ("eval path" + label, e2e))

    # -- K2 and K2b against their plain versions --------------------------
    qkv_e, n = first["eval"]["args"]
    qkv, g = first["train"]["args"][0], first["train"]["dy"].contiguous()

    def k2_check(qkv):
        return compare(k_attn.packed_attention(qkv, n),
                       k_attn.attention_core_reference(qkv, n), TOL_K1)

    def k2b_check(g):
        return compare_scaled(k_attn.packed_attention_bwd(qkv, g, n),
                              k_attn.attention_core_bwd_reference(qkv, g, n), TOL_K1B)

    cmps = {"K2": k2_check(qkv_e), "K2 seeded qkv": k2_check(seeded_cotangent(qkv_e, 7)),
            "K2b": k2b_check(g), "K2b seeded cotangent": k2b_check(seeded_cotangent(g, 8))}
    with patched(k_attn, attention_core_cuda=fault_attention_tail(k_attn.attention_core_cuda),
                 attention_core_bwd_cuda=fault_attention_bwd_tail(
                     k_attn.attention_core_bwd_cuda)):
        faults = {"K2": k2_check(qkv_e), "K2b": k2b_check(seeded_cotangent(g, 8))}
    for name, c in cmps.items():
        print(f"{name} vs plain{' (eval input)' if name == 'K2' else ''}:", json.dumps(c))
    print(f"K2, K2b planted faults (the last {PLANTED_FAULT_ROWS} rows unwritten):",
          json.dumps(brief(faults)))
    checks += list(cmps.items())
    checks += [(f"{k} planted fault caught", {"ok": not c["ok"]}) for k, c in faults.items()]

    # -- timings ---------------------------------------------------------------
    B, T, D3 = qkv.shape
    hd = D3 // 3 // n
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = (t.reshape(B, T, n, hd).transpose(1, 2).detach().requires_grad_(True)
               for t in qkv.split(D3 // 3, dim=-1))
    g_heads = g.reshape(B, T, n, hd).transpose(1, 2)
    k2_ms = cuda_ms(lambda: k_attn.packed_attention(qkv, n), 20)
    k2_plain_ms = cuda_ms(lambda: k_attn.attention_core_reference(qkv, n), 5, 1)
    # the kernel with one pass and two passes forced, and K8's two-pass
    # kernel on the column views of the same packed tensor (no copy)
    k2_pass_ms = forward_variant_ms(qkv, n, None, (4, 0))
    q_cols, k_cols, v_cols = qkv.split(D3 // 3, dim=-1)
    k2_pass_ms["attention_split on the column views"] = cuda_ms(
        lambda: k_attn.fused_attention_cuda(q_cols, k_cols, v_cols, n), 20)
    print("K2 with one pass and two passes forced, and attention_split, ms:",
          json.dumps(k2_pass_ms))
    sdpa_f_ms = cuda_ms(lambda: sdpa(q, k, v), 20)
    k2b_ms = cuda_ms(lambda: k_attn.packed_attention_bwd(qkv, g, n), 10)
    k2b_plain_ms = cuda_ms(lambda: k_attn.attention_core_bwd_reference(qkv, g, n), 3, 1)
    sdpa_fb_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(q, k, v), (q, k, v), g_heads), 20)
    pairs = B * n * hd * T * T
    k2_bound = bound(qkv.numel() * 2 + B * T * D3 // 3 * 2, 4 * pairs)
    k2b_bound = bound(2 * qkv.numel() * 2 + g.numel() * 2, 10 * pairs)
    print(f"packed_attention: {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, SDPA "
          f"{sdpa_f_ms:.4f} ms, bound {k2_bound[0]:.4f} ms; packed_attention_bwd: "
          f"{k2b_ms:.4f} ms, plain {k2b_plain_ms:.4f} ms, SDPA backward "
          f"{sdpa_fb_ms - sdpa_f_ms:.4f} ms, bound {k2b_bound[0]:.4f} ms")
    width_checks, by_width = backward_head_widths(qkv, g, n, k2b_ms)
    checks += width_checks
    common = {"route": "cuda", "shape": [list(qkv.shape), n]}
    rows = [
        dict(common, name="packed_attention",
             launches_eval_apply=eval_counts["K2 packed_attention"],
             source="federated_multi_modal_tpu_torch/csrc/attention_core.cu",
             replaces="federated_multi_modal_tpu/ops/pallas/attention.py:386",
             tpu_function="attention_packed_fwd (behind packed_attention)",
             launches=counts["K2 packed_attention"],
             max_abs_err=cmps["K2"]["max_abs_err"], tol=cmps["K2"]["tol"],
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound[0], bound_by=k2_bound[1],
             library_ms=sdpa_f_ms,
             library_call="torch.nn.functional.scaled_dot_product_attention (no mask)",
             ms_by_passes=k2_pass_ms),
        dict(common, name="packed_attention_bwd",
             source="federated_multi_modal_tpu_torch/csrc/attention_core_bwd.cu",
             replaces="federated_multi_modal_tpu/ops/pallas/attention.py:422",
             tpu_function="attention_packed_bwd (the custom VJP of packed_attention)",
             launches=counts["K2b packed_attention_bwd"],
             max_abs_err=cmps["K2b"]["max_abs_err"], tol=cmps["K2b"]["tol"],
             ms=k2b_ms, plain_ms=k2b_plain_ms, bound_ms=k2b_bound[0], bound_by=k2b_bound[1],
             library_ms=sdpa_fb_ms - sdpa_f_ms,
             library_call="torch.nn.functional.scaled_dot_product_attention (no mask), "
                          "forward + backward minus forward",
             by_head_width=by_width),
    ]
    return rows, checks, summary


def two_kernel_eval_phase(prog, canvas, boxes, flips) -> tuple:
    """``FMM_TPU_FUSED_BLOCK=0``: eval with every vision block on K6a then
    K6b; both against their plain versions, the 16-image logits against
    the plain path, and the timings. Returns ``(rows, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    n_vis = prog["arch"].vision_layers
    label = " (two-kernel block)"
    first = {}
    with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_BLOCK="0")):
        logits, counts, prep, images = eval_counted(
            prog, canvas, boxes, flips, {"_block_kernels": overlay(
                k_block,
                fused_ln_attention_residual=cotangent_recorder(
                    first, "k6a", k_block.fused_ln_attention_residual),
                fused_ln_mlp_residual=cotangent_recorder(
                    first, "k6b", k_block.fused_ln_mlp_residual))}, label)
        check_counts(counts, {"K6a fused_ln_attention_residual": n_vis,
                              "K6b fused_ln_mlp_residual": n_vis,
                              "K5 fused_block_residual": 0, "fmm_gemm_epilogue": 4 * n_vis,
                              "fmm_layernorm_rows": 2 * n_vis, "fmm_attention_core": n_vis},
                     "eval apply" + label)
        e2e = eval_vs_plain(prog, images, logits, label)
        summary = eval_images_per_s(prog, canvas, boxes, flips, prep, label)
        summary["eval_apply_idle_share"] = profile_by_kernel(
            lambda: prog["eval_apply_fn"](prog["trainable"], prog["frozen"], images, prep),
            f"eval apply{label} (towers only)")["idle_share"]
        del logits, prep, images
    summary["eval_launches"] = counts

    x, lnp, attnp, n = first["k6a"]["args"]
    y, ln2, mlpp = first["k6b"]["args"]
    seeded = seeded_block({"ln_1": lnp, "attn": attnp, "ln_2": ln2, "mlp": mlpp}, seed=8)
    x_unit, y_unit = seeded_cotangent(x, 9), seeded_cotangent(y, 10)

    def k6a(x, lnp, attnp, tol):
        return compare(k_block.fused_ln_attention_residual(x, lnp, attnp, n),
                       k_block.fused_ln_attention_residual_reference(x, lnp, attnp, n), tol)

    def k6b(y, ln2, mlpp, tol):
        return compare(k_block.fused_ln_mlp_residual(y, ln2, mlpp),
                       k_block.fused_ln_mlp_residual_reference(y, ln2, mlpp), tol)

    cmps = {"K6a": k6a(x, lnp, attnp, TOL_K5), "K6b": k6b(y, ln2, mlpp, TOL_K5),
            "K6a seeded": k6a(x_unit, seeded["ln_1"], seeded["attn"], TOL_K5_SEEDED),
            "K6b seeded": k6b(y_unit, seeded["ln_2"], seeded["mlp"], TOL_K5_SEEDED)}
    with patched(k_block, gemm_epilogue_cuda=fault_residual_gemm_tail(
            k_block.gemm_epilogue_cuda)):
        faults = {"K6a": k6a(x, lnp, attnp, TOL_K5), "K6b": k6b(y, ln2, mlpp, TOL_K5),
                  "K6a seeded": k6a(x_unit, seeded["ln_1"], seeded["attn"], TOL_K5_SEEDED),
                  "K6b seeded": k6b(y_unit, seeded["ln_2"], seeded["mlp"], TOL_K5_SEEDED)}
    for name, c in cmps.items():
        print(f"{name} vs plain:", json.dumps(c))
    print(f"K6a, K6b planted faults (the last {PLANTED_FAULT_ROWS} output rows "
          "unwritten):", json.dumps(brief(faults)))
    checks = [("eval path" + label, e2e), *cmps.items()]
    checks += [(f"{k} planted fault caught", {"ok": not c["ok"]}) for k, c in faults.items()]
    del seeded, x_unit, y_unit

    # -- timings and yardsticks -------------------------------------------
    F = torch.nn.functional
    B, T, D = x.shape
    M = B * T
    bf = torch.bfloat16

    def lin(w, b):
        return w.to(bf).T.contiguous(), b.to(bf)

    w_qkv, b_qkv = lin(attnp["w_qkv"], attnp["b_qkv"])
    w_out, b_out = lin(attnp["w_out"], attnp["b_out"])
    w_fc, b_fc = lin(mlpp["w_fc"], mlpp["b_fc"])
    w_proj, b_proj = lin(mlpp["w_proj"], mlpp["b_proj"])
    hidden = w_fc.shape[0]

    def k6a_library():
        xn = F.layer_norm(x, (D,), lnp["scale"].to(bf), lnp["bias"].to(bf), 1e-5)
        q, k, v = F.linear(xn, w_qkv, b_qkv).view(B, T, 3, n, D // n).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, D)
        return x + F.linear(a, w_out, b_out)

    def k6b_library():
        h = F.linear(F.layer_norm(y, (D,), ln2["scale"].to(bf), ln2["bias"].to(bf), 1e-5),
                     w_fc, b_fc)
        return y + F.linear(h * torch.sigmoid(1.702 * h), w_proj, b_proj)

    with torch.no_grad():
        lib_cmps = {
            "K6a library yardstick": compare(
                k6a_library(), k_block.fused_ln_attention_residual_reference(x, lnp, attnp, n),
                TOL_LIBRARY),
            "K6b library yardstick": compare(
                k6b_library(), k_block.fused_ln_mlp_residual_reference(y, ln2, mlpp),
                TOL_LIBRARY)}
        print("K6a, K6b library yardsticks vs plain:", json.dumps(brief(lib_cmps)))
        checks += list(lib_cmps.items())
        times = {
            "K6a": (cuda_ms(lambda: k_block.fused_ln_attention_residual(x, lnp, attnp, n), 10),
                    cuda_ms(lambda: k_block.fused_ln_attention_residual_reference(
                        x, lnp, attnp, n), 3, 1),
                    cuda_ms(k6a_library, 10)),
            "K6b": (cuda_ms(lambda: k_block.fused_ln_mlp_residual(y, ln2, mlpp), 10),
                    cuda_ms(lambda: k_block.fused_ln_mlp_residual_reference(y, ln2, mlpp), 3, 1),
                    cuda_ms(k6b_library, 10))}
    for key, fn, args in (("K6a", k_block.fused_ln_attention_residual, (x, lnp, attnp, n)),
                          ("K6b", k_block.fused_ln_mlp_residual, (y, ln2, mlpp))):
        launches, _ = device_profile(lambda: fn(*args))
        print(f"one {key}, device us per launch:",
              json.dumps([[short_name(nm), round(us, 1)] for nm, us in launches]))
    attn_ops = 4 * B * D * T * T
    bounds = {
        "K6a": bound(2 * M * D * 2 + 4 * D * D * 2 + 4 * D * 2 + 2 * D * 4,
                     2 * M * 4 * D * D + attn_ops),
        "K6b": bound(2 * M * D * 2 + 2 * D * hidden * 2 + (hidden + D) * 2 + 2 * D * 4,
                     2 * M * 2 * D * hidden)}
    rows = []
    for key, name, line, tpu in (
            ("K6a", "fused_ln_attention_residual", 200, "fused_ln_attention_residual"),
            ("K6b", "fused_ln_mlp_residual", 462, "fused_ln_mlp_residual")):
        ms, plain_ms, lib_ms = times[key]
        b = bounds[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/gemm_epilogue.cu",
            "sources": [f"federated_multi_modal_tpu_torch/csrc/{f}" for f in (
                ("layernorm_rows.cu", "gemm_epilogue.cu", "attention_core.cu")
                if key == "K6a" else ("layernorm_rows.cu", "gemm_epilogue.cu"))],
            "replaces": f"federated_multi_modal_tpu/ops/pallas/fused_block.py:{line}",
            "tpu_function": tpu, "shape": [list(x.shape), n, hidden],
            "launches": counts[f"{key} {name}"],
            "max_abs_err": cmps[key]["max_abs_err"], "tol": cmps[key]["tol"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms,
            "library_call": ("F.layer_norm + F.linear + scaled_dot_product_attention + "
                             "F.linear + x" if key == "K6a" else
                             "F.layer_norm + F.linear + x*sigmoid(1.702x) + F.linear + x"),
        })
        print(f"{name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, "
              f"bound {b[0]:.3f} ms ({b[1]})")
    return rows, checks, summary


def ln_attention_checks(x, dy, lnp, w, b, n_head: int, tol_act: float = TOL_TRAIN_ACT,
                        steps=None) -> dict:
    """K7 on ``x``, ``dy`` and its parameters: the CUDA forward and backward
    (dx, d gamma, d beta) against the plain steps. ``steps`` replaces the
    CUDA steps (a planted fault)."""
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    cuda, plain = steps or k_block.CUDA_STEPS, k_block.PLAIN_STEPS
    cmps = {"out": compare(k_block.ln_attention_forward(x, lnp, w, b, n_head, cuda),
                           k_block.ln_attention_forward(x, lnp, w, b, n_head, plain), tol_act)}
    got = k_block.ln_attention_backward(x, dy, lnp, w, b, n_head, cuda)
    ref = k_block.ln_attention_backward(x, dy, lnp, w, b, n_head, plain)
    for name, gt, rf, tol in zip(("dx", "ln_1.scale", "ln_1.bias"), got, ref,
                                 (TOL_TRAIN_DX, TOL_TRAIN_PARAM, TOL_TRAIN_PARAM)):
        cmps[name] = compare_scaled(gt, rf, tol)
    return cmps


def sublayer_train_phase(prog, canvas) -> tuple:
    """``FMM_TPU_FUSED_TRAIN=1, FMM_TPU_FUSED_TRAIN_BLOCK=0``: the train
    step with the frozen vision blocks on K7 (and a plain out-projection
    and MLP) and the last block on K4; K7 against its plain version, a
    whole 16-image step against the plain path, and the timings. Returns
    ``(rows, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    arch = prog["arch"]
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    label = " (sublayer)"
    first = {}
    with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_TRAIN="1", FMM_TPU_FUSED_TRAIN_BLOCK="0")):
        run = drive_train(prog, canvas, {"_block_kernels": overlay(
            k_block, fused_ln_attention=cotangent_recorder(
                first, "k7", k_block.fused_ln_attention))}, label)
        counts = run["counts"]
        check_counts(counts, {
            "K1 packed_attention_masked": n_text, "K1b packed_attention_masked_bwd": n_text,
            "K7 fused_ln_attention": n_vis - 1, "K7 fused_ln_attention (backward)": n_vis - 1,
            "K4 fused_block_train_dw": 1, "K4 fused_block_train_dw (backward)": 1,
            "K3 fused_block_train": 0, "K3 fused_block_train (backward)": 0,
            "K2 packed_attention": 0, "K5 fused_block_residual": 0}, "train step" + label)
        small = {k: v[:STEP_IMAGES] for k, v in run["make_batch"]().items()}
        # Planted faults: the vision LayerNorms' gradients skip the last rows
        # (vision limit); K1b ignores the mask (the rest).
        checks = whole_step_vs_plain(
            prog["loss_fn"], run["state"]["trainable"], prog["frozen"], small,
            (k_block, {"CUDA_STEPS": k_block.CUDA_STEPS._replace(
                layernorm_bwd=fault_ln_grad_tail(k_block.layernorm_bwd_rows_cuda))}),
            (k_attn, {"attention_core_bwd_cuda": fault_mask_dropped(
                k_attn.attention_core_bwd_cuda)}), label)
        summary = dict(run["summary"], whole_step_vs_plain=checks[0][1])
        del run, small
        torch.cuda.empty_cache()

    x, lnp, w, b, n = first["k7"]["args"]
    lnp = {k: t.detach() for k, t in lnp.items()}
    dy = first["k7"]["dy"].contiguous()
    cmps = ln_attention_checks(x, dy, lnp, w, b, n)
    seeded = seeded_block({"ln_1": lnp, "attn": {"w_qkv": w, "b_qkv": b}}, seed=12)
    s_args = (seeded["ln_1"], seeded["attn"]["w_qkv"], seeded["attn"]["b_qkv"], n)
    dy_unit = seeded_cotangent(dy, 13)
    seeded_cmps = ln_attention_checks(x, dy_unit, *s_args, TOL_TRAIN_SEEDED)
    print("K7 vs plain, main path's inputs, [max |err|, err/tol]:", json.dumps(brief(cmps)))
    print("K7 vs plain, seeded weights and unit cotangent, [max |err|, err/tol]:",
          json.dumps(brief(seeded_cmps)))
    cs = k_block.CUDA_STEPS
    faults = {
        "out": ln_attention_checks(x, dy, lnp, w, b, n, steps=cs._replace(
            attention=fault_attention_tail(k_block.attention_core_cuda)))["out"],
        "dx": ln_attention_checks(x, dy, lnp, w, b, n, steps=cs._replace(
            layernorm_bwd=fault_dx_tail_zero(k_block.layernorm_bwd_rows_cuda)))["dx"]}
    ln_fault = ln_attention_checks(x, dy_unit, *s_args, TOL_TRAIN_SEEDED, steps=cs._replace(
        layernorm_bwd=fault_ln_grad_tail(k_block.layernorm_bwd_rows_cuda)))
    faults.update({k: ln_fault[k] for k in ("ln_1.scale", "ln_1.bias")})
    print(f"K7 planted faults (the last {PLANTED_FAULT_ROWS} rows unwritten or skipped), "
          "[max |err|, err/tol]:", json.dumps(brief(faults)))
    checks += [(f"K7 {k}", c) for k, c in cmps.items()]
    checks += [(f"K7 seeded {k}", c) for k, c in seeded_cmps.items()]
    checks += [(f"K7 planted fault caught by {k}", {"ok": not c["ok"]})
               for k, c in faults.items()]
    del seeded, dy_unit, ln_fault

    # -- timings and the yardstick ------------------------------------------
    F = torch.nn.functional
    B, T, D = x.shape
    ln = {k: t.detach().requires_grad_(True) for k, t in lnp.items()}

    def fwd_bwd(fn=k_block.fused_ln_attention):
        xr = x.detach().requires_grad_(True)
        torch.autograd.grad(fn(xr, ln, w, b, n), [xr, ln["scale"], ln["bias"]], dy)

    bf = torch.bfloat16
    w_t, b_t = w.to(bf).T.contiguous(), b.to(bf)
    ln_lib = {k: t.detach().to(bf).requires_grad_(True) for k, t in lnp.items()}

    def library_fwd_bwd():
        xr = x.detach().requires_grad_(True)
        xn = F.layer_norm(xr, (D,), ln_lib["scale"], ln_lib["bias"], 1e-5)
        q, k, v = F.linear(xn, w_t, b_t).view(B, T, 3, n, D // n).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, D)
        torch.autograd.grad(a, [xr, ln_lib["scale"], ln_lib["bias"]], dy)

    ms = cuda_ms(fwd_bwd, 10)
    plain_ms = cuda_ms(lambda: fwd_bwd(k_block.fused_ln_attention_reference), 3, 1)
    lib_ms = cuda_ms(library_fwd_bwd, 10)
    launches, _ = device_profile(fwd_bwd)
    print("one fused_ln_attention forward + backward, device us per launch:",
          json.dumps([[short_name(nm), round(us, 1)] for nm, us in launches]))
    M = B * T
    attn_fwd = 4 * B * D * T * T
    k7_bound = bound(4 * M * D * 2 + 3 * D * D * 2 + 3 * D * 2 + 4 * D * 4,
                     2 * (2 * M * 3 * D * D) + attn_fwd + 2 * attn_fwd)
    worst = max(cmps.values(), key=lambda c: c["max_err_over_tol"])
    rows = [{
        "name": "fused_ln_attention", "route": "cuda",
        "source": "federated_multi_modal_tpu_torch/csrc/attention_core_bwd.cu",
        "sources": [f"federated_multi_modal_tpu_torch/csrc/{f}" for f in (
            "layernorm_rows.cu", "gemm_epilogue.cu", "attention_core.cu",
            "attention_core_bwd.cu", "layernorm_bwd_rows.cu")],
        "replaces": "federated_multi_modal_tpu/ops/pallas/fused_block.py:324",
        "tpu_function": "fused_ln_attention_fwd (:324) and fused_ln_attention_bwd (:359), "
                        "behind fused_ln_attention",
        "shape": [list(x.shape), n], "head_dim": D // n,
        "launches": counts["K7 fused_ln_attention"],
        "backward_launches": counts["K7 fused_ln_attention (backward)"],
        "max_abs_err": worst["max_abs_err"], "max_err_over_tol": worst["max_err_over_tol"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
        "library_ms": lib_ms,
        "library_call": "F.layer_norm + F.linear + scaled_dot_product_attention, "
                        "forward + backward",
        "timed": "forward + backward",
    }]
    print(f"fused_ln_attention: fwd+bwd {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
          f"{lib_ms:.3f} ms, bound {k7_bound[0]:.3f} ms ({k7_bound[1]})")
    return rows, checks, summary


# -- the block-group eval kernel, CoOp, zero-shot CLIP and K8 -----------------


def fault_inject_last_row(inject):
    """``inject_rows`` writes one row fewer: the last injected row keeps
    the stream's old value."""
    def faulty(stream, prompt, extra=None):
        keep = stream[:, -1].clone()
        inject(stream, prompt, extra)
        stream[:, -1] = keep
        return stream
    return faulty


def fault_extra_dropped(inject):
    """``inject_rows`` writes the prompt rows but drops the extra rows."""
    def faulty(stream, prompt, extra=None):
        if extra is None:
            return inject(stream, prompt)
        keep = stream[:, -extra.shape[1]:].clone()
        inject(stream, prompt, extra)
        stream[:, -extra.shape[1]:] = keep
        return stream
    return faulty


def seeded_affines(blk, seed: int):
    """``blk`` with seeded biases and LayerNorm affines (``seeded_block``'s
    draws) and its own weights."""
    out = seeded_block(blk, seed)
    for part in ("attn", "mlp"):
        for name, t in blk[part].items():
            if name.startswith("w"):
                out[part][name] = t
    return out


def block_bound(B, T, D, n_head, hidden):
    """Bytes of one block's weights, biases and LayerNorm parameters and
    operations of its four products and attention (K5's count)."""
    weight_elems = 4 * D * D + 2 * D * hidden
    n_bytes = weight_elems * 2 + (3 * D + D + hidden + D) * 2 + 4 * D * 4
    ops = 2 * B * T * weight_elems + 4 * B * n_head * (D // n_head) * T * T
    return n_bytes, ops


def group_eval_phase(prog, canvas, boxes, flips) -> tuple:
    """``FMM_TPU_FUSED_NBLK`` = 4, then 5: MaPLe's eval apply with the vision
    blocks in groups through K9 and the deep prompts injected by
    ``inject_rows``; K9 against its plain version on the first group's own
    inputs and on seeded ones (extra rows at T = 200, seeded biases and
    LayerNorm affines), with a planted fault per limit; the 16-image logits
    against the plain path; the apply beside the K5 route's in this phase.
    Returns ``(rows, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize

    arch = prog["arch"]
    n_vis = arch.vision_layers
    tr, fr = prog["trainable"], prog["frozen"]
    first, summary, checks, logits16 = {}, {}, [], {}
    with gates(**DEFAULT_GATES):
        prep = prog["eval_prepare_fn"](tr, fr)
        n_deep = len(prep["vis_deep"])
        summary["K5"] = eval_images_per_s(prog, canvas, boxes, flips, prep, " (K5, this phase)")
        images = crop_resize_flip_normalize(canvas[:E2E_IMAGES], boxes[:E2E_IMAGES],
                                            flips[:E2E_IMAGES], out_size=arch.image_resolution)
        logits16["K5"] = prog["eval_apply_fn"](tr, fr, images, prep)
    for nblk in GROUP_SIZES:
        label = f" (FMM_TPU_FUSED_NBLK={nblk})"
        with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_NBLK=nblk)):
            logits, counts, prep, images = eval_counted(
                prog, canvas, boxes, flips, {"_block_kernels": overlay(
                    k_block, fused_block_group_residual=cotangent_recorder(
                        first, nblk, k_block.fused_block_group_residual))}, label)
            check_counts(counts, {
                "K9 fused_block_group_residual": -(-n_vis // int(nblk)),
                "K5 fused_block_residual": 0, "fmm_inject_rows": n_deep,
                "fmm_gemm_epilogue": 4 * n_vis, "fmm_layernorm_rows": 2 * n_vis,
                "fmm_attention_core": n_vis}, "eval apply" + label)
            checks.append(("eval path" + label, eval_vs_plain(prog, images, logits, label)))
            vs_k5 = compare(logits[:E2E_IMAGES], logits16["K5"], TOL_E2E)
            print(f"eval path{label} vs the K5 route, {E2E_IMAGES} images (printed, not "
                  "checked):", json.dumps(brief({"vs K5": vs_k5})))
            summary[nblk] = dict(eval_images_per_s(prog, canvas, boxes, flips, prep, label),
                                 eval_launches=counts, max_abs_diff_vs_k5=vs_k5["max_abs_err"])
            del logits, prep, images
    summary["apply_ms_k9_over_k5"] = {n: summary[n]["eval_apply_ms"] / summary["K5"]["eval_apply_ms"]
                                      for n in GROUP_SIZES}
    print("eval apply ms, K9 over K5 (same phase):", json.dumps(summary["apply_ms_k9_over_k5"]))

    # -- K9 and inject_rows against their plain versions -------------------
    x, blocks, n, flags, prompts, extra = first[GROUP_SIZES[0]]["args"]
    B, T, D = x.shape

    def k9_check(x, blocks, extra, tol):
        return compare(k_block.fused_block_group_residual(x, blocks, n, flags, prompts, extra),
                       k_block.fused_block_group_residual_reference(
                           x, blocks, n, flags, prompts, extra), tol)

    gen = torch.Generator(device=x.device).manual_seed(14)
    x_s = torch.randn(B, T + 1, D, generator=gen, device=x.device).to(x.dtype)
    extra_s = torch.randn(B, 1, D, generator=gen, device=x.device).to(x.dtype)
    blocks_s = [seeded_affines(b, seed=20 + i) for i, b in enumerate(blocks)]
    cmps = {"K9": k9_check(x, blocks, extra, TOL_K9),
            "K9 seeded": k9_check(x_s, blocks_s, extra_s, TOL_K9_SEEDED)}
    stream = torch.randn(B, T + 1, D, generator=gen, device=x.device)
    got = k_block.inject_rows_cuda(stream.clone(), prompts[0], extra_s)
    ref = k_block.inject_rows_reference(stream.clone(), prompts[0], extra_s)
    cmps["inject_rows"] = {"max_abs_err": float((got - ref).abs().max()), "tol": "exact",
                           "ok": bool(torch.equal(got, ref))}
    del got, ref
    with patched(k_block, inject_rows_cuda=fault_inject_last_row(k_block.inject_rows_cuda)):
        faults = {"K9 one row fewer": k9_check(x, blocks, extra, TOL_K9)}
    with patched(k_block, inject_rows_cuda=fault_extra_dropped(k_block.inject_rows_cuda)):
        faults["K9 seeded, extra rows dropped"] = k9_check(x_s, blocks_s, extra_s, TOL_K9_SEEDED)
    for name, c in cmps.items():
        print(f"{name} vs plain:", json.dumps(c))
    print("K9 planted faults (inject_rows writes one row fewer; drops the extra rows):",
          json.dumps(brief(faults)))
    checks += list(cmps.items())
    checks += [(f"{k} planted fault caught", {"ok": not c["ok"]}) for k, c in faults.items()]

    # -- timings and the yardstick ------------------------------------------
    G = len(blocks)
    hidden = blocks[0]["mlp"]["w_fc"].shape[1]
    k9_ms = cuda_ms(lambda: k_block.fused_block_group_residual(x, blocks, n, flags, prompts,
                                                               extra), 5)
    k9_plain_ms = cuda_ms(lambda: k_block.fused_block_group_residual_reference(
        x, blocks, n, flags, prompts, extra), 2, 1)
    layers = [library_block(b, n) for b in blocks]

    def library_group():
        y = x
        for layer in layers:
            y = layer(y)
        return y

    with torch.no_grad():
        k9_lib_ms = cuda_ms(library_group, 5)
    del layers
    inject_host_us = cuda_ms(lambda: k_block.inject_rows_cuda(stream, prompts[0], extra_s),
                             50) * 1e3
    inject_plain_us = cuda_ms(lambda: k_block.inject_rows_reference(stream, prompts[0], extra_s),
                              50) * 1e3
    # device time per launch over twenty launches in one window: a single
    # few-microsecond launch may be missing from the trace, and now and then
    # every launch of the window is, so it is profiled up to three times
    for _ in range(3):
        traced = [us for name, us in device_profile(lambda: [
            k_block.inject_rows_cuda(stream, prompts[0], extra_s) for _ in range(20)])[0]
            if "inject_rows" in name]
        if traced:
            break
    assert traced, "no inject_rows launch in the profiler's trace"
    inject_us = statistics.median(traced)
    launches, _ = device_profile(lambda: k_block.fused_block_group_residual(
        x, blocks, n, flags, prompts, extra))
    print(f"one fused_block_group_residual (G={G}), device us per launch:",
          json.dumps([[short_name(nm), round(us, 1)] for nm, us in launches]))
    w_bytes, ops = block_bound(B, T, D, n, hidden)
    k9_bound = bound(2 * B * T * D * 2 + G * w_bytes + sum(p.numel() for p in prompts) * 2,
                     G * ops)
    inj_bound = bound(prompts[0].numel() * 2 + extra_s.numel() * 2 + B * 3 * D * 4, 0)
    counts = summary[GROUP_SIZES[0]]["eval_launches"]
    row = {
        "name": "fused_block_group_residual", "route": "cuda",
        "source": "federated_multi_modal_tpu_torch/csrc/inject_rows.cu",
        "sources": [f"federated_multi_modal_tpu_torch/csrc/{f}" for f in (
            "inject_rows.cu", "layernorm_rows.cu", "gemm_epilogue.cu", "attention_core.cu")],
        "replaces": "federated_multi_modal_tpu/ops/pallas/fused_block.py:776",
        "tpu_function": "_fused_block_group_jit with G > 1 (_group_kernel), behind "
                        "fused_block_group_residual",
        "shape": [list(x.shape), n, hidden, G, list(flags)],
        "launches": counts["K9 fused_block_group_residual"],
        "launches_nblk5": summary[GROUP_SIZES[1]]["eval_launches"][
            "K9 fused_block_group_residual"],
        "max_abs_err": cmps["K9"]["max_abs_err"], "tol": cmps["K9"]["tol"],
        "ms": k9_ms, "plain_ms": k9_plain_ms, "bound_ms": k9_bound[0], "bound_by": k9_bound[1],
        "library_ms": k9_lib_ms,
        "library_call": f"{G} x torch.nn.TransformerEncoderLayer (bf16, norm_first, QuickGELU)",
        "inject_rows": {"launches": counts["fmm_inject_rows"], "device_us": inject_us,
                        "us_by_events_one_call": inject_host_us,
                        "plain_us_by_events_one_call": inject_plain_us,
                        "shape": [[B, T + 1, D], list(prompts[0].shape), list(extra_s.shape)],
                        "bound_us": inj_bound[0] * 1e3,
                        "max_abs_err": cmps["inject_rows"]["max_abs_err"]},
    }
    print(f"fused_block_group_residual (G={G}): {k9_ms:.3f} ms, plain {k9_plain_ms:.3f} ms, "
          f"library {k9_lib_ms:.3f} ms, bound {k9_bound[0]:.3f} ms ({k9_bound[1]}); "
          f"inject_rows {inject_us:.2f} us on the device ({inject_host_us:.2f} us between "
          f"events around one call; its plain version's two copies {inject_plain_us:.2f} us), "
          f"bound {inj_bound[0] * 1e3:.2f} us")
    return [row], checks, summary


def drive_steps(loss_fn, tx, trainable, frozen, make_batch, label: str) -> dict:
    """One train step with every count set to 0 just before and read just
    after, then ``TRAIN_STEPS`` timed steps; returns the counts, the
    numbers and the state."""
    import torch

    from federated_multi_modal_tpu_torch.engine.trainer import make_train_step

    train_step = make_train_step(loss_fn, tx)
    state = {"trainable": trainable, "opt": tx.init(trainable)}

    def one_step():
        state["trainable"], state["opt"], loss, _ = train_step(
            state["trainable"], frozen, state["opt"], make_batch())
        return loss

    reset_counts()
    loss0 = one_step()
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches, one train step{label}:", json.dumps(counts))
    losses, step_ms = [float(loss0)], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = one_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    assert all(np.isfinite(losses)), losses
    median_ms = statistics.median(step_ms)
    print(f"train step{label}: median {median_ms:.2f} ms of {TRAIN_STEPS} "
          f"({', '.join(f'{t:.2f}' for t in step_ms)}), losses {json.dumps(losses)}")
    return {"counts": counts, "state": state,
            "summary": {"train_step_ms": median_ms, "train_step_ms_all": step_ms,
                        "train_losses": losses, "train_launches": counts,
                        "profile": profile_by_kernel(one_step, "train step" + label)}}


def coop_phase(canvas, boxes, flips) -> tuple:
    """CoOp at ViT-B/16, 1000 classes, 16 generic context tokens, class token
    at the end: the train step at batch 32 (counted, timed) under the
    default gates and under ``FMM_TPU_FUSED_NBLK=4``, a whole 16-image step
    against the plain path with a planted fault, and the eval at 512 images
    under both. Returns ``(program, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.trainers.coop import (
        build_coop_optimizer,
        build_coop_program,
    )

    t0 = time.perf_counter()
    prog = build_coop_program("ViT-B/16", classnames=[f"class {i}" for i in range(N_CLASSES)],
                              n_ctx=16, csc=False, class_token_position="end", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arch = prog["arch"]
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    tr, fr = prog["trainable"], prog["frozen"]
    first = {}
    with patched(primitives, _attn_kernels=overlay(
            k_attn, packed_attention_masked=cotangent_recorder(
                first, "k1", k_attn.packed_attention_masked))):
        prog["eval_prepare_fn"](tr, fr)
    qkv = first["k1"]["args"][0]
    print(f"CoOp program: ViT-B/16, {prog['n_cls']} classes, n_ctx {prog['n_ctx']}, text_len "
          f"{prog['text_len']}, text tower K1 on qkv {list(qkv.shape)}, init {init_s:.1f} s")
    summary = {"init_s": init_s, "text_len": prog["text_len"], "k1_shape": list(qkv.shape)}
    checks = []

    rng = np.random.default_rng(3)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, COOP_BATCH)).cuda()
    gen = torch.Generator(device=canvas.device).manual_seed(4)
    crops = canvas[:COOP_BATCH]

    def make_batch():
        b, f = sample_rrc_boxes_torch(gen, COOP_BATCH, crops.shape[1])
        return {"image": crop_resize_flip_normalize(crops, b, f, out_size=arch.image_resolution),
                "label": labels}

    for nblk, expected in (("1", {"K5 fused_block_residual": n_vis,
                                  "K9 fused_block_group_residual": 0}),
                           ("4", {"K9 fused_block_group_residual": -(-n_vis // 4),
                                  "K5 fused_block_residual": 0})):
        label = f" (CoOp, B={COOP_BATCH}, FMM_TPU_FUSED_NBLK={nblk})"
        with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_NBLK=nblk)):
            run = drive_steps(prog["loss_fn"], build_coop_optimizer(), tr, fr, make_batch, label)
        check_counts(run["counts"], dict(
            expected, **{"K1 packed_attention_masked": n_text,
                         "K1b packed_attention_masked_bwd": n_text,
                         "K3 fused_block_train": 0, "K4 fused_block_train_dw": 0,
                         "fmm_inject_rows": 0}), "train step" + label)
        summary[f"train_nblk{nblk}"] = run["summary"]
        trained = run["state"]["trainable"]

    # -- one whole 16-image step: kernel path against plain path ------------
    small = {k: v[:STEP_IMAGES] for k, v in make_batch().items()}

    def hold(got, ref, loss_ref=None):
        (loss, grads), (r_loss, r_grads) = got, ref
        r_loss = r_loss if loss_ref is None else loss_ref
        loss_rel = abs(loss - r_loss) / abs(r_loss)
        grad = compare_scaled(grads["prompt_learner.ctx"], r_grads["prompt_learner.ctx"],
                              TOL_STEP_GRAD_OTHER)
        return {"loss_rel_err": loss_rel, "loss_tol": TOL_STEP_LOSS, "ctx_grad": grad,
                "max_err_over_tol": max(loss_rel / TOL_STEP_LOSS, grad["max_err_over_tol"]),
                "ok": loss_rel <= TOL_STEP_LOSS and grad["ok"]}

    kernel_step = step_loss_and_grads(prog["loss_fn"], trained, fr, small)
    with plain_path():
        full_plain_step = step_loss_and_grads(prog["loss_fn"], trained, fr, small)
    with plain_path(exact_attention_forward):
        ref_step = step_loss_and_grads(prog["loss_fn"], trained, fr, small)
    step_cmp = hold(kernel_step, ref_step, loss_ref=full_plain_step[0])
    print("  CoOp, printed, not checked: the kernel path against the fully plain path, and "
          "the fully plain path against the reference (the control):",
          json.dumps({"kernel path": hold(kernel_step, full_plain_step),
                      "control": hold(full_plain_step, ref_step)}))
    with patched(k_attn, attention_core_bwd_cuda=fault_mask_dropped(
            k_attn.attention_core_bwd_cuda)):
        fault = hold(step_loss_and_grads(prog["loss_fn"], trained, fr, small), ref_step)
    print(f"CoOp whole step, {STEP_IMAGES} images, kernel path vs the plain path with an "
          f"exact attention forward:", json.dumps(step_cmp))
    print("  planted fault (K1b ignores the mask):", json.dumps(fault))
    checks += [("CoOp whole step", step_cmp),
               ("CoOp whole step planted fault caught", {"ok": not fault["ok"]})]
    del small

    # -- the eval at BATCH images ---------------------------------------------
    for nblk, expected in (("1", {"K5 fused_block_residual": n_vis}),
                           ("4", {"K9 fused_block_group_residual": -(-n_vis // 4),
                                  "K5 fused_block_residual": 0})):
        label = f" (CoOp, FMM_TPU_FUSED_NBLK={nblk})"
        with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_NBLK=nblk)):
            logits, counts, prep, images = eval_counted(prog, canvas, boxes, flips, {}, label)
            check_counts(counts, expected, "eval apply" + label)
            checks.append(("eval path" + label, eval_vs_plain(prog, images, logits, label)))
            prepare_ms = wall_ms(lambda: prog["eval_prepare_fn"](tr, fr), 3)
            summary[f"eval_nblk{nblk}"] = dict(
                eval_images_per_s(prog, canvas, boxes, flips, prep, label),
                eval_prepare_ms=prepare_ms, eval_launches=counts)
            print(f"eval{label}: prepare {prepare_ms:.2f} ms")
            del logits, prep, images
    summary["whole_step_vs_plain"] = step_cmp
    return prog, checks, summary


def zeroshot_phase(coop_prog, canvas, boxes, flips) -> tuple:
    """Zero-shot CLIP on the CoOp program's CLIP weights: the text features
    of ``ZS_TEMPLATE`` over the same 1000 classes (K1 on 77 tokens under the
    causal mask, held against its plain version), then the eval at 512
    images under the default gates and ``FMM_TPU_FUSED_NBLK=4``, with the
    16-image logits against the plain path. Returns ``(rows, checks,
    summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.trainers.zsclip import (
        make_zeroshot_infer,
        zeroshot_text_features,
    )

    arch = coop_prog["arch"]
    clip = coop_prog["frozen"]["clip"]
    classnames = [f"class {i}" for i in range(N_CLASSES)]
    n_text, n_vis = arch.transformer_layers, arch.vision_layers
    infer = make_zeroshot_infer(arch)
    prog = {"arch": arch, "trainable": None, "frozen": clip,
            "eval_prepare_fn": lambda _, fr: zeroshot_text_features(
                fr, arch, classnames, [ZS_TEMPLATE], device=canvas.device),
            "eval_apply_fn": lambda _, fr, images, feats: infer(fr, feats, images)}
    first = {}
    with patched(primitives, _attn_kernels=overlay(
            k_attn, packed_attention_masked=cotangent_recorder(
                first, "k1", k_attn.packed_attention_masked))):
        reset_counts()
        feats = prog["eval_prepare_fn"](None, clip)
        torch.cuda.synchronize()
        counts = read_counts()
    print("launches, zero-shot text features:", json.dumps(counts))
    check_counts(counts, {"K1 packed_attention_masked": n_text, "fmm_attention_core": n_text},
                 "zero-shot text features")
    assert feats.shape == (N_CLASSES, arch.embed_dim) and bool(torch.isfinite(feats).all())
    features_ms = wall_ms(lambda: prog["eval_prepare_fn"](None, clip), 3)
    summary = {"text_features_ms": features_ms, "text_launches": counts,
               "text_features_profile": profile_by_kernel(
                   lambda: prog["eval_prepare_fn"](None, clip), "zero-shot text features")}
    print(f"zero-shot text features ({N_CLASSES} classes, 77 tokens): {features_ms:.2f} ms")

    # -- K1 at the new shape against its plain version ----------------------
    qkv, mask, n = first["k1"]["args"]
    k1 = compare(k_attn.packed_attention_masked(qkv, mask, n),
                 k_attn.packed_attention_masked_reference(qkv, mask, n), TOL_K1)
    print(f"K1 at qkv {list(qkv.shape)}, causal mask {list(mask.shape)}, vs plain:",
          json.dumps(k1))
    B1, T1, D3 = qkv.shape
    hd = D3 // 3 // n
    q, k, v = (t.reshape(B1, T1, n, hd).transpose(1, 2) for t in qkv.split(D3 // 3, dim=-1))
    k1_times = {
        "ms": cuda_ms(lambda: k_attn.packed_attention_masked(qkv, mask, n), 10),
        "plain_ms": cuda_ms(lambda: k_attn.packed_attention_masked_reference(qkv, mask, n), 3, 1),
        "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10)}
    b = bound(qkv.numel() * 2 + mask.numel() * 4 + B1 * T1 * D3 // 3 * 2,
              4 * B1 * n * hd * int(torch.isfinite(mask).sum()))
    k1_times.update(bound_ms=b[0], bound_by=b[1], shape=[list(qkv.shape), list(mask.shape), n],
                    max_abs_err=k1["max_abs_err"],
                    ms_by_passes=forward_variant_ms(qkv, n, mask, (2, 4, 0)),
                    library_call="scaled_dot_product_attention(is_causal=True)")
    print("K1 at the zero-shot shape:", json.dumps(k1_times))
    checks = [("K1 zero-shot shape", k1)]

    for nblk, expected in (("1", {"K5 fused_block_residual": n_vis}),
                           ("4", {"K9 fused_block_group_residual": -(-n_vis // 4),
                                  "K5 fused_block_residual": 0})):
        label = f" (zero-shot, FMM_TPU_FUSED_NBLK={nblk})"
        with gates(**dict(DEFAULT_GATES, FMM_TPU_FUSED_NBLK=nblk)):
            logits, counts, prep, images = eval_counted(prog, canvas, boxes, flips, {}, label)
            check_counts(counts, expected, "eval apply" + label)
            checks.append(("eval path" + label, eval_vs_plain(prog, images, logits, label)))
            summary[f"eval_nblk{nblk}"] = dict(
                eval_images_per_s(prog, canvas, boxes, flips, prep, label), eval_launches=counts)
            del logits, prep, images
    return k1_times, checks, summary


def fault_split_tail(attention):
    """The split-head attention leaves the last rows of its output
    unwritten (zero)."""
    def faulty(q, k, v, n_head, attn_mask=None):
        out = attention(q, k, v, n_head, attn_mask)
        out.view(-1, out.shape[-1])[-PLANTED_FAULT_ROWS:] = 0
        return out
    return faulty


def fault_split_mask_dropped(attention):
    """The split-head attention ignores the mask it is given."""
    def faulty(q, k, v, n_head, attn_mask=None):
        return attention(q, k, v, n_head, None)
    return faulty


def split_attention_phase(device) -> tuple:
    """K8 on ``SPLIT_SHAPES``: each shape once through the route
    (``multi_head_attention`` with seeded weights, counts set to 0 just
    before and read just after), then the forward on the column split of a
    seeded packed QKV against the plain version, the gradients of
    ``fused_attention_diff`` against plain autograd with a seeded unit
    cotangent, planted faults, and times beside SDPA, on ``device``.
    Returns ``(row, checks)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    inputs = {}
    for name, B, T, D, H, causal in SPLIT_SHAPES:
        gen = torch.Generator(device=device).manual_seed(30 + T)

        def randn(*shape, scale=1.0, gen=gen):
            return (torch.randn(shape, generator=gen, device=device) * scale).to(bf)

        mask = primitives.build_causal_mask(T, device=device) if causal else None
        p = {"w_qkv": randn(D, 3 * D, scale=D ** -0.5), "b_qkv": randn(3 * D, scale=0.1),
             "w_out": randn(D, D, scale=D ** -0.5), "b_out": randn(D, scale=0.1)}
        inputs[name] = (randn(B, T, D), p, randn(B, T, 3 * D), randn(B, T, D), mask, H)
    reset_counts()
    for name, (x, p, _, _, mask, H) in inputs.items():
        out = primitives.multi_head_attention(x, p, H, mask)
        assert bool(torch.isfinite(out).all())
    torch.cuda.synchronize()
    counts = read_counts()
    print("launches, multi_head_attention on the two K8 shapes:", json.dumps(counts))
    check_counts(counts, {"K8 fused_attention": len(SPLIT_SHAPES),
                          "fmm_attention_split": len(SPLIT_SHAPES),
                          "fmm_attention_core": 0}, "K8 shapes")

    checks, results = [], {}
    for name, B, T, D, H, causal in SPLIT_SHAPES:
        _, _, qkv, g, mask, _ = inputs[name]
        hd = D // H
        q, k, v = qkv.split(D, dim=-1)

        def fwd_check():
            return compare(k_attn.fused_attention(q, k, v, H, mask),
                           k_attn.fused_attention_reference(q, k, v, H, mask), TOL_K1)

        qkv_r = qkv.detach().requires_grad_(True)
        (dqkv,) = torch.autograd.grad(
            k_attn.fused_attention_diff(*qkv_r.split(D, dim=-1), H, mask), qkv_r, g)
        (r_dqkv,) = torch.autograd.grad(
            k_attn.fused_attention_reference(*qkv_r.split(D, dim=-1), H, mask), qkv_r, g)
        cmps = {"forward": fwd_check(), "gradient": compare_scaled(dqkv, r_dqkv, TOL_K1B)}
        with patched(k_attn, fused_attention_cuda=fault_split_tail(k_attn.fused_attention_cuda)):
            faults = {"output's last rows dropped": fwd_check()}
        if causal:
            with patched(k_attn, fused_attention_cuda=fault_split_mask_dropped(
                    k_attn.fused_attention_cuda)):
                faults["mask dropped"] = fwd_check()
        print(f"K8 shape ({name}) {[B, T, D]}, {H} heads of {hd}"
              f"{', causal' if causal else ''}, vs plain:", json.dumps(cmps))
        print(f"K8 shape ({name}) planted faults:", json.dumps(brief(faults)))
        checks += [(f"K8 ({name}) {k}", c) for k, c in cmps.items()]
        checks += [(f"K8 ({name}) planted fault caught: {k}", {"ok": not c["ok"]})
                   for k, c in faults.items()]
        qh, kh, vh = (t.reshape(B, T, H, hd).transpose(1, 2) for t in (q, k, v))
        ms = cuda_ms(lambda: k_attn.fused_attention(q, k, v, H, mask), 20)
        plain_ms = cuda_ms(lambda: k_attn.fused_attention_reference(q, k, v, H, mask), 5, 1)
        lib_ms = cuda_ms(lambda: sdpa(qh, kh, vh, is_causal=causal), 20)
        pairs = int(torch.isfinite(mask).sum()) if causal else T * T
        b = bound(4 * B * T * D * 2 + (T * T * 4 if causal else 0), 4 * B * H * hd * pairs)
        results[name] = {
            "shape": [[B, T, D], H, hd, "causal" if causal else "no mask"],
            "max_abs_err": cmps["forward"]["max_abs_err"], "tol": cmps["forward"]["tol"],
            "grad_max_err_over_max": cmps["gradient"]["max_err_over_max"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms}
        print(f"fused_attention ({name}): {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    a = results["a"]
    row = dict(
        a, name="fused_attention", route="cuda",
        source="federated_multi_modal_tpu_torch/csrc/attention_split.cu",
        replaces="federated_multi_modal_tpu/ops/pallas/attention.py:127 (no mask) and :147 "
                 "(masked)",
        tpu_function="fused_attention (_attn_kernel_nomask, _attn_kernel), behind "
                     "fused_attention_diff and multi_head_attention_pallas",
        launches=counts["K8 fused_attention"],
        library_call="torch.nn.functional.scaled_dot_product_attention (is_causal for (b))",
        timed="forward; shape (a) here, (b) under shape_b", shape_b=results["b"])
    return row, checks


# -- the attention microbench and its prototypes P1-P3 -------------------------


# -- gemm_epilogue.cu by product ------------------------------------------------
#
# Every product that the vision blocks of the default train step hand to
# gemm_epilogue.cu (fused_block.block_gemm_products at the step's own M, D
# and hidden), each on seeded bf16 inputs: held against its plain version,
# the same bits on a repeat launch, planted faults, timed beside its bound
# and torch.matmul on the same operands.

# The line of the TPU kernel's body that computes each product
# (federated_multi_modal_tpu/ops/pallas/fused_block.py): _block_body32 for
# the forward, _train_fwd_kernel for K3's fc, _train_bwd_kernel for the rest.
GEMM_REPLACES = {"qkv": 528, "out_proj": 555, "fc": 569, "fc_save_h": 948,
                 "fc_h_f32": 1077, "proj": 574, "dh": 1083, "dh_h_f32": 1083,
                 "dxn2": 1088, "da": 1118, "dyln1": 1169, "dw_qkv": 1175,
                 "dw_out": 1124, "dw_fc": 1095, "dw_proj": 1101}
GEMM_STEP = 64  # the kernel's K step (kBK in gemm_epilogue.cu)
GEMM_TILE_N = 256  # its tile's columns


def gemm_step_launches(passes: dict, n_vis: int) -> dict:
    """Launches of each product in one default train step: vision blocks
    0 to n_vis - 2 take K3 (forward keeping h, backward), the last K4."""
    per_step = {}
    for run, n in (("forward_save_h", n_vis - 1), ("backward", n_vis - 1),
                   ("forward", 1), ("backward_wgrad", 1)):
        for prod in passes[run]:
            per_step[prod] = per_step.get(prod, 0) + n
    return per_step


def gemm_inputs(prod, gen):
    """Seeded bf16 operands of ``prod`` at unit scale over its contraction,
    and the keyword arguments of ``gemm_epilogue_cuda`` (``None`` for TN)."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    if prod.layout == k_block._TN:
        return randn(prod.k, prod.rows), randn(prod.k, prod.cols), None
    e = k_block.epilogue_fields(prod.code)
    M, N, K = prod.rows, prod.cols, prod.k
    a = randn(M, K)
    w = randn(*((N, K) if prod.layout == k_block._NT else (K, N)), scale=K ** -0.5)
    kw = {"out_dtype": e["out"], "trans_w": prod.layout == k_block._NT, "gelu": e["gelu"],
          "pre_dtype": e["pre"]}
    if e["bias"]:
        kw["bias"] = randn(N, dtype=torch.float32, scale=0.25)
    if e["dgelu"]:
        kw["dgelu_of"] = randn(M, N, dtype=e["dgelu"], scale=2.0)
    if e["residual"]:
        kw["residual"] = randn(M, N, dtype=e["residual"])
    return a, w, kw


def gemm_held(got, ref) -> dict:
    """bf16 outputs at 2**-7 (``compare``), fp32 ones at 2**-14 of their
    largest value (``compare_scaled``); a dual write's two outputs each."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    cmps = [compare(g, r, TOL_GEMM_BF16) if g.dtype == torch.bfloat16
            else compare_scaled(g, r, TOL_GEMM_F32) for g, r in zip(got, ref)]
    worst = max(cmps, key=lambda c: c["max_err_over_tol"])
    return dict(worst, ok=all(c["ok"] for c in cmps))


def gemm_faults(prod, a, w, kw, ref) -> dict:
    """The planted faults of one product, each ``{"ok": caught}``: the last
    K stage dropped (the product over all but the last 64-deep step); for a
    product with an epilogue, the epilogue skipped on its last 256-column
    tile (the bare product spliced in there); for TN, the last split's
    partial never written (the product over the other splits' rows)."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    faults = {}
    K = prod.k
    if kw is None:
        dropped = k_block.gemm_tn_cuda(a[:K - GEMM_STEP].contiguous(),
                                       w[:K - GEMM_STEP].contiguous())
        faults["last K stage dropped"] = {"ok": not gemm_held(dropped, ref)["ok"]}
        splits, k_per = k_block.tn_split_plan(
            prod.rows, prod.cols, K, torch.cuda.get_device_properties(0).multi_processor_count)
        rows = (splits - 1) * k_per
        unwritten = k_block.gemm_tn_cuda(a[:rows].contiguous(), w[:rows].contiguous())
        faults["last split's partial unwritten"] = {"ok": not gemm_held(unwritten, ref)["ok"]}
        return faults
    cut = w[:, :K - GEMM_STEP] if kw["trans_w"] else w[:K - GEMM_STEP]
    dropped = k_block.gemm_epilogue_cuda(a[:, :K - GEMM_STEP].contiguous(), cut.contiguous(),
                                         **kw)
    faults["last K stage dropped"] = {"ok": not gemm_held(dropped, ref)["ok"]}
    if prod.code != k_block.epilogue_code(out=kw["out_dtype"]):
        got = k_block.gemm_epilogue_cuda(a, w, **kw)
        got = got[0] if isinstance(got, tuple) else got
        bare = k_block.gemm_epilogue_cuda(a, w, out_dtype=kw["out_dtype"],
                                          trans_w=kw["trans_w"])
        n0 = (prod.cols - 1) // GEMM_TILE_N * GEMM_TILE_N
        got[:, n0:] = bare[:, n0:]
        faults["epilogue skipped on the last N tile"] = {
            "ok": not gemm_held(got, ref[0] if isinstance(ref, tuple) else ref)["ok"]}
    return faults


def library_mm(a, b, f32: bool):
    """``torch.mm`` of the bf16 operands, with an fp32 output where the
    product writes fp32 (``out_dtype``, where this PyTorch has it; else the
    bf16 product, and the row says so)."""
    import torch

    if f32:
        try:
            return torch.mm(a, b, out_dtype=torch.float32), "torch.mm (bf16 in, fp32 out)"
        except (TypeError, RuntimeError):
            pass
    return torch.mm(a, b), "torch.mm (bf16 in, bf16 out)"


def gemm_product_phase(gemm_counts: dict, x_shape, hidden: int, n_vis: int) -> tuple:
    """The products of the default train step's vision blocks at the step's
    own M = B T, D and hidden: the counted step's launches of each against
    the table, then each product on seeded inputs against its plain
    version, the same bits on repeat, its planted faults, and its time
    beside its bound and the library call's. Returns ``(rows, checks,
    summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    B, T, D = x_shape
    M = B * T
    passes = k_block.block_gemm_products(M, D, hidden)
    per_step = gemm_step_launches(passes, n_vis)
    table = {product_label(p.key): n for p, n in per_step.items()}
    launches_ok = gemm_counts == table
    print("gemm_epilogue launches by product in the counted train step (got, table):",
          json.dumps({k: [gemm_counts.get(k, 0), table.get(k, 0)]
                      for k in sorted(set(gemm_counts) | set(table))}))
    checks = [("gemm_epilogue products launched in the train step as the table says",
               {"ok": launches_ok})]
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, summary = [], {}
    for prod, n in per_step.items():
        a, w, kw = gemm_inputs(prod, gen)
        if kw is None:
            def run(a=a, w=w):
                return k_block.gemm_tn_cuda(a, w)

            def plain(a=a, w=w):
                return k_block.gemm_tn_reference(a, w)
            lib_a, lib_b, f32 = a.T, w, True
            in_bytes = (a.numel() + w.numel()) * 2
            out_bytes = prod.rows * prod.cols * 4
        else:
            def run(a=a, w=w, kw=kw):
                return k_block.gemm_epilogue_cuda(a, w, **kw)

            def plain(a=a, w=w, kw=kw):
                return k_block.gemm_epilogue_reference(a, w, **kw)
            lib_a, lib_b = a, (w.T if kw["trans_w"] else w)
            f32 = kw["out_dtype"] == torch.float32
            in_bytes = (a.numel() + w.numel()) * 2 + sum(
                kw[k].numel() * kw[k].element_size() for k in ("bias", "dgelu_of", "residual")
                if k in kw)
            out_bytes = prod.rows * prod.cols * (kw["out_dtype"].itemsize + (
                kw["pre_dtype"].itemsize if kw["pre_dtype"] else 0))
        got, again = run(), run()
        ref = plain()
        torch.cuda.synchronize()
        held = gemm_held(got, ref)
        same = all(torch.equal(u, v) for u, v in zip(
            got if isinstance(got, tuple) else (got,), again if isinstance(again, tuple) else (again,)))
        faults = gemm_faults(prod, a, w, kw, ref)
        del got, again, ref
        ms = cuda_ms(run, 10)
        plain_ms = cuda_ms(plain, 3, 1)
        lib_call = library_mm(lib_a, lib_b, f32)[1]
        lib_ms = cuda_ms(lambda: library_mm(lib_a, lib_b, f32), 10)
        b = bound(in_bytes + out_bytes, prod.flops)
        label = product_label(prod.key)
        name = f"gemm_epilogue {prod.name}"
        print(f"{name} [{label}]: {ms:.4f} ms ({prod.flops / ms / 1e9:.1f} TFLOP/s), bound "
              f"{b[0]:.4f} ms ({b[1]}), {lib_call} {lib_ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"{n} launches a step; vs plain {json.dumps(brief({'': held}))[5:-1]}, same bits "
              f"{same}, faults caught {json.dumps({k: v['ok'] for k, v in faults.items()})}")
        checks += [(f"{name} vs plain", held), (f"{name} same bits on repeat", {"ok": same})]
        checks += [(f"{name} planted fault ({k}) caught", v) for k, v in faults.items()]
        rows.append({
            "name": name, "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/gemm_epilogue.cu",
            "replaces": f"federated_multi_modal_tpu/ops/pallas/fused_block.py:"
                        f"{GEMM_REPLACES[prod.name]}",
            "product": label, "layout": GEMM_LAYOUTS[prod.layout],
            "shape": [prod.rows, prod.cols, prod.k], "epilogue": prod.code,
            "launches": gemm_counts.get(label, 0), "launches_table": n,
            "max_abs_err": held["max_abs_err"], "max_err_over_tol": held["max_err_over_tol"],
            "tol": held["tol"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms, "library_call": lib_call,
            "tflops": prod.flops / ms / 1e9, "share_of_bound": b[0] / ms,
        })
        summary[prod.name] = {"ms": ms, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib_ms,
                              "launches": n}
        del a, w, kw
        torch.cuda.empty_cache()
    step_ms = sum(r["ms"] * r["launches_table"] for r in rows)
    step_bound = sum(r["bound_ms"] * r["launches_table"] for r in rows)
    step_lib = sum(r["library_ms"] * r["launches_table"] for r in rows)
    print(f"gemm_epilogue by product, one train step's launches: {step_ms:.2f} ms, bound "
          f"{step_bound:.2f} ms, library {step_lib:.2f} ms")
    summary["train_step_sum"] = {"ms": step_ms, "bound_ms": step_bound, "library_ms": step_lib}
    return rows, checks, summary


# The LayerNorm backward's instances at the default train step's 102,400
# rows of 768: (name, x, dres, dx dtypes, bf16 copy, partials, the TPU
# kernel's line, the run whose counted launches are the instance's).
LN_BWD_INSTANCES = (
    ("LN2 (K3/K4)", "float32", "bfloat16", "float32", True, True,
     "federated_multi_modal_tpu/ops/pallas/fused_block.py:1107", "default train step"),
    ("LN1 (K3/K4)", "bfloat16", "float32", "bfloat16", False, True,
     "federated_multi_modal_tpu/ops/pallas/fused_block.py:1186", "default train step"),
    ("K7", "bfloat16", None, "bfloat16", False, True,
     "federated_multi_modal_tpu/ops/pallas/fused_block.py:293", "sublayer train step"),
    ("P2", "bfloat16", None, "bfloat16", False, False,
     "tools/attn_microbench.py:202", "microbench drive"),
)
LN_BWD_ROWS = BATCH * 200  # the vision tower's B T in the train step
# The LayerNorm backward against its plain version: the card tests'
# elementwise limits (bf16 outputs 2**-7, the fp32 dx 1e-4, d gamma and
# d beta 1e-4 sqrt(rows)), and each output to a share of its own largest
# value: bf16 outputs 2**-7, fp32 ones 2**-14 (sums in another order).
TOL_LN_BF16 = 2.0 ** -7
TOL_LN_F32 = 2.0 ** -14


def ln_bwd_held(got, ref, rows: int) -> dict:
    import torch

    cmps = {}
    for name, g, r in zip(("dx", "dx bf16 copy", "d gamma", "d beta"), got, ref):
        if g is None:
            continue
        bf = g.dtype == torch.bfloat16
        cmps[name] = compare(g, r, TOL_LN_BF16 if bf else 1e-4 if name == "dx"
                             else 1e-4 * rows ** 0.5)
        cmps[name + ", of its largest"] = compare_scaled(g, r, TOL_LN_BF16 if bf else TOL_LN_F32)
    return cmps


def ln_library_backward(x32, dxn, gamma, partials: bool):
    """``native_layer_norm_backward`` over fp32 rows with the moments given:
    the library's LayerNorm backward, without the residual add, the moments
    and the bf16 copy."""
    import torch

    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mean).square().mean(-1, keepdim=True) + 1e-5)
    mask = [True, partials, partials]
    return lambda: torch.ops.aten.native_layer_norm_backward(
        dxn, x32, [x32.shape[-1]], mean, rstd, gamma, torch.zeros_like(gamma), mask)


def kernel_device_us(fn, keys) -> dict:
    """Device microseconds of one call of ``fn`` by kernel (``short_name``),
    for the kernels whose short names are in ``keys``."""
    kernels, _ = device_profile(fn)
    out = {}
    for name, us in kernels:
        key = short_name(name)
        if key in keys:
            out[key] = out.get(key, 0.0) + us
    return out


def ln_bwd_ptxas(build_log: str) -> dict:
    """``(x, dres, dx dtypes, partials, vector width, D's bucket)``: the
    registers and spill bytes that ``ptxas -v`` printed in this build for
    each instance of ``layernorm_bwd_rows_kernel`` (a mangled ``S1_`` is the
    bf16 named before it)."""
    import re

    out, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"layernorm_bwd_rows_kernelI((?:f|13__nv_bfloat16|S1_){3})"
                          r"Lb(\d)ELi(\d+)ELi(\d+)EE", line)
            entry = m and (*("float32" if t == "f" else "bfloat16" for t in re.findall(
                r"f|13__nv_bfloat16|S1_", m[1])), m[2] == "1", int(m[3]), int(m[4]))
            continue
        if not entry:
            continue
        rec = out.setdefault(entry, {})
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            rec["spill_stores"], rec["spill_loads"] = int(spill[1]), int(spill[2])
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            rec["registers"] = int(regs[1])
    return out


def layernorm_bwd_phase(runs: dict) -> tuple:
    """``layernorm_bwd_rows.cu`` by instance: LN2's and LN1's (K3, K4), K7's
    and P2's, at the train step's 102,400 rows of 768 on seeded inputs;
    ``runs`` maps each instance's run to its counted launches by instance
    and the launches its callers' counters imply (one LN2 and one LN1 a K3
    or K4 backward, one a K7 backward, one a P2 call), which the counts must
    equal. Each held against its plain version, the same bits on repeat,
    the planted faults caught, timed beside its byte bound and the library's
    backward, with its registers, spills, blocks per SM and waves; then
    ``layernorm_rows.cu`` on its two main-path inputs beside
    ``F.layer_norm``, and ``column_sum`` on the step's sums beside
    ``torch.sum``. Returns ``(rows, checks, summary)``."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    F = torch.nn.functional
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16, None: None}
    M, D = LN_BWD_ROWS, 768
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(50)
    ptxas = ln_bwd_ptxas(_build.build_log)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dtype)

    gamma = randn(D, scale=0.1, shift=1.0)
    rows, checks, summary = [], [], {}
    for name, xd, rd, od, copy, partials, replaces, run_name in LN_BWD_INSTANCES:
        x = randn(M, D, dtype=dt[xd], scale=3.0, shift=1.0)
        dxn = randn(M, D)
        dres = None if rd is None else randn(M, D, dtype=dt[rd])
        out = dt[od]

        def run(x=x, dxn=dxn, dres=dres, out=out, copy=copy, partials=partials):
            return k_block.layernorm_bwd_rows_cuda(x, dxn, dres, gamma, out, copy,
                                                   param_grads=partials)

        got, again = run(), run()
        ref = k_block.layernorm_bwd_rows_reference(x, dxn, dres, gamma, out, copy)
        if not partials:
            ref = ref[:2] + (None, None)
        torch.cuda.synchronize()
        held = ln_bwd_held(got, ref, M)
        same = all(torch.equal(g, a) for g, a in zip(got, again) if g is not None)
        faults = {}
        if out == torch.bfloat16:
            faulty = fault_dx_tail_zero(k_block.layernorm_bwd_rows_cuda)(
                x, dxn, dres, gamma, out, copy)
        else:  # the fp32 dx (LN2's dyh): its last rows unwritten
            faulty = tuple(t.clone() if t is not None else None for t in got)
            faulty[0][-PLANTED_FAULT_ROWS:] = 0
        faults["dx tail zero"] = not all(c["ok"] for c in ln_bwd_held(
            faulty[:2] + ((got[2], got[3]) if partials else (None, None)), ref, M).values())
        if partials:
            faulty = fault_ln_grad_tail(k_block.layernorm_bwd_rows_cuda)(
                x, dxn, dres, gamma, out, copy)
            faults["d gamma, d beta skip the tail"] = not all(
                c["ok"] for c in ln_bwd_held(faulty, ref, M).values())
        del got, again, faulty
        torch.cuda.empty_cache()

        ms = cuda_ms(run, 20)
        device_us = kernel_device_us(run, ("layernorm_bwd_rows", "column_sum"))
        plain_ms = cuda_ms(lambda: k_block.layernorm_bwd_rows_reference(
            x, dxn, dres, gamma, out, copy), 3, 1)
        library = ln_library_backward(x.float(), dxn, gamma, partials)
        lib_ms = cuda_ms(library, 20)
        in_bytes = x.numel() * x.element_size() + dxn.numel() * 4 + D * 4 + (
            0 if dres is None else dres.numel() * dres.element_size())
        out_bytes = M * D * (out.itemsize + (2 if copy else 0)) + (2 * D * 4 if partials else 0)
        b = bound(in_bytes + out_bytes, 0)
        kernel_ms = device_us.get("layernorm_bwd_rows", 0) / 1e3
        per_sm, smem = _build.blocks_per_sm(
            "fmm_layernorm_bwd_rows_blocks_per_sm", k_block.ln_bwd_variant(
                D, x.dtype, None if dres is None else dres.dtype, out, partials), False)
        blocks, stride = k_block.ln_bwd_plan(M, sms, per_sm)
        resources = dict(ptxas.get((xd, rd or "bfloat16", od, partials, 8, -(-D // 256)), {}),
                         smem_bytes=smem, blocks_per_sm=per_sm, blocks=blocks,
                         waves=blocks / (per_sm * sms), rows_per_warp=-(-M // stride))
        key = ln_instance_label(k_block.ln_bwd_instance(x, dres, out, copy, partials))
        counted, implied = runs[run_name]
        n = counted.get(key, 0)
        lib_call = ("torch.ops.aten.native_layer_norm_backward on fp32 x and dxn, mean and "
                    "rstd given (x converted outside the timing); leaves out the residual "
                    "add, the moments and the bf16 copy")
        worst = max(held.values(), key=lambda c: c["max_err_over_tol"])
        print(f"layernorm_bwd_rows {name} [{key}]: {ms:.4f} ms (kernel {kernel_ms:.4f} ms, "
              f"column_sum {device_us.get('column_sum', 0) / 1e3:.4f} ms), bound "
              f"{b[0]:.4f} ms (bytes), share {b[0] / kernel_ms if kernel_ms else 0:.3f} of the "
              f"kernel, library {lib_ms:.4f} ms, plain {plain_ms:.3f} ms, {n} launches a "
              f"{run_name} ({implied} implied by its callers); {json.dumps(resources)}; vs "
              f"plain {json.dumps(brief(held))}, same bits {same}, faults caught "
              f"{json.dumps(faults)}")
        label = f"layernorm_bwd_rows {name}"
        checks += [(f"{label} {k} vs plain", c) for k, c in held.items()]
        checks += [(f"{label} same bits on repeat", {"ok": same}),
                   (f"{label} launched in the {run_name} once a caller's backward",
                    {"ok": n > 0 and n == implied, "launches": n, "implied": implied}),
                   (f"{label} resources read from this build",
                    {"ok": "registers" in resources})]
        checks += [(f"{label} planted fault ({k}) caught", {"ok": v}) for k, v in faults.items()]
        rows.append({
            "name": label, "route": "cuda",
            "source": "federated_multi_modal_tpu_torch/csrc/layernorm_bwd_rows.cu",
            "replaces": replaces, "instance": key, "shape": [M, D],
            "launches": n, "launches_in": run_name,
            "max_abs_err": worst["max_abs_err"], "max_err_over_tol": worst["max_err_over_tol"],
            "ms": ms, "kernel_ms": kernel_ms,
            "column_sum_ms": device_us.get("column_sum", 0) / 1e3, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1],
            "share_of_bound": b[0] / kernel_ms if kernel_ms else 0.0,
            "library_ms": lib_ms, "library_call": lib_call, "resources": resources,
        })
        summary[name] = {"ms": ms, "kernel_ms": kernel_ms, "bound_ms": b[0],
                         "library_ms": lib_ms, "launches": n, "resources": resources}
        del x, dxn, dres, ref, library
        torch.cuda.empty_cache()

    # layernorm_rows.cu on its main-path inputs (LN1's bf16 x, LN2's fp32 y)
    beta = randn(D, scale=0.1)
    for name, xd in (("bf16 in (LN1)", torch.bfloat16), ("fp32 in (LN2)", torch.float32)):
        x = randn(M, D, dtype=xd, scale=3.0, shift=1.0)
        got = k_block.layernorm_rows_cuda(x, gamma, beta, torch.bfloat16)
        held = compare(got, k_block.layernorm_rows_reference(x, gamma, beta, torch.bfloat16),
                       TOL_LN_BF16)
        ms = cuda_ms(lambda: k_block.layernorm_rows_cuda(x, gamma, beta, torch.bfloat16), 20)
        plain_ms = cuda_ms(lambda: k_block.layernorm_rows_reference(
            x, gamma, beta, torch.bfloat16), 3, 1)
        try:
            F.layer_norm(x[:8], (D,), gamma, beta)
            lg, lb, lib_call = gamma, beta, "F.layer_norm (fp32 gamma and beta)"
        except RuntimeError:
            lg, lb, lib_call = gamma.to(xd), beta.to(xd), "F.layer_norm (gamma, beta in x's dtype)"
        lib_ms = cuda_ms(lambda: F.layer_norm(x, (D,), lg, lb), 20)
        lib_call += f", writes {str(xd).replace('torch.', '')}"
        b = bound(x.numel() * x.element_size() + M * D * 2 + 2 * D * 4, 0)
        print(f"layernorm_rows {name}: {ms:.4f} ms, bound {b[0]:.4f} ms, share "
              f"{b[0] / ms:.3f}, {lib_call} {lib_ms:.4f} ms, plain {plain_ms:.3f} ms; vs plain "
              f"{json.dumps(brief({'': held}))[5:-1]}")
        checks.append((f"layernorm_rows {name} vs plain", held))
        summary[f"layernorm_rows {name}"] = {
            "ms": ms, "bound_ms": b[0], "share_of_bound": b[0] / ms, "library_ms": lib_ms,
            "library_call": lib_call, "plain_ms": plain_ms, "max_abs_err": held["max_abs_err"]}
        del x, got
        torch.cuda.empty_cache()

    # column_sum on the step's sums: the LayerNorm partials, a bias gradient
    # (K4's db_fc over the bf16 dh) and a split weight gradient's partials
    splits = k_block.tn_split_plan(768, 2304, M, sms)[0]
    ln_blocks = k_block.ln_bwd_plan(M, sms, k_block.ln_bwd_blocks_per_sm(k_block.ln_bwd_variant(
        D, torch.bfloat16, torch.float32, torch.bfloat16, True)))[0]
    for name, shape, xd in (("LayerNorm partials", (ln_blocks, 2 * D), torch.float32),
                            ("db_fc over dh", (M, 3072), torch.bfloat16),
                            ("dw_qkv partials", (splits, 768 * 2304), torch.float32)):
        x = randn(*shape, dtype=xd)
        got = k_block.column_sum_cuda(x)
        held = compare(got, k_block.column_sum_reference(x), 1e-5 * shape[0] ** 0.5)
        ms = cuda_ms(lambda: k_block.column_sum_cuda(x), 20)
        lib_ms = cuda_ms(lambda: torch.sum(x, 0, dtype=torch.float32), 20)
        b = bound(x.numel() * x.element_size() + shape[1] * 4, 0)
        print(f"column_sum {name} {list(shape)}: {ms:.4f} ms, bound {b[0]:.4f} ms, share "
              f"{b[0] / ms:.3f}, torch.sum {lib_ms:.4f} ms; vs plain "
              f"{json.dumps(brief({'': held}))[5:-1]}")
        checks.append((f"column_sum {name} vs plain", held))
        summary[f"column_sum {name}"] = {"shape": list(shape), "ms": ms, "bound_ms": b[0],
                                         "library_ms": lib_ms}
        del x, got
        torch.cuda.empty_cache()
    return rows, checks, summary


def fault_rows_dropped(fn):
    """A kernel leaves the last rows of its output unwritten (zero)."""
    def faulty(*args, **kwargs):
        out = fn(*args, **kwargs)
        out.view(-1, out.shape[-1])[-PLANTED_FAULT_ROWS:] = 0
        return out
    return faulty


def fault_gemm_input(gemm, D: int, which: str):
    """P2's GEMM given a d(QKV) with head 0's q, k and v columns zeroed
    (``"head0"``: the attention stage left them unwritten) or its last 64
    columns zeroed (``"ktile"``: the wgmma ring dropped its last K tile)."""
    def faulty(a, w):
        a = a.clone()
        if which == "head0":
            for part in range(3):
                a[:, part * D:part * D + 64] = 0
        else:
            a[:, -64:] = 0
        return gemm(a, w)
    return faulty


def swap_head0_qk(t, D: int):
    """``t`` with head 0's q and k columns (the last axis of a packed QKV
    tensor, or of ``w_qkv`` and ``b_qkv``; heads of 64) swapped."""
    t = t.clone()
    q = t[..., :64].clone()
    t[..., :64] = t[..., D:D + 64]
    t[..., D:D + 64] = q
    return t


def prototype_phase(lnp, w, b, device) -> tuple:
    """P1, P2 and P3 on the microbench's shapes (x and dy ``(BATCH, 200,
    768)``, qkv ``(BATCH, 200, 2304)``) with ViT-B/16 block 0's ``ln_1``,
    ``w_qkv`` and ``b_qkv``: each against its plain version (P2 with the
    microbench's own cotangent, the squared loss's ``dy = y``, and a seeded
    unit-scale one; P1 also with seeded biases and LayerNorm affines; P3 at
    ``tpad`` 8 and 16), a planted fault per limit, P1 against K7's forward
    and P3 against K2 printed, the microbench driven once (``attn`` with
    every variant, ``block --only attn_path,attn_fusedp,attn_fused,block``)
    with the counts set to 0 just before and read just after, and the
    timings. Returns ``(rows, checks, summary)``."""
    import argparse

    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.kernels import prototypes as k_proto
    from federated_multi_modal_tpu_torch.tools import attn_microbench as bench

    F = torch.nn.functional
    B, T, D = BATCH, MICROBENCH_T, w.shape[0]
    n = D // 64
    gen = torch.Generator(device=device).manual_seed(40)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)

    x, dy_unit, qkv = randn(B, T, D), randn(B, T, D), randn(B, T, 3 * D)

    # -- the microbench, driven once through its entry points -----------------
    plain_calls = []

    def plain_recorder(fn):
        def rec(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return rec

    iters = MICROBENCH_ITERS
    common = dict(batch=B, t=T, d=D, heads=n, n_cls=N_CLASSES, iters=iters, dtype="bf16",
                  fwd_only=False, no_captions=False, attention="pallas", platform="default")
    plain_names = ("fused_lnqkv_attention_reference", "fused_lnqkv_attention_bwd_dx_reference",
                   "packed4d_attention_reference")
    t0 = time.perf_counter()
    with patched(k_proto, **{nm: plain_recorder(getattr(k_proto, nm)) for nm in plain_names}):
        reset_counts()
        failed = bench.run_attn(argparse.Namespace(**common, variants="", only=""), device)
        failed += bench.run_block(argparse.Namespace(
            **common, mode="block", variants="", only="attn_path,attn_fusedp,attn_fused,block"),
            device)
        torch.cuda.synchronize()
        counts = read_counts()
    drive_s = time.perf_counter() - t0
    print("launches, one drive of the microbench:", json.dumps(counts))
    # every line runs a warm-up and a timed chain of `iters` iterations:
    # P3 in packed4d and packed4d_par; P1 in the attn_fused check, attn_fusedp
    # and attn_fused (forward, and forward + backward), P2 in the latter
    check_counts(counts, {
        "P3 packed4d_attention": 4 * iters, "fmm_attention_pair": 4 * iters,
        "P1 fused_lnqkv_attention": 6 * iters + 1, "fmm_lnqkv_attention": 6 * iters + 1,
        "P2 fused_lnqkv_attention_bwd_dx": 2 * iters,
        "fmm_lnqkv_attention_bwd_dqkv": 2 * iters, "fmm_gemm_nt_f32": 2 * iters},
        "microbench drive")
    checks = [("microbench drive, no FAILED line", {"ok": not failed, "failed": failed}),
              ("microbench drive, no plain version", {"ok": not plain_calls,
                                                      "calls": plain_calls})]

    # -- each prototype against its plain version -----------------------------
    def p1_check(x, lnp, w, b, tol=TOL_TRAIN_ACT):
        return compare(k_proto.fused_lnqkv_attention(x, lnp, w, b, n),
                       k_proto.fused_lnqkv_attention_reference(x, lnp, w, b, n), tol)

    def p2_check(dy, tol=TOL_TRAIN_DX):
        return compare_scaled(k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy, n),
                              k_proto.fused_lnqkv_attention_bwd_dx_reference(
                                  x, lnp, w, b, dy, n), tol)

    def p3_check(tpad, qkv=qkv, heads=n):
        return compare(k_proto.packed4d_attention(qkv, heads, tpad),
                       k_proto.packed4d_attention_reference(qkv, heads, tpad), TOL_K1)

    # q > 0 > k: every real key scores far below zero, so the padded keys'
    # zero scores would take the softmax if their mask were dropped
    qkv_neg = qkv.clone()
    qkv_neg[..., :D] = qkv[..., :D].abs() + 1
    qkv_neg[..., D:2 * D] = -(qkv[..., D:2 * D].abs() + 1)

    y = k_proto.fused_lnqkv_attention(x, lnp, w, b, n)
    seeded = seeded_block({"ln_1": lnp, "attn": {"w_qkv": w, "b_qkv": b}}, seed=41)
    s_args = (seeded["ln_1"], seeded["attn"]["w_qkv"], seeded["attn"]["b_qkv"])
    cmps = {"P1": p1_check(x, lnp, w, b), "P1 seeded": p1_check(x, *s_args, TOL_TRAIN_SEEDED),
            "P2 dx, the microbench's cotangent": p2_check(y),
            "P2 dx, seeded unit cotangent": p2_check(dy_unit),
            "P3 tpad 8": p3_check(8), "P3 tpad 16": p3_check(16),
            "P3 tpad 16, negative scores": p3_check(16, qkv_neg),
            "P3 heads of 32": p3_check(8, heads=D // 32),
            "P3 heads of 128": p3_check(8, heads=D // 128)}
    dx_again = k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy_unit, n)
    cmps["P2 repeats bit for bit"] = {"ok": bool(torch.equal(
        dx_again, k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy_unit, n)))}
    for name, c in cmps.items():
        print(f"{name} vs plain:", json.dumps(c))
    checks += [(k, c) for k, c in cmps.items()]

    swapped = {"P1 seeded": (swap_head0_qk(s_args[1], D), swap_head0_qk(s_args[2], D))}
    with patched(k_proto, fused_lnqkv_attention_cuda=fault_rows_dropped(
            k_proto.fused_lnqkv_attention_cuda)):
        faults = {"P1, last rows dropped": p1_check(x, lnp, w, b)}
    ref_s = k_proto.fused_lnqkv_attention_reference(x, *s_args, n)
    faults["P1 seeded, head 0's q and k swapped"] = compare(
        k_proto.fused_lnqkv_attention(x, s_args[0], *swapped["P1 seeded"], n), ref_s,
        TOL_TRAIN_SEEDED)
    with patched(k_proto, fused_lnqkv_attention_bwd_dx_cuda=fault_rows_dropped(
            k_proto.fused_lnqkv_attention_bwd_dx_cuda)):
        faults["P2 dx (microbench cotangent), last rows dropped"] = p2_check(y)
        faults["P2 dx (unit cotangent), last rows dropped"] = p2_check(dy_unit)
    # one per new stage: the attention stage leaves head 0's d(QKV) zero; the
    # GEMM's ring drops its last 64-deep K tile (v's last head)
    with patched(k_proto, gemm_nt_f32_cuda=fault_gemm_input(k_proto.gemm_nt_f32_cuda, D, "head0")):
        faults["P2 dx (unit cotangent), head 0's d(QKV) zeroed"] = p2_check(dy_unit)
    with patched(k_proto, gemm_nt_f32_cuda=fault_gemm_input(k_proto.gemm_nt_f32_cuda, D, "ktile")):
        faults["P2 dx (unit cotangent), the GEMM's last K tile dropped"] = p2_check(dy_unit)
    qkv_swapped = swap_head0_qk(qkv, D)
    faults["P3 tpad 8, head 0's q and k swapped"] = compare(
        k_proto.packed4d_attention(qkv_swapped, n, 8),
        k_proto.packed4d_attention_reference(qkv, n, 8), TOL_K1)
    faults["P3 tpad 16 (negative scores), key mask dropped"] = compare(
        k_proto.packed4d_attention_cuda(qkv_neg, n, valid_T=-(-T // 16) * 16),
        k_proto.packed4d_attention_reference(qkv_neg, n, 16), TOL_K1)
    print("P1-P3 planted faults, [max |err|, err/tol]:", json.dumps(brief(faults)))
    checks += [(f"{k} planted fault caught", {"ok": not c["ok"]}) for k, c in faults.items()]
    del ref_s, qkv_swapped, qkv_neg, dx_again

    # printed, not checked: the rounding points differ
    vs = {"P1 vs K7 forward": compare(y, k_block.fused_ln_attention(x, lnp, w, b, n),
                                      TOL_TRAIN_ACT),
          "P3 vs K2": compare(k_proto.packed4d_attention(qkv, n),
                              k_attn.packed_attention(qkv, n), TOL_K1)}
    print("P1 vs K7's forward, P3 vs K2 (printed, not checked), [max |err|, err/tol]:",
          json.dumps(brief(vs)))

    # -- timings, yardsticks and bounds ---------------------------------------
    bf = torch.bfloat16
    w_t, b_t = w.to(bf).T.contiguous(), b.to(bf)
    g_lib, be_lib = lnp["scale"].to(bf), lnp["bias"].to(bf)

    def library_fwd(xr):
        xn = F.layer_norm(xr, (D,), g_lib, be_lib, 1e-5)
        q, k, v = F.linear(xn, w_t, b_t).view(B, T, 3, n, 64).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(B, T, D)

    def library_fwd_bwd():
        xr = x.detach().requires_grad_(True)
        torch.autograd.grad(library_fwd(xr), xr, dy_unit)

    # P2's stages apart: its GEMM at P2's shape on seeded operands against its
    # plain version (fp32 sums in another order, 2**-14 of the largest value)
    # and timed beside torch.matmul's bf16 product; the LayerNorm backward
    # without parameter gradients timed
    from federated_multi_modal_tpu_torch.ops.kernels import gemm as k_gemm

    M = B * T
    a_g, w_g = randn(M, 3 * D), w.to(torch.bfloat16).contiguous()
    cmps["P2's GEMM (wgmma) vs plain"] = compare_scaled(
        k_gemm.gemm_nt_f32_cuda(a_g, w_g), k_gemm.gemm_nt_f32_reference(a_g, w_g), 2.0 ** -14)
    cmps["P2's GEMM repeats bit for bit"] = {"ok": bool(torch.equal(
        k_gemm.gemm_nt_f32_cuda(a_g, w_g), k_gemm.gemm_nt_f32_cuda(a_g, w_g)))}
    print("P2's GEMM vs plain:", json.dumps(cmps["P2's GEMM (wgmma) vs plain"]))
    checks += [(k, cmps[k])
               for k in ("P2's GEMM (wgmma) vs plain", "P2's GEMM repeats bit for bit")]
    dxn_g = k_gemm.gemm_nt_f32_cuda(a_g, w_g)
    gamma_f = lnp["scale"].float().contiguous()
    stage_ms = {
        "gemm_epilogue NT dxn = d(QKV) . W^T": cuda_ms(lambda: k_gemm.gemm_nt_f32_cuda(a_g, w_g), 10),
        "torch.matmul, bf16 out": cuda_ms(lambda: torch.matmul(a_g, w_g.T), 10),
        "layernorm_bwd_rows, no parameter gradients": cuda_ms(
            lambda: k_block.layernorm_bwd_rows_cuda(x.view(M, D), dxn_g, None, gamma_f,
                                                    torch.bfloat16, param_grads=False), 10)}
    del a_g, dxn_g
    qh, kh, vh = (t.reshape(B, T, n, 64).transpose(1, 2) for t in qkv.split(D, dim=-1))
    with torch.no_grad():
        lib_p1 = cuda_ms(lambda: library_fwd(x), 10)
    lib_p2 = cuda_ms(library_fwd_bwd, 10) - lib_p1
    times = {
        "P1": (cuda_ms(lambda: k_proto.fused_lnqkv_attention(x, lnp, w, b, n), 10),
               cuda_ms(lambda: k_proto.fused_lnqkv_attention_reference(x, lnp, w, b, n), 3, 1),
               lib_p1),
        "P2": (cuda_ms(lambda: k_proto.fused_lnqkv_attention_bwd_dx(x, lnp, w, b, dy_unit, n), 5),
               cuda_ms(lambda: k_proto.fused_lnqkv_attention_bwd_dx_reference(
                   x, lnp, w, b, dy_unit, n), 3, 1), lib_p2),
        "P3": (cuda_ms(lambda: k_proto.packed4d_attention(qkv, n), 20),
               cuda_ms(lambda: k_proto.packed4d_attention_reference(qkv, n), 5, 1),
               cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 20)),
    }
    stage_ms["P2 whole"] = times["P2"][0]
    stage_ms["attention stage (whole less GEMM and LayerNorm backward)"] = (
        times["P2"][0] - stage_ms["gemm_epilogue NT dxn = d(QKV) . W^T"]
        - stage_ms["layernorm_bwd_rows, no parameter gradients"])
    print("P2 by stage, ms:", json.dumps(stage_ms))
    p3_width_ms = {str(hd): cuda_ms(lambda hd=hd: k_proto.packed4d_attention(qkv, D // hd), 20)
                   for hd in (32, 128)}
    p3_width_ms["64"] = times["P3"][0]
    print("P3 by head width, ms:", json.dumps(p3_width_ms))
    M = B * T
    attn_fwd = 4 * B * D * T * T
    qkv_flops = 2 * M * D * 3 * D
    params_bytes = 3 * D * D * 2 + 3 * D * 2 + 2 * D * 4
    bounds = {"P1": bound(2 * M * D * 2 + params_bytes, qkv_flops + attn_fwd),
              "P2": bound(3 * M * D * 2 + params_bytes, qkv_flops + 2 * attn_fwd),
              "P3": bound(M * 3 * D * 2 + M * D * 2, attn_fwd)}
    meta = {
        "P1": ("fused_lnqkv_attention", "lnqkv_attention.cu", ":110",
               "fused_lnqkv_attention", "P1 fused_lnqkv_attention", [[B, T, D], n],
               "F.layer_norm + F.linear + scaled_dot_product_attention, forward",
               cmps["P1"]),
        "P2": ("fused_lnqkv_attention_bwd_dx", "lnqkv_attention_bwd_dx.cu", ":207",
               "fused_lnqkv_attention_bwd_dx", "P2 fused_lnqkv_attention_bwd_dx",
               [[B, T, D], n], "the same, forward + backward (dx) minus forward",
               cmps["P2 dx, the microbench's cotangent"]),
        "P3": ("packed4d_attention", "attention_pair.cu", ":351", "_build_packed4d",
               "P3 packed4d_attention", [[B, T, 3 * D], n],
               "torch.nn.functional.scaled_dot_product_attention", cmps["P3 tpad 8"]),
    }
    extra = {
        "P2": {"sources": [f"federated_multi_modal_tpu_torch/csrc/{f}" for f in (
            "lnqkv_attention_bwd_dx.cu", "ln_qkv.cuh", "attn_bwd.cuh", "gemm_epilogue.cu",
            "wgmma.cuh", "layernorm_bwd_rows.cu")], "ms_by_stage": stage_ms},
        "P3": {"key_tiles": {str(hd): k_proto.packed4d_attention_key_tiles(hd, T)
                             for hd in (32, 64, 128)},
               "head_width_shapes": [[[B, T, 3 * D], D // hd] for hd in (32, 128)],
               "ms_by_head_width": p3_width_ms},
    }
    rows = []
    for key, (name, src, line, tpu_fn, counter, shape, lib_call, cmp) in meta.items():
        ms, plain_ms, lib_ms = times[key]
        rows.append({**extra.get(key, {}),
            "name": name, "route": "cuda",
            "source": f"federated_multi_modal_tpu_torch/csrc/{src}",
            "replaces": f"tools/attn_microbench.py{line}", "tpu_function": tpu_fn,
            "shape": shape, "launches": counts[counter],
            "launches_note": f"per drive of the microbench at iters={iters}; none on any "
                             "program's path",
            "max_abs_err": cmp["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": lib_ms,
            "library_call": lib_call})
        print(f"{name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bound "
              f"{bounds[key][0]:.4f} ms ({bounds[key][1]})")
    summary = {"microbench_drive_s": drive_s, "launches": counts,
               "p1_vs_k7": vs["P1 vs K7 forward"]["max_abs_err"],
               "p3_vs_k2": vs["P3 vs K2"]["max_abs_err"]}
    return rows, checks, summary


# -- the port's training command line (the cli phase) ------------------------

CLI_MAPLE_YAML = "configs/trainers/MaPLe/vit_b16_c2_ep5_batch4_2ctx.yaml"
CLI_COOP_YAML = "configs/trainers/CoOp/vit_b16.yaml"
CLI_DATASET_YAML = "configs/datasets/synthetic.yaml"
CLI_EPOCHS = 2
# CoOp's configuration trains at batch 32, more than Synthetic's 16 training
# images, and the loader drops the short batch: the phase trains it at 4
CLI_COOP_OPTS = ["OPTIM.MAX_EPOCH", "1", "DATALOADER.TRAIN_X.BATCH_SIZE", "4"]
CLI_PATH_KERNELS = ("K1 packed_attention_masked", "K1b packed_attention_masked_bwd",
                    "K3 fused_block_train", "K4 fused_block_train_dw",
                    "K5 fused_block_residual")


def kernel_counts() -> dict:
    """Each wrapper's launches (and backward launches) so far, by label."""
    counts = {}
    for name, fn in kernel_counters().items():
        counts[name] = fn.launches
        if hasattr(fn, "backward_launches"):
            counts[name + " (backward)"] = fn.backward_launches
    return counts


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def cli_implied(arch, trainer: str, n_test_batches: int) -> tuple:
    """``(per train step, per test(), at build)``: the launches the routing
    implies under the default gates. Each text block launches K1 forward
    and, where the prompts train, K1b backward; MaPLe's frozen vision
    blocks K3 and its last one K4 (forward and backward); VPT's and IVLP's
    vision blocks, all frozen, K3 forward and backward; CoOp's and CoCoOp's
    frozen image tower K5 per block. ``test()`` runs the prompt cache's text
    once (K1 per block; zero-shot CLIP's and VPT's fixed text features are
    made at build) and K5 per block and test batch; CoCoOp, whose text
    depends on the image, runs K1 per block and test batch. A ModifiedResNet
    image tower (cuDNN's convolutions and plain PyTorch) launches no kernel
    of the port."""
    n_text = arch.transformer_layers
    n_vis = arch.vision_layers if arch.is_vit else 0
    zero = {label: 0 for label in kernel_counts()}
    text_train = {"K1 packed_attention_masked": n_text,
                  "K1b packed_attention_masked_bwd": n_text}
    frozen_vision = {"K3 fused_block_train": n_vis, "K3 fused_block_train (backward)": n_vis}
    if trainer == "MaPLe":
        step = dict(zero, **text_train, **{
            "K3 fused_block_train": n_vis - 1, "K3 fused_block_train (backward)": n_vis - 1,
            "K4 fused_block_train_dw": 1, "K4 fused_block_train_dw (backward)": 1})
    elif trainer == "VPT":
        step = dict(zero, **frozen_vision)
    elif trainer == "IVLP":
        step = dict(zero, **text_train, **frozen_vision)
    else:
        step = dict(zero, **text_train, **{"K5 fused_block_residual": n_vis})
    fixed_text = trainer.startswith("ZeroshotCLIP") or trainer == "VPT"
    text_per_test = 0 if fixed_text else n_text
    if trainer == "CoCoOp":
        text_per_test = n_text * n_test_batches
    test = dict(zero, **{"K1 packed_attention_masked": text_per_test,
                         "K5 fused_block_residual": n_vis * n_test_batches})
    build = dict(zero, **{"K1 packed_attention_masked": n_text if fixed_text else 0})
    return step, test, build


@contextlib.contextmanager
def cli_instrumented(record: dict):
    """The port's trainer with each train step and each ``test()``
    synchronised and timed on the host clock and its launches read before
    and after (``record["steps"]``: ms, launches, the step's loss;
    ``record["tests"]``: ms, launches, accuracy), ``save_model`` timed, and
    the module globals a trainer sets and ``sys.stdout`` (``main`` tees it
    into ``log.txt``) put back afterwards."""
    import torch

    from federated_multi_modal_tpu_torch.engine import trainer as eng
    from federated_multi_modal_tpu_torch.models import clip_model
    from federated_multi_modal_tpu_torch.ops import primitives

    def timed(fn, key, read):
        def run(self, *args, **kwargs):
            torch.cuda.synchronize()
            before = kernel_counts()
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            torch.cuda.synchronize()
            after = kernel_counts()
            entry = {"ms": (time.perf_counter() - t0) * 1e3,
                     "launches": {k: after[k] - before[k] for k in after},
                     "client": getattr(self, "client_id", None)}
            entry.update(read(self, out))
            record.setdefault(key, []).append(entry)
            return out
        return run

    def step_loss(self, out):
        pending = self._pending_summaries
        return {"loss": float(pending[-1][0]) if pending else out["loss"]}

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(primitives, _ATTENTION_IMPL=primitives._ATTENTION_IMPL))
        stack.enter_context(patched(clip_model, _TEXT_PACK_DEFAULT=clip_model._TEXT_PACK_DEFAULT))
        stack.enter_context(patched(sys, stdout=sys.stdout))
        stack.enter_context(patched(eng.FunctionalTrainerMixin, train_step=timed(
            eng.FunctionalTrainerMixin.train_step, "steps", step_loss)))
        stack.enter_context(patched(
            eng.TrainerBase,
            test=timed(eng.TrainerBase.test, "tests",
                       lambda self, out: {"accuracy": out["accuracy"]}),
            save_model=timed(eng.TrainerBase.save_model, "saves", lambda self, out: {})))
        yield


def cli_run(argv: list, label: str) -> dict:
    """The port's command line's ``main`` on ``argv`` (parsed by its own
    parser) in this process, every count set to 0 just before and read just
    after: the counts, the trainer and its per-step and per-test records."""
    import torch

    from federated_multi_modal_tpu_torch import train as port_cli

    args = port_cli.build_parser().parse_args(argv)
    record = {"steps": [], "tests": [], "saves": []}
    reset_counts()
    t0 = time.perf_counter()
    with cli_instrumented(record):
        record["trainer"] = port_cli.main(args)
    torch.cuda.synchronize()
    record["wall_s"] = time.perf_counter() - t0
    record["counts"] = kernel_counts()
    print(f"cli {label}: launches {json.dumps(nonzero(record['counts']))}, "
          f"{len(record['steps'])} steps, {len(record['tests'])} test(), "
          f"main {record['wall_s']:.1f} s")
    return record


def cli_argv(trainer: str, config_file: str, out_dir: str, root: str, opts: list,
             extra: tuple = ()) -> list:
    argv = ["--root", root, "--seed", "1", "--trainer", trainer,
            "--dataset-config-file", CLI_DATASET_YAML, "--output-dir", out_dir, *extra]
    if config_file:
        argv += ["--config-file", config_file]
    return argv + list(opts)


def hold_launches(record: dict, implied: tuple, what: str) -> dict:
    """Each train step's and each ``test()``'s launches equal to the
    routing's, and the whole run's to their sum plus the build's."""
    step, test, build = implied
    wrong = []
    for kind, expected in (("steps", step), ("tests", test)):
        for i, entry in enumerate(record[kind]):
            bad = {k: (entry["launches"][k], v) for k, v in expected.items()
                   if entry["launches"][k] != v}
            if bad:
                wrong.append([f"{kind}[{i}]", bad])
    total = {k: step[k] * len(record["steps"]) + test[k] * len(record["tests"]) + build[k]
             for k in step}
    bad = {k: (record["counts"][k], v) for k, v in total.items() if record["counts"][k] != v}
    if bad:
        wrong.append(["run", bad])
    print(f"  {what}: launches per train step {json.dumps(nonzero(step))}, per test() "
          f"{json.dumps(nonzero(test))}, at build {json.dumps(nonzero(build))}: "
          f"{'as the routing implies' if not wrong else json.dumps(wrong)}")
    return {"ok": not wrong, "wrong": wrong, "implied_run": nonzero(total)}


# the last BatchNorm of each residual branch scaled down, as a trained
# tower's are (the branches small beside the identity paths); at full scale
# the random tower with calibrated statistics is chaotic: bf16 rounding
# alone moves RN50's features about as far as other images do
RN_RESIDUAL_GAIN = 0.2


def calibrate_batchnorms(visual, arch, seed: int = 0, images: int = 8) -> None:
    """Give a ModifiedResNet tree's frozen BatchNorms (fp32, in place) what
    a trained tower has: seeded affines (scale 1 + 0.1 N(0, 1), times
    ``RN_RESIDUAL_GAIN`` for each branch's ``bn3``; bias 0.1 N(0, 1)) and
    the statistics of their inputs, each taken in one fp32 forward of
    ``images`` seeded images on the tree's device after the BNs before it
    are set. A random init's unit BNs do not normalise: the activations grow
    block by block (RN50's features reach norms of ~1e4) and the features
    hardly depend on the images."""
    import torch

    from federated_multi_modal_tpu_torch.models import resnet

    gen = torch.Generator().manual_seed(seed)

    def seed_affine(p, gain=1.0):
        c = p["scale"].shape[0]
        with torch.no_grad():
            p["scale"].copy_((1.0 + 0.1 * torch.randn(c, generator=gen)) * gain)
            p["bias"].copy_(0.1 * torch.randn(c, generator=gen))

    for i in (1, 2, 3):
        seed_affine(visual["stem"][f"bn{i}"])
    for blocks in visual["layers"]:
        for blk in blocks:
            seed_affine(blk["bn1"])
            seed_affine(blk["bn2"])
            seed_affine(blk["bn3"], RN_RESIDUAL_GAIN)
            if "downsample" in blk:
                seed_affine(blk["downsample"]["bn"])

    real_bn = resnet.bn

    def calibrating_bn(x, p, relu=False):
        with torch.no_grad():
            flat = x.float().reshape(-1, x.shape[-1])
            p["mean"].copy_(flat.mean(0))
            p["var"].copy_(flat.var(0, unbiased=False))
        return real_bn(x, p, relu)

    res = arch.image_resolution
    x = torch.randn((images, res, res, 3), generator=gen).to(visual["stem"]["conv1"]["w"].device)
    with torch.no_grad(), patched(resnet, bn=calibrating_bn):
        resnet.encode_image_resnet(visual, arch.resnet_config(), x)


def write_openai_state_dict(path: str, seed: int = 0, backbone: str = "ViT-B/16") -> float:
    """A seeded CLIP of the catalog's ``backbone`` in OpenAI's state-dict
    layout, fp16 as OpenAI ships it, written with ``torch.save``; a
    ModifiedResNet's BatchNorms calibrated first (:func:`calibrate_batchnorms`,
    on the card). Returns the seconds it took."""
    import torch

    from federated_multi_modal_tpu_torch.engine.tree import to_device
    from federated_multi_modal_tpu_torch.models import params

    t0 = time.perf_counter()
    arch = params.BACKBONE_CONFIGS[backbone]
    tree = params.init_clip_params(arch, torch.Generator().manual_seed(seed), dtype_policy=False)
    if not arch.is_vit:
        tree["visual"] = to_device(tree["visual"], "cuda")
        calibrate_batchnorms(tree["visual"], arch, seed)
    torch.save(params.export_openai_state_dict(tree, arch, torch.float16), path)
    return time.perf_counter() - t0


def maple_timings(run: dict, out: str) -> dict:
    """The numbers of a MaPLe run through ``main``: step ms (synchronised,
    median over the steps after the first), epoch s, the share of each
    epoch the host waited on the loader, ``test()`` ms, checkpoint save
    and load ms, per-epoch mean losses, the final accuracy."""
    trainer = run["trainer"]
    steps_ms = [s["ms"] for s in run["steps"]]
    epochs = trainer.epoch_stats
    return {
        "batch": trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE,
        "steps_per_epoch": [e["steps"] for e in epochs],
        "step_ms_median": statistics.median(steps_ms[1:]),
        "step_ms_first": steps_ms[0], "step_ms_all": steps_ms,
        "epoch_s": [e["epoch_s"] for e in epochs],
        "loader_wait_share": [e["loader_wait_s"] / e["epoch_s"] for e in epochs],
        "epoch_mean_losses": [e["mean_loss"] for e in epochs],
        "first_loss": run["steps"][0]["loss"],
        "test_ms": [t["ms"] for t in run["tests"]],
        "final_accuracy": run["tests"][-1]["accuracy"],
        "checkpoint_save_ms": [s["ms"] for s in run["saves"]],
        "checkpoint_load_ms": wall_ms(lambda: trainer.load_model(out, epoch=CLI_EPOCHS), 1),
        "main_s": run["wall_s"],
    }


def cli_phase(card: str) -> tuple:
    """The port's command line (``python -m federated_multi_modal_tpu_torch.
    train``) at ViT-B/16 on the Synthetic dataset, from a seeded OpenAI-format
    state dict (``MODEL.BACKBONE.WEIGHTS_PATH``):

    * MaPLe (``CLI_MAPLE_YAML``, ``OPTIM.MAX_EPOCH 2``: the constant warmup,
      then cosine; the final ``test()``; the checkpoint of epoch 2) through
      ``main`` in this process, each step's and each ``test()``'s launches
      held against the routing, and its times;
    * the same run under ``TPU.ATTENTION_IMPL xla`` (no kernel launched),
      its first loss within ``TOL_STEP_LOSS`` of the kernel run's;
    * ``--eval-only --model-dir --load-epoch 2`` through the command line as
      a subprocess, its accuracy that of the final ``test()``;
    * CoOp (one epoch) and ZeroshotCLIP (``--eval-only``) through ``main``,
      their launches held the same way.

    Returns ``(launches by kernel label over the kernel runs, checks,
    summary)``."""
    import re
    import tempfile

    import torch

    checks, summary, launches = [], {"card": card}, {}
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="fmm_cli_") as tmp:
        sd_path = os.path.join(tmp, "vit_b16_openai_fp16.pt")
        summary["state_dict_write_s"] = write_openai_state_dict(sd_path)
        root = os.path.join(tmp, "data")
        weights = ["MODEL.BACKBONE.WEIGHTS_PATH", sd_path]
        maple_opts = ["OPTIM.MAX_EPOCH", str(CLI_EPOCHS)] + weights

        def add(counts):
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v

        # -- MaPLe through main, on the kernel routes ---------------------------
        out = os.path.join(tmp, "maple")
        run = cli_run(cli_argv("MaPLe", CLI_MAPLE_YAML, out, root, maple_opts), "MaPLe")
        trainer = run["trainer"]
        n_test = len(trainer.test_loader)
        decoder = ("native codec" if getattr(trainer.test_loader.transform, "native", False)
                   else "PIL (the native codec did not build: "
                   + (native_build_error() or "disabled") + ")")
        held = hold_launches(run, cli_implied(trainer.arch, "MaPLe", n_test), "MaPLe")
        maple = dict(maple_timings(run, out), decoder=decoder, test_batches=n_test,
                     launches_per_step=nonzero(run["steps"][-1]["launches"]),
                     launches_per_test=nonzero(run["tests"][-1]["launches"]))
        # where the time of a step and of a test() goes: one more of each,
        # after the run, under the profiler
        batches = iter(trainer.train_loader_x)
        step_batch = trainer.parse_batch_train(next(batches))
        batches.close()
        maple["profile_step"] = profile_by_kernel(lambda: trainer.train_step(step_batch),
                                                  f"cli MaPLe train step, B=4, on {card}")
        maple["profile_test"] = profile_by_kernel(trainer.test, f"cli MaPLe test(), on {card}")
        maple["host_step"] = host_profile(lambda: trainer.train_step(step_batch),
                                          f"cli MaPLe train step, B=4, on {card}")
        checks.append(("cli MaPLe launches as the routing implies", held))
        checks += [(f"cli MaPLe {k} launched", {"ok": run["counts"][k] > 0})
                   for k in CLI_PATH_KERNELS if k != "K5 fused_block_residual"]
        checks.append(("cli MaPLe K5 launched",
                       {"ok": run["counts"]["K5 fused_block_residual"] > 0}))
        checks.append(("cli MaPLe checkpoint of epoch 2", {"ok": os.path.isfile(os.path.join(
            out, "MultiModalPromptLearner", f"model.pth.tar-{CLI_EPOCHS}"))}))
        add(run["counts"])
        del trainer, run
        torch.cuda.empty_cache()

        # -- the same run on the plain formulation -------------------------------
        run = cli_run(cli_argv("MaPLe", CLI_MAPLE_YAML, os.path.join(tmp, "maple-xla"), root,
                               maple_opts + ["TPU.ATTENTION_IMPL", "xla"]), "MaPLe, xla")
        xla = maple_timings(run, os.path.join(tmp, "maple-xla"))
        first_rel = abs(maple["first_loss"] - xla["first_loss"]) / abs(xla["first_loss"])
        loss_cmp = {"first_loss_rel_err": first_rel, "tol": TOL_STEP_LOSS,
                    "ok": first_rel <= TOL_STEP_LOSS}
        checks.append(("cli MaPLe first loss, kernel routes vs xla", loss_cmp))
        checks.append(("cli MaPLe xla launches no kernel", {"ok": not nonzero(run["counts"])}))
        summary["maple_xla"] = xla
        del run
        torch.cuda.empty_cache()

        # -- --eval-only reload through the command line ---------------------------
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "federated_multi_modal_tpu_torch.train",
             *cli_argv("MaPLe", CLI_MAPLE_YAML, os.path.join(tmp, "maple-eval"), root,
                       maple_opts, extra=("--eval-only", "--model-dir", out,
                                          "--load-epoch", str(CLI_EPOCHS)))],
            capture_output=True, text=True, timeout=600, cwd=repo)
        reload_s = time.perf_counter() - t0
        found = re.findall(r"\* accuracy: ([\d.]+)%", proc.stdout)
        reload_cmp = {"returncode": proc.returncode, "accuracy": found,
                      "in_process": f"{maple['final_accuracy']:.2f}", "s": reload_s,
                      "ok": proc.returncode == 0 and found == [f"{maple['final_accuracy']:.2f}"]}
        if not reload_cmp["ok"]:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
        checks.append(("cli --eval-only reload, same accuracy", reload_cmp))
        print("cli --eval-only --model-dir --load-epoch reload (subprocess):",
              json.dumps(reload_cmp))

        # -- CoOp and zero-shot CLIP through main ------------------------------------
        for trainer_name, yaml, opts, extra in (
                ("CoOp", CLI_COOP_YAML, CLI_COOP_OPTS + weights, ()),
                ("ZeroshotCLIP", CLI_COOP_YAML, weights, ("--eval-only",))):
            run = cli_run(cli_argv(trainer_name, yaml, os.path.join(tmp, trainer_name), root,
                                   opts, extra), trainer_name)
            n_test = len(run["trainer"].test_loader)
            held = hold_launches(run, cli_implied(run["trainer"].arch, trainer_name, n_test),
                                 trainer_name)
            checks.append((f"cli {trainer_name} launches as the routing implies", held))
            checks.append((f"cli {trainer_name} K1 and K5 launched", {"ok": (
                run["counts"]["K1 packed_attention_masked"] > 0
                and run["counts"]["K5 fused_block_residual"] > 0)}))
            summary[trainer_name] = {
                "steps": len(run["steps"]),
                "step_ms_median": (statistics.median(s["ms"] for s in run["steps"][1:])
                                   if len(run["steps"]) > 1 else None),
                "test_ms": [t["ms"] for t in run["tests"]],
                "accuracy": run["tests"][-1]["accuracy"], "main_s": run["wall_s"],
                "launches": nonzero(run["counts"])}
            add(run["counts"])
            del run
            torch.cuda.empty_cache()

    summary["maple"] = maple
    summary["first_loss_vs_xla"] = loss_cmp
    print(f"cli MaPLe, ViT-B/16, batch {maple['batch']}, on {card}: step "
          f"{maple['step_ms_median']:.2f} ms (median of the steps after the first, "
          f"synchronised; first {maple['step_ms_first']:.1f} ms), epochs "
          f"{', '.join(f'{s:.3f}' for s in maple['epoch_s'])} s, loader wait "
          f"{', '.join(f'{w:.1%}' for w in maple['loader_wait_share'])} of the epoch, test() "
          f"{', '.join(f'{t:.1f}' for t in maple['test_ms'])} ms, checkpoint save "
          f"{', '.join(f'{t:.1f}' for t in maple['checkpoint_save_ms'])} ms, load "
          f"{maple['checkpoint_load_ms']:.1f} ms, decoder {maple['decoder']}")
    print(f"cli MaPLe per-epoch mean losses, kernel routes {json.dumps(maple['epoch_mean_losses'])}"
          f" and xla {json.dumps(xla['epoch_mean_losses'])}; final accuracy "
          f"{maple['final_accuracy']:.2f}% and {xla['final_accuracy']:.2f}%; first loss "
          f"{maple['first_loss']:.6f} and {xla['first_loss']:.6f}, relative "
          f"{first_rel:.2e} (limit {TOL_STEP_LOSS:.2e}); on {card}")
    return launches, checks, summary


# -- federated MaPLe through the command line (the fed phase) ----------------

FED_YAML = "configs/trainers/MaPLeFederated/vit_b16_c2_ep5_batch4_2ctx_cross_datasets.yaml"
# the configuration runs 30 rounds of 10 local epochs; the phase cuts both
FED_ROUNDS, FED_LOCAL_EPOCHS = 2, 1
# images a class of the seeded stand-in trees (EuroSAT's splitter needs 4
# for a non-empty test split); PatternNet's 50/20/30 split is in order over
# the flat list, so its clients train on the first half of its classes
FED_PER_CLASS = {"PatternNet": 3, "Ucmerced": 3, "EuroSAT": 4}
# FedAvg of two fp32 trees: one rounding of the sum, times 1/2
TOL_FEDAVG = 2.0 ** -23


@contextlib.contextmanager
def fed_instrumented(record: dict, plant_nan: bool = False):
    """``MaPLeFederated``'s round loop with each round's seconds and
    launches, each FedAvg (timed, its output held against the fp64 host mean
    of its inputs), each broadcast (timed) and each round checkpoint (timed,
    read back and held against the global weights bit for bit) recorded in
    ``record``; with ``plant_nan``, client 1's trainable tree gets a NaN
    after its round-0 epoch."""
    import torch

    from federated_multi_modal_tpu_torch.engine.checkpoint import (
        flatten_params,
        load_checkpoint,
    )
    from federated_multi_modal_tpu_torch.trainers import maple, maple_fed

    fed_cls = maple_fed.MaPLeFederated
    average, save_round = maple_fed.safe_average_trees, fed_cls._save_round
    broadcast, resume = fed_cls.broadcast_weights, fed_cls._resume_round
    run_epoch = maple.MaPLe.run_epoch

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def resume_rec(self):
        record["fed"] = self
        torch.cuda.synchronize()
        record["round_marks"] = [(time.perf_counter(), kernel_counts())]
        return resume(self)

    def average_rec(trees):
        fed = record["fed"]
        inputs = [flatten_params(t) for t in trees]
        out, ms = synced(lambda: average(trees))
        got = flatten_params(out)
        worst = 0.0
        for name, value in got.items():
            mean = np.mean([np.asarray(t[name], np.float64) for t in inputs], axis=0)
            err = np.abs(value.astype(np.float64) - mean)
            worst = max(worst, float((err / np.maximum(np.abs(mean), 1e-30)).max()))
        # a client whose weights failed the gate was reset to the global ones
        reset = []
        if len(trees) < len(fed.clients):
            held = flatten_params(fed.global_weights)
            reset = [i for i, c in enumerate(fed.clients) if all(
                np.array_equal(v, held[k]) for k, v in flatten_params(c.trainable).items())]
        record.setdefault("fedavg", []).append({
            "ms": ms, "clients": len(trees), "max_rel_err_vs_fp64_mean": worst,
            "tol": TOL_FEDAVG, "ok": worst <= TOL_FEDAVG, "reset_to_global": reset})
        return out

    def broadcast_rec(self, global_tree, round_idx=0, advance=False):
        _, ms = synced(lambda: broadcast(self, global_tree, round_idx, advance))
        record.setdefault("broadcast_ms", []).append(ms)

    def save_round_rec(self, round_idx):
        _, ms = synced(lambda: save_round(self, round_idx))
        path = os.path.join(self.cfg.OUTPUT_DIR, maple_fed.AGGREGATOR_DIR,
                            f"model.pth.tar-round{round_idx + 1}")
        saved = load_checkpoint(path)["state_dict"]
        held = flatten_params(self.global_weights)
        same = saved.keys() == held.keys() and all(
            saved[k].dtype == held[k].dtype and np.array_equal(saved[k], held[k]) for k in held)
        record.setdefault("round_checkpoints", []).append({"ms": ms, "bit_equal": same})
        record["round_marks"].append((time.perf_counter(), kernel_counts()))

    def run_epoch_planted(self, epoch=None):
        out = run_epoch(self, epoch)
        if self.client_id == 1 and epoch == 0:
            ctx = self.trainable["prompt_learner"]["ctx"].clone()
            ctx[0, 0] = float("nan")
            self.trainable["prompt_learner"]["ctx"] = ctx
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(maple_fed, safe_average_trees=average_rec))
        stack.enter_context(patched(fed_cls, _save_round=save_round_rec,
                                    broadcast_weights=broadcast_rec, _resume_round=resume_rec))
        if plant_nan:
            stack.enter_context(patched(maple.MaPLe, run_epoch=run_epoch_planted))
        yield


def fed_run(argv: list, label: str, plant_nan: bool = False, instrument=None) -> dict:
    """``MaPLeFederated`` through the port's ``main`` on ``argv`` in this
    process, every count set to 0 just before and read just after, under
    :func:`cli_instrumented`, :func:`fed_instrumented` and
    ``instrument(record)`` where given: the record, with the peak device
    memory the run allocated above what was allocated before it (the
    trainers of earlier runs collected first: they hold reference
    cycles)."""
    import gc

    import torch

    from federated_multi_modal_tpu_torch import train as port_cli

    args = port_cli.build_parser().parse_args(argv)
    record = {"steps": [], "tests": [], "saves": []}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    with cli_instrumented(record), fed_instrumented(record, plant_nan), (
            instrument(record) if instrument else contextlib.nullcontext()):
        record["trainer"] = port_cli.main(args)
    torch.cuda.synchronize()
    record["wall_s"] = time.perf_counter() - t0
    record["counts"] = kernel_counts()
    record["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    record["allocated_before_gib"] = base / 2 ** 30
    marks = record["round_marks"]
    record["round_s"] = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    record["round_launches"] = [nonzero({k: b[1][k] - a[1][k] for k in b[1]})
                                for a, b in zip(marks, marks[1:])]
    print(f"fed {label}: launches {json.dumps(nonzero(record['counts']))}, "
          f"{len(record['steps'])} steps, {len(record['tests'])} test(), "
          f"main {record['wall_s']:.1f} s, peak {record['peak_gib']:.2f} GiB above the "
          f"{record['allocated_before_gib']:.2f} allocated before, "
          f"nan_stats {json.dumps(record['trainer'].nan_stats)}")
    return record


def fed_launches_held(run: dict) -> dict:
    """Each local step's and each ``test()``'s launches equal to the
    routing's (a ``test()`` runs the text once and K5 per block and test
    batch of its client's split), and the run's to their sum."""
    fed = run["trainer"]
    arch = fed.clients[0].arch
    n_test = {c.client_id: len(c.test_loader) for c in fed.clients}
    step = cli_implied(arch, "MaPLe", 0)[0]
    wrong, total = [], dict.fromkeys(step, 0)
    for kind in ("steps", "tests"):
        for i, entry in enumerate(run[kind]):
            expected = step if kind == "steps" else cli_implied(
                arch, "MaPLe", n_test[entry["client"]])[1]
            bad = {k: (entry["launches"][k], v) for k, v in expected.items()
                   if entry["launches"][k] != v}
            if bad:
                wrong.append([f"{kind}[{i}] client {entry['client']}", bad])
            for k, v in expected.items():
                total[k] += v
    bad = {k: (run["counts"][k], v) for k, v in total.items() if run["counts"][k] != v}
    if bad:
        wrong.append(["run", bad])
    print(f"  fed launches per local step {json.dumps(nonzero(step))}, per test() K1 "
          f"{arch.transformer_layers} and K5 {arch.vision_layers} a test batch "
          f"(test batches by client {json.dumps(n_test)}): "
          f"{'as the routing implies' if not wrong else json.dumps(wrong[:4])}")
    return {"ok": not wrong, "wrong": wrong, "implied_run": nonzero(total)}


def shared_tower(fed) -> dict:
    """Whether the clients' frozen CLIP leaves are the same storage and
    their trainable leaves are not."""
    from federated_multi_modal_tpu_torch.engine.tree import flatten

    frozen = [flatten(c.frozen["model"]) for c in fed.clients]
    trainable = [{t.data_ptr() for t in flatten(c.trainable).values()} for c in fed.clients]
    shared = all(f.keys() == frozen[0].keys() and all(
        f[k].data_ptr() == frozen[0][k].data_ptr() for k in f) for f in frozen)
    disjoint = all(not (a & b) for i, a in enumerate(trainable) for b in trainable[i + 1:])
    out = {"frozen_leaves": len(frozen[0]), "frozen_shared": shared,
           "trainable_disjoint": disjoint, "ok": shared and disjoint and len(frozen) > 1}
    print("  fed clients' frozen tower:", json.dumps(out))
    return out


def first_losses(run: dict) -> dict:
    return {str(c): next(s["loss"] for s in run["steps"] if s["client"] == c)
            for c in sorted({s["client"] for s in run["steps"]})}


def fed_phase(card: str, opts: tuple = ()) -> tuple:
    """Federated MaPLe (``python -m federated_multi_modal_tpu_torch.train
    --trainer MaPLeFederated``, ``FED_YAML``) at ViT-B/16 from a seeded
    OpenAI-format state dict, on seeded stand-ins of its datasets in their
    own layout and published image sizes: PatternNet and Ucmerced clients,
    EuroSAT's class names, 51 unified classes. ``FED_ROUNDS`` rounds of
    ``FED_LOCAL_EPOCHS`` local epoch:

    * the run through ``main``: no failed client or skipped round, an
      update a round; each local step's and each ``test()``'s launches
      held against the routing; the clients' frozen tower one storage;
      each FedAvg against the fp64 host mean of its inputs; each round
      checkpoint read back bit for bit; its times; then one local step and
      one ``test()`` of client 0 under the profiler;
    * one round under ``TPU.ATTENTION_IMPL xla``: each client's first loss
      within ``TOL_STEP_LOSS`` of the kernel run's;
    * the run with a NaN planted in client 1's weights after its round-0
      epoch: client 1 reset to the global weights, round 0 averaged from
      client 0 alone, the accounting as the JAX package's NaN-gate case;
    * one round with one client, for the peak device memory beside two.

    ``opts`` are appended to every run's configuration options. Returns
    ``(launches by kernel label of the first run, checks, summary)``."""
    import tempfile

    import torch

    from federated_multi_modal_tpu_torch.data.seeded_trees import write_seeded_tree

    checks, summary = [], {"card": card}
    cuts = {"FED.NUM_ROUNDS": [FED_ROUNDS, 30], "FED.LOCAL_EPOCHS": [FED_LOCAL_EPOCHS, 10],
            "images a class (stand-in trees)": FED_PER_CLASS}
    print(f"fed cuts [this phase, the configuration]: {json.dumps(cuts)}")
    with tempfile.TemporaryDirectory(prefix="fmm_fed_") as tmp:
        sd_path = os.path.join(tmp, "vit_b16_openai_fp16.pt")
        summary["state_dict_write_s"] = write_openai_state_dict(sd_path)
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        for name, n in FED_PER_CLASS.items():
            write_seeded_tree(root, name, n, seed=0)
        summary["tree_write_s"] = time.perf_counter() - t0
        common = ["MODEL.BACKBONE.WEIGHTS_PATH", sd_path,
                  "FED.NUM_ROUNDS", str(FED_ROUNDS), "FED.LOCAL_EPOCHS", str(FED_LOCAL_EPOCHS),
                  "FED.CHECKPOINT_EVERY_ROUND", "True", *opts]

        def argv(out, *opts):
            return ["--root", root, "--seed", "1", "--trainer", "MaPLeFederated",
                    "--dataset-config-file", "configs/datasets/PatternNet.yaml",
                    "--config-file", FED_YAML, "--output-dir", os.path.join(tmp, out),
                    *common, *opts]

        # -- the run, on the kernel routes ------------------------------------------
        run = fed_run(argv("fed"), "MaPLeFederated")
        fed = run["trainer"]
        stats = fed.nan_stats
        checks.append(("fed no failed client or skipped round, an update a round", {
            "ok": stats == {"total_updates": FED_ROUNDS, "failed_clients": [],
                            "skipped_rounds": 0}, "nan_stats": stats}))
        checks.append(("fed launches as the routing implies", fed_launches_held(run)))
        checks += [(f"fed {k} launched", {"ok": run["counts"][k] > 0}) for k in CLI_PATH_KERNELS]
        checks.append(("fed clients share one frozen tower", shared_tower(fed)))
        checks.append(("fed FedAvg against the fp64 host mean", {
            "ok": len(run["fedavg"]) == FED_ROUNDS and all(a["ok"] for a in run["fedavg"]),
            "rounds": run["fedavg"]}))
        checks.append(("fed round checkpoints read back bit for bit", {
            "ok": len(run["round_checkpoints"]) == FED_ROUNDS
            and all(c["bit_equal"] for c in run["round_checkpoints"]),
            "rounds": run["round_checkpoints"]}))
        print("  fed FedAvg by round (ms, clients, max relative error against the fp64 host "
              "mean):", json.dumps([[round(a["ms"], 3), a["clients"],
                                     a["max_rel_err_vs_fp64_mean"]] for a in run["fedavg"]]),
              "; round checkpoints (ms, bit-equal):",
              json.dumps([[round(c["ms"], 1), c["bit_equal"]] for c in run["round_checkpoints"]]))
        agg = os.path.join(tmp, "fed", "MultiModalPromptLearner_Aggregator",
                           f"model.pth.tar-{fed.cfg.OPTIM.MAX_EPOCH}")
        checks.append(("fed aggregator checkpoint written", {"ok": os.path.isfile(agg)}))
        steps = [s["ms"] for s in run["steps"]]
        client0 = fed.clients[0]
        batches = iter(client0.train_loader_x)
        step_batch = client0.parse_batch_train(next(batches))
        batches.close()
        fed_summary = {
            "backbone": fed.cfg.MODEL.BACKBONE.NAME, "unified_classes": fed.num_classes,
            "train_images": [len(dm.dataset.train_x) for dm in fed.client_data_managers],
            "test_images": [len(dm.dataset.test) for dm in fed.client_data_managers],
            "steps_per_epoch": [[e["steps"] for e in c.epoch_stats] for c in fed.clients],
            "round_s": run["round_s"],
            "client_epoch_s": [[e["epoch_s"] for e in c.epoch_stats] for c in fed.clients],
            "step_ms_median": statistics.median(steps[1:]), "step_ms_first": steps[0],
            "fedavg_ms": [a["ms"] for a in run["fedavg"]],
            "broadcast_ms": run["broadcast_ms"],
            "round_checkpoint_save_ms": [c["ms"] for c in run["round_checkpoints"]],
            "test_ms": [t["ms"] for t in run["tests"]],
            "round_launches": run["round_launches"],
            "first_losses": first_losses(run),
            "final_accuracy": run["tests"][-1]["accuracy"],
            "peak_gib_two_clients": run["peak_gib"], "main_s": run["wall_s"],
            "profile_step": profile_by_kernel(lambda: client0.train_step(step_batch),
                                              f"fed client-0 local step, B=4, on {card}"),
            "profile_test": profile_by_kernel(client0.test, f"fed client-0 test(), on {card}"),
        }
        launches = run["counts"]
        del fed, client0, run, step_batch
        torch.cuda.empty_cache()

        # -- one round on the plain formulation ---------------------------------------
        run = fed_run(argv("fed-xla", "FED.NUM_ROUNDS", "1", "TPU.ATTENTION_IMPL", "xla"),
                      "MaPLeFederated, xla, one round")
        xla_first = first_losses(run)
        rel = {c: abs(fed_summary["first_losses"][c] - v) / abs(v) for c, v in xla_first.items()}
        loss_cmp = {"first_loss_rel_err": rel, "tol": TOL_STEP_LOSS,
                    "ok": len(rel) == 2 and max(rel.values()) <= TOL_STEP_LOSS}
        checks.append(("fed first losses, kernel routes vs xla", loss_cmp))
        checks.append(("fed xla launches no kernel", {"ok": not nonzero(run["counts"])}))
        fed_summary["first_losses_xla"] = xla_first
        fed_summary["step_ms_median_xla"] = statistics.median(s["ms"] for s in run["steps"][1:])
        del run
        torch.cuda.empty_cache()

        # -- a NaN planted in client 1's weights after its round-0 epoch ---------------
        run = fed_run(argv("fed-nan"), "MaPLeFederated, NaN planted in client 1", plant_nan=True)
        with open(os.path.join(tmp, "fed-nan", "log.txt")) as f:
            log = f.read()
        planted = {
            "nan_stats": run["trainer"].nan_stats,
            "fedavg_clients": [a["clients"] for a in run["fedavg"]],
            "reset_to_global": [a["reset_to_global"] for a in run["fedavg"]],
            "logged": "Client 1 produced invalid weights, skipping aggregation" in log}
        planted["ok"] = (planted["nan_stats"] == {"total_updates": FED_ROUNDS,
                                                  "failed_clients": [], "skipped_rounds": 0}
                         and planted["fedavg_clients"] == [1] + [2] * (FED_ROUNDS - 1)
                         and planted["reset_to_global"][0] == [1] and planted["logged"]
                         and all(a["ok"] for a in run["fedavg"]))
        print("  fed planted NaN in client 1:", json.dumps(planted))
        checks.append(("fed planted NaN caught by the validity gate", planted))
        del run
        torch.cuda.empty_cache()

        # -- one client, one round: the memory beside two clients ---------------------
        run = fed_run(argv("fed-one", "FED.NUM_CLIENTS", "1", "FED.NUM_ROUNDS", "1"),
                      "MaPLeFederated, one client, one round")
        fed_summary["peak_gib_one_client"] = run["peak_gib"]
        del run
        torch.cuda.empty_cache()

    summary.update(fed_summary, first_loss_vs_xla=loss_cmp, planted_nan=planted)
    s = fed_summary
    print(f"fed MaPLeFederated, {s['backbone']}, {s['unified_classes']} unified classes, clients "
          f"PatternNet and Ucmerced ({s['train_images']} train, {s['test_images']} test "
          f"images), batch 4, on {card}: rounds {', '.join(f'{r:.2f}' for r in s['round_s'])} s;"
          f" client epochs {json.dumps([[round(e, 3) for e in c] for c in s['client_epoch_s']])}"
          f" s; local step {s['step_ms_median']:.2f} ms (median after the first, synchronised; "
          f"first {s['step_ms_first']:.1f}; xla {s['step_ms_median_xla']:.2f}); FedAvg "
          f"{', '.join(f'{t:.2f}' for t in s['fedavg_ms'])} ms; broadcast "
          f"{', '.join(f'{t:.2f}' for t in s['broadcast_ms'])} ms; round checkpoint save "
          f"{', '.join(f'{t:.1f}' for t in s['round_checkpoint_save_ms'])} ms; test() "
          f"{', '.join(f'{t:.1f}' for t in s['test_ms'])} ms")
    print(f"fed launches per round {json.dumps(s['round_launches'])}; peak device memory "
          f"above the run's start {s['peak_gib_two_clients']:.2f} GiB with two clients, "
          f"{s['peak_gib_one_client']:.2f} GiB with one; first losses {json.dumps(s['first_losses'])}"
          f" and xla {json.dumps(s['first_losses_xla'])}; final accuracy "
          f"{s['final_accuracy']:.2f}%; on {card}")
    return launches, checks, summary


# -- base-to-novel: VPT, IVLP and CoCoOp through the command line (the b2n phase)

B2N_CONFIGS = {"VPT": "configs/trainers/VPT/vit_b16_c2_ep5_batch4_4.yaml",
               "IVLP": "configs/trainers/IVLP/vit_b16_c2_ep5_batch4_2+2ctx.yaml",
               "CoCoOp": "configs/trainers/CoCoOp/vit_b16_c4_ep10_batch1.yaml"}
B2N_DATASET_YAML = "configs/datasets/caltech101.yaml"
# the base-to-novel runs take 16 shots for 5 epochs (VPT, IVLP) or 10
# (CoCoOp); the phase cuts both
B2N_SHOTS, B2N_EPOCHS = 2, 1
# images a class of the seeded Caltech101 stand-in: 4 train, 1 val and 2 test
# after its 50/20/30 split, so each half's test split is one batch of 100
B2N_PER_CLASS = 7
# the registered model each trainer checkpoints under
B2N_MODEL_NAME = {"VPT": "prompt_learner", "IVLP": "VLPromptLearner",
                  "CoCoOp": "prompt_learner"}


def vision_prompt_leaf(name: str) -> bool:
    """VPT's and IVLP's vision-limit leaves: the vision prompts, whose
    gradient reaches them only through K3's dx."""
    return name.startswith("vpt.")


def b2n_run(argv: list, label: str) -> dict:
    """:func:`cli_run`, with the peak device memory the run allocated
    above what was allocated before it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run = cli_run(argv, label)
    run["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return run


def b2n_batch(trainer, n: int) -> dict:
    """``n`` images and labels of the trainer's training split, through its
    loader and ``parse_batch_train`` (random crops), as one batch."""
    import torch

    images, labels = [], []
    batches = iter(trainer.train_loader_x)
    while sum(len(x) for x in labels) < n:
        x, y = trainer.parse_batch_train(next(batches))
        images.append(x)
        labels.append(y)
    batches.close()
    return {"image": torch.cat(images)[:n], "label": torch.cat(labels)[:n]}


def text_rows(n_prompts: int, text_len: int) -> dict:
    """The text tower's rows for ``n_prompts`` prompts of ``text_len``
    tokens, as ``encode_text_embedded`` packs them."""
    from federated_multi_modal_tpu_torch.models.clip_model import text_pack_layout

    per_row, rows = text_pack_layout(n_prompts, text_len)
    return {"prompts": n_prompts, "packed_rows": rows, "row_tokens": per_row * text_len}


def b2n_phase(card: str, opts: tuple = ()) -> tuple:
    """VPT, IVLP and CoCoOp (``python -m federated_multi_modal_tpu_torch.train
    --trainer X``, each with its configuration in ``B2N_CONFIGS``) at
    ViT-B/16 from a seeded OpenAI-format state dict, on a seeded stand-in of
    Caltech101 in its own layout (102 folders, ~300 x 200 JPEG), trained on
    the 50 base classes and evaluated on the 50 novel ones. Per trainer:

    * the run through ``main`` on the base classes: each step's, each
      ``test()``'s and the build's launches held against the routing (no
      K4); its times; one more step under the profiler;
    * one whole ``STEP_IMAGES``-image step of the trained state against the
      plain path (``whole_step_vs_plain``; the vision prompts at the vision
      limit, every other leaf at the other), with K3's dx tail zeroed
      (vision) and K1b's mask dropped (other) as planted faults;
    * the same run under ``TPU.ATTENTION_IMPL xla``: the first loss within
      ``TOL_STEP_LOSS`` of the kernel run's, no kernel launched;
    * ``--eval-only --load-epoch`` on the novel classes from the kernel
      run's checkpoint: the class-conditioned buffers dropped, every other
      leaf loaded, finite logits, launches held.

    ``opts`` are appended to every run's configuration options. Returns
    ``(launches by kernel label over the kernel runs, checks, summary)``."""
    import tempfile

    import torch

    from federated_multi_modal_tpu_torch.data.seeded_trees import write_caltech101_tree
    from federated_multi_modal_tpu_torch.engine.checkpoint import (
        drop_class_conditioned,
        load_checkpoint,
    )
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    checks, summary, launches = [], {"card": card}, {}
    cuts = {"DATASET.NUM_SHOTS": [B2N_SHOTS, 16],
            "OPTIM.MAX_EPOCH": [B2N_EPOCHS, "5 (VPT, IVLP), 10 (CoCoOp)"],
            "images a class (stand-in tree)": B2N_PER_CLASS}
    print(f"b2n cuts [this phase, the base-to-novel runs]: {json.dumps(cuts)}")
    vision_fault = (k_block, {"CUDA_STEPS": k_block.CUDA_STEPS._replace(
        layernorm_bwd=fault_dx_tail_zero(k_block.layernorm_bwd_rows_cuda))})
    other_fault = (k_attn, {"attention_core_bwd_cuda": fault_mask_dropped(
        k_attn.attention_core_bwd_cuda)})
    with tempfile.TemporaryDirectory(prefix="fmm_b2n_") as tmp:
        sd_path = os.path.join(tmp, "vit_b16_openai_fp16.pt")
        summary["state_dict_write_s"] = write_openai_state_dict(sd_path)
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_caltech101_tree(root, B2N_PER_CLASS, seed=0)
        summary["tree_write_s"] = time.perf_counter() - t0

        for name, yaml in B2N_CONFIGS.items():
            t_trainer = time.perf_counter()

            def argv(out, subsample, *extra, cfg=()):
                return ["--root", root, "--seed", "1", "--trainer", name,
                        "--dataset-config-file", B2N_DATASET_YAML, "--config-file", yaml,
                        "--output-dir", os.path.join(tmp, out), *extra,
                        "MODEL.BACKBONE.WEIGHTS_PATH", sd_path,
                        "DATASET.NUM_SHOTS", str(B2N_SHOTS), "OPTIM.MAX_EPOCH", str(B2N_EPOCHS),
                        "DATASET.SUBSAMPLE_CLASSES", subsample, *cfg, *opts]

            # -- the base classes, on the kernel routes ----------------------------
            run = b2n_run(argv(name, "base"), f"b2n {name}, base classes")
            trainer = run["trainer"]
            n_test = len(trainer.test_loader)
            held = hold_launches(run, cli_implied(trainer.arch, name, n_test), f"b2n {name}")
            checks.append((f"b2n {name} launches as the routing implies", held))
            no_k4 = {k: run["counts"][k] for k in ("K4 fused_block_train_dw",
                                                   "K4 fused_block_train_dw (backward)")}
            checks.append((f"b2n {name} launches no K4", {"ok": not any(no_k4.values()),
                                                          **no_k4}))
            steps = [s["ms"] for s in run["steps"]]
            n_cls = len(trainer.dm.dataset.classnames)
            batch = trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
            test_batch = trainer.cfg.DATALOADER.TEST.BATCH_SIZE
            rec = {
                "base_classes": n_cls, "train_images": len(trainer.dm.dataset.train_x),
                "test_images": len(trainer.dm.dataset.test), "batch": batch,
                "steps": len(steps), "step_ms_median": statistics.median(steps[1:]),
                "step_ms_first": steps[0], "epoch_s": [e["epoch_s"] for e in trainer.epoch_stats],
                "loader_wait_share": [e["loader_wait_s"] / e["epoch_s"]
                                      for e in trainer.epoch_stats],
                "first_loss": run["steps"][0]["loss"], "test_ms": [t["ms"] for t in run["tests"]],
                "accuracy": run["tests"][-1]["accuracy"], "test_batches": n_test,
                "launches_per_step": nonzero(run["steps"][-1]["launches"]),
                "launches_per_test": nonzero(run["tests"][-1]["launches"]),
                "launches_run": nonzero(run["counts"]), "peak_gib": run["peak_gib"],
                "main_s": run["wall_s"],
            }
            if name in ("IVLP", "CoCoOp"):
                text_len = trainer.const.text_len
                conditioned = name == "CoCoOp"
                rec["text_rows_per_step"] = text_rows(n_cls * (batch if conditioned else 1),
                                                      text_len)
                rec["text_rows_per_test_batch"] = text_rows(
                    n_cls * (test_batch if conditioned else 1), text_len)
            step_batch = trainer.parse_batch_train(next(iter(trainer.train_loader_x)))
            rec["profile_step"] = profile_by_kernel(
                lambda: trainer.train_step({"image": step_batch[0], "label": step_batch[1]}),
                f"b2n {name} train step, B={batch}, on {card}")
            rec["profile_test"] = profile_by_kernel(
                trainer.test, f"b2n {name} test(), {n_test} batch of {test_batch}, on {card}")
            checks += whole_step_vs_plain(
                trainer.loss_fn, trainer.trainable, trainer.frozen,
                b2n_batch(trainer, STEP_IMAGES),
                vision_fault if name != "CoCoOp" else None,
                other_fault if name != "VPT" else None,
                f" (b2n {name})", vision_leaf=vision_prompt_leaf)
            for k, v in run["counts"].items():
                launches[k] = launches.get(k, 0) + v
            base_classes = list(trainer.dm.dataset.classnames)
            del trainer, run, step_batch
            torch.cuda.empty_cache()

            # -- the same run on the plain formulation -------------------------------
            # (its final test() skipped: only its steps are read)
            run = b2n_run(argv(f"{name}-xla", "base",
                               cfg=("TPU.ATTENTION_IMPL", "xla", "TEST.NO_TEST", "True")),
                          f"b2n {name}, base classes, xla")
            rel = abs(rec["first_loss"] - run["steps"][0]["loss"]) / abs(run["steps"][0]["loss"])
            rec["first_loss_xla"] = run["steps"][0]["loss"]
            rec["step_ms_median_xla"] = statistics.median(s["ms"] for s in run["steps"][1:])
            checks.append((f"b2n {name} first loss, kernel routes vs xla", {
                "first_loss_rel_err": rel, "tol": TOL_STEP_LOSS, "ok": rel <= TOL_STEP_LOSS}))
            checks.append((f"b2n {name} xla launches no kernel",
                           {"ok": not nonzero(run["counts"])}))
            del run
            torch.cuda.empty_cache()

            # -- the novel classes, from the base run's checkpoint --------------------
            ckpt_dir = os.path.join(tmp, name)
            run = b2n_run(argv(f"{name}-new", "new", "--eval-only", "--model-dir", ckpt_dir,
                               "--load-epoch", str(B2N_EPOCHS)),
                          f"b2n {name}, novel classes from the base checkpoint")
            novel = run["trainer"]
            held = hold_launches(run, cli_implied(novel.arch, name, len(novel.test_loader)),
                                 f"b2n {name} novel eval")
            checks.append((f"b2n {name} novel eval launches as the routing implies", held))
            state = load_checkpoint(os.path.join(ckpt_dir, B2N_MODEL_NAME[name],
                                                 f"model.pth.tar-{B2N_EPOCHS}"))["state_dict"]
            # the checkpoint's every leaf but the class-conditioned ones, read
            # back through the novel trainer's own state surface
            saved = drop_class_conditioned(state)
            loaded = drop_class_conditioned(
                novel._models[B2N_MODEL_NAME[name]]["get"]()["state_dict"])
            with torch.no_grad():
                eval_batch = next(iter(novel.test_loader))
                logits = novel.model_inference(novel.parse_batch_images(eval_batch))
            reload = {
                "dropped": sorted(set(state) - set(drop_class_conditioned(state))),
                "loaded_leaves": len(loaded),
                "every_leaf_loaded": loaded.keys() == saved.keys() and all(
                    np.array_equal(loaded[k], saved[k]) for k in loaded),
                "novel_classes": len(novel.dm.dataset.classnames),
                "disjoint_from_base": not set(novel.dm.dataset.classnames) & set(base_classes),
                "logits": list(logits.shape), "logits_finite": bool(torch.isfinite(logits).all()),
                "accuracy": run["tests"][-1]["accuracy"], "test_ms": run["tests"][-1]["ms"],
                "main_s": run["wall_s"]}
            reload["ok"] = (reload["dropped"] == ([] if name == "VPT"
                                                  else ["token_prefix", "token_suffix"])
                            and reload["every_leaf_loaded"] and reload["disjoint_from_base"]
                            and reload["novel_classes"] == rec["base_classes"]
                            and reload["logits_finite"]
                            and reload["logits"] == [len(eval_batch["label"]),
                                                     reload["novel_classes"]])
            print(f"  b2n {name} novel eval from the base checkpoint:", json.dumps(reload))
            checks.append((f"b2n {name} novel eval loads the base checkpoint", reload))
            rec["novel_eval"] = reload
            for k, v in run["counts"].items():
                launches[k] = launches.get(k, 0) + v
            del run, novel, logits
            torch.cuda.empty_cache()
            rec["trainer_s"] = time.perf_counter() - t_trainer
            summary[name] = rec
            print(f"b2n {name}, ViT-B/16, Caltech101 stand-in, {rec['base_classes']} base classes "
                  f"({rec['train_images']} train, {rec['test_images']} test images), batch "
                  f"{batch}, on {card}: step {rec['step_ms_median']:.2f} ms (median of "
                  f"{rec['steps'] - 1} after the first, synchronised; first "
                  f"{rec['step_ms_first']:.1f}; xla {rec['step_ms_median_xla']:.2f}), test() "
                  f"{', '.join(f'{t:.1f}' for t in rec['test_ms'])} ms, novel eval test() "
                  f"{reload['test_ms']:.1f} ms, profiled step wall "
                  f"{rec['profile_step']['wall_ms']:.2f} ms, device busy "
                  f"{rec['profile_step']['device_busy_ms']:.2f} ms, idle "
                  f"{rec['profile_step']['idle_share']:.3f}, profiled test() wall "
                  f"{rec['profile_test']['wall_ms']:.2f} ms, idle "
                  f"{rec['profile_test']['idle_share']:.3f}, peak {rec['peak_gib']:.2f} GiB; "
                  f"launches per step {json.dumps(rec['launches_per_step'])}, per test() "
                  f"{json.dumps(rec['launches_per_test'])}"
                  + (f"; text rows per step {json.dumps(rec['text_rows_per_step'])}, per test "
                     f"batch {json.dumps(rec['text_rows_per_test_batch'])}"
                     if "text_rows_per_step" in rec else "")
                  + f"; first loss {rec['first_loss']:.6f}, xla {rec['first_loss_xla']:.6f}")
    return launches, checks, summary


RN_COOP_YAML = "configs/trainers/CoOp/rn50.yaml"
# the catalog's ModifiedResNets and the input size each is built for
RN_ZEROSHOT = (("RN50", 224), ("RN101", 224), ("RN50x4", 288), ("RN50x16", 384))
RN_TOWER_BATCHES = (32, 100)  # CoOp rn50.yaml's train and test batches
# The RN50 tower on the card (bf16 policy) against the port's fp32 run of the
# same weights on the CPU, 16 seeded images, BatchNorms calibrated
# (``calibrate_batchnorms``): the largest relative L2 error of a feature row.
# The phase also reads the port's own bf16 run on the CPU and other images.
# On an H100 (700 W) the card read 0.0098, the CPU's bf16 run 0.0097, other
# images 0.26 and the mean token dropped from the attention pool (the
# planted fault) 0.113: the card's bf16 differs from the CPU's in its sums'
# order and cuDNN's algorithms only. The limit sits about 3x from the sound
# and the faulty run.
TOL_RN_TOWER = 2.0 ** -5


def feature_gap(got, ref) -> dict:
    """The largest relative L2 error of a feature row (``max_rel_l2``, the
    one held), with the max |difference| of the L2-normalised rows and the
    least cosine (compared in fp32 on the CPU)."""
    import torch

    g, r = got.detach().float().cpu(), ref.detach().float().cpu()
    a, b = torch.nn.functional.normalize(g, dim=-1), torch.nn.functional.normalize(r, dim=-1)
    return {"max_rel_l2": float(((g - r).norm(dim=-1) / r.norm(dim=-1)).max()),
            "normalised_max_abs_err": float((a - b).abs().max()),
            "min_cosine": float((a * b).sum(-1).min())}


def fault_mean_token_dropped(tokens):
    """The attention pool's mean token replaced by the first spatial one."""
    return tokens[:, :1]


def rn_tower_phase(card: str, sd_path: str) -> tuple:
    """The RN50 tower from a seeded OpenAI-format state dict through
    ``clip_api.load`` on the card: the inferred config against the catalog's,
    16 seeded images under the bf16 policy (cuDNN, channels-last) against the
    port's fp32 run of the same weights on the CPU (``TOL_RN_TOWER``), the
    mean token dropped as a planted fault, the TF32 flags before and after,
    the launches of one forward with the derived weights built and kept,
    and the forward's ms at ``RN_TOWER_BATCHES``. Returns ``(checks,
    summary)``."""
    import torch

    from federated_multi_modal_tpu_torch import clip_api
    from federated_multi_modal_tpu_torch.engine.tree import tree_map_with_path
    from federated_multi_modal_tpu_torch.models import params, resnet
    from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    arch, tree = clip_api.load(sd_path)
    visual = tree["visual"]
    same_config = arch == params.BACKBONE_CONFIGS["RN50"]
    checks = [("rn RN50 config inferred from the state dict equals the catalog's",
               {"ok": same_config})]
    res = arch.image_resolution
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((16, res, res, 3)).astype(np.float32))

    def forward(x):
        with torch.no_grad():
            return encode_image_auto(visual, arch, x, inference=True)

    images_card = images.cuda()
    feats = forward(images_card)
    t0 = time.perf_counter()
    visual_cpu = tree_map_with_path(lambda _, t: t.detach().cpu().float(), visual)
    ref = encode_image_auto(visual_cpu, arch, images)
    ref_s = time.perf_counter() - t0
    gap = feature_gap(feats, ref)
    with patched(resnet, mean_token=fault_mean_token_dropped):
        fault = feature_gap(forward(images_card), ref)
    # what the limit sits between: the CPU's own bf16 run, and other images
    cpu_bf16 = feature_gap(encode_image_auto(
        tree_map_with_path(lambda _, t: t.detach().cpu(), visual), arch, images), ref)
    other_images = feature_gap(forward(torch.from_numpy(
        rng.standard_normal((16, res, res, 3)).astype(np.float32)).cuda()), ref)
    tower = dict(gap, tol=TOL_RN_TOWER, ok=gap["max_rel_l2"] <= TOL_RN_TOWER
                 and feats.shape == (16, arch.embed_dim) and feats.dtype == torch.float32
                 and bool(torch.isfinite(feats).all()))
    checks += [("rn RN50 tower on the card vs fp32 on the CPU", tower),
               ("rn RN50 tower planted fault (mean token dropped) caught",
                {"ok": fault["max_rel_l2"] > TOL_RN_TOWER})]
    print(f"rn RN50 tower, 16 images, bf16 on the card vs fp32 on the CPU (relative L2 "
          f"error of a feature row): {json.dumps(tower)}; planted fault (mean token "
          f"dropped): {json.dumps(fault)}; the CPU's bf16 run: {json.dumps(cpu_bf16)}; other "
          f"images: {json.dumps(other_images)}; CPU fp32 run {ref_s:.1f} s")

    resnet._DERIVED.clear()
    first_kernels, _ = device_profile(lambda: forward(images_card))
    kernels, wall_us = device_profile(lambda: forward(images_card))
    by_kind = {}
    for name, _ in kernels:
        by_kind[short_name(name)] = by_kind.get(short_name(name), 0) + 1
    summary = {
        "config_equal_catalog": same_config, "tower_vs_cpu_fp32": tower, "planted_fault": fault,
        "cpu_bf16_vs_cpu_fp32": cpu_bf16, "other_images_vs_cpu_fp32": other_images,
        "conv_dtype": str(visual["stem"]["conv1"]["w"].dtype),
        "bn_dtype": str(visual["stem"]["bn1"]["scale"].dtype),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "tf32_flags_unchanged": flags == (torch.backends.cudnn.allow_tf32,
                                          torch.backends.cuda.matmul.allow_tf32),
        "launches_first_forward": len(first_kernels), "launches_forward": len(kernels),
        "launches_by_kernel": by_kind, "forward_16_wall_ms": wall_us / 1e3,
        "forward_16_device_ms": sum(us for _, us in kernels) / 1e3,
        "cpu_fp32_reference_s": ref_s,
    }
    checks.append(("rn the port leaves the TF32 flags as it found them",
                   {"ok": summary["tf32_flags_unchanged"]}))
    for batch in RN_TOWER_BATCHES:
        x = torch.from_numpy(rng.standard_normal((batch, res, res, 3)).astype(np.float32)).cuda()
        summary[f"forward_ms_b{batch}"] = cuda_ms(lambda: forward(x), 10)
    print(f"rn RN50 tower on {card}: one forward of 16 launches {len(kernels)} kernels "
          f"({len(first_kernels)} with the derived weights built), by kernel "
          f"{json.dumps(by_kind)}; wall {wall_us / 1e3:.2f} ms, device "
          f"{summary['forward_16_device_ms']:.2f} ms; forward ms at batch "
          + ", ".join(f"{b}: {summary[f'forward_ms_b{b}']:.2f}" for b in RN_TOWER_BATCHES)
          + f"; convs in {summary['conv_dtype']}, BN in {summary['bn_dtype']}, "
          f"cudnn.allow_tf32 {summary['cudnn_allow_tf32']} (a bf16 conv takes no TF32), "
          f"flags unchanged {summary['tf32_flags_unchanged']}")
    return checks, summary


def rn_zeroshot_k1(first: dict, name: str) -> tuple:
    """K1 at a zero-shot text shape (the first text block's qkv and mask
    that the run handed it) against its plain version, with the mask
    dropped as a planted fault, timed beside SDPA."""
    import torch

    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    qkv, mask, n = first["args"]
    ref = k_attn.packed_attention_masked_reference(qkv, mask, n)
    held = compare(k_attn.packed_attention_masked(qkv, mask, n), ref, TOL_K1)
    with patched(k_attn, attention_core_cuda=fault_forward_mask_dropped(
            k_attn.attention_core_cuda)):
        fault = compare(k_attn.packed_attention_masked(qkv, mask, n), ref, TOL_K1)
    B1, T1, D3 = qkv.shape
    hd = D3 // 3 // n
    q, k, v = (t.reshape(B1, T1, n, hd).transpose(1, 2) for t in qkv.split(D3 // 3, dim=-1))
    b = bound(qkv.numel() * 2 + mask.numel() * 4 + B1 * T1 * D3 // 3 * 2,
              4 * B1 * n * hd * int(torch.isfinite(mask).sum()))
    row = {"shape": [list(qkv.shape), list(mask.shape), n], "heads": n, "head_width": hd,
           "max_abs_err": held["max_abs_err"], "tol": held["tol"],
           "ms": cuda_ms(lambda: k_attn.packed_attention_masked(qkv, mask, n), 20),
           "plain_ms": cuda_ms(lambda: k_attn.packed_attention_masked_reference(qkv, mask, n),
                               5, 1),
           "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
               q, k, v, is_causal=True), 20),
           "library_call": "scaled_dot_product_attention(is_causal=True)",
           "bound_ms": b[0], "bound_by": b[1]}
    print(f"  rn {name} K1 at {row['shape']}: {json.dumps(held)}; planted fault (mask "
          f"dropped) [max |err|, err/tol] {json.dumps(brief({'K1': fault}))}; "
          f"{json.dumps({k: row[k] for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')})}")
    return row, [(f"rn {name} K1 at its text shape", held),
                 (f"rn {name} K1 planted fault (mask dropped) caught", {"ok": not fault["ok"]})]


def rn_phase(card: str, opts: tuple = (), zeroshot=RN_ZEROSHOT) -> tuple:
    """The ModifiedResNet backbones (``models/resnet.py``, ``clip_api.py``),
    each from a seeded OpenAI-format fp16 state dict written here:

    * the RN50 tower (:func:`rn_tower_phase`);
    * CoOp with ``rn50.yaml`` through ``main`` on the seeded Caltech101
      stand-in, all 100 classes, 2 shots, one epoch at the config's batch of
      32: each step's, ``test()``'s and the build's launches held against the
      routing (K1 and K1b per text block a step, no vision kernel), one more
      step profiled, a whole ``STEP_IMAGES``-image step against the plain
      path with K1b's mask dropped as a planted fault, the same run under
      ``TPU.ATTENTION_IMPL xla`` (first loss within ``TOL_STEP_LOSS``, no
      kernel launched);
    * ``ZeroshotCLIP --eval-only`` on the same stand-in (all 100 class
      prompts, the config's test batch) for each of ``zeroshot`` (name,
      input size): launches held, finite logits, K1 at the text shape
      against its plain version with a planted fault and beside SDPA, the
      tower's forward ms, ``test()`` ms and peak memory.

    ``opts`` are appended to every run's options. Returns ``(launches by
    kernel label over the kernel runs, checks, summary, K1 rows by
    backbone)``."""
    import tempfile

    import torch

    from federated_multi_modal_tpu_torch.data.seeded_trees import write_caltech101_tree
    from federated_multi_modal_tpu_torch.models.clip_model import encode_image_auto
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn

    checks, summary, launches, k1_rows = [], {"card": card}, {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory(prefix="fmm_rn_") as tmp:
        sd_path = os.path.join(tmp, "rn50_openai_fp16.pt")
        summary["state_dict_write_s"] = write_openai_state_dict(sd_path, backbone="RN50")
        tower_checks, summary["tower"] = rn_tower_phase(card, sd_path)
        checks += tower_checks
        torch.cuda.empty_cache()

        # -- CoOp RN50 through the command line --------------------------------
        root = os.path.join(tmp, "data")
        t0 = time.perf_counter()
        write_caltech101_tree(root, B2N_PER_CLASS, seed=0)
        summary["tree_write_s"] = time.perf_counter() - t0

        def argv(out, *cfg):
            return ["--root", root, "--seed", "1", "--trainer", "CoOp",
                    "--dataset-config-file", B2N_DATASET_YAML, "--config-file", RN_COOP_YAML,
                    "--output-dir", os.path.join(tmp, out),
                    "MODEL.BACKBONE.WEIGHTS_PATH", sd_path, "DATASET.NUM_SHOTS", str(B2N_SHOTS),
                    "OPTIM.MAX_EPOCH", "1", *cfg, *opts]

        run = b2n_run(argv("coop"), "rn CoOp RN50")
        trainer = run["trainer"]
        n_test = len(trainer.test_loader)
        checks.append(("rn CoOp RN50 launches as the routing implies",
                       hold_launches(run, cli_implied(trainer.arch, "CoOp", n_test),
                                     "rn CoOp RN50")))
        steps = [s["ms"] for s in run["steps"]]
        batch = trainer.cfg.DATALOADER.TRAIN_X.BATCH_SIZE
        step_batch = trainer.parse_batch_train(next(iter(trainer.train_loader_x)))
        coop = {
            "classes": len(trainer.dm.dataset.classnames),
            "train_images": len(trainer.dm.dataset.train_x),
            "test_images": len(trainer.dm.dataset.test), "batch": batch,
            "test_batches": n_test, "steps": len(steps),
            "step_ms_median": statistics.median(steps[1:]), "step_ms_first": steps[0],
            "step_ms_all": steps, "test_ms": [t["ms"] for t in run["tests"]],
            "first_loss": run["steps"][0]["loss"], "accuracy": run["tests"][-1]["accuracy"],
            "epoch_s": [e["epoch_s"] for e in trainer.epoch_stats],
            "loader_wait_share": [e["loader_wait_s"] / e["epoch_s"]
                                  for e in trainer.epoch_stats],
            "launches_per_step": nonzero(run["steps"][-1]["launches"]),
            "launches_per_test": nonzero(run["tests"][-1]["launches"]),
            "peak_gib": run["peak_gib"], "main_s": run["wall_s"],
            "text_rows_per_step": text_rows(len(trainer.dm.dataset.classnames),
                                            trainer.const.text_len),
            "profile_step": profile_by_kernel(
                lambda: trainer.train_step({"image": step_batch[0], "label": step_batch[1]}),
                f"rn CoOp RN50 train step, B={batch}, on {card}", top=14),
            "profile_test": profile_by_kernel(
                trainer.test, f"rn CoOp RN50 test(), {n_test} batches, on {card}"),
        }
        checks += whole_step_vs_plain(
            trainer.loss_fn, trainer.trainable, trainer.frozen, b2n_batch(trainer, STEP_IMAGES),
            None, (k_attn, {"attention_core_bwd_cuda": fault_mask_dropped(
                k_attn.attention_core_bwd_cuda)}), " (rn CoOp RN50)")
        add(run["counts"])
        del trainer, run, step_batch
        torch.cuda.empty_cache()

        run = b2n_run(argv("coop-xla", "TPU.ATTENTION_IMPL", "xla", "TEST.NO_TEST", "True"),
                      "rn CoOp RN50, xla")
        rel = abs(coop["first_loss"] - run["steps"][0]["loss"]) / abs(run["steps"][0]["loss"])
        coop["first_loss_xla"] = run["steps"][0]["loss"]
        coop["step_ms_median_xla"] = statistics.median(s["ms"] for s in run["steps"][1:])
        checks += [("rn CoOp RN50 first loss, kernel routes vs xla",
                    {"first_loss_rel_err": rel, "tol": TOL_STEP_LOSS, "ok": rel <= TOL_STEP_LOSS}),
                   ("rn CoOp RN50 xla launches no kernel", {"ok": not nonzero(run["counts"])})]
        del run
        torch.cuda.empty_cache()
        summary["coop_rn50"] = coop
        print(f"rn CoOp RN50, Caltech101 stand-in, {coop['classes']} classes "
              f"({coop['train_images']} train, {coop['test_images']} test images), batch "
              f"{batch}, on {card}: step {coop['step_ms_median']:.2f} ms (median of "
              f"{coop['steps'] - 1} after the first, synchronised; first "
              f"{coop['step_ms_first']:.1f}; xla {coop['step_ms_median_xla']:.2f}), test() "
              f"{', '.join(f'{t:.1f}' for t in coop['test_ms'])} ms, profiled step wall "
              f"{coop['profile_step']['wall_ms']:.2f} ms, device busy "
              f"{coop['profile_step']['device_busy_ms']:.2f} ms, idle "
              f"{coop['profile_step']['idle_share']:.3f}, peak {coop['peak_gib']:.2f} GiB; "
              f"launches per step {json.dumps(coop['launches_per_step'])}, per test() "
              f"{json.dumps(coop['launches_per_test'])}; first loss {coop['first_loss']:.6f}, "
              f"xla {coop['first_loss_xla']:.6f}")

        # -- zero-shot CLIP on each catalog ResNet --------------------------------
        for name, size in zeroshot:
            path = os.path.join(tmp, f"{name}_openai_fp16.pt")
            write_s = write_openai_state_dict(path, backbone=name)
            first = {}
            with patched(primitives, _attn_kernels=overlay(
                    k_attn, packed_attention_masked=cotangent_recorder(
                        first, "k1", k_attn.packed_attention_masked))):
                run = b2n_run(
                    ["--root", root, "--seed", "1", "--trainer", "ZeroshotCLIP",
                     "--dataset-config-file", B2N_DATASET_YAML, "--config-file", RN_COOP_YAML,
                     "--output-dir", os.path.join(tmp, f"zs-{name}"), "--eval-only",
                     "MODEL.BACKBONE.NAME", name, "MODEL.BACKBONE.WEIGHTS_PATH", path,
                     "DATASET.NUM_SHOTS", str(B2N_SHOTS), "INPUT.SIZE", f"({size}, {size})",
                     *opts],
                    f"rn ZeroshotCLIP {name}")
            trainer = run["trainer"]
            arch = trainer.arch
            n_test = len(trainer.test_loader)
            rec = {"state_dict_write_s": write_s, "input_size": size,
                   "text": {"width": arch.transformer_width, "heads": arch.transformer_heads},
                   "test_ms": [t["ms"] for t in run["tests"]],
                   "accuracy": run["tests"][-1]["accuracy"], "peak_gib": run["peak_gib"],
                   "launches_run": nonzero(run["counts"]), "main_s": run["wall_s"]}
            checks.append((f"rn ZeroshotCLIP {name} launches as the routing implies",
                           hold_launches(run, cli_implied(arch, "ZeroshotCLIP", n_test),
                                         f"rn ZeroshotCLIP {name}")))
            with torch.no_grad():
                eval_batch = next(iter(trainer.test_loader))
                logits = trainer.model_inference(trainer.parse_batch_images(eval_batch))
            rec["logits"] = list(logits.shape)
            checks.append((f"rn ZeroshotCLIP {name} logits finite", {
                "ok": bool(torch.isfinite(logits).all())
                and rec["logits"] == [len(eval_batch["label"]), len(trainer.dm.dataset.classnames)]}))
            images = torch.from_numpy(np.random.default_rng(1).standard_normal(
                (RN_TOWER_BATCHES[0], size, size, 3)).astype(np.float32)).cuda()
            visual = trainer.clip_params["visual"]
            with torch.no_grad():
                rec["tower_forward_ms_b32"] = cuda_ms(
                    lambda: encode_image_auto(visual, arch, images, inference=True), 5)
            row, k1_checks = rn_zeroshot_k1(first["k1"], name)
            checks += k1_checks
            k1_rows[name] = row
            rec["k1"] = row
            summary[f"zeroshot_{name}"] = rec
            add(run["counts"])
            print(f"rn ZeroshotCLIP {name} ({size} x {size}, text {arch.transformer_width} wide, "
                  f"{arch.transformer_heads} heads) on {card}: test() "
                  f"{', '.join(f'{t:.1f}' for t in rec['test_ms'])} ms, tower forward at batch "
                  f"{RN_TOWER_BATCHES[0]} {rec['tower_forward_ms_b32']:.2f} ms, peak "
                  f"{rec['peak_gib']:.2f} GiB, launches {json.dumps(rec['launches_run'])}")
            del trainer, run, logits, images, visual, first
            torch.cuda.empty_cache()
    return launches, checks, summary, k1_rows


# -- the distributed layer: the parallel round loop, remat, multi-process DP,
#    profiling (the dist phase)

# FED.NUM_CLIENTS 1 on one card: the JAX package's own parallel case there
DIST_CLIENTS = 1
# the multi-process data-parallel step: two processes on halves of a batch
# of 8 (each the MaPLe configuration's batch of 4)
DIST_DP_BATCH = 8
DIST_CHILD_TIMEOUT_S = 300
# the all-reduced update against one process's over the same two halves:
# the same two fp32 gradients added in another place
DIST_DP_TOL = 2.0 ** -20
# a whole B = 512 step with remat against one without: the same kernels on
# the same inputs, held at the whole-step limits (hold_step)
DIST_REMAT_STEPS = 3

DIST_CHILD = """
import json, os, sys
import torch
from federated_multi_modal_tpu_torch.parallel import multihost

spec = json.loads(os.environ["DIST_SPEC"])
out = {"initialized": multihost.initialize_multihost(backend=spec["backend"])}
rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
out.update(rank=rank, world=world, backend=torch.distributed.get_backend(),
           device=str(torch.device("cuda", torch.cuda.current_device()))
           if spec["device"] == "cuda" else spec["device"])
if spec["mode"] == "nccl":
    from federated_multi_modal_tpu_torch.engine.trainer import all_reduce_mean
    x = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3) + 1
    torch.distributed.all_reduce(x)
    tree = {"a": torch.full((3,), 2.0, device="cuda"), "b": torch.tensor(4.0, device="cuda")}
    got = all_reduce_mean(tree)
    multihost.sync_hosts("nccl")
    out["all_reduce_sum"] = x.cpu().tolist()
    out["all_reduce_mean"] = {k: v.cpu().tolist() for k, v in got.items()}
else:
    import federated_multi_modal_tpu_torch.trainers  # noqa: F401
    from federated_multi_modal_tpu_torch.config import get_cfg_default
    from federated_multi_modal_tpu_torch.engine import build_trainer
    from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params

    cfg = get_cfg_default()
    for f in spec["config_files"]:
        cfg.merge_from_file(f)
    cfg.merge_from_list(spec["opts"])
    cfg.OUTPUT_DIR = os.path.join(spec["dir"], f"rank{rank}")
    cfg.freeze()
    trainer = build_trainer(cfg, device=spec["device"])
    out["dp_multihost"] = trainer._dp_multihost
    full = torch.load(spec["batch"])
    n = len(full["label"]) // world
    half = {k: v[rank * n:(rank + 1) * n].to(spec["device"]) for k, v in full.items()}
    summary = trainer.train_step(half)
    out.update(loss=summary["loss"], grad_norm=summary["grad_norm"], shard=n)
    import numpy as np
    np.savez(os.path.join(spec["dir"], f"trained{rank}.npz"), **flatten_params(trainer.trainable))
multihost.sync_hosts("done")
out["imported_jax"] = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "optax", "federated_multi_modal_tpu"))
with open(os.path.join(spec["dir"], f"result{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def dist_children(spec: dict, world: int, tmp: str) -> list:
    """``DIST_CHILD`` in ``world`` processes on this card, meeting through a
    ``file://`` store under ``tmp``; each one's JSON result. A child that
    fails or outlives ``DIST_CHILD_TIMEOUT_S`` fails the phase (every child
    is killed first)."""
    here = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(tmp, f"store_{spec['mode']}")
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   JAX_COORDINATOR_ADDRESS=f"file://{store}", JAX_NUM_PROCESSES=str(world),
                   JAX_PROCESS_ID=str(rank), DIST_SPEC=json.dumps(spec))
        procs.append(subprocess.Popen([sys.executable, "-c", DIST_CHILD], env=env, cwd=here,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"dist {spec['mode']} children failed:\n" + "\n---\n".join(
            o[-4000:] for o in outs))
    results = []
    for r in range(world):
        with open(os.path.join(spec["dir"], f"result{r}.json")) as f:
            results.append(json.load(f))
    return results


@contextlib.contextmanager
def fedpar_instrumented(record: dict, plant_nan: bool = False):
    """The parallel round loop with each step synchronised, timed and its
    launches read (``record["steps"]``, as :func:`cli_instrumented` records
    a sequential step; the step, its last arguments and output kept for a
    profiled replay), each FedAvg over the client axis timed and held bit
    for bit against its one client's input, and the resumed global weights
    kept (``record["resumed"]``). With ``plant_nan``, a NaN is written into
    the stacked weights the round's last step returns."""
    import torch

    from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params
    from federated_multi_modal_tpu_torch.engine.tree import flatten
    from federated_multi_modal_tpu_torch.trainers import maple_fed

    build, fedavg = maple_fed.build_parallel_fed_step, maple_fed.fedavg_over_clients
    fed_cls = maple_fed.MaPLeFederated
    resume = fed_cls._resume_round

    def build_rec(*args, **kwargs):
        step = build(*args, **kwargs)

        def step_rec(stacked, frozen, opt, batch):
            torch.cuda.synchronize()
            before = kernel_counts()
            t0 = time.perf_counter()
            out = step(stacked, frozen, opt, batch)
            torch.cuda.synchronize()
            after = kernel_counts()
            record["steps"].append({"ms": (time.perf_counter() - t0) * 1e3,
                                    "launches": {k: after[k] - before[k] for k in after},
                                    "client": 0, "loss": float(out[2][0]),
                                    "batch": list(batch["image"].shape)})
            record["step_fn"], record["step_args"] = step, (stacked, frozen, opt, batch)
            fed = record["fed"]
            if plant_nan and len(record["steps"]) == len(fed.clients[0].train_loader_x):
                out[0]["prompt_learner"]["ctx"][0, 0, 0] = float("nan")
            return out

        return step_rec

    def fedavg_rec(stacked):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fedavg(stacked)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got, held = flatten(out), flatten(stacked)
        record.setdefault("fedavg", []).append({
            "ms": ms, "clients": int(next(iter(held.values())).shape[0]),
            "bit_equal_to_input": all(torch.equal(got[k], held[k]) for k in held)})
        return out

    def resume_rec(self):
        rnd = resume(self)
        record["resumed"] = (rnd, flatten_params(self.global_weights))
        return rnd

    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(maple_fed, build_parallel_fed_step=build_rec,
                                    fedavg_over_clients=fedavg_rec))
        stack.enter_context(patched(fed_cls, _resume_round=resume_rec))
        yield


def remat_step_phase(card: str, backbone: str = "ViT-B/16", device: str = "cuda") -> tuple:
    """The flagship MaPLe step at ViT-B/16, batch ``BATCH``, with ``remat``
    (every block of both towers under ``torch.utils.checkpoint``) against
    the same step without: the loss and every trainable gradient held at
    the whole-step limits (``hold_step``), the launches (each forward
    kernel twice, each backward once), peak memory and step ms of both."""
    import torch

    from federated_multi_modal_tpu_torch.engine.trainer import make_train_step
    from federated_multi_modal_tpu_torch.flagship import build_fed_optimizer, build_maple_program
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        crop_resize_flip_normalize,
        sample_rrc_boxes_torch,
    )
    from federated_multi_modal_tpu_torch.tokenizer import tokenize
    from federated_multi_modal_tpu_torch.trainers.maple import make_maple_model_fns

    prog = build_maple_program(backbone, classnames=[f"class {i}" for i in range(N_CLASSES)],
                               n_ctx=2, depth=9, use_captions=True, seed=0, device=device)
    arch, tr, fr = prog["arch"], prog["trainable"], prog["frozen"]
    _, remat_loss = make_maple_model_fns(arch, min(9, arch.vision_layers), prog["text_len"],
                                         True, 0.5, remat=True)
    losses = {"plain": prog["loss_fn"], "remat": remat_loss}
    rng = np.random.default_rng(5)
    canvas = torch.from_numpy(rng.integers(0, 255, (BATCH, 256, 256, 3), np.uint8)).cuda()
    gen = torch.Generator(device=canvas.device).manual_seed(6)
    boxes, flips = sample_rrc_boxes_torch(gen, BATCH, 256)
    batch = {"image": crop_resize_flip_normalize(canvas, boxes, flips,
                                                 out_size=arch.image_resolution),
             "label": torch.from_numpy(rng.integers(0, N_CLASSES, BATCH)).cuda(),
             "caption_tokens": torch.from_numpy(
                 tokenize(["a satellite photo of a scene"] * BATCH)).cuda()}
    del canvas
    out, counts, checks = {}, {}, []
    for name, loss_fn in losses.items():
        torch.cuda.synchronize()
        reset_counts()
        out[name] = step_loss_and_grads(loss_fn, tr, fr, batch)
        torch.cuda.synchronize()
        counts[name] = {k: v for k, v in read_counts().items()
                        if k.split(" ")[0] in ("K1", "K1b", "K3", "K4")}
    held = hold_step(out["remat"], out["plain"])
    print("remat whole step vs without, B=512:", json.dumps(brief_step(held)))
    checks.append(("remat whole B=512 step vs without", held))
    implied = {k: v * (2 if "(backward)" not in k and k.split(" ")[0] != "K1b" else 1)
               for k, v in counts["plain"].items()}
    launches = {"counts": counts, "implied_remat": implied, "ok": counts["remat"] == implied
                and counts["plain"]["K3 fused_block_train"] == arch.vision_layers - 1}
    print("remat launches (each forward kernel twice):", json.dumps(launches))
    checks.append(("remat launches: every forward kernel twice", launches))
    del out
    timing = {}
    for name, loss_fn in losses.items():
        tx = build_fed_optimizer()
        step = make_train_step(loss_fn, tx)
        state = [tr, tx.init(tr)]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(DIST_REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state[0], state[1], loss, _ = step(state[0], fr, state[1], batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        timing[name] = {"step_ms": ms, "step_ms_median": statistics.median(ms),
                        "peak_gib_above_start": (torch.cuda.max_memory_allocated() - base)
                        / 2 ** 30, "loss": float(loss)}
        del state
    print(f"remat train step B={BATCH} on {card}: remat "
          f"{timing['remat']['step_ms_median']:.2f} ms, peak "
          f"{timing['remat']['peak_gib_above_start']:.2f} GiB; without "
          f"{timing['plain']['step_ms_median']:.2f} ms, peak "
          f"{timing['plain']['peak_gib_above_start']:.2f} GiB")
    del prog, tr, fr, batch
    torch.cuda.empty_cache()
    return checks, {"whole_step": brief_step(held), "launches": counts, "timing": timing}


def update_errs(got: dict, ref: dict, initial: dict) -> dict:
    """Each trainable leaf's update (new - initial) in ``got`` against
    ``ref``'s, as max |difference| over max |ref's update|."""
    errs = {}
    for k, r in ref.items():
        d_ref = r.astype(np.float64) - initial[k]
        d_got = got[k].astype(np.float64) - initial[k]
        errs[k] = float(np.abs(d_got - d_ref).max() / max(np.abs(d_ref).max(), 1e-30))
    return errs


def worst(errs: dict) -> list:
    name = max(errs, key=errs.get)
    return [name, errs[name]]


def dist_dp_phase(card: str, tmp: str, sd_path: str, opts: tuple = (),
                  device: str = "cuda") -> tuple:
    """``TPU.DATA_PARALLEL_MULTIHOST`` in two processes on this one card
    (Gloo: NCCL refuses two ranks on one device), each on its half of a
    MaPLe batch of ``DIST_DP_BATCH`` at ViT-B/16 (the cli phase's
    configuration, Synthetic), from the same weights as this process's
    steps over the whole batch:

    * the all-reduced update against this process's step over the same two
      halves, their gradients, losses and aux averaged here
      (``DIST_DP_TOL`` of each leaf's update: the all-reduce adds the same
      two fp32 values), both processes bit for bit alike, the all-reduced
      loss against the whole batch's at ``TOL_STEP_LOSS``;
    * printed beside it, its distance from the step over the whole batch,
      and that of the one-process two-halves step (the control: under the
      bf16 policy a batch split moves the text tower's gradients by bf16
      rounding);
    * then a world of one through NCCL: its ``all_reduce`` and
      :func:`~engine.trainer.all_reduce_mean` on card tensors."""
    import torch

    import federated_multi_modal_tpu_torch.trainers  # noqa: F401
    from federated_multi_modal_tpu_torch.config import get_cfg_default
    from federated_multi_modal_tpu_torch.engine import build_trainer
    from federated_multi_modal_tpu_torch.engine.checkpoint import flatten_params
    from federated_multi_modal_tpu_torch.engine.trainer import (
        loss_grads_and_aux,
        make_train_step_with_aux,
    )
    from federated_multi_modal_tpu_torch.parallel.mesh import mean_over_devices

    checks = []
    opts = ["DATASET.ROOT", os.path.join(tmp, "dp-data"), "MODEL.BACKBONE.WEIGHTS_PATH", sd_path,
            "DATALOADER.TRAIN_X.BATCH_SIZE", str(DIST_DP_BATCH), "SEED", "1", "VERBOSE", "False",
            "TRAINER.NAME", "MaPLe", *opts]
    files = [CLI_DATASET_YAML, CLI_MAPLE_YAML]
    cfg = get_cfg_default()
    for f in files:
        cfg.merge_from_file(f)
    cfg.merge_from_list(opts + ["TPU.DATA_PARALLEL_MULTIHOST", "False"])
    cfg.OUTPUT_DIR = os.path.join(tmp, "dp-one")
    cfg.freeze()
    trainer = build_trainer(cfg, device=device)
    batches = iter(trainer.train_loader_x)
    batch = trainer.parse_batch_train(next(batches))
    batches.close()
    torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(tmp, "dp-batch.pt"))
    n = len(batch["label"]) // 2

    def halves(tr, frozen, b):
        outs = [loss_grads_and_aux(trainer.loss_fn, tr, frozen,
                                   {k: v[i * n:(i + 1) * n] for k, v in b.items()})
                for i in range(2)]
        return tuple(mean_over_devices([o[i] for o in outs], trainer.device) for i in range(3))

    initial = flatten_params(trainer.trainable)
    ref = {}
    for name, grad_fn in (("whole", None), ("halves", halves)):
        step = make_train_step_with_aux(trainer.loss_fn, trainer.tx, grad_fn)
        tr, _, loss, gnorm, _ = step(trainer.trainable, trainer.frozen, trainer.opt_state, batch)
        ref[name] = {"loss": float(loss), "grad_norm": float(gnorm),
                     "params": flatten_params(tr)}
    del trainer, batch, tr
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spec = {"mode": "dp", "backend": "gloo", "dir": tmp, "config_files": files, "device": device,
            "opts": opts + ["TPU.DATA_PARALLEL_MULTIHOST", "True"],
            "batch": os.path.join(tmp, "dp-batch.pt")}
    children = dist_children(spec, 2, tmp)
    dp_s = time.perf_counter() - t0
    trained = [dict(np.load(os.path.join(tmp, f"trained{r}.npz"))) for r in range(2)]
    errs = update_errs(trained[0], ref["halves"]["params"], initial)
    loss_halves = abs(children[0]["loss"] - ref["halves"]["loss"]) / abs(ref["halves"]["loss"])
    loss_whole = abs(children[0]["loss"] - ref["whole"]["loss"]) / abs(ref["whole"]["loss"])
    held = {
        "update_vs_halves_worst": worst(errs), "tol": DIST_DP_TOL,
        "loss_rel_err_vs_halves": loss_halves,
        "loss_rel_err_vs_whole": loss_whole, "loss_tol": TOL_STEP_LOSS,
        "ranks_bit_equal": all(np.array_equal(trained[0][k], trained[1][k])
                               for k in ref["whole"]["params"]),
        "update_vs_whole_worst": worst(update_errs(trained[0], ref["whole"]["params"], initial)),
        "control_halves_vs_whole_worst": worst(update_errs(
            ref["halves"]["params"], ref["whole"]["params"], initial)),
        "children": [{k: c[k] for k in ("rank", "world", "backend", "device", "dp_multihost",
                                        "loss", "grad_norm", "shard", "imported_jax")}
                     for c in children],
        "one_process": {k: {"loss": v["loss"], "grad_norm": v["grad_norm"]}
                        for k, v in ref.items()},
        "seconds": dp_s,
    }
    held["ok"] = (held["update_vs_halves_worst"][1] <= DIST_DP_TOL
                  and loss_halves <= DIST_DP_TOL and loss_whole <= TOL_STEP_LOSS
                  and held["ranks_bit_equal"]
                  and all(c["dp_multihost"] and c["world"] == 2 and c["backend"] == "gloo"
                          and c["shard"] == n and not c["imported_jax"] for c in children))
    print(f"dist two-process DP (Gloo, one card, halves of {DIST_DP_BATCH}) vs one process, on "
          f"{card}:", json.dumps(held))
    checks.append(("dist two-process DP step vs one process's step over the same halves", held))

    spec = {"mode": "nccl", "backend": "nccl", "dir": os.path.join(tmp, "nccl"),
            "device": "cuda"}
    os.makedirs(spec["dir"], exist_ok=True)
    nccl = dist_children(spec, 1, tmp)[0]
    nccl["ok"] = (nccl["backend"] == "nccl" and nccl["world"] == 1
                  and nccl["all_reduce_sum"] == [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
                  and nccl["all_reduce_mean"] == {"a": [2.0, 2.0, 2.0], "b": 4.0})
    print("dist NCCL world of one:", json.dumps(nccl))
    checks.append(("dist NCCL starts and all-reduces", nccl))
    return checks, {"dp": held, "nccl": nccl}


def profile_dir_phase(card: str, tmp: str, sd_path: str, opts: tuple = ()) -> tuple:
    """One epoch of MaPLe through the command line (the cli phase's
    configuration, Synthetic, ViT-B/16) with ``TRAIN.PROFILE_DIR``: the
    trace it writes, and the port's kernels among its CUDA events."""
    trace_dir = os.path.join(tmp, "trace")
    opts = ["MODEL.BACKBONE.WEIGHTS_PATH", sd_path, "OPTIM.MAX_EPOCH", "1",
            "TRAIN.PROFILE_DIR", trace_dir, *opts]
    run = cli_run(cli_argv("MaPLe", CLI_MAPLE_YAML, os.path.join(tmp, "profiled"),
                           os.path.join(tmp, "profile-data"), opts), "MaPLe, TRAIN.PROFILE_DIR")
    files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")))
    names = []
    for path in files:
        with open(path) as f:
            names += [e.get("name", "") for e in json.load(f).get("traceEvents", [])
                      if e.get("cat") == "kernel"]
    want = ("attention_core", "attention_core_bwd", "gemm_epilogue", "layernorm_rows",
            "layernorm_bwd_rows", "column_sum")
    out = {"files": [os.path.basename(p) for p in files],
           "mb": [round(os.path.getsize(p) / 2 ** 20, 1) for p in files],
           "steps": len(run["steps"]),
           "port_kernel_events": {k: sum(short_name(n) == k or short_name(n).startswith(k + "<")
                                         for n in names) for k in want},
           "kernel_events": len(names)}
    out["ok"] = len(files) == 1 and all(out["port_kernel_events"].values())
    print(f"dist TRAIN.PROFILE_DIR, one epoch on {card}:", json.dumps(out))
    return [("dist TRAIN.PROFILE_DIR trace names the port's kernels", out)], out


def dist_phase(card: str, opts: tuple = (), sequential_profile: dict = None,
               backbone: str = "ViT-B/16", device: str = "cuda") -> tuple:
    """The distributed layer on the card. The card's machine has one card,
    so the parallel round loop runs as the JAX package runs it on one chip:
    ``FED.NUM_CLIENTS`` 1 on a ``{client: 1, data: 1}`` mesh.

    * ``--trainer MaPLeFederated`` through ``main`` with
      ``FED.PARALLEL_CLIENTS`` (``FED_YAML``, ViT-B/16 from a seeded
      OpenAI-format state dict, the fed phase's PatternNet stand-in, batch
      4, one round of one local epoch): the mesh line; every step's and
      ``test()``'s launches against the routing; FedAvg over the one
      client bit for bit its input; the round checkpoint read back bit for
      bit; the step, FedAvg, round and ``test()`` ms, the peak memory and a
      profiled step's idle share beside the fed phase's sequential step;
    * the same round under ``TPU.ATTENTION_IMPL xla``: the first loss within
      ``TOL_STEP_LOSS``, no kernel launched;
    * the round with a NaN planted in the stacked weights after the last
      step: the validity gate's per-client fallback reverts to the global
      weights;
    * the sequential loop resuming (``--resume``) from the parallel round's
      checkpoint, bit for bit, and training round 2;
    * :func:`remat_step_phase`, :func:`dist_dp_phase` and
      :func:`profile_dir_phase`.

    Returns ``(launches by kernel label of the parallel run, checks,
    summary)``."""
    import tempfile

    import torch

    from federated_multi_modal_tpu_torch.data.seeded_trees import write_seeded_tree
    from federated_multi_modal_tpu_torch.engine.checkpoint import load_checkpoint

    checks, summary = [], {"card": card}
    with tempfile.TemporaryDirectory(prefix="fmm_dist_") as tmp:
        sd_path = os.path.join(tmp, "vit_b16_openai_fp16.pt")
        summary["state_dict_write_s"] = write_openai_state_dict(sd_path)
        root = os.path.join(tmp, "data")
        for name, n in FED_PER_CLASS.items():
            write_seeded_tree(root, name, n, seed=0)

        def argv(out, *more, flags=()):
            return ["--root", root, "--seed", "1", "--trainer", "MaPLeFederated",
                    "--dataset-config-file", "configs/datasets/PatternNet.yaml",
                    "--config-file", FED_YAML, "--output-dir", os.path.join(tmp, out), *flags,
                    "MODEL.BACKBONE.WEIGHTS_PATH", sd_path, "FED.NUM_CLIENTS", str(DIST_CLIENTS),
                    "FED.NUM_ROUNDS", "1", "FED.LOCAL_EPOCHS", "1",
                    "FED.CHECKPOINT_EVERY_ROUND", "True", "FED.PARALLEL_CLIENTS", "True",
                    *opts, *more]

        def log_of(out):
            with open(os.path.join(tmp, out, "log.txt")) as f:
                return f.read()

        # -- the parallel round loop on the kernel routes -----------------------
        run = fed_run(argv("par"), "MaPLeFederated, parallel clients",
                      instrument=fedpar_instrumented)
        fed = run["trainer"]
        log = log_of("par")
        mesh_line = "[FED] parallel clients over mesh {'client': 1, 'data': 1}"
        checks.append(("dist parallel loop over the {client: 1, data: 1} mesh", {
            "ok": mesh_line in log and "falling back" not in log
            and fed.nan_stats == {"total_updates": 1, "failed_clients": [], "skipped_rounds": 0},
            "nan_stats": fed.nan_stats}))
        checks.append(("dist launches as the routing implies", fed_launches_held(run)))
        checks += [(f"dist {k} launched", {"ok": run["counts"][k] > 0}) for k in CLI_PATH_KERNELS]
        checks.append(("dist FedAvg over one client is its input bit for bit", {
            "ok": len(run["fedavg"]) == 1 and run["fedavg"][0]["bit_equal_to_input"]
            and run["fedavg"][0]["clients"] == 1, "fedavg": run["fedavg"]}))
        checks.append(("dist round checkpoint read back bit for bit", {
            "ok": len(run["round_checkpoints"]) == 1 and run["round_checkpoints"][0]["bit_equal"],
            "rounds": run["round_checkpoints"]}))
        steps = [s["ms"] for s in run["steps"]]
        step_fn, step_args = run["step_fn"], run["step_args"]
        par = {
            "mesh_line": mesh_line in log, "steps": len(steps), "batch": run["steps"][0]["batch"],
            "step_ms_median": statistics.median(steps[1:]), "step_ms_first": steps[0],
            "fedavg_ms": [a["ms"] for a in run["fedavg"]], "round_s": run["round_s"],
            "round_checkpoint_save_ms": [c["ms"] for c in run["round_checkpoints"]],
            "test_ms": [t["ms"] for t in run["tests"]], "peak_gib": run["peak_gib"],
            "first_loss": run["steps"][0]["loss"], "round_launches": run["round_launches"],
            "profile_step": profile_by_kernel(lambda: step_fn(*step_args),
                                              f"dist parallel step, C=1, B=4, on {card}"),
        }
        if sequential_profile:
            par["sequential_step_idle_share"] = sequential_profile["idle_share"]
        launches = run["counts"]
        ckpt_dir = os.path.join(tmp, "par")
        del fed, run, step_fn, step_args
        torch.cuda.empty_cache()

        # -- the same round on the plain formulation ------------------------------
        run = fed_run(argv("par-xla", "TPU.ATTENTION_IMPL", "xla"),
                      "MaPLeFederated, parallel clients, xla", instrument=fedpar_instrumented)
        rel = abs(par["first_loss"] - run["steps"][0]["loss"]) / abs(run["steps"][0]["loss"])
        loss_cmp = {"first_loss_rel_err": rel, "tol": TOL_STEP_LOSS, "ok": rel <= TOL_STEP_LOSS,
                    "kernel": par["first_loss"], "xla": run["steps"][0]["loss"]}
        checks.append(("dist first loss, kernel routes vs xla", loss_cmp))
        checks.append(("dist xla launches no kernel", {"ok": not nonzero(run["counts"])}))
        par["step_ms_median_xla"] = statistics.median(s["ms"] for s in run["steps"][1:])
        del run
        torch.cuda.empty_cache()

        # -- a NaN planted in the stacked weights ---------------------------------
        run = fed_run(argv("par-nan"), "MaPLeFederated, parallel clients, NaN planted",
                      instrument=lambda record: fedpar_instrumented(record, plant_nan=True))
        log = log_of("par-nan")
        reverted = load_checkpoint(os.path.join(
            tmp, "par-nan", "MultiModalPromptLearner_Aggregator", "model.pth.tar-round1"))
        reverted = reverted["state_dict"]
        trained = load_checkpoint(os.path.join(
            ckpt_dir, "MultiModalPromptLearner_Aggregator", "model.pth.tar-round1"))["state_dict"]
        planted = {
            "nan_stats": run["trainer"].nan_stats, "fedavg_runs": len(run.get("fedavg", [])),
            "logged": "Client 0 produced invalid weights, skipping aggregation" in log
            and "All clients failed! Reverting to previous global model." in log,
            "round_checkpoint_finite": all(np.isfinite(v).all() for v in reverted.values()),
            "reverted_differs_from_trained": any(
                not np.array_equal(reverted[k], trained[k]) for k in reverted)}
        planted["ok"] = (planted["nan_stats"] == {"total_updates": 0, "failed_clients": [],
                                                  "skipped_rounds": 1}
                         and planted["fedavg_runs"] == 0 and planted["logged"]
                         and planted["round_checkpoint_finite"]
                         and planted["reverted_differs_from_trained"])
        print("  dist planted NaN in the stacked weights:", json.dumps(planted))
        checks.append(("dist planted NaN caught by the validity gate", planted))
        del run
        torch.cuda.empty_cache()

        # -- the sequential loop resumes from the parallel round's checkpoint ------
        run = fed_run(argv("par-resumed", "FED.NUM_ROUNDS", "2", "FED.PARALLEL_CLIENTS", "False",
                           flags=("--resume", ckpt_dir)),
                      "MaPLeFederated, sequential, resumed from the parallel round",
                      instrument=fedpar_instrumented)
        rnd, resumed = run["resumed"]
        resume = {"round": rnd, "nan_stats": run["trainer"].nan_stats,
                  "bit_equal": resumed.keys() == trained.keys() and all(
                      resumed[k].dtype == trained[k].dtype and np.array_equal(resumed[k], trained[k])
                      for k in trained), "steps": len(run["steps"])}
        resume["ok"] = (rnd == 1 and resume["bit_equal"] and resume["steps"] > 0
                        and resume["nan_stats"]["total_updates"] == 1)
        print("  dist sequential resume from the parallel round:", json.dumps(resume))
        checks.append(("dist sequential loop resumes the parallel round bit for bit", resume))
        del run
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        remat_checks, summary["remat"] = remat_step_phase(card, backbone, device)
        summary["remat"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp_checks, summary["multiprocess"] = dist_dp_phase(card, tmp, sd_path, opts, device)
        summary["multiprocess"]["phase_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prof_checks, summary["profile_dir"] = profile_dir_phase(card, tmp, sd_path, opts)
        summary["profile_dir"]["phase_s"] = time.perf_counter() - t0
        checks += remat_checks + dp_checks + prof_checks

    summary.update(parallel=par, first_loss_vs_xla=loss_cmp, planted_nan=planted, resume=resume)
    p = par
    print(f"dist MaPLeFederated, parallel clients over {{client: 1, data: 1}}, batch 4, on "
          f"{card}: step {p['step_ms_median']:.2f} ms (median after the first; first "
          f"{p['step_ms_first']:.1f}; xla {p['step_ms_median_xla']:.2f}); FedAvg "
          f"{', '.join(f'{t:.3f}' for t in p['fedavg_ms'])} ms; round "
          f"{', '.join(f'{t:.2f}' for t in p['round_s'])} s; test() "
          f"{', '.join(f'{t:.1f}' for t in p['test_ms'])} ms; peak {p['peak_gib']:.2f} GiB; "
          f"profiled step idle share {p['profile_step']['idle_share']:.3f} (the fed phase's "
          f"sequential step: {p.get('sequential_step_idle_share', float('nan')):.3f})")
    return launches, checks, summary


def host_profile(fn, label: str, top: int = 12) -> dict:
    """One run of ``fn`` under the profiler's CPU activity: the host wall
    time, the share of it inside PyTorch operators (their self time), the
    operator calls and kernel launches the host made, and the ``top``
    operators by self time, printed. Where the device idles, this is where
    the host's time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    self_ms = {e.key: e.self_cpu_time_total / 1e3 for e in averages}
    calls = {e.key: e.count for e in averages}
    launches = sum(n for k, n in calls.items() if "LaunchKernel" in k)
    ops = sum(n for k, n in calls.items() if k.startswith("aten::"))
    in_ops = sum(v for k, v in self_ms.items() if k.startswith("aten::"))
    out = {"wall_ms": wall_ms, "aten_self_ms": in_ops, "aten_calls": ops,
           "kernel_launch_calls": launches,
           "top_self_ms": [[k, round(v, 3), calls[k]] for k, v in sorted(
               self_ms.items(), key=lambda kv: -kv[1])[:top]]}
    print(f"host of one {label}: wall {wall_ms:.2f} ms, {in_ops:.2f} ms in {ops} aten calls, "
          f"{launches} kernel-launch calls; top self ms [name, ms, calls]: "
          f"{json.dumps(out['top_self_ms'])}")
    return out


def native_build_error() -> str:
    from federated_multi_modal_tpu_torch import native

    return native.build_error.splitlines()[0] if native.build_error else ""


STEP_SWEEP_ROUTES = (("default", {}), ("unfused", {"FMM_TPU_FUSED": "0"}),
                     ("sublayer", {"FMM_TPU_FUSED_TRAIN": "1",
                                   "FMM_TPU_FUSED_TRAIN_BLOCK": "0"}))


def step_sweep(n_batches: int) -> None:
    """``--step-sweep N``: the whole 16-image step's gradient readings
    (max |err| over max |value| over the vision limit, worst leaf) on N
    batches per train route, of the kernel path and of the kernel path with
    its attention forward (K1, K2, and inside K3-K7) replaced by a PyTorch
    forward whose q.k or P.V sums, or both, are exact; each against the
    whole-step reference (the plain path with the exact forward), beside the
    control (the fully plain path against the same reference). Each variant
    trains its own state first, as the main run does. Prints; checks
    nothing."""
    import torch

    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block

    os.environ.update(DEFAULT_GATES)
    prog = build_maple_program(
        "ViT-B/16", classnames=[f"class {i}" for i in range(N_CLASSES)],
        n_ctx=2, depth=9, use_captions=True, seed=0)
    canvas = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (BATCH, 256, 256, 3), np.uint8)).cuda()
    variants = {"kernel": None, "exact forward": (True, True),
                "exact q.k": (True, False), "exact P.V": (False, True)}
    table = {}
    for name, exact in variants.items():
        with contextlib.ExitStack() as stack:
            if exact is not None:
                fwd = attention_forward_with(*exact)
                stack.enter_context(patched(k_attn, attention_core_cuda=fwd))
                stack.enter_context(patched(k_block, attention_core_cuda=fwd,
                                            CUDA_STEPS=k_block.CUDA_STEPS._replace(attention=fwd)))
            for route, env in STEP_SWEEP_ROUTES:
                with gates(**dict(DEFAULT_GATES, **env)):
                    run = drive_train(prog, canvas, {}, f" ({name}, {route})")
                    for _ in range(n_batches):
                        small = {k: v[:STEP_IMAGES] for k, v in run["make_batch"]().items()}
                        steps = {"path": step_loss_and_grads(
                            prog["loss_fn"], run["state"]["trainable"], prog["frozen"], small)}
                        for label, fwd in (("plain", None), ("reference", exact_attention_forward)):
                            with plain_path(fwd):
                                steps[label] = step_loss_and_grads(
                                    prog["loss_fn"], run["state"]["trainable"], prog["frozen"],
                                    small)
                        for label, (a, b) in (("path", ("path", "reference")),
                                              ("control", ("plain", "reference"))):
                            c = hold_step(steps[a], steps[b])
                            table.setdefault(f"{name} | {route} | {label}", []).append(
                                [round(c["vision"]["max_err_over_tol"], 3), c["vision"]["worst"]])
                    del run
                    torch.cuda.empty_cache()
    print("step sweep, vision max |err| over max |value| over its limit, per batch:",
          json.dumps(table))
    for key, readings in table.items():
        values = [r[0] for r in readings]
        print(f"  {key}: {min(values):.2f}-{max(values):.2f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--step-sweep"]:
        print(card_line())
        step_sweep(int(sys.argv[2]))
        return 0

    from federated_multi_modal_tpu_torch.engine.tree import merge_trees
    from federated_multi_modal_tpu_torch.flagship import build_maple_program
    from federated_multi_modal_tpu_torch.ops import primitives
    from federated_multi_modal_tpu_torch.ops.kernels import _build
    from federated_multi_modal_tpu_torch.ops.kernels import attention as k_attn
    from federated_multi_modal_tpu_torch.ops.kernels import fused_block as k_block
    from federated_multi_modal_tpu_torch.ops.preprocess import (
        center_boxes,
        crop_resize_flip_normalize,
    )

    # The main path runs under the JAX package's default gates, whatever the
    # environment says; each later phase sets its route's gates on top.
    os.environ.update(DEFAULT_GATES)
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
    attn_rec = overlay(k_attn, packed_attention_masked=cotangent_recorder(
        first, "k1", k_attn.packed_attention_masked))
    block_rec = overlay(k_block, fused_block_residual=cotangent_recorder(
        first, "k5", k_block.fused_block_residual))
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
    qkv, mask, n_head_t = first["k1"]["args"]
    k1_got = k_attn.packed_attention_masked(qkv, mask, n_head_t)
    k1_ref = k_attn.packed_attention_masked_reference(qkv, mask, n_head_t)
    k1_cmp = compare(k1_got, k1_ref, TOL_K1)
    print("K1 packed_attention_masked vs plain:", json.dumps(k1_cmp))
    with patched(k_attn, attention_core_cuda=fault_forward_mask_dropped(
            k_attn.attention_core_cuda)):
        k1_fault = compare(k_attn.packed_attention_masked(qkv, mask, n_head_t), k1_ref, TOL_K1)
    print("K1 planted fault (mask dropped in the forward), [max |err|, err/tol]:",
          json.dumps(brief({"K1": k1_fault})))

    x, blk, n_head_v = first["k5"]["args"]
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

    with patched(primitives, **plain_kernels()):
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
    k1_pass_ms = forward_variant_ms(qkv, n_head_t, mask, (2, 4, 0))
    print("K1 with one pass and two passes forced, ms:", json.dumps(k1_pass_ms))
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
    apply_prof = profile_by_kernel(crop_and_apply, "eval apply")

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
            "ms_by_passes": k1_pass_ms,
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
        "eval_apply_device_busy_ms": apply_prof["device_busy_ms"],
        "eval_apply_idle_share": apply_prof["idle_share"],
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
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary["text_unpacked"] = unpacked_text_step(prog, canvas, train_summary["train_step_ms"])
    summary["text_unpacked"]["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 9.-11. the JAX package's other routes ----------------------------------
    route_checks = []
    for key, phase, args in (
            ("unfused", unfused_phase, (prog, canvas, boxes, flips)),
            ("two_kernel_eval", two_kernel_eval_phase, (prog, canvas, boxes, flips)),
            ("sublayer_train", sublayer_train_phase, (prog, canvas))):
        t0 = time.perf_counter()
        phase_rows, phase_checks, phase_summary = phase(*args)
        rows += phase_rows
        route_checks += phase_checks
        summary[key] = dict(phase_summary, phase_s=time.perf_counter() - t0)
        torch.cuda.empty_cache()

    # -- 12.-15. K9 on MaPLe's eval, CoOp, zero-shot CLIP, K8 -------------------
    t0 = time.perf_counter()
    group_rows, group_checks, summary["group_eval"] = group_eval_phase(prog, canvas, boxes, flips)
    summary["group_eval"]["phase_s"] = time.perf_counter() - t0
    blk0 = merge_trees(tr, fr["model"])["clip"]["visual"]["blocks"][0]
    proto_args = ({k: t.detach() for k, t in blk0["ln_1"].items()},
                  blk0["attn"]["w_qkv"].detach(), blk0["attn"]["b_qkv"].detach())
    del prog, blk0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    coop_prog, coop_checks, summary["coop"] = coop_phase(canvas, boxes, flips)
    summary["coop"]["phase_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zs_k1, zs_checks, summary["zeroshot"] = zeroshot_phase(coop_prog, canvas, boxes, flips)
    summary["zeroshot"]["phase_s"] = time.perf_counter() - t0
    del coop_prog
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    k8_row, k8_checks = split_attention_phase(canvas.device)
    summary["split_attention_phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    # -- 16. the attention microbench and its prototypes P1-P3 ----------------
    t0 = time.perf_counter()
    proto_rows, proto_checks, summary["prototypes"] = prototype_phase(*proto_args, canvas.device)
    summary["prototypes"]["phase_s"] = time.perf_counter() - t0
    rows[0].update(
        launches_coop_step=summary["coop"]["train_nblk1"]["train_launches"][
            "K1 packed_attention_masked"],
        launches_zeroshot=summary["zeroshot"]["text_launches"]["K1 packed_attention_masked"],
        zeroshot_shape=zs_k1)
    rows += group_rows + [k8_row] + proto_rows
    torch.cuda.empty_cache()

    # -- 17. gemm_epilogue.cu by product --------------------------------------
    t0 = time.perf_counter()
    k3_row = next(r for r in rows if r["name"] == "fused_block_train")
    gemm_rows, gemm_checks, summary["gemm_products"] = gemm_product_phase(
        summary["train_launches"]["gemm_epilogue by product"], k3_row["shape"][0],
        k3_row["shape"][2], n_vis)
    summary["gemm_products"]["phase_s"] = time.perf_counter() - t0
    rows += gemm_rows
    torch.cuda.empty_cache()

    # -- 18. layernorm_bwd_rows.cu by instance, layernorm_rows, column_sum -----
    t0 = time.perf_counter()
    by_instance = "layernorm_bwd_rows by instance"
    train = summary["train_launches"]
    sublayer = summary["sublayer_train"]["train_launches"]
    drive = summary["prototypes"]["launches"]
    ln_rows, ln_checks, summary["layernorm_bwd"] = layernorm_bwd_phase({
        "default train step": (train[by_instance], train["K3 fused_block_train (backward)"]
                               + train["K4 fused_block_train_dw (backward)"]),
        "sublayer train step": (sublayer[by_instance],
                                sublayer["K7 fused_ln_attention (backward)"]),
        "microbench drive": (drive[by_instance], drive["P2 fused_lnqkv_attention_bwd_dx"])})
    summary["layernorm_bwd"]["phase_s"] = time.perf_counter() - t0
    rows += ln_rows
    torch.cuda.empty_cache()

    # -- 19. the port's training command line (the cli phase) -----------------
    t0 = time.perf_counter()
    cli_launches, cli_checks, summary["cli"] = cli_phase(card)
    summary["cli"]["phase_s"] = time.perf_counter() - t0
    for row in rows:
        launched = sum(n for label, n in cli_launches.items()
                       if label.split(" ")[1] == row["name"] and "(backward)" not in label)
        if launched:
            row.setdefault("paths", []).append("cli")
            row["launches_cli"] = launched
    torch.cuda.empty_cache()

    # -- 20. federated MaPLe through the command line (the fed phase) ---------
    t0 = time.perf_counter()
    fed_launches, fed_checks, summary["fed"] = fed_phase(card)
    summary["fed"]["phase_s"] = time.perf_counter() - t0
    for row in rows:
        launched = sum(n for label, n in fed_launches.items()
                       if label.split(" ")[1] == row["name"] and "(backward)" not in label)
        if launched:
            row.setdefault("paths", []).append("fed")
            row["launches_fed"] = launched
    torch.cuda.empty_cache()

    # -- 21. VPT, IVLP and CoCoOp base to novel (the b2n phase) ---------------
    t0 = time.perf_counter()
    b2n_launches, b2n_checks, summary["b2n"] = b2n_phase(card)
    summary["b2n"]["phase_s"] = time.perf_counter() - t0
    for row in rows:
        launched = sum(n for label, n in b2n_launches.items()
                       if label.split(" ")[1] == row["name"] and "(backward)" not in label)
        if launched:
            row.setdefault("paths", []).append("b2n")
            row["launches_b2n"] = launched
    torch.cuda.empty_cache()

    # -- 22. the ModifiedResNet backbones (the rn phase) ----------------------
    t0 = time.perf_counter()
    rn_launches, rn_checks, summary["rn"], rn_k1 = rn_phase(card)
    summary["rn"]["phase_s"] = time.perf_counter() - t0
    for row in rows:
        launched = sum(n for label, n in rn_launches.items()
                       if label.split(" ")[1] == row["name"] and "(backward)" not in label)
        if launched:
            row.setdefault("paths", []).append("rn")
            row["launches_rn"] = launched
    rows[0]["rn_text_shapes"] = rn_k1
    torch.cuda.empty_cache()

    # -- 23. the distributed layer (the dist phase) ---------------------------
    t0 = time.perf_counter()
    dist_launches, dist_checks, summary["dist"] = dist_phase(
        card, sequential_profile=summary["fed"]["profile_step"])
    summary["dist"]["phase_s"] = time.perf_counter() - t0
    for row in rows:
        launched = sum(n for label, n in dist_launches.items()
                       if label.split(" ")[1] == row["name"] and "(backward)" not in label)
        if launched:
            row.setdefault("paths", []).append("fedpar")
            row["launches_fedpar"] = launched
    summary["attention_resources"] = attention_resources(_build.build_log, rows)
    route_checks += (group_checks + coop_checks + zs_checks + k8_checks + proto_checks
                     + gemm_checks + ln_checks + cli_checks + fed_checks + b2n_checks
                     + rn_checks + dist_checks)
    summary["attention_forward"] = {
        r["name"]: {k: r.get(k) for k in ("ms", "library_ms", "bound_ms", "ms_by_passes")}
        for r in rows if r["name"] in ("packed_attention_masked", "packed_attention",
                                       "fused_lnqkv_attention")}
    print("attention forward (K1, K2, P1), ms beside the library call and the bound:",
          json.dumps(summary["attention_forward"]))
    print("summary:", json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": rows}))
    checks = [("K1", k1_cmp),
              ("K1 planted fault (mask dropped) caught", {"ok": not k1_fault["ok"]}),
              ("K5", k5_cmp), ("K5 seeded", k5s_cmp),
              ("K5 library yardstick", lib_cmp), ("end to end", e2e_cmp)]
    checks += train_checks + route_checks
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
