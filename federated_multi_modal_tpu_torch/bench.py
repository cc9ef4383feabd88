"""Benchmark of the port: MaPLe fine-tune throughput (images/sec/card) on one
NVIDIA GPU, the counterpart of the repository's root ``bench.py`` (which
stays the JAX package's benchmark).

    python -m federated_multi_modal_tpu_torch.bench [--mode train|eval|fed-step|loader|cocoop] ...

The same modes, flags, defaults and metric names as ``bench.py``, and the
same one JSON line on stdout, with two keys more: ``device`` (the card's
name, or ``"cpu"``) and ``power_limit_w`` (``nvidia-smi``'s, ``null`` on
the CPU). ``mfu`` divides by the H100's dense bf16 peak and is ``null`` on
the CPU. Every other line goes to stderr, each starting with ``#``: the
run's details, the kernel wrappers' launches in one step (``# launches:
{...}``; ``# launches_prepare: {...}`` for eval's text features), and under
``scan`` one replayed step held against the eager step from the same state
and the same crops (``# replay_vs_eager: {...}``).

The train step is everything the reference's ``forward_backward``
(``trainers/maple.py:547-627``) does per batch: crop, resize, flip and
normalize on the card from a uint8 canvas, both towers with MaPLe's deep
prompts and the caption token, cross-entropy plus the alignment loss, the
backward, the global-norm clip and SGD.

Dispatch modes:

* ``scan`` (default): the counterpart of ``bench.py``'s one ``lax.scan``.
  One whole step is captured in CUDA graphs and replayed ``--steps``
  times; each step draws fresh random-resized-crop boxes and flips on the
  card from a ``torch.Generator`` registered with the graphs
  (``sample_rrc_boxes_torch``), and copies its new state into the buffers
  the next replay reads, so the loop makes no host round trip. Over every
  visible card, as ``bench.py``'s scan is over every device: the train
  step's batch split over the cards where they divide it, the fed-step's
  two clients on a ``(client, data)`` mesh where their count is even; each
  card's share is a graph of its own, replayed on its own stream, and the
  home card's graphs take the mean and the update (``mesh.StepGraph``). A
  step that cannot be captured raises; nothing falls back to eager calls.
  On the CPU, run ``--dispatch python``.
* ``python``: one eager call a step, after ``--warmup`` of them; the train
  mode draws its boxes once on the host (``sample_rrc_boxes``), as
  ``bench.py``'s python mode does.

Baseline (BASELINE.md): the reference trains MaPLe on ImageNet 16-shot
(16,000 images) for 5 epochs in ~1 hour on one A100 => ~22.2 images/sec.
``vs_baseline`` is the multiple of that number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from federated_multi_modal_tpu_torch.config import get_cfg_default
from federated_multi_modal_tpu_torch.data.datum import Datum
from federated_multi_modal_tpu_torch.data.loader import DataLoader
from federated_multi_modal_tpu_torch.data.transforms import DeviceTransform
from federated_multi_modal_tpu_torch.device import resolve_device
from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.trainer import loss_grads_and_aux
from federated_multi_modal_tpu_torch.engine.tree import (
    flatten,
    leaves,
    to_device,
    tree_map_multi,
    tree_map_with_path,
)
from federated_multi_modal_tpu_torch.flagship import (
    build_fed_optimizer,
    build_maple_program,
    estimate_train_step_flops,
)
from federated_multi_modal_tpu_torch.models.clip_model import (
    encode_image,
    encode_text_embedded,
    set_text_pack,
)
from federated_multi_modal_tpu_torch.models.params import BACKBONE_CONFIGS, init_clip_params
from federated_multi_modal_tpu_torch.ops.kernels import counters
from federated_multi_modal_tpu_torch.ops.preprocess import (
    center_boxes,
    crop_resize_flip_normalize,
    sample_rrc_boxes,
    sample_rrc_boxes_torch,
)
from federated_multi_modal_tpu_torch.ops.primitives import l2_normalize, set_attention_impl
from federated_multi_modal_tpu_torch.parallel import (
    build_parallel_fed_step,
    fedavg_over_clients,
    stack_client_trees,
)
from federated_multi_modal_tpu_torch.parallel.mesh import (
    make_client_mesh,
    mean_over_devices,
    StepGraph,
    replicate,
    run_replicas,
    visible_devices,
)
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.trainers.common import (
    apply_linear,
    build_prompt_constants,
    linear_params,
)

A100_BASELINE_IPS = 16000 * 5 / 3600.0  # ~22.2 img/s (docs/RUN.md:8-10)

# NVIDIA H100 SXM data sheet: the dense bf16 tensor-core peak at the 700 W limit.
H100_BF16_PEAK_FLOPS = 989e12

PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the device and the line -----------------------------------------------------


def bench_device(platform: str) -> torch.device:
    """``default`` is the card (raises without CUDA); ``cpu`` runs every
    kernel's plain version on the CPU."""
    return resolve_device("cpu" if platform == "cpu" else None)


def card_fields(device: torch.device) -> dict:
    """``{"device", "power_limit_w"}``: the card's name and its power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` reads it (``None`` when
    it cannot be read), or ``"cpu"`` and ``None``."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.splitlines()
        line = out[device.index or 0]
        print(f"# card: {line.strip()}", file=sys.stderr)
        limit = float(line.split(",")[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        print(f"# nvidia-smi: power limit not read ({type(e).__name__}: {e})", file=sys.stderr)
    return {"device": torch.cuda.get_device_name(device), "power_limit_w": limit}


def _emit(card: dict, metric, ips, extra="", host_free=True, extra_fields=None):
    # As bench.py's: the A100 baseline rate INCLUDES dataloading (reference
    # docs/RUN.md:8-10), while every mode except ``loader`` measures a
    # host-free step loop; ``card`` names what ran the measurement.
    payload = {
        "metric": metric,
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / A100_BASELINE_IPS, 2),
        "baseline_includes_dataloading": True,
        "this_run_host_free": host_free,
        **card,
    }
    if extra_fields:
        payload.update(extra_fields)
    print(json.dumps(payload))
    sys.stdout.flush()
    if extra:
        print(f"# {extra}", file=sys.stderr)


def _info(label: str, value) -> None:
    print(f"# {label}: {json.dumps(value)}", file=sys.stderr)


def _peak(device) -> str:
    if device.type != "cuda":
        return ""
    return f" peak={torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f}GiB"


# -- the step loop: eager calls or a replayed CUDA graph ---------------------------


def _copy_into(dst, src) -> None:
    def copy(d, s):
        if d is not s:
            d.copy_(s)

    tree_map_multi(copy, dst, src)


def _clone(tree):
    return tree_map_multi(lambda t: t.detach().clone(), tree)


def held_bitwise(got, ref) -> dict:
    """Every leaf of ``got`` against ``ref``'s: whether all hold the same
    bits, the largest absolute difference and the leaf that has it."""
    got, ref = flatten({"state": got}), flatten({"state": ref})
    worst, worst_name = 0.0, None
    for name, g in got.items():
        r = ref[name]
        if g.dtype != r.dtype or g.shape != r.shape:
            return {"bit_for_bit": False, "max_abs_diff": None, "leaves": len(got),
                    "worst": f"{name}: {g.dtype} {tuple(g.shape)} against "
                             f"{r.dtype} {tuple(r.shape)}"}
        if torch.equal(g, r):
            continue
        diff = float((g.double() - r.double()).abs().nan_to_num(float("inf")).max())
        if worst_name is None or diff > worst:
            worst, worst_name = diff, name
    return {"bit_for_bit": worst_name is None, "max_abs_diff": worst, "leaves": len(got),
            "worst": worst_name}


def capture_step(step, state, generators=()):
    """One ``step(state, run) -> (new state, out)`` captured as CUDA graphs
    (``mesh.StepGraph``: one graph where the step runs on one card; where
    it spreads over several devices through ``run``, the eager step's
    ``mesh.run_replicas`` and the capture's ``StepGraph.replicas``, the home
    card's stretches and one graph a replica) whose every replay runs the
    step on ``state`` and copies the new state into it, so that each replay
    reads what the last one left. ``generators`` are the
    ``torch.Generator`` s the step draws from, registered with the graphs
    so that each replay draws new numbers. One eager step runs first on a
    side stream and its result is dropped: first-use set-up (the kernel
    library, cuBLAS handles, kernel attributes, the replicas' streams and
    frozen copies) happens outside the capture. Returns ``(graph, out,
    launches)``, ``launches`` the kernel wrappers' counts in the captured
    step, which every replay repeats. A step that cannot be captured raises
    ``RuntimeError`` saying why."""
    device = leaves(state)[0].device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step(state, run_replicas)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    graph = StepGraph(device, generators)
    counters.reset()

    def captured():
        new_state, out = step(state, graph.replicas)
        _copy_into(state, new_state)
        return out

    try:
        out = graph.capture(captured)
    except Exception as e:
        raise RuntimeError(
            f"--dispatch scan: the step cannot be captured in a CUDA graph "
            f"({type(e).__name__}: {e}); --dispatch python runs it eagerly") from e
    return graph, out, counters.read(nonzero=True)


def _recording_step(apply, draw):
    """``(step, drawn)``: ``step(state, run)`` applies ``apply`` to
    ``draw()`` (or ``()``) with ``run`` (what runs its replicas), keeping
    the latest draws in ``drawn["inputs"]``."""
    drawn = {}

    def step(state, run):
        drawn["inputs"] = draw() if draw is not None else ()
        return apply(state, drawn["inputs"], run)

    return step, drawn


def replay_vs_eager(apply, state, draw=None, generators=()):
    """One replay of the captured step held against the eager step from
    the same state with the same draws: ``(held_bitwise's record, the
    captured step's launches)``. The state is put back afterwards, and the
    graph and its memory pool go before the eager step runs, so that the
    check needs no more device memory than a run."""
    step, drawn = _recording_step(apply, draw)
    initial = _clone(state)
    graph, out, launches = capture_step(step, state, generators)
    graph.replay()
    replayed, inputs = _clone((state, out)), _clone(drawn["inputs"])
    del graph, out
    drawn.clear()
    gc.collect()
    torch.cuda.empty_cache()
    _copy_into(state, initial)
    return held_bitwise(replayed, apply(initial, inputs, run_replicas)), launches


def dispatch(apply, state, args, draw=None, generators=(), restart=False, finish=None):
    """Run ``apply(state, draw(), run) -> (state, out)`` as ``--dispatch`` says
    (``()`` in place of the draws when ``draw`` is ``None``) and time
    ``--steps`` of it on the host's clock, ended by reading the last
    ``out`` back (``bench.py``'s ``device_get``).

    ``python``: ``--warmup`` eager steps, then the timed ones. ``scan``:
    :func:`replay_vs_eager` (printed as ``replay_vs_eager``), then the step
    captured (:func:`capture_step`); the warm-up is one full run of
    ``--steps`` replays, synchronised; then the timed run. ``restart``: the
    timed run starts again from ``state`` as given (``bench.py``'s eval,
    whose scan carry starts anew in each call) rather than from where the
    warm-up left it. ``finish(state) -> state`` closes each run
    (``fed-step``'s FedAvg).

    Returns ``(state, out read back, seconds, launches)``, ``launches`` the
    kernel wrappers' counts in one step (the captured one, or the first
    eager one)."""
    step, _ = _recording_step(apply, draw)
    if args.dispatch == "python":
        first, launches, out = state, None, None
        counters.reset()
        for i in range(args.warmup):
            state, out = step(state, run_replicas)
            if i == 0:
                launches = counters.read(nonzero=True)
        if finish is not None and args.warmup:
            state = finish(state)
        if out is not None:
            out.tolist()
        if restart:
            state = first
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, out = step(state, run_replicas)
            if launches is None:
                launches = counters.read(nonzero=True)
        if finish is not None:
            state = finish(state)
        value = out.tolist()
        return state, value, time.perf_counter() - t0, launches

    held, launches = replay_vs_eager(apply, state, draw, generators)
    _info("replay_vs_eager", held)
    initial = _clone(state) if restart else None
    graph, out, _ = capture_step(step, state, generators)

    def run():
        for _ in range(args.steps):
            graph.replay()
        if finish is not None:
            _copy_into(state, finish(state))

    run()
    out.tolist()
    if restart:
        _copy_into(state, initial)
    t0 = time.perf_counter()
    run()
    value = out.tolist()
    return state, value, time.perf_counter() - t0, launches


# -- the train step ------------------------------------------------------------------


def data_parallel_grads(loss_fn, devices):
    """``grads(trainable, frozen, batch, run=run_replicas) -> (loss,
    grads)``: on one device the plain ones; over several (``bench.py``'s
    batch sharded along a ``data`` mesh), each device's share of the batch a
    replica of ``run`` (``mesh.run_replicas``, or a capture's
    ``StepGraph.replicas``) with the trees replicated to it, the losses and
    gradients averaged on the first device."""
    def grads(trainable, frozen, batch, run=run_replicas):
        if len(devices) == 1:
            return loss_grads_and_aux(loss_fn, trainable, frozen, batch)[:2]
        n, home = len(devices), devices[0]

        def work(d, x):
            return loss_grads_and_aux(loss_fn, x[0], replicate(frozen, d), x[1])[:2]

        outs = run(work, devices, [
            (trainable, tree_map_with_path(lambda _, x, j=j: x.chunk(n)[j], batch))
            for j in range(n)], home)
        return (mean_over_devices([o[0] for o in outs], home),
                mean_over_devices([o[1] for o in outs], home))

    return grads


def make_one_step(prog, tx, use_captions: bool, fwd_only: bool = False, devices=(None,)):
    """``bench.py``'s ``one_step(trainable, frozen, opt_state, canvas, boxes,
    flips, labels, caption_tokens) -> (trainable, opt_state, loss)``: the
    crop on the device, the loss and its gradients, the optimizer's update
    added to the parameters; ``fwd_only`` computes the loss alone (the
    towers on the train step's kernel routes, no autograd graph). Its
    keyword ``run`` runs the replicas over ``devices``
    (:func:`data_parallel_grads`)."""
    loss_fn = prog["loss_fn"]
    out_size = prog["arch"].image_resolution
    grads_fn = data_parallel_grads(loss_fn, list(devices))

    def one_step(trainable, frozen, opt_state, canvas, boxes, flips, labels, caption_tokens,
                 run=run_replicas):
        images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=out_size)
        batch = {"image": images, "label": labels}
        if use_captions:
            batch["caption_tokens"] = caption_tokens
        if fwd_only:
            # the trainable leaves marked as such pick the train step's
            # kernels (K4 for the last vision block)
            marked = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), trainable)
            with torch.no_grad():
                loss, _ = loss_fn(marked, frozen, batch)
            return trainable, opt_state, loss
        loss, grads = grads_fn(trainable, frozen, batch, run)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = tree_map_multi(lambda p, u: p + u, trainable, updates)
        return trainable, opt_state, loss

    return one_step


def measure_train(args, device):
    """The train mode's measurement: ``(primary_args for _emit, extra
    fields)``."""
    use_captions = not args.no_captions
    classnames = [f"class {i}" for i in range(args.n_cls)]
    prog = build_maple_program(backbone=args.backbone, classnames=classnames,
                               depth=args.depth, use_captions=use_captions,
                               remat=args.remat, device=device)
    # bench.py's build_optimizer(cfg.OPTIM) on the default config (SGD, momentum
    # 0.9, weight decay 5e-4) with MaPLe's trainer-level clip
    tx = build_optimizer(lr=0.0026, clip=1.0)
    opt_state = tx.init(prog["trainable"])

    rng = np.random.default_rng(0)
    B = args.batch_size
    canvas = torch.from_numpy(rng.integers(0, 255, (B, 256, 256, 3), np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, args.n_cls, B).astype(np.int32)).to(device)
    captions = torch.from_numpy(tokenize(["a satellite photo of a scene"] * B)).to(device)
    frozen = prog["frozen"]

    # data parallelism over every visible card: the batch split along axis
    # 0, the trees replicated; on one card n_dev is 1, and the metric stays
    # per card
    devices = visible_devices(device)
    n_dev = len(devices)
    if n_dev > 1 and B % n_dev == 0:
        print(f"# data-parallel over {n_dev} devices", file=sys.stderr)
    else:
        n_dev, devices = 1, [device]
    one_step = make_one_step(prog, tx, use_captions, args.fwd_only, devices)

    draw, generators, fixed = None, (), None
    if args.dispatch == "scan":
        # fresh boxes and flips on the card each step
        gen = torch.Generator(device=device).manual_seed(0)
        generators = (gen,)

        def draw():
            return sample_rrc_boxes_torch(gen, B)
    else:
        # boxes drawn once on the host, as bench.py's python mode does
        boxes_np, flips_np = sample_rrc_boxes(rng, B)
        fixed = (torch.from_numpy(boxes_np).to(device), torch.from_numpy(flips_np).to(device))

    def apply(state, drawn, run=run_replicas):
        trainable, opt = state
        boxes, flips = drawn or fixed
        trainable, opt, loss = one_step(trainable, frozen, opt, canvas, boxes, flips,
                                        labels, captions, run)
        return (trainable, opt), loss

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = (prog.pop("trainable"), opt_state)
    del opt_state
    _, loss_val, dt, launches = dispatch(apply, state, args, draw, generators)
    _info("launches", launches)
    if not np.isfinite(loss_val):
        raise FloatingPointError(f"train loss is not finite: {loss_val}")

    ips = args.steps * B / dt / n_dev
    primary_args = (
        "maple_train_images_per_sec_per_chip", ips,
        f"batch={B} n_cls={args.n_cls} steps={args.steps} "
        f"dispatch={args.dispatch} devices={n_dev} wall={dt:.2f}s "
        f"loss={loss_val:.4f} device={device}{_peak(device)}",
    )
    # step latency and MFU ride the line, as in bench.py; the MFU is the
    # H100's and is not written for a CPU run
    extra_fields = {}
    step_s = dt / args.steps
    extra_fields["train_step_ms"] = round(step_s * 1000, 2)
    step_flops = estimate_train_step_flops(
        prog["arch"], B, args.n_cls, prog["text_len"], use_captions=use_captions,
        n_vis_ctx=prog["n_ctx"], fwd_only=args.fwd_only)
    if step_flops is not None:
        extra_fields["step_tflops"] = round(step_flops / 1e12, 4)
        extra_fields["mfu"] = (round(step_flops / n_dev / step_s / H100_BF16_PEAK_FLOPS, 6)
                               if device.type == "cuda" else None)
    return primary_args, extra_fields


# -- eval --------------------------------------------------------------------------


def make_eval_step(prog, prep, boxes, flips, labels):
    """``bench.py``'s eval scan body, ``apply((correct, canvas), ()) ->
    ((correct, canvas), correct)``: the centre crops of the canvas through
    the prompt-cached apply, the correct predictions counted on the device,
    the canvas rolled by one image so that successive steps differ (on one
    device: ``run`` is not called)."""
    trainable, frozen = prog["trainable"], prog["frozen"]
    out_size = prog["arch"].image_resolution

    def apply(state, _, run=None):
        correct, canvas = state
        images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=out_size)
        logits = prog["eval_apply_fn"](trainable, frozen, images, prep)
        correct = correct + (logits.argmax(-1) == labels).sum(dtype=torch.int32)
        return (correct, torch.roll(canvas, 1, 0)), correct

    return apply


def measure_eval(args, device):
    """Eval throughput on the prompt-cached path: the text features once,
    then image batches against them (the reference recomputes the text
    tower per eval batch, ``trainers/maple.py:674``). Every federated
    round runs ``test()``. Returns ``(ips, info)``."""
    classnames = [f"class {i}" for i in range(args.n_cls)]
    prog = build_maple_program(backbone=args.backbone, classnames=classnames,
                               depth=args.depth, use_captions=False, device=device)
    out_size = prog["arch"].image_resolution
    B = args.batch_size
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 255, (B, 256, 256, 3), np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, args.n_cls, B).astype(np.int32)).to(device)
    boxes_np, flips_np = center_boxes(B, 256, out_size)
    boxes, flips = torch.from_numpy(boxes_np).to(device), torch.from_numpy(flips_np).to(device)

    counters.reset()
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    _info("launches_prepare", counters.read(nonzero=True))
    apply = make_eval_step(prog, prep, boxes, flips, labels)
    state = (torch.zeros((), dtype=torch.int32, device=device), canvas)
    _, correct, dt, launches = dispatch(apply, state, args, restart=True)
    _info("launches", launches)
    ips = args.steps * B / dt
    return ips, (
        f"mode=eval batch={B} n_cls={args.n_cls} steps={args.steps} "
        f"dispatch={args.dispatch} wall={dt:.2f}s correct={correct}{_peak(device)} "
        f"(vs_baseline is the multiple of the A100 TRAIN-step rate; the reference "
        f"publishes no eval rate)"
    )


def run_eval(args, device) -> int:
    ips, info = measure_eval(args, device)
    _emit(args.card, "maple_eval_images_per_sec_per_chip", ips, info)
    return 0


# -- the parallel federated step ---------------------------------------------------


def make_fed_loss(prog):
    """``bench.py``'s ``bench_loss``: the crop folded into the loss, so that
    ``build_parallel_fed_step`` (the non-finite gate, the one-client path)
    is what is measured."""
    loss_fn = prog["loss_fn"]
    out_size = prog["arch"].image_resolution

    def bench_loss(trainable, frozen, b):
        images = crop_resize_flip_normalize(b["canvas"], b["boxes"], b["flips"],
                                            out_size=out_size)
        bb = {"image": images, "label": b["label"]}
        if "caption_tokens" in b:
            bb["caption_tokens"] = b["caption_tokens"]
        return loss_fn(trainable, frozen, bb)

    return bench_loss


def measure_fed_step(args, device):
    """The parallel federated step: clients stacked along a leading axis,
    each taking one local SGD step a step on its row of the client mesh,
    FedAvg once at the end of a run (``MaPLeFederated._train_parallel``'s
    path). Returns ``(ips, info)``."""
    devices = visible_devices(device)
    n_dev = len(devices)
    n_clients = 2 if n_dev % 2 == 0 else 1
    mesh = make_client_mesh(n_clients, devices)
    classnames = [f"class {i}" for i in range(args.n_cls)]
    use_captions = not args.no_captions
    prog = build_maple_program(backbone=args.backbone, classnames=classnames,
                               depth=args.depth, use_captions=use_captions, device=device)
    tx = build_fed_optimizer()

    C = n_clients
    Bc = max(1, args.batch_size // C)
    trainable = prog.pop("trainable")
    stacked = stack_client_trees([trainable] * C)
    opt = stack_client_trees([tx.init(trainable)] * C)
    del trainable
    frozen = prog["frozen"]

    rng = np.random.default_rng(0)
    batch = {
        "canvas": torch.from_numpy(rng.integers(0, 255, (C, Bc, 256, 256, 3), np.uint8)),
        "label": torch.from_numpy(rng.integers(0, args.n_cls, (C, Bc)).astype(np.int32)),
    }
    if use_captions:
        cap = torch.from_numpy(tokenize(["a satellite photo of a scene"] * Bc))
        batch["caption_tokens"] = cap[None].expand(C, *cap.shape).clone()
    batch = {k: v.to(device) for k, v in batch.items()}
    fed_step = build_parallel_fed_step(make_fed_loss(prog), tx, mesh)
    gen = torch.Generator(device=device).manual_seed(0)

    def draw():
        return sample_rrc_boxes_torch(gen, C * Bc)

    def apply(state, drawn, run=run_replicas):
        boxes, flips = drawn
        b = dict(batch, boxes=boxes.reshape(C, Bc, 4), flips=flips.reshape(C, Bc))
        stacked, opt, losses = fed_step(state[0], frozen, state[1], b, run)
        return (stacked, opt), losses

    def finish(state):  # round-end FedAvg over the client axis
        return fedavg_over_clients(state[0]), state[1]

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, losses, dt, launches = dispatch(apply, (stacked, opt), args, draw, (gen,),
                                       finish=finish)
    _info("launches", launches)
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"fed-step losses are not finite: {losses}")
    ips = args.steps * C * Bc / dt / n_dev
    return ips, (
        f"mode=fed-step clients={C} per_client_batch={Bc} steps={args.steps} "
        f"dispatch={args.dispatch} devices={n_dev} wall={dt:.2f}s "
        f"losses={losses}{_peak(device)}"
    )


def run_fed_step(args, device) -> int:
    ips, info = measure_fed_step(args, device)
    _emit(args.card, "maple_fed_step_images_per_sec_per_chip", ips, info)
    return 0


# -- CoCoOp ------------------------------------------------------------------------


def init_cocoop(arch, n_cls: int, device, seed: int = 0):
    """``bench.py``'s CoCoOp state from a seed: ``(trainable, frozen,
    text_len)``, the CLIP weights under the dtype policy, 4 context vectors
    (``"X X X X"``) and the meta-net (``linear1`` embed -> embed // 16,
    ``linear2`` -> the text width)."""
    gen = torch.Generator().manual_seed(seed)
    clip_params = init_clip_params(arch, gen)
    n_ctx = 4
    classnames = [f"class {i}" for i in range(n_cls)]
    const = build_prompt_constants(clip_params["text"], classnames, "X X X X", n_ctx)
    ctx_dim, vis_dim = arch.transformer_width, arch.embed_dim
    trainable = {
        "ctx": torch.randn(n_ctx, ctx_dim, generator=gen) * 0.02,
        "meta_net": {"linear1": linear_params(gen, vis_dim, vis_dim // 16),
                     "linear2": linear_params(gen, vis_dim // 16, ctx_dim)},
    }
    frozen = {"clip": clip_params, "prefix": const.token_prefix,
              "suffix": const.token_suffix, "eot": const.eot_index}
    return to_device(trainable, device), to_device(frozen, device), const.text_len


def make_cocoop_loss(arch, text_len: int, loop: bool):
    """``bench.py``'s CoCoOp ``loss_fn(trainable, frozen, batch) -> (loss,
    {})``: each image's context (``ctx + meta_net(image feature)``) before
    every class name, the text features, the cross-entropy of the scaled
    cosine logits. Batched: one ``(B * n_cls)``-prompt text pass. ``loop``:
    one text pass per image (the reference's loop,
    ``trainers/cocoop.py:184-192``), each under ``torch.utils.checkpoint``
    as ``bench.py`` wraps it in ``jax.checkpoint``."""

    def per_image_text(frozen, ctx_shift_i):
        prefix, suffix = frozen["prefix"], frozen["suffix"]
        ctx_i = ctx_shift_i[None].to(prefix.dtype).expand(prefix.shape[0], *ctx_shift_i.shape)
        prompts = torch.cat([prefix, ctx_i, suffix], dim=1)
        txt = encode_text_embedded(frozen["clip"]["text"], arch, prompts, frozen["eot"],
                                   max_len=text_len)
        return l2_normalize(txt)

    def logits_fn(trainable, frozen, images):
        img = encode_image(frozen["clip"]["visual"], arch, images)
        img_n = l2_normalize(img)
        h = torch.relu(apply_linear(trainable["meta_net"]["linear1"], img_n))
        bias = apply_linear(trainable["meta_net"]["linear2"], h)
        ctx_shift = trainable["ctx"][None] + bias[:, None, :]  # (B, n_ctx, d)
        scale = torch.exp(frozen["clip"]["logit_scale"].float())
        if loop:
            txt_n = torch.stack([
                torch.utils.checkpoint.checkpoint(per_image_text, frozen, c,
                                                  use_reentrant=False)
                for c in ctx_shift])
            return scale * torch.einsum("bd,bcd->bc", img_n, txt_n)
        B = images.shape[0]
        prefix, suffix = frozen["prefix"], frozen["suffix"]
        n_cls, n_ctx, d = prefix.shape[0], ctx_shift.shape[1], ctx_shift.shape[2]
        ctx_b = ctx_shift[:, None].to(prefix.dtype).expand(B, n_cls, n_ctx, d)
        prompts = torch.cat([prefix[None].expand(B, *prefix.shape), ctx_b,
                             suffix[None].expand(B, *suffix.shape)], dim=2)
        prompts = prompts.reshape(B * n_cls, arch.context_length, d)
        txt = encode_text_embedded(frozen["clip"]["text"], arch, prompts,
                                   frozen["eot"].repeat(B), max_len=text_len)
        txt_n = l2_normalize(txt).reshape(B, n_cls, -1)
        return scale * torch.einsum("bd,bcd->bc", img_n, txt_n)

    def loss_fn(trainable, frozen, batch):
        logits = logits_fn(trainable, frozen, batch["image"])
        return torch.nn.functional.cross_entropy(logits, batch["label"].long()), {}

    return loss_fn


def make_cocoop_step(arch, tx, loss_fn, frozen, canvas, labels):
    """``bench.py``'s CoCoOp scan body: ``apply((trainable, opt_state),
    (boxes, flips)) -> ((trainable, opt_state), loss)`` (on one device:
    ``run`` is not called)."""
    def apply(state, drawn, run=None):
        trainable, opt_state = state
        boxes, flips = drawn
        images = crop_resize_flip_normalize(canvas, boxes, flips,
                                            out_size=arch.image_resolution)
        loss, grads, _ = loss_grads_and_aux(loss_fn, trainable, frozen,
                                            {"image": images, "label": labels})
        updates, opt_state = tx.update(grads, opt_state, trainable)
        trainable = tree_map_multi(lambda p, u: p + u, trainable, updates)
        return (trainable, opt_state), loss

    return apply


def run_cocoop(args, device) -> int:
    """CoCoOp training throughput: the reference's per-image text-encoder
    loop (``trainers/cocoop.py:184-192``, the bottleneck that forces its
    ``BATCH_SIZE: 1``) as one batched ``(B * n_cls)`` text pass;
    ``--cocoop-loop`` measures the loop (one text pass per image)."""
    arch = BACKBONE_CONFIGS[args.backbone]
    loop = bool(args.cocoop_loop)
    trainable, frozen, text_len = init_cocoop(arch, args.n_cls, device)
    tx = build_optimizer(lr=0.002)
    opt_state = tx.init(trainable)

    B = args.batch_size
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 255, (B, 256, 256, 3), np.uint8)).to(device)
    labels = torch.from_numpy(rng.integers(0, args.n_cls, B).astype(np.int32)).to(device)
    apply = make_cocoop_step(arch, tx, make_cocoop_loss(arch, text_len, loop), frozen,
                             canvas, labels)
    gen = torch.Generator(device=device).manual_seed(1)

    def draw():
        return sample_rrc_boxes_torch(gen, B)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _, loss_val, dt, launches = dispatch(apply, (trainable, opt_state), args, draw, (gen,))
    _info("launches", launches)
    if not np.isfinite(loss_val):
        raise FloatingPointError(f"cocoop loss is not finite: {loss_val}")
    ips = args.steps * B / dt
    name = "cocoop_loop" if loop else "cocoop"
    _emit(
        args.card, f"{name}_train_images_per_sec_per_chip", ips,
        f"mode=cocoop loop={loop} batch={B} n_cls={args.n_cls} steps={args.steps} "
        f"dispatch={args.dispatch} wall={dt:.2f}s loss={loss_val:.4f}{_peak(device)} "
        f"(vs_baseline is the multiple of the A100 MaPLe train rate; the reference's "
        f"CoCoOp configs force BATCH_SIZE 1 around this loop)",
    )
    return 0


# -- the input pipeline end to end -------------------------------------------------


def _ensure_jpeg_corpus(n_images: int, width: int, height: int) -> list:
    """``bench.py``'s synthetic JPEG corpus (low-frequency noise, so that
    decoding costs what a photo's does), written once under the temporary
    directory from seed 0; returns the file list."""
    from PIL import Image

    root = os.path.join(tempfile.gettempdir(), f"fmm_bench_jpegs_{width}x{height}_{n_images}")
    paths = [os.path.join(root, f"img_{i:05d}.jpg") for i in range(n_images)]
    if os.path.isdir(root) and all(os.path.exists(p) for p in paths):
        return paths
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    for p in paths:
        low = rng.integers(0, 255, (height // 16, width // 16, 3), np.uint8)
        img = Image.fromarray(low).resize((width, height), Image.BILINEAR)
        arr = np.asarray(img).astype(np.int16)
        arr = arr + rng.integers(-20, 20, arr.shape, np.int16)
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(p, quality=85)
    return paths


def run_loader(args, device) -> int:
    """End-to-end throughput with the real input pipeline: JPEGs on disk ->
    the native codec (Pillow where it is not built) -> the loader's
    prefetch thread -> the device -> the train step. This is the comparison
    with the A100 baseline, which included dataloading. Reports the
    steady-state epoch (canvases cached); stderr has the cold epoch (decode
    bound) and the host-only loader rate."""
    B = args.batch_size
    n_img = max(args.loader_images, 2 * B)
    paths = _ensure_jpeg_corpus(n_img, 500, 375)
    classnames = [f"class {i}" for i in range(args.n_cls)]
    data = [Datum(impath=p, label=i % args.n_cls, classname=classnames[i % args.n_cls])
            for i, p in enumerate(paths)]
    tfm = DeviceTransform(get_cfg_default(), is_train=True)
    print(f"# decoder: {'native codec' if tfm.native else 'Pillow'}", file=sys.stderr)
    loader = DataLoader(data, batch_size=B, transform=tfm, is_train=True,
                        sampler_type="RandomSampler")

    # the host-only decode rate, on a separate uncached loader so that the
    # main loader's first timed epoch is cold (decode bound)
    host_loader = DataLoader(data, batch_size=B, transform=tfm, is_train=True,
                             sampler_type="RandomSampler", cache_decoded=False)
    t0 = time.perf_counter()
    n_host = sum(len(b["label"]) for b in host_loader)
    host_ips = n_host / (time.perf_counter() - t0)

    prog = build_maple_program(backbone=args.backbone, classnames=classnames,
                               depth=args.depth, use_captions=False, device=device)
    tx = build_optimizer(lr=0.0026, clip=1.0)
    trainable, frozen = prog.pop("trainable"), prog["frozen"]
    opt_state = tx.init(trainable)
    step = make_one_step(prog, tx, use_captions=False)

    # bench.py compiles the step before timing, so that the cold epoch
    # measures decoding; here one step on a blank batch (its result
    # dropped) loads the kernels and sets up the device's libraries first
    S = tfm.canvas
    counters.reset()
    step(trainable, frozen, opt_state,
         torch.zeros((B, S, S, 3), dtype=torch.uint8, device=device),
         torch.tensor([[0.0, 0.0, S, S]] * B, device=device),
         torch.zeros(B, dtype=torch.bool, device=device),
         torch.zeros(B, dtype=torch.int32, device=device), None)[2].item()
    _info("launches", counters.read(nonzero=True))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    epochs, loss_val = {}, None
    for epoch in (1, 2):
        t0 = time.perf_counter()
        n = 0
        for b in loader:
            trainable, opt_state, loss = step(
                trainable, frozen, opt_state, torch.from_numpy(b["canvas"]).to(device),
                torch.from_numpy(b["box"]).to(device), torch.from_numpy(b["flip"]).to(device),
                torch.from_numpy(b["label"]).to(device), None)
            n += len(b["label"])
        loss_val = float(loss)  # synchronises the epoch
        epochs[epoch] = n / (time.perf_counter() - t0)
    if not np.isfinite(loss_val):
        raise FloatingPointError(f"loader loss is not finite: {loss_val}")
    # epoch 1 is cold (JPEG decoding in the loop); epoch 2 the steady state
    # (canvas cache warm, the device's step behind the loader thread)
    _emit(
        args.card, "maple_loader_e2e_images_per_sec_per_chip", epochs[2],
        f"mode=loader batch={B} images={n_img} host_only={host_ips:.1f} "
        f"cold_epoch={epochs[1]:.1f} steady={epochs[2]:.1f} img/s "
        f"loss={loss_val:.4f}{_peak(device)} (host decoding and the device's step "
        f"overlap through the prefetch thread)",
        host_free=False,
    )
    return 0


# -- the secondaries ---------------------------------------------------------------


def secondary_argv(mode: str, args) -> list:
    """The child's command line: every flag its mode reads, so that it
    measures the parent's configuration."""
    argv = [sys.executable, "-m", "federated_multi_modal_tpu_torch.bench", "--mode", mode,
            "--batch-size", str(args.batch_size), "--n-cls", str(args.n_cls),
            "--steps", str(args.steps), "--warmup", str(args.warmup),
            "--dispatch", args.dispatch, "--attention", args.attention,
            "--backbone", args.backbone, "--platform", args.platform,
            "--depth", str(args.depth)]
    if args.no_captions:
        argv.append("--no-captions")
    if args.no_pack:
        argv.append("--no-pack")
    return argv


def run_secondary(mode: str, args, timeout_s: float, children: list) -> float:
    """``--mode <mode>`` in a fresh process (its own device memory, as
    ``bench.py``'s secondaries): its one line's value. The child's ``#``
    lines are printed here under its mode. Raises when the child fails or
    prints other than one line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (PKG_PARENT, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(secondary_argv(mode, args), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    children.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        children.remove(proc)
    for line in err.splitlines():
        if line.startswith("# "):
            print(f"# {mode}: {line[2:]}", file=sys.stderr)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"{mode} subprocess rc={proc.returncode}, {len(lines)} JSON "
                           f"lines; stderr tail: {err[-300:]}")
    return json.loads(lines[0])["value"]


def run_train(args, device) -> int:
    primary_args, extra_fields = measure_train(args, device)
    # the train state is gone before the secondaries, each of which builds a
    # program of the same size in a fresh process
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if args.no_secondary:
        _emit(args.card, *primary_args, extra_fields=extra_fields)
        return 0

    # A wall-clock budget (FMM_BENCH_SECONDARY_BUDGET seconds) shared by the
    # phases, the cheap one first, each under SIGALRM; a watchdog thread
    # covers a stall that never returns to the interpreter by printing the
    # measured line and ending the process. A phase the budget leaves no
    # time for gets a "skipped" error field and the run exits 0; a phase
    # that fails gets its error field and the run exits 1.
    budget = int(os.environ.get("FMM_BENCH_SECONDARY_BUDGET", "600"))
    deadline = time.time() + budget
    # one line, printed once: the watchdog and the main thread both go
    # through this test-and-set, and the fields are read under its lock
    emit_lock = threading.Lock()
    emitted = [False]
    children, failed, infos = [], [], []

    def emit_line_once(error=None):
        with emit_lock:
            if emitted[0]:
                return
            emitted[0] = True
            fields = dict(extra_fields)
            if error:
                fields["secondary_error"] = error
            _emit(args.card, *primary_args, extra_fields=fields)

    def watchdog_fire():
        for proc in list(children):
            proc.kill()
        emit_line_once("watchdog: hard stall in secondary measurement (uninterruptible)")
        sys.stdout.flush()
        os._exit(1)

    watchdog = threading.Timer(budget + 90, watchdog_fire)
    watchdog.daemon = True
    watchdog.start()

    def guarded(name, mode):
        remaining = int(deadline - time.time())
        if remaining <= 0:
            extra_fields[f"{name}_error"] = f"skipped: {budget}s secondary budget exhausted"
            return None

        def alarm(signum, frame):
            raise TimeoutError(f"exceeded secondary budget ({remaining}s of the shared "
                               f"{budget}s remained when this phase started)")

        old_handler = signal.signal(signal.SIGALRM, alarm)
        signal.alarm(remaining)
        try:
            value = run_secondary(mode, args, max(30, remaining), children)
            infos.append(f"{mode}: measured in a fresh subprocess")
            return value
        except Exception as e:  # the line still carries the measured train number
            extra_fields[f"{name}_error"] = f"{type(e).__name__}: {e}"
            failed.append(name)
            return None
        finally:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_handler)

    value = guarded("fed_step", "fed-step")
    if value is not None:
        extra_fields["fed_step_images_per_sec"] = round(value, 2)
    value = guarded("eval", "eval")
    if value is not None:
        extra_fields["eval_images_per_sec"] = round(value, 2)
    watchdog.cancel()
    emit_line_once()
    for info in infos:
        print(f"# {info}", file=sys.stderr)
    return 1 if failed else 0


# -- the command line --------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m federated_multi_modal_tpu_torch.bench",
        description="MaPLe throughput of the port on one card, with bench.py's modes "
                    "and flags")
    # the defaults mirror the baseline workload: the A100 number was
    # measured on ImageNet (1000 classes)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--n-cls", type=int, default=1000)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--no-captions", action="store_true")
    parser.add_argument("--depth", type=int, default=9)
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block in the backward (bigger batches)")
    parser.add_argument("--attention", choices=["xla", "pallas"], default="pallas",
                        help="pallas = the hand-written kernels' routes; xla = plain "
                             "PyTorch, no kernel (set_attention_impl)")
    parser.add_argument("--dispatch", choices=["scan", "python"], default="scan",
                        help="scan = one step captured in a CUDA graph and replayed; "
                             "python = one eager call a step")
    parser.add_argument("--warmup", type=int, default=5,
                        help="warm-up steps (python mode only; scan mode warms up with "
                             "one full run of the replays)")
    parser.add_argument("--backbone", default="ViT-B/16",
                        help="backbone catalog entry (Tiny for CI-scale runs)")
    parser.add_argument("--platform", choices=["default", "cpu"], default="default",
                        help="default = the card (raises without CUDA); cpu = the "
                             "kernels' plain versions on the CPU")
    parser.add_argument("--mode", choices=["train", "eval", "fed-step", "loader", "cocoop"],
                        default="train",
                        help="train = the train step; eval = the prompt-cached eval "
                             "path; fed-step = the parallel federated step; loader = "
                             "end to end with the input pipeline (JPEG corpus -> codec "
                             "-> prefetch -> device); cocoop = the batched "
                             "conditional-prompt trainer")
    parser.add_argument("--loader-images", type=int, default=2048,
                        help="synthetic JPEG corpus size for --mode loader")
    parser.add_argument("--cocoop-loop", action="store_true",
                        help="cocoop mode: the reference's per-image text loop instead "
                             "of the batched pass")
    parser.add_argument("--no-pack", action="store_true",
                        help="turn text-tower sequence packing off (set_text_pack)")
    parser.add_argument("--fwd-only", action="store_true",
                        help="train mode: the loss only (no gradient or update), to "
                             "split forward from backward cost")
    parser.add_argument("--no-secondary", action="store_true",
                        help="train mode: skip the eval and fed-step measurements that "
                             "otherwise ride the JSON line as extra fields")
    return parser


def main(argv=None) -> int:
    """Run one mode and print its line; returns the exit code. Sets the
    process's attention implementation and text packing from the flags."""
    args = build_parser().parse_args(argv)
    device = bench_device(args.platform)
    if args.dispatch == "scan" and device.type != "cuda" and args.mode != "loader":
        raise ValueError("--dispatch scan replays a CUDA graph and needs the card; on the "
                         "CPU run --dispatch python")
    # bench.py's persistent JAX compilation cache has no counterpart: the
    # kernels are compiled once into the package's build directory, keyed by
    # a hash of their sources (ops/kernels/_build.py), and nothing else is
    # compiled
    args.card = card_fields(device)
    set_attention_impl(args.attention)
    set_text_pack(not args.no_pack)
    runs = {"eval": run_eval, "fed-step": run_fed_step, "loader": run_loader,
            "cocoop": run_cocoop, "train": run_train}
    return runs[args.mode](args, device)


if __name__ == "__main__":
    sys.exit(main())
