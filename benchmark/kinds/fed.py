"""Federated cells: MaPLe clients in lockstep, a card each, with FedAvg.

The mix names ``clients``, their ``mesh`` (``(clients, 1)``: a client a card),
``fedavg_every`` (local steps a round) and ``train``'s crop parameters; each
client's canvas, labels, captions and crops are its own, made from the seed
and its index, and live on the client's card, where its crops are drawn
inside its replica of the step (its boxes, ``B x 4`` numbers, are drawn on
the first card, whose graphs alone may draw random numbers, and copied).
The program is driven as ``trainers/maple_fed.py`` drives its parallel
rounds: one ``parallel/fedavg.py::build_parallel_fed_step`` over
``parallel/mesh.py::make_client_mesh`` (every client's local SGD step, each
on its card, the stacked state and the updates on the first), and
``fedavg_over_clients`` at a round's end, after which the optimizer starts
afresh. Both are captured once (``bench.capture_step``: the local step over
every card, the average on the first) and replayed: a round is
``fedavg_every`` local replays and one average. The window covers whole
rounds; ``train_images_per_s`` counts every client's images of its local
steps, and the trace's ``steps`` are the local steps.

Set-up drives the first ``CHECK_STEPS`` local steps and one average and keeps,
per client, what ``benchmark/kinds/train.py`` keeps, and each client's state
before the average. After the window each client's steps are taken by the
plain reference from the same weights on that client's crops
(``grad_gap``, ``change_gap``: the worst client), and ``fedavg_gap`` holds
every client's state after the program's average to the float32 mean of
the four states it averaged: the widest gap of any client's leaf, against
the larger of the mean's change since the start and the median leaf's.
"""

from __future__ import annotations

import math
import statistics

import torch

from benchmark import checks, window
from benchmark.kinds import common
from benchmark.kinds.train import reference_steps
from benchmark.traffic import generator
from federated_multi_modal_tpu_torch.bench import capture_step
from federated_multi_modal_tpu_torch.engine.tree import leaves, tree_map_with_path
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.parallel.fedavg import (
    build_parallel_fed_step,
    fedavg_over_clients,
    stack_client_trees,
)
from federated_multi_modal_tpu_torch.parallel.mesh import make_client_mesh

CHECK_STEPS = 3


def client_seed(seed: int, c: int) -> int:
    return seed * 8 + c + 1


def _client(tree, c):
    return tree_map_with_path(lambda _, x: x[c], tree)


def _as_train(mix: dict) -> dict:
    """The mix as the train counts read it (one client's batch)."""
    return dict(mix, kind="train")


class Rounds:
    """The local step and the average over one state: on the card each captured
    once and replayed on the same tensors, on the CPU (tests) eager calls."""

    def __init__(self, local, average, state, generators):
        self.local_fn, self.average_fn, self.state = local, average, state
        self.graphs = None
        if leaves(state)[0].device.type == "cuda":
            g_local, self.out, _ = capture_step(local, state, generators)
            g_avg, _, _ = capture_step(average, state)
            self.graphs = (g_local, g_avg)

    def local(self):
        if self.graphs is not None:
            self.graphs[0].replay()
        else:
            self.state, self.out = self.local_fn(self.state)
        return self.out

    def average(self):
        if self.graphs is not None:
            self.graphs[1].replay()
        else:
            self.state, _ = self.average_fn(self.state)


def setup(cfg, mix, arch, seed, devices):
    """``(rounds, program, per-client inputs, use_captions)``: the program
    built on the first device, its local step and average captured; each
    client's inputs on its card."""
    C, home = mix["clients"], devices[0]
    system = arch.system
    system.build_kernels(home)
    mesh = make_client_mesh(C, devices)
    if tuple(mesh.devices.shape) != tuple(mix["mesh"]):
        raise ValueError(f"mesh {tuple(mesh.devices.shape)} on {len(devices)} devices, "
                         f"the mix asks for {tuple(mix['mesh'])}")
    cards = [torch.device(d) for d in mesh.devices.reshape(C, -1)[:, 0]]
    use_captions = bool(mix.get("captions") and cfg["maple"]["use_captions"])
    prog = system.build(arch.state_dict(cfg, seed, home),
                        arch.prompt_learner(cfg, use_captions, seed, home), cfg,
                        common.classnames(cfg), use_captions, home)
    inputs = [generator.make_inputs(mix, cfg["n_classes"], client_seed(seed, c), cards[c])
              for c in range(C)]
    gens = [generator.box_generator(client_seed(seed, c), home) for c in range(C)]
    tx = system.optimizer(cfg)
    out = cfg["image_resolution"]
    loss_fn = prog["loss_fn"]

    def crop_and_loss(trainable, frozen, batch):
        images = crop_resize_flip_normalize(batch["canvas"], batch["boxes"], batch["flips"], out)
        return loss_fn(trainable, frozen, dict(
            {k: v for k, v in batch.items() if k not in ("canvas", "boxes", "flips")},
            image=images))

    fed_step = build_parallel_fed_step(crop_and_loss, tx, mesh)
    frozen = prog["frozen"]

    def local(state, run=None):
        stacked, opt, bad = state
        drawn = [generator.random_resized_boxes(g, mix) for g in gens]
        batch = []
        for i, (b, f) in zip(inputs, drawn):
            batch.append({"canvas": i["canvas"], "boxes": b, "flips": f, "label": i["labels"]})
            if use_captions:
                batch[-1]["caption_tokens"] = i["captions"]
        kw = {} if run is None else {"run": run}
        stacked, opt, losses = fed_step(stacked, frozen, opt, batch, **kw)
        bad = bad + (~torch.isfinite(losses)).sum(dtype=bad.dtype)
        return (stacked, opt, bad), (losses, torch.stack([b for b, _ in drawn]),
                                     torch.stack([f for _, f in drawn]))

    def average(state, run=None):
        stacked, opt, bad = state
        opt = dict(opt, trace=tree_map_with_path(lambda _, t: torch.zeros_like(t), opt["trace"]))
        return (fedavg_over_clients(stacked), opt, bad), ()

    trainable = prog["trainable"]
    state = (stack_client_trees([trainable] * C), stack_client_trees([tx.init(trainable)] * C),
             torch.zeros((), dtype=torch.int32, device=home))
    return Rounds(local, average, state, gens), prog, inputs, use_captions


def _client_state(state, c):
    return (_client(state[0], c), _client(state[1], c), state[2])


def first_steps(rounds, system, cfg, C):
    """The first local steps and an average, as ``train.program_steps`` keeps
    them per client, and ``(states before the average, each client's after
    it, client 0's at the start)``."""
    wd = cfg["optim"]["weight_decay"]

    def flat(c):
        return {k: v.detach().clone() for k, v in
                system.trainable_flat(_client_state(rounds.state, c)).items()}

    p0 = [flat(c) for c in range(C)]
    recs = [{"losses": [], "gnorms": [], "boxes": [], "flips": []} for _ in range(C)]
    for k in range(CHECK_STEPS):
        losses, boxes, flips = rounds.local()
        for c, rec in enumerate(recs):
            rec["losses"].append(float(losses[c]))
            rec["gnorms"].append(math.nan)  # the fed step returns no gradient norm
            rec["boxes"].append(boxes[c].clone())
            rec["flips"].append(flips[c].clone())
            if k == 0:
                trace = system.trace_flat(_client_state(rounds.state, c))
                rec["grad"] = checks.norms({n: t - wd * p0[c][n] for n, t in trace.items()})
    before = [flat(c) for c in range(C)]
    for c, rec in enumerate(recs):
        rec["change"] = checks.norms({n: v - p0[c][n] for n, v in before[c].items()})
    rounds.average()
    return recs, (before, [flat(c) for c in range(C)], p0[0])


def fedavg_gap(averaged: list, states: list, start: dict) -> tuple:
    """``(gap, where)``: the widest gap between a client's state after the
    program's average (``averaged``, one per client) and the float32 mean
    of ``states`` (summed in client order, times the reciprocal of their
    count), against the larger of the mean's change since ``start`` and the
    median leaf's."""
    gaps, moved = {}, {}
    for k in averaged[0]:
        total = states[0][k].float()
        for s in states[1:]:
            total = total + s[k].float()
        mean = (total * (1.0 / len(states))).double()
        moved[k] = float(torch.linalg.vector_norm(mean - start[k].double()))
        for c, avg in enumerate(averaged):
            gaps[c, k] = float(torch.linalg.vector_norm(avg[k].double() - mean))
    floor = statistics.median(moved.values())
    worst, at = 0.0, None
    for (c, k), g in gaps.items():
        gap = g / max(moved[k], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, f"client {c}: {k}"
        if gap >= worst:
            worst, at = gap, f"client {c}: {k}"
    return worst, at


def _references(cfg, mix, arch, seed, device, inputs, recs, use_captions, quant=False,
                take=None):
    rows = arch.reference_rows(cfg, mix, device)
    out = []
    for inp, rec in zip(inputs, recs):
        inp = {k: v.to(device) for k, v in inp.items()}
        ref = common.reference_model(cfg, arch, seed, device, use_captions, quant=quant)
        out.append(reference_steps(ref, arch, inp, rec, cfg["image_resolution"], rows, take))
        del ref
        common.release(device)
    return out


def _worst(recs, refs) -> dict:
    """``grad_gap`` and ``change_gap``, the worst client's, with the client
    named beside the leaf."""
    out = {}
    for c, (rec, ref) in enumerate(zip(recs, refs)):
        nums = checks.train_numbers(rec, ref)
        for name in ("loss_gap", "grad_gap", "change_gap"):
            value, at = nums[name]
            if name not in out or not value <= out[name][0]:
                out[name] = (value, f"client {c}" + (f": {at}" if at else ""))
    return out


def run(cfg, mix, arch, seed, seconds, trace, devices, start, limits) -> dict:
    home, C, every = devices[0], mix["clients"], mix["fedavg_every"]
    rounds, prog, inputs, use_captions = setup(cfg, mix, arch, seed, devices)
    recs, (before, averaged, p0) = first_steps(rounds, arch.system, cfg, C)
    window.sync(home)
    bad_before = int(rounds.state[2])
    setup_s = common.elapsed(start)

    def one_round():
        for _ in range(every):
            rounds.local()
        rounds.average()

    n_rounds, window_s, prof = window.run(one_round, seconds, home, trace)
    steps = n_rounds * every
    B = mix["batch"]
    failed = (int(rounds.state[2]) - bad_before) * B
    last_losses = rounds.out[0].float().cpu()
    peak = max(common.peak_bytes(d) for d in devices)
    text_len = prog["text_len"]
    res = {"attempted": steps * B * C, "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {"train_images_per_s": steps * B * C / window_s,
                          "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if prof is not None:
        from benchmark.devtrace import Trace

        tm = _as_train(mix)
        res["trace"] = Trace(prof, "train", steps, C * arch.train_step_flops(cfg, tm, text_len),
                             {"attention": arch.attention_work(cfg, tm, text_len) * C,
                              "gemm": arch.gemm_work(cfg, tm, text_len) * C}, len(devices))
        del prof
    del rounds, prog
    common.release(home)

    refs = _references(cfg, mix, arch, seed, home, inputs, recs, use_captions)
    numbers = _worst(recs, refs)
    numbers["fedavg_gap"] = fedavg_gap(averaged, before, p0)
    ok, res["checks"] = checks.judge(numbers, limits)
    res["correct"] = bool(ok and failed == 0 and bool(torch.isfinite(last_losses).all()))
    return res


def readings(cfg, mix, arch, seed, devices, controls: bool) -> dict:
    """The compared numbers with no window (``program``); with ``controls``
    the float8 reference in the program's place (``control``), the
    reference's loss over half of each batch (``half_batch``), and the
    average with the last client's state left out of the exchange
    (``left_out``, for ``fedavg_gap``); each the worst client's, and under
    ``by_client`` each client's."""
    home, C = devices[0], mix["clients"]
    rounds, prog, inputs, use_captions = setup(cfg, mix, arch, seed, devices)
    recs, (before, averaged, p0) = first_steps(rounds, arch.system, cfg, C)
    del rounds, prog
    common.release(home)
    refs = _references(cfg, mix, arch, seed, home, inputs, recs, use_captions)

    by_client = {}

    def against(name, got):
        by_client[name] = [{k: v[0] for k, v in checks.train_numbers(g, ref).items()}
                           for g, ref in zip(got, refs)]
        return {k: v[0] for k, v in _worst(got, refs).items()}

    out = {"program": dict(against("program", recs),
                           fedavg_gap=fedavg_gap(averaged, before, p0)[0])}
    if controls:
        out["control"] = against("control", _references(cfg, mix, arch, seed, home, inputs,
                                                        recs, use_captions, quant=True))
        half = torch.arange(mix["batch"] // 2, device=home)
        out["half_batch"] = against("half_batch", _references(
            cfg, mix, arch, seed, home, inputs, recs, use_captions, take=half))
        left_out = {k: sum(s[k] for s in before[:-1]) / (C - 1) for k in averaged[0]}
        out["left_out"] = {"fedavg_gap": fedavg_gap([left_out] * C, before, p0)[0]}
    out["by_client"] = by_client
    return out
