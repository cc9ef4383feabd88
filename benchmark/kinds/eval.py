"""Eval cells: a closed loop of the program's captured prompt-cached eval.

Set-up makes the text features once (``eval_prepare_fn``, as a round's
``test()`` does), captures the image batch (centre crops through
``eval_apply_fn``, the canvas moved on after each batch) and replays it
``WARM`` times. The window keeps a copy of the logits of the batches the
seed picks and of its last batch; once it has closed and the program is
freed, the reference computes the same batches' logits. The cell's first
device runs it all.
"""

from __future__ import annotations

import torch

from benchmark import checks, window
from benchmark.kinds import common
from benchmark.traffic import generator

WARM = 3


def warmed(cfg, mix, arch, seed, device):
    """The program built from the seed, its batch captured and replayed
    ``WARM`` times: ``(runner, program, inputs, boxes, flips)``."""
    system, prog, inputs = common.setup(cfg, mix, arch, seed, device, use_captions=False)
    boxes, flips = generator.center_boxes(mix, device)
    step, state = system.eval_step(prog, inputs, boxes, flips, mix["roll"])
    runner = system.Runner(step, state)
    for _ in range(WARM):
        runner()
    return runner, prog, inputs, boxes, flips


def widest_gap(ref, arch, saved: dict, inputs, boxes, flips, cfg, mix, rows) -> tuple:
    """``(gap, where)``: the widest logit gap of the saved batches (by their
    replay's index) against ``ref``'s logits of the same images."""
    worst, at = 0.0, None
    for a, got in sorted(saved.items()):
        canvas = torch.roll(inputs["canvas"], a * mix["roll"], 0)
        want = ref.logits(arch.crop(canvas, boxes, flips, cfg["image_resolution"]), rows)
        gap = checks.logit_gap(got, want.cpu())
        if gap >= worst:
            worst, at = gap, f"batch {a}"
    return worst, at


def run(cfg, mix, arch, seed, seconds, trace, devices, start, limits) -> dict:
    device = devices[0]
    runner, prog, inputs, boxes, flips = warmed(cfg, mix, arch, seed, device)
    window.sync(device)
    bad_before = int(runner.state[1])
    setup_s = common.elapsed(start)

    picks = {WARM + p for p in generator.eval_picks(mix, seed)}
    saved = {}

    def keep(i):
        if WARM + i in picks:
            saved[WARM + i] = runner.out.clone()

    steps, window_s, prof = window.run(runner, seconds, device, trace, after_step=keep)
    saved[WARM + steps - 1] = runner.out.clone()
    B = mix["batch"]
    failed = int(runner.state[1]) - bad_before
    peak = common.peak_bytes(device)
    text_len = prog["text_len"]
    res = {"attempted": steps * B, "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {"eval_images_per_s": steps * B / window_s,
                          "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if prof is not None:
        from benchmark.devtrace import Trace

        res["trace"] = Trace(prof, "eval", steps, arch.eval_batch_flops(cfg, mix, text_len),
                             {"attention": arch.attention_work(cfg, mix, text_len),
                              "gemm": arch.gemm_work(cfg, mix, text_len)}, len(devices))
        del prof
    saved = {a: t.cpu() for a, t in saved.items()}
    del runner, prog
    common.release(device)

    ref = common.reference_model(cfg, arch, seed, device, use_captions=False)
    gap = widest_gap(ref, arch, saved, inputs, boxes, flips, cfg, mix,
                     arch.reference_rows(cfg, mix, device))
    ok, res["checks"] = checks.judge({"logit_gap": gap}, limits)
    res["correct"] = bool(ok and failed == 0)
    return res


def readings(cfg, mix, arch, seed, devices, controls: bool) -> dict:
    """The numbers a run compares, with no window: the program's logits of
    the batches the seed picks against the reference (``program``); with
    ``controls`` the reference on float8 operands in the program's place
    (``control``)."""
    device = devices[0]
    runner, prog, inputs, boxes, flips = warmed(cfg, mix, arch, seed, device)
    picks = {WARM + p for p in generator.eval_picks(mix, seed)}
    saved = {}
    for a in range(WARM, max(picks) + 1):
        out = runner()
        if a in picks:
            saved[a] = out.clone().cpu()
    del runner, prog
    common.release(device)
    rows = arch.reference_rows(cfg, mix, device)
    ref = common.reference_model(cfg, arch, seed, device, use_captions=False)

    def gap(got):
        return {"logit_gap": widest_gap(ref, arch, got, inputs, boxes, flips, cfg, mix,
                                        rows)[0]}

    out = {"program": gap(saved)}
    if controls:
        fp8 = common.reference_model(cfg, arch, seed, device, use_captions=False, quant=True)
        out["control"] = gap({a: fp8.logits(arch.crop(
            torch.roll(inputs["canvas"], a * mix["roll"], 0), boxes, flips,
            cfg["image_resolution"]), rows).cpu() for a in saved})
    return out
