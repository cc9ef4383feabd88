"""Train cells: a closed loop of the program's captured MaPLe train step.

Set-up builds the program and its step once, and drives that same step
through its first ``CHECK_STEPS`` steps (the capture's replays, the crops
drawn on the card as in the window), keeping each step's loss, gradient
norm and crops, the first gradient as the optimizer took it and the change
of every trainable leaf. The window then goes on from there. Once it has
closed and the program is freed, the reference takes the same steps from
the same weights on the same crops. The cell's first device runs it all.
"""

from __future__ import annotations

import math

import torch

from benchmark import checks, window
from benchmark.kinds import common
from benchmark.traffic import generator

CHECK_STEPS = 3


def program_steps(system, runner, cfg: dict) -> dict:
    """Run the first steps through ``runner`` and keep what the reference is
    held to: ``losses``, ``gnorms``, ``boxes``, ``flips``, ``grad`` and
    ``change`` (leaf norms by the reference's names)."""
    wd = cfg["optim"]["weight_decay"]
    p0 = {k: v.clone() for k, v in system.trainable_flat(runner.state).items()}
    rec = {"losses": [], "gnorms": [], "boxes": [], "flips": []}
    for k in range(CHECK_STEPS):
        loss, gnorm, boxes, flips = runner()
        rec["losses"].append(float(loss))
        rec["gnorms"].append(float(gnorm))
        rec["boxes"].append(boxes.clone())
        rec["flips"].append(flips.clone())
        if k == 0:
            rec["grad"] = checks.norms({k2: t - wd * p0[k2]
                                        for k2, t in system.trace_flat(runner.state).items()})
    rec["change"] = checks.norms({k: v - p0[k]
                                  for k, v in system.trainable_flat(runner.state).items()})
    return rec


def reference_steps(ref, arch, inputs: dict, rec: dict, out_size: int, rows: int,
                    take=None) -> dict:
    """The reference's steps on the program's crops: the same read-outs."""
    p0 = {k: ref.params[k].clone() for k in ref.trainable}
    res = {"losses": [], "gnorms": []}
    for k in range(len(rec["boxes"])):
        images = arch.crop(inputs["canvas"], rec["boxes"][k], rec["flips"][k], out_size)
        loss, grads = ref.loss_and_grads(images, inputs["labels"], inputs.get("captions"),
                                         rows, take)
        res["losses"].append(loss)
        res["gnorms"].append(arch.grad_norm(grads))
        clipped = ref.step(grads)
        if k == 0:
            res["grad"] = checks.norms(clipped)
    res["change"] = checks.norms({k: ref.params[k] - p0[k] for k in ref.trainable})
    return res


def first_steps(cfg, mix, arch, seed, device):
    """The program built from the seed, its step captured and driven
    through its first steps: ``(runner, program, inputs, read-outs,
    use_captions)``."""
    use_captions = bool(mix.get("captions") and cfg["maple"]["use_captions"])
    system, prog, inputs = common.setup(cfg, mix, arch, seed, device, use_captions)
    gen = generator.box_generator(seed, device)
    step, state = system.train_step(prog, cfg, inputs,
                                    lambda: generator.random_resized_boxes(gen, mix))
    runner = system.Runner(step, state, (gen,))
    return runner, prog, inputs, program_steps(system, runner, cfg), use_captions


def run(cfg, mix, arch, seed, seconds, trace, devices, start, limits) -> dict:
    device = devices[0]
    runner, prog, inputs, rec, use_captions = first_steps(cfg, mix, arch, seed, device)
    window.sync(device)
    bad_before = int(runner.state[2])
    setup_s = common.elapsed(start)

    steps, window_s, prof = window.run(runner, seconds, device, trace)
    B = mix["batch"]
    failed = (int(runner.state[2]) - bad_before) * B
    last_loss = float(runner.out[0])
    peak = common.peak_bytes(device)
    text_len = prog["text_len"]
    res = {"attempted": steps * B, "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {"train_images_per_s": steps * B / window_s,
                          "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}}
    if prof is not None:
        from benchmark.devtrace import Trace

        res["trace"] = Trace(prof, "train", steps, arch.train_step_flops(cfg, mix, text_len),
                             {"attention": arch.attention_work(cfg, mix, text_len),
                              "gemm": arch.gemm_work(cfg, mix, text_len)}, len(devices))
        del prof
    del runner, prog
    common.release(device)

    ref = common.reference_model(cfg, arch, seed, device, use_captions)
    got = reference_steps(ref, arch, inputs, rec, cfg["image_resolution"],
                          arch.reference_rows(cfg, mix, device))
    ok, res["checks"] = checks.judge(checks.train_numbers(rec, got), limits)
    res["correct"] = bool(ok and failed == 0 and math.isfinite(last_loss))
    return res


def readings(cfg, mix, arch, seed, devices, controls: bool) -> dict:
    """The numbers a run compares, with no window: the program's first steps
    against the reference (``program``); with ``controls`` the reference on
    float8 operands (``control``) and the reference's loss over half of the
    batch (``half_batch``) in the program's place."""
    device = devices[0]
    runner, prog, inputs, rec, use_captions = first_steps(cfg, mix, arch, seed, device)
    del runner, prog
    common.release(device)
    rows = arch.reference_rows(cfg, mix, device)

    def steps(quant=False, take=None):
        model = common.reference_model(cfg, arch, seed, device, use_captions, quant=quant)
        got = reference_steps(model, arch, inputs, rec, cfg["image_resolution"], rows, take)
        del model
        common.release(device)
        return got

    ref = steps()

    def against_reference(got):
        return {k: v[0] for k, v in checks.train_numbers(got, ref).items()}

    out = {"program": against_reference(rec)}
    if controls:
        out["control"] = against_reference(steps(quant=True))
        out["half_batch"] = against_reference(
            steps(take=torch.arange(mix["batch"] // 2, device=device)))
    return out
