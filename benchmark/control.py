"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... [--controls 3]

For each seed, in one process and with no measured window: the program's
numbers against the float32 reference, as a run of the cell compares them
(the lower readings); for the first ``--controls`` seeds the control's,
the reference computed on float8 operands put in the program's place, and
for train cells the half-batch fault's, the reference's loss taken over
half of the batch (the upper readings). One JSON line a seed on standard
output. A state left unchanged reads 1 on ``change_gap`` by its measure and
needs no run. The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
for _key in [k for k in os.environ if k.startswith("FMM_TPU_")]:
    del os.environ[_key]

import torch  # noqa: E402

from benchmark import checks, harness  # noqa: E402
from benchmark.kinds import common, train  # noqa: E402
from benchmark.kinds import eval as evaluation  # noqa: E402
from benchmark.reference import model as reference  # noqa: E402
from benchmark.traffic import generator  # noqa: E402


def train_readings(cfg, mix, seed, device, controls: bool) -> dict:
    runner, prog, inputs, rec, use_captions = train.first_steps(cfg, mix, seed, device)
    del runner, prog
    common.release(device)
    rows = common.reference_rows(cfg, mix, device)

    def steps(quant=False, take=None):
        model = common.reference_model(cfg, seed, device, use_captions, quant=quant)
        got = train.reference_steps(model, inputs, rec, cfg["image_resolution"], rows, take)
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


def eval_readings(cfg, mix, seed, device, controls: bool) -> dict:
    runner, prog, inputs, boxes, flips = evaluation.warmed(cfg, mix, seed, device)
    picks = {evaluation.WARM + p for p in generator.eval_picks(mix, seed)}
    saved = {}
    for a in range(evaluation.WARM, max(picks) + 1):
        out = runner()
        if a in picks:
            saved[a] = out.clone().cpu()
    del runner, prog
    common.release(device)
    rows = common.reference_rows(cfg, mix, device)
    ref = common.reference_model(cfg, seed, device, use_captions=False)

    def gap(got):
        return {"logit_gap": evaluation.widest_gap(ref, got, inputs, boxes, flips, cfg, mix,
                                                   rows)[0]}

    out = {"program": gap(saved)}
    if controls:
        fp8 = common.reference_model(cfg, seed, device, use_captions=False, quant=True)
        out["control"] = gap({a: fp8.logits(reference.crop(
            torch.roll(inputs["canvas"], a * mix["roll"], 0), boxes, flips,
            cfg["image_resolution"]), rows).cpu() for a in saved})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    from pathlib import Path

    root = Path(ROOT)
    bench = harness.load_benchmark(root)
    w, cfg, mix, _ = harness.cell_parts(root, bench, args.workload)
    device = harness.require_devices(w["chips"])
    if device is None:
        return 3
    readings = train_readings if mix["kind"] == "train" else eval_readings
    for i, seed in enumerate(args.seeds):
        out = readings(cfg, mix, seed, device, i < args.controls)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        common.release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
