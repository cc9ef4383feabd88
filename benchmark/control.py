"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 ... [--controls 3]

For each seed, in one process and with no measured window, the cell's kind
module (``benchmark/kinds/<kind>.py``) gives its ``readings``: the
program's numbers against the float32 reference, as a run of the cell
compares them (the lower readings), and for the first ``--controls`` seeds
the control's, the reference computed on float8 operands put in the
program's place, and the kind's faults' (the upper readings; the train
kind's half-batch fault, the reference's loss taken over half of the
batch). One JSON line a seed on standard output. A state left unchanged
reads 1 on ``change_gap`` by its measure and needs no run. The benchmark's
own runs never run this.
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

from benchmark import harness  # noqa: E402
from benchmark.kinds import common  # noqa: E402


def readings(root, cfg, mix, seed, devices, controls: bool) -> dict:
    """One seed's readings, from the cell's kind and architecture."""
    kind = harness.kind_module(root, mix["kind"])
    return kind.readings(cfg=cfg, mix=mix, arch=harness.architecture(root, cfg), seed=seed,
                         devices=devices, controls=controls)


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
    devices = harness.require_devices(w["chips"])
    if devices is None:
        return 3
    for i, seed in enumerate(args.seeds):
        out = readings(root, cfg, mix, seed, devices, i < args.controls)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
        common.release(devices[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
