"""The benchmark's driver: finds a cell's pieces by name and runs it once.

``BENCHMARK.json`` names every piece. A cell (``workloads``) names its
configuration, whose ``file`` holds the sizes, and its traffic mix,
``benchmark/traffic/<traffic>.json``. The mix's ``kind`` picks the loop,
``benchmark/kinds/<kind>.py``; the configuration's ``architecture``
(``clip_vit`` where it names none) picks the model's pieces,
``benchmark/architectures/<architecture>.py``. A per-layer metric is read
by ``benchmark/metrics/<name>.py``; the numbers compared against the
reference have their limits in ``benchmark/limits/<cell>.json``. Adding a
cell, a configuration, a mix, a metric, an architecture, a kind of loop or
a cell on several cards adds files and entries and edits none.

An architecture module exports what a loop takes from the model:

* ``state_dict(cfg, seed, device)`` and ``prompt_learner(cfg,
  use_captions, seed, device)``: the weights and the prompt learner's
  initial values, made on ``device`` from the seed;
* ``system``: the module or object that drives the program under test
  (``build_kernels(device)``; ``build(sd, pl, cfg, classnames,
  use_captions, device)``, a dict with at least ``text_len``;
  ``train_step(prog, cfg, inputs, draw)`` and ``eval_step(prog, inputs,
  boxes, flips, roll)``, each ``(step, state)``, the train state
  ``(trainable, optimizer state with its "trace", non-finite count)``, the
  eval state ``(canvas, non-finite count)``; ``Runner(step, state,
  generators=())``; ``trainable_flat(state)`` and ``trace_flat(state)`` by
  the reference's leaf names);
* ``Reference(sd, pl, classnames, cfg, device, quant=False)``: the plain
  float32 reference (``params``, ``trainable``, ``loss_and_grads``,
  ``step``, ``logits``), float8 operands with ``quant`` (the control);
  ``crop(canvas, boxes, flips, out)``, its crop; ``grad_norm(grads)``;
  ``strict_fp32()``, called before it is built;
* ``reference_rows(cfg, mix, device)``: the images the reference takes at
  once;
* the frozen counts ``train_step_flops``, ``eval_batch_flops``,
  ``attention_work`` and ``gemm_work``, each ``(cfg, mix, text_len)``:
  one step's operations, and its attention and product work as
  ``[{"flops", "bytes"}]``, summed over every device of the cell.

A kind module exports ``run(cfg, mix, arch, seed, seconds, trace, devices,
start, limits)``: one run on ``devices`` (``cuda:0`` up to the cell's
chips, the CPU in tests) returning ``correct``, ``attempted``, ``failed``,
``memory_peak_bytes`` (the fullest device's), ``end_to_end`` (by metric
name), ``checks`` (``benchmark/checks.py::judge``) and with ``trace`` a
``benchmark/devtrace.py::Trace`` of the cell's chips; and ``readings(cfg,
mix, arch, seed, devices, controls)``: the compared numbers with no window,
``{"program": {...}}`` and with ``controls`` the control's and the faults'
(``benchmark/control.py``).

One run: set-up (weights and inputs from the seed, the program built, its
step captured and warmed up), the window of ``--seconds`` (under the
profiler with ``--trace 1``), the peak memory read, the program freed, the
plain reference, the comparison. The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from benchmark import pieces

FORBIDDEN = ("jax", "jaxlib", "flax", "federated_multi_modal_tpu")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_parts(root: Path, bench: dict, workload: str):
    """``(workload entry, configuration, mix, limits)`` of a cell."""
    from benchmark.traffic.generator import load_mix

    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    limits = json.loads((root / "benchmark" / "limits" / f"{workload}.json").read_text())
    return w, cfg, load_mix(root, w["traffic"]), limits


def reported_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metrics this cell prints: its end-to-end ones, or with ``trace``
    its per-layer ones."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload]) and m["moves"] in names]


def read_metric(root: Path, name: str, t):
    return pieces.load(root, "metrics", name).read(t)


def kind_module(root: Path, kind: str):
    return pieces.load(root, "kinds", kind)


def architecture(root: Path, cfg: dict):
    """The configuration's architecture module."""
    return pieces.load(root, "architectures", cfg.get("architecture", "clip_vit"))


def card_line() -> None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
        log(f"card: {out.splitlines()[0] if out else 'nvidia-smi printed nothing'}")
    except (OSError, subprocess.SubprocessError) as e:
        log(f"card: nvidia-smi not read ({type(e).__name__})")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_devices(chips: int):
    """The cell's cards, ``cuda:0`` up to ``cuda:chips-1``, or ``None`` where
    CUDA or enough devices are missing."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"this cell needs {chips} CUDA device(s); {n} visible: no result")
        return None
    return [torch.device("cuda", i) for i in range(chips)]


def run_kind(root: Path, bench: dict, args, start: float, devices) -> tuple:
    """``(workload entry, the kind's result)`` of one run of the cell on
    ``devices``."""
    import torch

    w, cfg, mix, limits = cell_parts(root, bench, args.workload)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    res = kind_module(root, mix["kind"]).run(
        cfg=cfg, mix=mix, arch=architecture(root, cfg), seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), devices=devices, start=start, limits=limits)
    return w, res


def run_cell(root: Path, args, start: float, devices) -> dict:
    """One run of the cell on ``devices``: the result's fields and the
    checks."""
    import torch

    bench = load_benchmark(root)
    w, res = run_kind(root, bench, args, start, devices)
    device = devices[0]
    metrics = {}
    for m in reported_metrics(bench, args.workload, bool(args.trace)):
        value = res["end_to_end"].get(m["name"]) if not args.trace else read_metric(
            root, m["name"], res["trace"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": w["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = res["trace"].busy_s, res["trace"].window_s
        out["breakdown"] = res["trace"].breakdown()
    out["checks"] = res["checks"]
    return out


def main(argv, root, start) -> int:
    args = parse(argv)
    root = Path(root)
    chips = next((w["chips"] for w in load_benchmark(root)["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        log(f"unknown workload {args.workload!r}")
        return 2
    devices = require_devices(chips)
    if devices is None:
        return 3
    card_line()
    out = run_cell(root, args, start, devices)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; no result")
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
