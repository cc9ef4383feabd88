"""Each span's device time per step in one traced run of a cell, busy and idle.

    python3 benchmark/span_table.py --workload <cell> --seed <n> --seconds <s>

Run from the root of a checkout, on the card. The cell runs as
``benchmark/run.py --trace 1`` runs it (the same set-up, window, reference
and checks); the table comes from ``benchmark/spans.py``. Prints one JSON
line: the complete steps, the window's ms per step, for each span its self
time, busy and idle ms per step and its instances per step, and the markers'
own device time and the idle time right after them, per step, and each
span's kernel time by the rooflines' groups (attention, gemm, the rest),
per step. Exits 3 without the card the cell needs.
"""

import json
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness, spans  # noqa: E402
from benchmark.devtrace import patterns  # noqa: E402

GROUPS = ("attention", "gemm")


def marker_cost(t, steps: int) -> dict:
    """The markers' count, device ms and the idle ms between each and the
    next operation, per step."""
    ops = sorted(t.kernels, key=lambda k: k[1])
    n, busy, gap = 0, 0.0, 0.0
    for i, (name, a, d) in enumerate(ops):
        if spans.MARKER.search(name):
            n += 1
            busy += d
            if i + 1 < len(ops):
                gap += max(0.0, ops[i + 1][1] - (a + d))
    return {"count": n / steps, "busy_ms": 1e3 * busy / steps, "gap_after_ms": 1e3 * gap / steps}


def kernel_groups(t, steps: int) -> dict:
    """Each span's own kernels' device ms per step (those whose innermost
    span it is), by group: the rooflines' ``attention`` and ``gemm``
    patterns and ``rest``."""
    pats = {g: patterns(g) for g in GROUPS}
    out, stack = {}, []
    for name, _, d in sorted(t.kernels, key=lambda k: k[1]):
        m = spans.MARKER.search(name)
        if m:
            sid = int(m.group(1) or m.group(3))
            if m.group(2) == "true" or m.group(4) == "1":
                stack.append(spans.NAMES[sid])
            elif stack:
                stack.pop()
            continue
        if not stack:
            continue
        group = next((g for g in GROUPS if any(p.search(name) for p in pats[g])), "rest")
        row = out.setdefault(stack[-1], dict.fromkeys(GROUPS + ("rest",), 0.0))
        row[group] += 1e3 * d / steps
    return out


def main(argv) -> int:
    from benchmark import run  # the caches and the program's gates as a run has them

    args = harness.parse(list(argv) + ["--trace", "1"])
    root = Path(run.ROOT)
    bench = harness.load_benchmark(root)
    w, _, _, _ = harness.cell_parts(root, bench, args.workload)
    devices = harness.require_devices(w["chips"])
    if devices is None:
        return 3
    harness.card_line()
    _, res = harness.run_kind(root, bench, args, run.START, devices)
    t = res["trace"]
    table = spans.read(t)
    out = {"workload": args.workload, "seed": args.seed, "correct": res["correct"],
           "window_steps": t.steps, "window_ms_per_step": 1e3 * t.window_s / t.steps}
    if table is not None:
        n = table["steps"]
        out["steps"] = n
        out["spans"] = {name: {"self_ms": 1e3 * r["self_s"] / n, "busy_ms": 1e3 * r["busy_s"] / n,
                               "idle_ms": 1e3 * r["idle_s"] / n, "per_step": r["count"] / n}
                        for name, r in table["spans"].items()}
        out["markers"] = marker_cost(t, n)
        out["kernels_ms"] = kernel_groups(t, n)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
