"""A toy kind of loop for the harness's tests: a closed loop of one square
matrix product of the mix's ``n`` on the cell's first device, the last
product held against the same product in float64. A test writes this file
into a benchmark root as ``benchmark/kinds/<kind>.py``; it exports what
``benchmark/harness.py`` lists for a kind."""

from __future__ import annotations

import torch

from benchmark import checks, window
from benchmark.kinds import common


def _operand(mix: dict, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return torch.randn(mix["n"], mix["n"], generator=gen, device=device)


def _gap(a, product) -> float:
    return float((product.double() - a.double() @ a.double()).abs().max())


def run(cfg, mix, arch, seed, seconds, trace, devices, start, limits) -> dict:
    device = devices[0]
    a = _operand(mix, seed, device)
    out = {}

    def step():
        out["product"] = a @ a

    setup_s = common.elapsed(start)
    steps, window_s, prof = window.run(step, seconds, device, trace)
    peak = common.peak_bytes(device)
    ok, checked = checks.judge({"product_gap": (_gap(a, out["product"]), None)}, limits)
    res = {"correct": ok, "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
           "end_to_end": {"products_per_s": steps / window_s, "peak_mem_gib": peak / 2 ** 30,
                          "setup_s": setup_s},
           "checks": checked}
    if prof is not None:
        from benchmark.devtrace import Trace

        res["trace"] = Trace(prof, mix["kind"], steps, 2.0 * mix["n"] ** 3, {}, len(devices))
    return res


def readings(cfg, mix, arch, seed, devices, controls: bool) -> dict:
    a = _operand(mix, seed, devices[0])
    return {"program": {"product_gap": _gap(a, a @ a)}}
