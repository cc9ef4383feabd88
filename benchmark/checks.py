"""The numbers that decide ``correct``: the program held against the reference.

Train cells compare the first steps the program took through its captured
step, each number the worst case of its kind:

* ``grad_gap``: each leaf's first gradient as the optimizer took it (the
  clipped gradient: the momentum after one step less the weight decay),
  the gap between the two norms;
* ``change_gap``: each leaf's change after the steps, the gap between the
  two norms, over the leaves whose first gradient in the reference is at
  least a thousandth of the median leaf's (the others move by weight decay
  and round-off alone).

A leaf's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger. ``loss_gap`` (each step's loss,
relative) and ``gnorm_gap`` (each step's global gradient norm before the
clip, relative) are worked out too; the limits hold neither (PERF.md).
Eval cells compare ``logit_gap``: the widest gap of any logit of the
compared batches, in logit units.
"""

from __future__ import annotations

import math
import statistics

import torch


def norms(flat: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in flat.items()}


def _worst_leaf(prog: dict, ref: dict, names) -> tuple:
    floor = statistics.median(ref[k] for k in names)
    worst, at = 0.0, None
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def _rel(a, b) -> float:
    gap = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))
    return gap if math.isfinite(gap) else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses``, ``gnorms`` (one a step), ``grad`` and
    ``change`` (leaf norms by name). Returns ``{name: (value, worst leaf)}``."""
    out = {"loss_gap": (_rel(prog["losses"], ref["losses"]), None),
           "gnorm_gap": (_rel(prog["gnorms"], ref["gnorms"]), None)}
    if set(prog["grad"]) != set(ref["grad"]):
        missing = sorted(set(prog["grad"]) ^ set(ref["grad"]))
        return dict(out, grad_gap=(math.inf, missing[0]), change_gap=(math.inf, missing[0]))
    names = sorted(ref["grad"])
    out["grad_gap"] = _worst_leaf(prog["grad"], ref["grad"], names)
    floor = 1e-3 * statistics.median(ref["grad"][k] for k in names)
    moved = [k for k in names if ref["grad"][k] >= floor]
    out["change_gap"] = _worst_leaf(prog["change"], ref["change"], moved)
    return out


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap between a logit of the program and the reference's,
    in logit units (``min(exp(logit_scale), 100) * cos``)."""
    gap = (prog.double() - ref.double()).abs().max()
    return float(gap) if torch.isfinite(gap) else math.inf


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number at or under its limit, each
    printed beside it."""
    checks, ok = {}, True
    for name, lim in limits.items():
        value, where = numbers.get(name, (math.inf, "not compared"))
        checks[name] = {"value": value if math.isfinite(value) else str(value),
                        "limit": lim["limit"]}
        if where:
            checks[name]["at"] = where
        ok = ok and math.isfinite(value) and value <= lim["limit"]
    return ok, checks
