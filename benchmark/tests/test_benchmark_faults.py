"""``correct`` comes out false when the timed path is broken, and the
control fails the limits that the sound program meets.

Each fault is planted in the system under test (``benchmark/system``) and a
whole run is driven on the CPU at Tiny size, past the harness's look for a
card: a step that returns its state unchanged, half of the batch left out
(the loss or the logits taken over the rest), an answer altered where it is
produced (the train step's: one leaf's update doubled). A one-card cell has no exchange between cards to leave out.
"""

import argparse

import pytest
import torch

from benchmark import checks, control, harness
from benchmark.system import maple as system
from benchmark.tests.tiny import TINY_LIMITS, load, make_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def run(root, cell, seed=2 ** 31 + 5):
    args = argparse.Namespace(workload=cell, seed=seed, seconds=0.3, trace=0)
    return harness.run_cell(root, args, 0.0, [torch.device("cpu")])


def unchanged(build_step):
    def make(*a, **k):
        step, state = build_step(*a, **k)
        return (lambda s, run=None: (s, step(s, run)[1])), state
    return make


def half_loss(build):
    def make(*a, **k):
        prog = build(*a, **k)
        loss_fn = prog["loss_fn"]

        def half(tr, fr, batch):
            n = batch["image"].shape[0] // 2
            return loss_fn(tr, fr, {k2: v[:n] for k2, v in batch.items()})
        return dict(prog, loss_fn=half)
    return make


def doubled_update(make_tx):
    """One leaf's update doubled where the optimizer produces it."""
    def make(*a, **k):
        tx = make_tx(*a, **k)

        class Doubled:
            init = staticmethod(tx.init)

            @staticmethod
            def update(grads, state, params):
                updates, state = tx.update(grads, state, params)
                pl = dict(updates["prompt_learner"], ctx=2 * updates["prompt_learner"]["ctx"])
                return dict(updates, prompt_learner=pl), state
        return Doubled()
    return make


def _apply_fault(fn):
    def wrap(build):
        def make(*a, **k):
            prog = build(*a, **k)
            return dict(prog, eval_apply_fn=fn(prog["eval_apply_fn"]))
        return make
    return wrap


def _half_rows(apply):
    def half(tr, fr, images, prep):
        n = images.shape[0] // 2
        got = apply(tr, fr, images[:n], prep)
        return torch.cat([got, got.mean(0, keepdim=True).expand(images.shape[0] - n, -1)])
    return half


def _one_altered(apply):
    def altered(tr, fr, images, prep):
        out = apply(tr, fr, images, prep).clone()
        out[0, 0] += 1.0
        return out
    return altered


FAULTS = {
    ("tiny_train", "state unchanged"): ("train_step", unchanged),
    ("tiny_train", "half of the batch"): ("build", half_loss),
    ("tiny_train", "update altered"): ("optimizer", doubled_update),
    ("tiny_eval", "state unchanged"): ("eval_step", unchanged),
    ("tiny_eval", "half of the batch"): ("build", _apply_fault(_half_rows)),
    ("tiny_eval", "answer altered"): ("build", _apply_fault(_one_altered)),
}


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_eval"])
def test_sound_run_is_correct(tiny, cell):
    assert run(tiny, cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_makes_the_run_incorrect(tiny, monkeypatch, cell, fault):
    name, wrap = FAULTS[(cell, fault)]
    monkeypatch.setattr(system, name, wrap(getattr(system, name)))
    res = run(tiny, cell)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell,seed", [("tiny_train", 21), ("tiny_train", 22),
                                       ("tiny_eval", 23), ("tiny_eval", 24)])
def test_control_fails_the_limits_the_program_meets(tiny, cell, seed):
    """The reference on float8 operands, in the program's place, fails; the
    program on the same seed passes."""
    cfg, mix = load(tiny, cell)
    got = control.readings(tiny, cfg, mix, seed, [torch.device("cpu")], True)
    limits = {k: {"limit": v} for k, v in TINY_LIMITS[cell].items()}
    as_numbers = {k: (v, None) for k, v in got["program"].items()}
    assert checks.judge(as_numbers, limits)[0], got["program"]
    as_numbers = {k: (v, None) for k, v in got["control"].items()}
    assert not checks.judge(as_numbers, limits)[0], got["control"]
