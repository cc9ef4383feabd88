"""The span reader (benchmark/spans.py) and its eleven metrics on synthetic
traces: self times less the children, busy and idle inside a span, nothing
read (and nothing raised) without markers or where they interleave, a kind's
metrics adding up to its steps, no marker named like a roofline's kernel,
and the span table's markers and kernel groups (benchmark/span_table.py)."""

import json
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.devtrace import patterns
from benchmark.tests.tiny import REPO

TRAIN = ("crop_ms.train", "prompt_learner_ms.train", "text_tower_ms.train",
         "vision_tower_ms.train", "loss_ms.train", "update_ms.train", "other_ms.train")
EVAL = ("crop_ms.eval", "vision_tower_ms.eval", "logits_ms.eval", "other_ms.eval")
MARK_S = 2e-6


def marker(name: str, opens: bool) -> str:
    return f"void span_marker<{spans.NAMES.index(name)}, {'true' if opens else 'false'}>()"


class Timeline:
    """Device operations laid end to end: markers, kernels and idle gaps."""

    def __init__(self):
        self.t, self.kernels = 0.0, []

    def op(self, name: str, seconds: float):
        self.kernels.append((name, self.t, seconds))
        self.t += seconds

    def idle(self, seconds: float):
        self.t += seconds

    def span(self, name, *body):
        self.op(marker(name, True), MARK_S)
        for part in body:
            part()
        self.op(marker(name, False), MARK_S)

    def trace(self, kind: str, steps: int):
        return SimpleNamespace(kernels=list(self.kernels), steps=steps, kind=kind,
                               window_s=self.t)


def work(tl, busy, idle=0.0):
    return lambda: (tl.op("gemm_epilogue_kernel<...>", busy), tl.idle(idle))


def train_step(tl):
    """One train step with every span, each doing some busy and idle time."""
    def nested(name, busy, idle=0.0, *inner):
        return lambda: tl.span(name, work(tl, busy, idle), *inner)

    tl.span("step",
            nested("crop", 2e-3, 1e-4),
            nested("forward_backward", 1e-4, 0.0,
                   nested("prompt_learner", 3e-4), nested("prompt_learner", 2e-4),
                   nested("text_tower", 2e-2, 1e-3), nested("vision_tower", 1e-1, 2e-3),
                   nested("loss", 1e-3),
                   nested("backward", 5e-5, 0.0,
                          nested("loss.backward", 1e-3), nested("vision_tower.backward", 1e-1),
                          nested("text_tower.backward", 1e-2),
                          nested("prompt_learner.backward", 1e-4),
                          nested("prompt_learner.backward", 1e-4))),
            nested("update", 5e-3, 5e-4),
            work(tl, 1e-3))


def eval_step(tl):
    tl.span("step",
            lambda: tl.span("crop", work(tl, 1e-3)),
            lambda: tl.span("vision_tower", work(tl, 8e-2, 1e-4)),
            lambda: tl.span("logits", work(tl, 5e-4)),
            work(tl, 2e-4, 1e-5))


def metric(name, t):
    return harness.read_metric(REPO, name, t)


def step_lengths(t) -> float:
    """The summed device time of the complete ``step`` spans: from the end of
    each opening marker to the start of its close."""
    opens = [a + d for n, a, d in t.kernels if n == marker("step", True)]
    closes = [a for n, a, d in t.kernels if n == marker("step", False)]
    return sum(c - o for o, c in zip(opens, closes))


def test_self_time_leaves_out_the_children():
    tl = Timeline()
    tl.span("step", lambda: tl.idle(1.0),
            lambda: tl.span("crop", lambda: tl.idle(2.0)),
            lambda: tl.idle(0.5),
            lambda: tl.span("update", lambda: tl.idle(3.0)))
    res = spans.read(tl.trace("train", 1))
    assert res["steps"] == 1
    crop, update, step = (res["spans"][n]["self_s"] for n in ("crop", "update", "step"))
    assert crop == pytest.approx(2.0) and update == pytest.approx(3.0)
    # the step's own time: its idle stretches and its children's four markers
    assert step == pytest.approx(1.5 + 4 * MARK_S)
    assert metric("crop_ms.train", tl.trace("train", 1)) == pytest.approx(2000.0)


def test_busy_and_idle_inside_a_span():
    tl = Timeline()
    tl.span("step", lambda: tl.span("vision_tower", lambda: tl.idle(0.25),
                                    lambda: tl.op("attention_core", 0.5),
                                    lambda: tl.idle(0.25)))
    tl.idle(1.0)
    tl.span("step", lambda: tl.span("vision_tower", lambda: tl.op("attention_core", 1.0)))
    row = spans.read(tl.trace("eval", 2))["spans"]["vision_tower"]
    assert row["count"] == 2
    assert row["busy_s"] == pytest.approx(1.5) and row["idle_s"] == pytest.approx(0.5)
    assert row["self_s"] == pytest.approx(row["busy_s"] + row["idle_s"])
    # the second window's gap lies between steps, in no span
    assert metric("vision_tower_ms.eval", tl.trace("eval", 2)) == pytest.approx(1000.0)


def test_no_markers_read_none_and_raise_nothing():
    tl = Timeline()
    tl.op("attention_core", 1e-3)
    for name in TRAIN:
        assert metric(name, tl.trace("train", 3)) is None
    for name in EVAL:
        assert metric(name, tl.trace("eval", 3)) is None
    assert metric("crop_ms.train", SimpleNamespace(kernels=[], steps=0, kind="train",
                                                   window_s=0.0)) is None


def test_markers_that_interleave_read_none():
    tl = Timeline()
    tl.op(marker("step", True), MARK_S)
    tl.op(marker("crop", True), MARK_S)
    tl.op(marker("step", False), MARK_S)
    tl.op(marker("crop", False), MARK_S)
    t = tl.trace("train", 1)
    assert spans.read(t) is None
    assert all(metric(name, t) is None for name in TRAIN)


def test_only_complete_steps_count():
    """A step cut by the window's start or end, and a span outside any step,
    are left out; the totals are per complete step."""
    tl = Timeline()
    tl.op(marker("crop", False), MARK_S)  # its step opened before the window
    tl.op(marker("step", False), MARK_S)
    tl.span("update", lambda: tl.idle(9.0))  # in no step
    train_step(tl)
    train_step(tl)
    tl.op(marker("step", True), MARK_S)  # the window closed inside it
    tl.span("crop", lambda: tl.idle(5.0))
    t = tl.trace("train", 3)
    res = spans.read(t)
    assert res["steps"] == 2 and res["spans"]["update"]["count"] == 2
    assert metric("update_ms.train", t) == pytest.approx(5.5)


@pytest.mark.parametrize("kind,names,step", [("train", TRAIN, train_step),
                                             ("eval", EVAL, eval_step)])
def test_a_kinds_metrics_add_up_to_its_steps(kind, names, step):
    tl = Timeline()
    for _ in range(3):
        step(tl)
        tl.idle(1e-5)
    t = tl.trace(kind, 3)
    got = [metric(n, t) for n in names]
    assert all(v is not None and v > 0 for v in got), dict(zip(names, got))
    assert sum(got) * 3 == pytest.approx(1e3 * step_lengths(t), rel=1e-9)
    other = EVAL if kind == "train" else TRAIN
    assert all(metric(n, t) is None for n in other)


def test_metrics_are_declared_for_their_cells():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for names, cells, moves in ((TRAIN, ["maple_b16_train", "maple_l14_train"],
                                 "train_images_per_s"),
                                (EVAL, ["maple_b16_eval"], "eval_images_per_s")):
        for name in names:
            m = declared[name]
            assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "device_trace")
            assert m["workloads"] == cells and m["moves"] == moves


def test_no_marker_is_named_like_a_rooflines_kernel():
    groups = {g: patterns(g) for g in ("attention", "gemm")}
    for sid in range(len(spans.NAMES)):
        for opens, bit in ((True, "1"), (False, "0")):
            demangled = f"void span_marker<{sid}, {'true' if opens else 'false'}>()"
            mangled = f"_Z11span_markerILi{sid}ELb{bit}EEvv"
            for name in (demangled, mangled):
                assert spans.markers([(name, 0.0, 1e-6)]) == [(sid, opens, 0.0, 1e-6)]
                for group, pats in groups.items():
                    assert not any(p.search(name) for p in pats), (name, group)


def test_span_table_reads_markers_and_kernel_groups():
    from benchmark import span_table

    tl = Timeline()
    train_step(tl)
    train_step(tl)
    t = tl.trace("train", 2)
    cost = span_table.marker_cost(t, 2)
    assert cost["count"] == 30 and cost["busy_ms"] == pytest.approx(30 * MARK_S * 1e3)
    groups = span_table.kernel_groups(t, 2)
    # every kernel here matches the gemm patterns; each span's own, per step
    assert groups["vision_tower"] == {"attention": 0.0, "gemm": pytest.approx(100.0),
                                      "rest": 0.0}
    assert groups["update"]["gemm"] == pytest.approx(5.0)
