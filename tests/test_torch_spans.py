"""Spans (``utils/profiling.py``) on the CPU at Tiny size: the list of spans
is closed, a MaPLe train and eval step show their host ranges with the
program's nesting, the markers' sequence nests with the backward spans inside
``backward`` (with and without remat), ``span_boundary`` is the identity bit
for bit, and a step reads the same whether or not markers are recorded."""

import ast
import re
from pathlib import Path

import pytest
import torch

from federated_multi_modal_tpu_torch.engine.optim import build_optimizer
from federated_multi_modal_tpu_torch.engine.trainer import (
    loss_grads_and_aux,
    make_train_step_with_aux,
)
from federated_multi_modal_tpu_torch.flagship import build_maple_program
from federated_multi_modal_tpu_torch.ops.preprocess import crop_resize_flip_normalize
from federated_multi_modal_tpu_torch.tokenizer import tokenize
from federated_multi_modal_tpu_torch.utils import profiling
from federated_multi_modal_tpu_torch.utils.profiling import SPANS, span, span_boundary

PKG = Path(profiling.__file__).resolve().parents[1]
REPO = PKG.parent
B, CANVAS = 4, 40

# the train step's spans as the program nests them (the step span belongs to
# a captured step and is checked on the card)
TRAIN_TREE = [
    ("crop", []),
    ("forward_backward", [
        ("prompt_learner", []), ("prompt_learner", []), ("text_tower", []),
        ("vision_tower", []), ("loss", []),
        ("backward", [("loss.backward", []), ("vision_tower.backward", []),
                      ("text_tower.backward", []), ("prompt_learner.backward", []),
                      ("prompt_learner.backward", [])])]),
    ("update", []),
]
EVAL_TREE = [("crop", []), ("vision_tower", []), ("logits", [])]


def _calls(path: Path):
    """``(function, first argument)`` of every call of ``span`` or
    ``span_boundary`` in ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            if name in ("span", "span_boundary") and node.args:
                yield name, node.args[0]


def test_spans_are_closed_and_their_ids_unique():
    assert len(set(SPANS)) == len(SPANS)
    assert profiling.SPAN_ID == {n: i for i, n in enumerate(SPANS)}
    found = set()
    for path in PKG.rglob("*.py"):
        for fn, arg in _calls(path):
            assert isinstance(arg, ast.Constant), (path, ast.dump(arg))
            name = arg.value if fn == "span" else arg.value + ".backward"
            assert name in SPANS, (path, fn, arg.value)
            found.add(name)
    assert found == set(SPANS), set(SPANS) - found
    cu = (PKG / "csrc" / "span_mark.cu").read_text()
    assert int(re.search(r"constexpr int kSpans = (\d+);", cu).group(1)) == len(SPANS)


def test_the_benchmark_reads_the_same_span_ids():
    from benchmark import spans as reader

    assert reader.NAMES == SPANS


def _program(remat=False):
    prog = build_maple_program(backbone="Tiny", classnames=[f"class {i}" for i in range(4)],
                               depth=3, remat=remat, device="cpu")
    gen = torch.Generator().manual_seed(5)
    canvas = torch.randint(0, 256, (B, CANVAS, CANVAS, 3), generator=gen, dtype=torch.uint8)
    boxes = torch.tensor([[2.0, 3.0, 30.0, 34.0]] * B)
    flips = torch.tensor([True, False] * (B // 2))
    labels = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    captions = torch.from_numpy(tokenize(["a photo of a test scene"] * B))
    return prog, (canvas, boxes, flips, labels, captions)


def _batch(prog, inputs):
    canvas, boxes, flips, labels, captions = inputs
    images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=prog["arch"].image_resolution)
    return {"image": images, "label": labels, "caption_tokens": captions}


def _train_step(prog, inputs):
    step = make_train_step_with_aux(prog["loss_fn"], build_optimizer(lr=0.01, clip=1.0))
    opt = build_optimizer(lr=0.01, clip=1.0).init(prog["trainable"])
    return step(prog["trainable"], prog["frozen"], opt, _batch(prog, inputs))


def _eval_step(prog, inputs, prep):
    canvas, boxes, flips, _, _ = inputs
    images = crop_resize_flip_normalize(canvas, boxes, flips, out_size=prog["arch"].image_resolution)
    return prog["eval_apply_fn"](prog["trainable"], prog["frozen"], images, prep)


def _tree(intervals):
    """Host ranges ``(name, start, end)`` as a nested list by containment."""
    root = []
    stack = [(float("inf"), root)]
    for name, a, b in sorted(intervals, key=lambda r: (r[1], -r[2])):
        while a >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((b, node[1]))
    return root


def _host_spans(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in SPANS:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return _tree(out)


@pytest.fixture(scope="module")
def tiny():
    return _program()


def test_host_ranges_nest_as_the_program_does(tiny):
    prog, inputs = tiny
    assert _host_spans(lambda: _train_step(prog, inputs)) == TRAIN_TREE
    prep = prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])
    assert _host_spans(lambda: _eval_step(prog, inputs, prep)) == EVAL_TREE
    assert _host_spans(lambda: prog["eval_prepare_fn"](prog["trainable"], prog["frozen"])) == [
        ("prompt_learner", []), ("text_tower", [])]


@pytest.fixture
def recorded(monkeypatch):
    """Markers recorded as ``(name, opens)`` instead of launched."""
    seq = []
    monkeypatch.setattr(profiling, "_markers_wanted", lambda profiling_on: True)
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda span_id, opening: seq.append((SPANS[span_id], opening)))
    return seq


def _flat(tree):
    out = []
    for name, children in tree:
        out += [(name, True), *_flat(children), (name, False)]
    return out


def _nested(seq) -> bool:
    stack = []
    for name, opening in seq:
        if opening:
            stack.append(name)
        elif not stack or stack.pop() != name:
            return False
    return not stack


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_marker_sequence_nests_with_the_backward_spans_inside_backward(recorded, remat):
    prog, inputs = _program(remat)
    _train_step(prog, inputs)
    assert _nested(recorded)
    assert recorded == _flat(TRAIN_TREE)
    inside = recorded[recorded.index(("backward", True)) + 1:recorded.index(("backward", False))]
    assert {n for n, _ in inside} == {"loss.backward", "vision_tower.backward",
                                      "text_tower.backward", "prompt_learner.backward"}


def test_a_step_is_the_same_bit_for_bit_with_markers_recorded(tiny, monkeypatch):
    prog, inputs = tiny
    batch = _batch(prog, inputs)
    plain = loss_grads_and_aux(prog["loss_fn"], prog["trainable"], prog["frozen"], batch)
    plain_step = _train_step(prog, inputs)
    seq = []
    monkeypatch.setattr(profiling, "_markers_wanted", lambda profiling_on: True)
    monkeypatch.setattr(profiling, "_launch_marker", lambda i, o: seq.append((i, o)))
    marked = loss_grads_and_aux(prog["loss_fn"], prog["trainable"], prog["frozen"], batch)
    marked_step = _train_step(prog, inputs)
    assert seq

    def same(a, b):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)

    same(plain, marked)
    same(plain_step, marked_step)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_span_boundary_is_the_identity_bit_for_bit(recorded, dtype):
    gen = torch.Generator().manual_seed(3)

    def inputs():
        x = torch.randn(5, 7, generator=gen).to(dtype)
        return x, x.clone().requires_grad_(True), torch.randn(5, 7, generator=gen).to(dtype)

    x0, w0, u0 = inputs()
    w, u = w0.detach().clone().requires_grad_(True), u0.clone().requires_grad_(True)
    w_ref, u_ref = w0.detach().clone().requires_grad_(True), u0.clone().requires_grad_(True)

    def loss(x, w, tree):
        return ((x * w).sin() * tree["a"][0]).sum()

    gx, gw, gu = span_boundary("loss", x0, w, {"a": [u], "b": None}, entry=True)
    assert gw.grad_fn is not None and gx is x0 and gu["b"] is None
    for got, want in ((gx, x0), (gw, w), (gu["a"][0], u)):
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert got.data_ptr() == want.data_ptr()
    with span("loss"):
        out = loss(gx, gw, gu)
    unused = torch.zeros((), dtype=dtype, requires_grad=True)
    out, no_grad = span_boundary("loss", out, unused * 2, entry=False)
    got = torch.autograd.grad(out, [w, u, unused], allow_unused=True)
    want = torch.autograd.grad(loss(x0, w_ref, {"a": [u_ref]}), [w_ref, u_ref])
    assert got[2] is None
    for g, r in zip(got[:2], want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert recorded == [("loss", True), ("loss", False), ("loss.backward", True),
                        ("loss.backward", False)]


def test_span_boundary_records_nothing_where_no_gradient_is(recorded):
    x = torch.randn(3, requires_grad=True)
    with torch.no_grad():
        (y,) = span_boundary("loss", x, entry=True)
    assert y is x
    (z,) = span_boundary("loss", x.detach(), entry=True)
    assert z.grad_fn is None and not recorded


def test_no_marker_and_no_range_without_a_profiler_or_a_capture(tiny, monkeypatch):
    """On the CPU, with no profiler running, a span launches nothing and a
    boundary adds no node to the autograd graph."""
    launched = []
    monkeypatch.setattr(profiling, "_launch_marker", lambda *a: launched.append(a))
    prog, inputs = tiny
    x = torch.randn(3, requires_grad=True)
    (y,) = span_boundary("loss", x, entry=True)
    assert y is x
    _train_step(prog, inputs)
    assert not launched
    assert not profiling._markers_wanted(False)
