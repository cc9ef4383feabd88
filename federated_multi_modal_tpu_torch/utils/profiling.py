"""Profiling and spans (port of ``federated_multi_modal_tpu/utils/profiling.py``).

``cfg.TRAIN.PROFILE_DIR`` turns it on: the trainer runs each epoch under
:func:`trace`, which records the host and, where CUDA is available, the
card's kernels with ``torch.profiler`` and writes a Chrome trace
(``<host>_<pid>.<time>.pt.trace.json``, which TensorBoard's profiler plugin
and ``chrome://tracing`` read) into the directory. The JAX module's
``StepTimer`` and ``annotate`` have no caller in the port and are not
ported.

Spans name the program's layers in such a trace and on the card's own
timeline. :data:`SPANS` lists every span; a name's index is its id, which
never changes (a new span is appended). ``with span(name):`` marks its
body. On a CUDA device, while the current stream is being captured into a
CUDA graph or a profiler runs, each boundary launches a one-thread empty
marker kernel on the current stream (``csrc/span_mark.cu``:
``span_marker<id, true>`` opens span ``id``, ``span_marker<id, false>``
closes it), so a captured step puts its spans' boundaries on the device
timeline in every replay, beside the kernels they enclose. While a
profiler runs, a host range of the span's name marks the host as well. It
is a range of the profiler's function scope, as an operator's is: a user
annotation (``torch.profiler.record_function``) would also lay a range
over its kernels on the device timeline, where the markers already are,
and a reader of device operations would count it as one. With neither, a
span costs a check or two.
:func:`span_boundary` carries a span into the backward pass
(``<name>.backward``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from federated_multi_modal_tpu_torch.engine.tree import flatten, tree_map_with_path

# Every span, by id. Ids are appended, never reordered: the benchmark's
# reader (benchmark/spans.py) keeps a copy, and csrc/span_mark.cu one marker
# instance per id.
SPANS = (
    "step",  # a captured step: bench.capture_step
    "crop",  # ops/preprocess.py::crop_resize_flip_normalize
    "forward_backward",  # engine/trainer.py::loss_grads_and_aux
    "prompt_learner",  # trainers/maple.py::maple_prompts, caption_tokens_to_extra
    "text_tower",  # models/clip_model.py::encode_text_embedded
    "vision_tower",  # models/clip_model.py::encode_image
    "loss",  # trainers/maple.py's loss_fn from the features on
    "backward",  # the torch.autograd.grad of loss_grads_and_aux
    "update",  # engine/trainer.py::make_train_step_with_aux after the gradients
    "logits",  # trainers/maple.py's eval_apply_fn after the vision tower
    "replay",  # host only: parallel/mesh.py::StepGraph.replay
    "prompt_learner.backward",
    "text_tower.backward",
    "vision_tower.backward",
    "loss.backward",
    "vision_mlp",  # ops/kernels/eva_block.py, ops/primitives.py: an EVA block's SwiGLU half
    "fedavg",  # parallel/fedavg.py::fedavg_over_clients
    "vision_mlp.backward",
)
SPAN_ID = {name: i for i, name in enumerate(SPANS)}

_profiling = torch.autograd._profiler_enabled


@contextlib.contextmanager
def trace(profile_dir: str = ""):
    """A ``torch.profiler`` trace of the body into ``profile_dir``; a
    no-op when it is empty."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield


def _markers_wanted(profiling: bool) -> bool:
    """Whether a boundary launches its marker: on a CUDA device, while the
    current stream is captured or a profiler runs."""
    return torch.cuda.is_initialized() and (
        profiling or torch.cuda.is_current_stream_capturing())


def _launch_marker(span_id: int, opening: bool) -> None:
    from federated_multi_modal_tpu_torch.ops.kernels import _build

    _build.launch("fmm_span_mark", span_id, int(opening))


def _open(span_id: int, marker: bool = True):
    """Open span ``span_id``: its host range (returned, or ``None``) and its
    marker."""
    profiling = _profiling()
    rng = None
    if profiling:
        rng = torch._C._profiler._RecordFunctionFast(SPANS[span_id])
        rng.__enter__()
    if marker and _markers_wanted(profiling):
        _launch_marker(span_id, True)
    return rng


def _close(span_id: int, rng, marker: bool = True) -> None:
    if marker and _markers_wanted(_profiling()):
        _launch_marker(span_id, False)
    if rng is not None:
        rng.__exit__(None, None, None)


class span:
    """``with span(name):`` marks the body as span ``name`` (in
    :data:`SPANS`); ``marker=False`` gives the host range alone."""

    __slots__ = ("_id", "_marker", "_range")

    def __init__(self, name: str, marker: bool = True):
        self._id = SPAN_ID[name]
        self._marker = marker
        self._range = None

    def __enter__(self):
        self._range = _open(self._id, self._marker)
        return self

    def __exit__(self, *exc):
        _close(self._id, self._range, self._marker)
        self._range = None
        return False


_LOCAL = threading.local()


def _backward_ranges(span_id: int) -> list:
    """This thread's open host ranges of backward span ``span_id`` (the
    autograd engine runs both nodes of a pair on one thread)."""
    if not hasattr(_LOCAL, "ranges"):
        _LOCAL.ranges = {}
    return _LOCAL.ranges.setdefault(span_id, [])


class _Boundary(torch.autograd.Function):
    """The identity; its backward opens (``opens``) or closes span
    ``span_id`` once every gradient of its outputs is in."""

    @staticmethod
    def forward(ctx, span_id, opens, *xs):
        ctx.span_id, ctx.opens = span_id, opens
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *grads):
        ranges = _backward_ranges(ctx.span_id)
        if ctx.opens:
            ranges.append(_open(ctx.span_id))
        else:
            _close(ctx.span_id, ranges.pop() if ranges else None)
        return (None, None, *grads)


def span_boundary(name: str, *trees, entry: bool) -> tuple:
    """``trees`` (tensors, or dicts, lists and tuples of them, ``None``
    where a tensor is absent) unchanged, with every tensor that needs a
    gradient passed through one identity node; used in pairs around a part
    of the forward whose backward is to be span ``<name>.backward``. The pair's exit node (``entry=False``, over
    the part's outputs) opens the span when its backward runs; its entry
    node (over everything that needs a gradient and enters the part, its
    trainable leaves included) closes it. The autograd engine runs a node's
    backward once every gradient of its outputs is in, so the span closes
    after the part's whole backward. Values and gradients pass bit for bit.
    Where no gradient is recorded, or no span would be marked, the trees
    come back as they are."""
    span_id = SPAN_ID[name + ".backward"]
    profiling = _profiling()
    if not torch.is_grad_enabled() or not (profiling or _markers_wanted(profiling)):
        return trees
    leaves = [t for t in flatten(trees).values() if t.requires_grad]
    if not leaves:
        return trees
    outs = iter(_Boundary.apply(span_id, not entry, *leaves))
    return tree_map_with_path(lambda _, t: next(outs) if t.requires_grad else t, trees)
