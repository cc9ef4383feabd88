"""The SwiGLU gate's share of its roofline in the train window (%): the least time
the card needs for the work tagged ``"part": "swiglu"`` in the cell's gemm work
(benchmark/counts/eva02.py: the gated product of W1 and W2 with its epilogue, and
the gate's backward fused with LN_ffn's, each bound by its FLOPs or its bytes; an
entry's ``part_flops`` and ``part_bytes`` where it carries them) over the device
time of the operations whose names match metrics/patterns/swiglu/ (those kernels'
instances alone)."""

from benchmark.counts.flops import bound_seconds


def read(t):
    if t.kind != "train":
        return None
    ops = [{"flops": o.get("part_flops", o["flops"]), "bytes": o.get("part_bytes", o["bytes"])}
           for o in t.work.get("gemm", []) if o.get("part") == "swiglu"]
    seconds = t.kernel_seconds("swiglu")
    if not ops or not seconds:
        return None
    return 100.0 * bound_seconds(ops) * t.steps / seconds
