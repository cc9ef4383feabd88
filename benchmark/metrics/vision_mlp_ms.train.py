"""Device time of EVA's SwiGLU halves (LN2, the gated product, LN_ffn, W3 and the
residual) and their backward, per train step (ms): the self time of the program's
spans ``vision_mlp`` and ``vision_mlp.backward`` (benchmark/spans.py, whose copy of
the span names is older than these two: it reads them under their ids, 15 and 17,
as ``utils/profiling.py``'s SPANS numbers them). CLIP's blocks have no such span."""

from benchmark.spans import per_step_ms

SPANS = ("15", "17")


def read(t):
    return per_step_ms(t, "train", SPANS)
