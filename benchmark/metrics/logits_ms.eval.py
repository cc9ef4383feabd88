"""Device time of the logits (normalisation, scale, the product with the text
features), per eval step (ms): the self time of the program's span ``logits``
(benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("logits",)


def read(t):
    return per_step_ms(t, "eval", SPANS)
