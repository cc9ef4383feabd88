"""Device time of the on-device centre crop, per eval step (ms): the self time of
the program's span ``crop`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("crop",)


def read(t):
    return per_step_ms(t, "eval", SPANS)
