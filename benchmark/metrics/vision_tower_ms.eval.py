"""Device time of the vision tower, per eval step (ms): the self time of the
program's span ``vision_tower`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("vision_tower",)


def read(t):
    return per_step_ms(t, "eval", SPANS)
