"""Device time of the batch outside its layers (the canvas roll, the finite count,
the markers of its spans), per eval step (ms): the self time of the program's
span ``step`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("step",)


def read(t):
    return per_step_ms(t, "eval", SPANS)
