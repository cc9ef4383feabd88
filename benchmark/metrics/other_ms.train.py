"""Device time of the step outside its layers (the copy into the state, the finite
count, the unused leaves' zeros, the markers of its spans), per train step (ms):
the self time of the program's spans ``step``, ``forward_backward``,
``backward`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("step", "forward_backward", "backward")


def read(t):
    return per_step_ms(t, "train", SPANS)
