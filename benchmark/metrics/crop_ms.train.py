"""Device time of the on-device crop (random resized crops, flips, normalisation),
per train step (ms): the self time of the program's span ``crop``
(benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("crop",)


def read(t):
    return per_step_ms(t, "train", SPANS)
