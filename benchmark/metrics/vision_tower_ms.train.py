"""Device time of the vision tower and its backward, per train step (ms): the self
time of the program's spans ``vision_tower``, ``vision_tower.backward``
(benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("vision_tower", "vision_tower.backward")


def read(t):
    return per_step_ms(t, "train", SPANS)
