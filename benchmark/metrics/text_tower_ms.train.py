"""Device time of the packed text tower over the class prompts and its backward,
per train step (ms): the self time of the program's spans ``text_tower``,
``text_tower.backward`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("text_tower", "text_tower.backward")


def read(t):
    return per_step_ms(t, "train", SPANS)
