"""Device time of the prompt learner (its couplers, the caption token) and its
backward, per train step (ms): the self time of the program's spans
``prompt_learner``, ``prompt_learner.backward`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("prompt_learner", "prompt_learner.backward")


def read(t):
    return per_step_ms(t, "train", SPANS)
