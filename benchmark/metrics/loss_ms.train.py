"""Device time of the loss from the features on (normalisation, logits, cross-
entropy, alignment) and its backward, per train step (ms): the self time of the
program's spans ``loss``, ``loss.backward`` (benchmark/spans.py)."""

from benchmark.spans import per_step_ms

SPANS = ("loss", "loss.backward")


def read(t):
    return per_step_ms(t, "train", SPANS)
