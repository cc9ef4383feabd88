"""Device time of FedAvg (``parallel/fedavg.py::fedavg_over_clients``: the clients'
trainable leaves averaged on the home card), per local train step (ms): the self
time of the program's span ``fedavg`` (id 16 in ``utils/profiling.py``'s SPANS,
newer than benchmark/spans.py's copy of the names) on each card's own timeline
(``Trace.per_device``), summed over the cards, over the window's local steps."""

from types import SimpleNamespace

from benchmark import spans

SPAN = "16"


def read(t):
    if t.kind != "train" or not t.steps:
        return None
    total, found = 0.0, False
    for dev in sorted(t.per_device):
        res = spans.read(SimpleNamespace(kernels=t.per_device[dev]))
        if res is not None and SPAN in res["spans"]:
            total += res["spans"][SPAN]["self_s"]
            found = True
    return 1e3 * total / t.steps if found else None
