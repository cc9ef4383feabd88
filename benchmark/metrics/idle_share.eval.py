"""Share of the eval window in which no operation ran on the device (%)."""


def read(t):
    if not t.kernels or t.kind != "eval" or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
