"""Device, by request: the share of the profiled span (first device activity to the
last) in which no kernel or copy ran (%)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
