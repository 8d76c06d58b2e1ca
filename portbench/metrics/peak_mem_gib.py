"""Device: `torch.cuda.max_memory_allocated()` over the window, the peak
statistics reset at its start (GiB)."""


def read(ctx):
    if not ctx["window_peak_bytes"]:
        return None
    return ctx["window_peak_bytes"] / 2 ** 30
