"""Ingest: device time of the host-to-device copies in the profiled
blocks, per clip those blocks served (ms)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["profiled_clips"]:
        return None
    return 1e3 * t["h2d_s"] / ctx["profiled_clips"]
