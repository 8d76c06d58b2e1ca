"""Model step: device time of the "other" kernels (every kernel outside
K1-K4, the library GEMMs, cuDNN and copies) in the profiled blocks, per
clip those blocks served (ms)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["profiled_clips"] or "other" not in t["groups"]:
        return None
    return 1e3 * t["groups"]["other"] / ctx["profiled_clips"]
