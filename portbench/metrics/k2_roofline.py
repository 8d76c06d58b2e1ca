"""Kernels: K2's share of its roofline in the profiled blocks: the bound
of the calls launched (forwards = K2 launches over its calls a forward)
over K2's device time (%)."""


def read(ctx):
    t = ctx["trace"]
    calls, bound = ctx["calls"]["K2"]
    launched = ctx["launches"].get("block_attention", 0)
    busy = t["groups"].get("K2", 0.0) if t else 0.0
    if not calls or not launched or busy <= 0.0:
        return None
    return 100.0 * launched / calls * bound / busy
