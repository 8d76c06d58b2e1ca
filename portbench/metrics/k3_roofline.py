"""Kernels: K3's share of its roofline in the profiled blocks: the bound
of the calls launched (forwards = K3 launches over its calls a forward)
over K3's device time (%)."""


def read(ctx):
    t = ctx["trace"]
    calls, bound = ctx["calls"]["K3"]
    launched = ctx["launches"].get("adapter_bottleneck", 0)
    busy = t["groups"].get("K3", 0.0) if t else 0.0
    if not calls or not launched or busy <= 0.0:
        return None
    return 100.0 * launched / calls * bound / busy
