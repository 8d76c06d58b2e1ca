"""Model step: the model FLOPs of the clips the window completed (counted
once at set-up over the reference forward on "meta") over the window's
seconds and the card's bf16 dense peak (%)."""


def read(ctx):
    if not ctx["clips"]:
        return None
    return 100.0 * ctx["flops_per_clip"] * ctx["clips"] / ctx["window_s"] / ctx["peak_flops"]
