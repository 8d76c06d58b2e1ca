"""Engine, by request: the host's time in each call of the engine's
`forward_batch`, from the call to its return, the mean over the window's
forwards (ms). Each request starts on an empty launch queue (the one before
was waited for), so this reads the host's issue of a forward, and a wait
for room on the queue only where the card falls behind within it."""


def read(ctx):
    if ctx["loop"] != "request" or not ctx["spans"]:
        return None
    return 1e3 * sum(ctx["spans"]) / len(ctx["spans"])
