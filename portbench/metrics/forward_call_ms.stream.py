"""Engine, streamed: the host's time in each call of the engine's
`forward_batch`, from the call to its return, the mean over the window's
forwards (ms). It is the forward's enqueue together with any wait for room
on the device's launch queue, so it reads the slower of the host's issue
and the card: a gain in the host's issue moves it only down to the card's
time a forward."""


def read(ctx):
    if ctx["loop"] != "stream" or not ctx["spans"]:
        return None
    return 1e3 * sum(ctx["spans"]) / len(ctx["spans"])
