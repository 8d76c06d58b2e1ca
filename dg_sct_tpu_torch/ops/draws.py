"""Random draws from an explicit generator, whole or by a data-parallel
rank's rows. Every stochastic op of the port draws through `draw`."""
from __future__ import annotations


class RowShard:
    """A generator's draws for this rank's rows of a data-parallel batch:
    each draw is made at the global batch's size (this rank's rows times
    `world`) and rows [rank * n, (rank + 1) * n) of its batch axis are kept.
    Every rank holds the same seed, so each draws what one process would
    draw for the whole batch and the ranks' draws tile it."""

    def __init__(self, gen, rank: int, world: int):
        self.gen, self.rank, self.world = gen, rank, world


def draw(gen, fn, shape, batch_axis=0):
    """`fn(shape, generator)`, or under a `RowShard` this rank's rows of
    `fn` at the global batch's shape (`batch_axis` is the batch's)."""
    if not isinstance(gen, RowShard):
        return fn(tuple(shape), gen)
    n = shape[batch_axis]
    full = list(shape)
    full[batch_axis] = n * gen.world
    return fn(tuple(full), gen.gen).narrow(batch_axis, gen.rank * n, n)
