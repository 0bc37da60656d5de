"""Traffic engines: each traffic file names one (``"engine"``), which reads
its parameters and drives the receiver through one kind of work."""

import numpy as np


class Reservoir:
    """A uniform sample of ``k`` of the units completed in a window, drawn
    from the seed (Algorithm R), whatever their count turns out to be."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k = k
        self.rng = rng
        self.seen = 0
        self.items: list = []

    def offer(self, make):
        """Count one completed unit; keep ``make()`` if it is drawn."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append((i, make()))
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = (i, make())

    def sample(self) -> list:
        return sorted(self.items, key=lambda it: it[0])
