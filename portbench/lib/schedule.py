"""The open-loop arrival schedule of a serving run.

``arrivals(seed, rate, seconds, n_bodies)``: rate x seconds requests. The
gaps between them are the quantiles of the exponential distribution of
mean 1 / rate (a Poisson process's gaps), scaled so that the last request
falls inside the window, and the seed permutes them; each body is sent
equally often, in an order the seed permutes too. So every seed offers the
same set of gaps and bodies, in another order.

``masks(seed, n, share)``: which of n requests ask for the class map
(``format=mask``) rather than the numbers (``format=json``): a fixed
count, round(share x n), placed by the seed.
"""
from __future__ import annotations

import numpy as np

STREAM = 8


def arrivals(seed: int, rate: float, seconds: float, n_bodies: int
             ) -> list[tuple[float, int]]:
    """[(send time in seconds from the window's start, body index)]."""
    n = int(round(rate * seconds))
    if n <= 0:
        return []
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng([seed, STREAM])
    gaps = rng.permutation(gaps)
    gaps *= seconds * n / (n + 1) / gaps.sum()
    times = np.cumsum(gaps) - gaps[0]
    bodies = rng.permutation(np.arange(n) % n_bodies)
    return [(float(t), int(b)) for t, b in zip(times, bodies)]


def masks(seed: int, n: int, share: float) -> list[bool]:
    k = int(round(share * n))
    flags = np.zeros(n, bool)
    flags[:k] = True
    return [bool(f) for f in
            np.random.default_rng([seed, STREAM, 1]).permutation(flags)]
