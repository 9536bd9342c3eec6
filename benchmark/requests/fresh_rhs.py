"""Request generator ``fresh_rhs``: each request a fresh right-hand side
on the fixed operator, every entry of b independent N(0, 1), drawn from
the run's seed. The same seed gives the same sequence, so the check draws
it again to judge each answer against its own b.
"""

from __future__ import annotations

import numpy as np


def make(spec: dict, n: int, seed: int):
    rng = np.random.default_rng([int(seed), 1])
    while True:
        yield rng.standard_normal(n)
