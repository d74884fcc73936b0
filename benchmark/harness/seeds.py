"""Seeds for each purpose of a run, derived from `--seed` (any whole
number, also one larger than 32 bits hold)."""

from __future__ import annotations

import numpy as np


def derive(seed: int, *salt: int) -> int:
    ss = np.random.SeedSequence([int(seed) % 2**64, *salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, *salt]))
