"""What the process that prints the result may not hold: JAX, its relatives,
or the JAX package whose port is measured, compared by whole top-level
module names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "vosesam_tpu")


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
