"""The run's process must not hold JAX or the JAX package.

Module names are compared by their top-level part (before the first dot)
as a whole: the port, vsearch_tpu_torch, begins with the JAX package's
name, vsearch_tpu, so a test of prefixes would be wrong.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vsearch_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among module names."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden top-level names in this process's sys.modules."""
    return forbidden(list(sys.modules))
