"""The check that a run loads nothing of JAX or of the JAX package: no
module in ``sys.modules`` whose top-level name (the part before the first
dot, compared whole) is one of :data:`FORBIDDEN`. The port, ``repro_torch``,
passes: its top-level name is not ``repro``."""
from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


class Forbidden(RuntimeError):
    """Raised by a run that finds a forbidden module loaded."""


def loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
