"""The run's process may hold nothing of JAX or of the JAX package: their
top-level module names (the part before the first dot), compared whole."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded(names=FORBIDDEN):
    """The loaded modules whose top-level name is one of ``names``."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)
