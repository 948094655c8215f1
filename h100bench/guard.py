"""The check that no JAX and no module of the JAX package is loaded.

A module is compared by its top-level name, the part before the first
dot, whole: ``vision_processor_tpu_torch`` (the port) passes although its
name begins with the JAX package's.
"""
from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vision_processor_tpu"})


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level name is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
