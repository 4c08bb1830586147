"""Which modules a process must not hold: JAX, its libraries and the JAX
package, compared by the whole top-level name (the part before the first
dot), since the port's name begins with the JAX package's."""

from __future__ import annotations

from typing import Iterable

__all__ = ["FORBIDDEN", "PORT", "forbidden_modules", "top_level"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "object_detection_destr_tpu"})
PORT = "object_detection_destr_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(names: Iterable[str], also: Iterable[str] = ()) -> set[str]:
    """The names among ``names`` whose top level is forbidden (or in ``also``)."""
    banned = FORBIDDEN | frozenset(also)
    return {n for n in names if top_level(n) in banned}
