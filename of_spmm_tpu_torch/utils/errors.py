"""Typed errors and error frames, the port of the JAX package's
utils/errors.py.

- a typed hierarchy (``ShapeError``, ``PlacementError``, ...) under
  ``OfSpmmError`` so callers can catch by failure class; each is also
  the matching builtin (``ValueError`` or ``RuntimeError``);
- ``check(cond, msg, exc)``, the reference's CHECK_OR_RETURN;
- ``error_frame(msg)``, a context manager that adds a "while <msg>" note
  (PEP 678) to any exception passing through, innermost first.
"""

from __future__ import annotations

import contextlib
from typing import Type


class OfSpmmError(Exception):
    """Base class of the package's errors."""


class ShapeError(OfSpmmError, ValueError):
    """Operand shapes or dims are inconsistent."""


class PlacementError(OfSpmmError, ValueError):
    """SBP, mesh or sharding misuse."""


class ConfigError(OfSpmmError, ValueError):
    """A bad configuration value."""


class PlanError(OfSpmmError, RuntimeError):
    """A plan could not be built."""


class CapacityError(OfSpmmError, RuntimeError):
    """A plan or store does not fit the capacity it was sized for."""


def check(cond: bool, msg: str, exc: Type[Exception] = OfSpmmError) -> None:
    """Raise ``exc(msg)`` when ``cond`` is false."""
    if not cond:
        raise exc(msg)


def check_shape(cond: bool, msg: str) -> None:
    check(cond, msg, ShapeError)


def check_placement(cond: bool, msg: str) -> None:
    check(cond, msg, PlacementError)


@contextlib.contextmanager
def error_frame(msg: str):
    """Annotate an exception passing through with a note "  while <msg>";
    nested frames stack their notes innermost first."""
    try:
        yield
    except Exception as e:  # noqa: BLE001 -- annotate and re-raise
        e.add_note(f"  while {msg}")
        raise


__all__ = ["OfSpmmError", "ShapeError", "PlacementError", "ConfigError", "PlanError",
           "CapacityError", "check", "check_shape", "check_placement", "error_frame"]
