"""Typed errors of the port (the JAX package's utils/errors.py keeps the
full hierarchy; the port has only what its ported paths raise)."""

from __future__ import annotations


class CapacityError(RuntimeError):
    """A plan or store does not fit the device memory it was sized for."""
