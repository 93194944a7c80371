"""Typed environment-variable flags.

Flags are declared once with a type and default, read from the process
environment on each access, and can be overridden programmatically for
tests. Only the flags the port reads are declared here.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_TRUE = frozenset({"1", "true", "yes", "on"})
_FALSE = frozenset({"0", "false", "no", "off"})


def _parse_bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"cannot parse boolean flag value {s!r}")


@dataclass
class _Flag:
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str = ""


class FlagRegistry:
    """Process-wide registry of typed env flags with test overrides."""

    def __init__(self) -> None:
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, default: Any, parser: Callable[[str], Any], doc: str = "") -> None:
        with self._lock:
            if name in self._flags:
                raise ValueError(f"flag {name} already defined")
            self._flags[name] = _Flag(name, default, parser, doc)

    def define_bool(self, name: str, default: bool, doc: str = "") -> None:
        self.define(name, default, _parse_bool, doc)

    def define_int(self, name: str, default: int, doc: str = "") -> None:
        self.define(name, default, int, doc)

    def define_str(self, name: str, default: str, doc: str = "") -> None:
        self.define(name, default, str, doc)

    def get(self, name: str) -> Any:
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
            flag = self._flags[name]
        raw = os.environ.get(name)
        if raw is None:
            return flag.default
        return flag.parser(raw)

    def override(self, name: str, value: Optional[Any]) -> None:
        """Set (or clear, with None) a programmatic override. For tests."""
        with self._lock:
            if name not in self._flags:
                raise KeyError(f"unknown flag {name}")
            if value is None:
                self._overrides.pop(name, None)
            else:
                self._overrides[name] = value

    def all_flags(self) -> Dict[str, Any]:
        with self._lock:
            names = list(self._flags)
        return {n: self.get(n) for n in names}


FLAGS = FlagRegistry()

FLAGS.define_int(
    "OFS_MAX_ELL_WIDTH",
    256,
    "Maximum ELL bucket width; rows with more nnz are split (load balancing).",
)
FLAGS.define_int(
    "OFS_SPMM_MAX_GATHER_SLOTS",
    2 * 1024 * 1024,
    "Max (rows*width) slots the plain tiered SpMM gathers at once; larger "
    "buckets run in row chunks (bounds the materialized block to "
    "slots * d * 4 bytes).",
)
FLAGS.define_int(
    "OFS_TIERED_SCATTER_BYTES",
    1_500_000_000,
    "Plain tiered-SpMM assembly cutoff: plans whose ELL-row results exceed "
    "this many bytes write each bucket into one preallocated buffer instead "
    "of concatenating the per-bucket results (which holds both at once).",
)
FLAGS.define_int(
    "OFS_FUSED_T",
    0,
    "Force the panel engine's lanes-per-step T (sparse/panels.py); the "
    "JAX package's flag of the same name, with the same meaning, so one "
    "environment gives equal plans in both. 0 = adaptive "
    "(panels.default_panels_t).",
)
FLAGS.define_int(
    "OFS_HBM_BYTES",
    0,
    "Device memory bytes for the panel plan's memory budget "
    "(sparse/fused.py device_hbm_bytes); the JAX package's flag of the same "
    "name. 0 = the card's total memory, or an H100's 80 GB on a host "
    "without a card.",
)
