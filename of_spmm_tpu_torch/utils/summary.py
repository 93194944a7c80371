"""Metrics/event writer — training observability; the counterpart of the
JAX package's ``utils/summary.py``.

The durable format is JSON-lines (one event per line: wall time, step,
tag, value), the JAX package's records: a file written by one package
reads in the other, equal except for ``ts``. Values may be tensors (a
loss on the card): ``add_scalar`` takes ``float(value)``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


class SummaryWriter:
    """Append-only scalar/metric logger.

        w = SummaryWriter("runs/exp1")
        w.add_scalar("loss", 0.93, step=10)
        w.add_scalars("eval", {"acc": 0.8, "f1": 0.7}, step=10)
        w.close()
    """

    def __init__(self, log_dir: str, filename: str = "events.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._lock = threading.Lock()

    def add_scalar(self, tag: str, value: Any, step: Optional[int] = None):
        rec = {
            "ts": time.time(),
            "step": int(step) if step is not None else None,
            "tag": tag,
            "value": float(value),
        }
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")

    def add_scalars(self, prefix: str, values: Dict[str, Any],
                    step: Optional[int] = None):
        for k, v in values.items():
            self.add_scalar(f"{prefix}/{k}", v, step=step)

    def add_text(self, tag: str, text: str, step: Optional[int] = None):
        rec = {"ts": time.time(), "step": step, "tag": tag, "text": text}
        with self._lock:
            self._f.write(json.dumps(rec) + "\n")

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        with self._lock:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_events(log_dir: str, filename: str = "events.jsonl"):
    """Load logged events back as a list of dicts."""
    path = os.path.join(log_dir, filename)
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
