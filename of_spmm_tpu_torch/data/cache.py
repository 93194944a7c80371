"""Plan-time artifact cache: graphs pickled host-side.

Building a 10^7-nnz graph (generate, symmetrize, sort) is seconds to
minutes of host work and a pure function of (graph, options), so it is
pickled once and reused. Artifacts are numpy data; nothing device-side is
stored.

Cache root: $OFS_TORCH_CACHE_DIR, else ~/.cache/ofs_torch_data. It is
separate from the JAX package's cache, whose pickles hold that package's
classes.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable


def cache_root() -> str:
    return os.environ.get(
        "OFS_TORCH_CACHE_DIR", os.path.expanduser("~/.cache/ofs_torch_data")
    )


def cache_path(kind: str, key: str) -> str:
    h = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(cache_root(), f"{kind}-{h}.pkl")


def cached(kind: str, key: str, build: Callable[[], Any], refresh: bool = False) -> Any:
    """Return the cached artifact for (kind, key), building it on a miss.

    The key string should encode every option that affects the artifact
    (graph name, seed, normalization, code version).
    """
    path = cache_path(kind, key)
    if not refresh and os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError):
            pass  # corrupt or stale entry: rebuild
    artifact = build()
    os.makedirs(cache_root(), exist_ok=True)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(artifact, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return artifact
