"""Cross-process consistency check: fail fast when ranks build different plans.

The port of the JAX package's parallel/consistency.py. If two ranks
disagree about a plan's shapes they deadlock in a collective; the
reference rendezvous-verifies placement metadata before global ops
(oneflow/core/framework/op_interpreter/eager_global_op_interpreter.cpp:
115-119, core/framework/consistency_check.cpp). Here each rank hashes its
plan's metadata and the ranks compare the digests in one all-gather.

The fingerprint covers the plan's structure (types, field names, nesting),
its static numbers and each array's shape and dtype, not the array
payloads. It cannot equal the JAX package's fingerprint of the same plan:
that hash includes a JAX treedef string.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from of_spmm_tpu_torch.distributed import current_device


def _meta(obj: Any):
    if isinstance(obj, torch.Tensor):
        return ["tensor", list(obj.shape), str(obj.dtype)]
    if isinstance(obj, np.ndarray):
        return ["array", list(obj.shape), str(obj.dtype)]
    if dataclasses.is_dataclass(obj):
        return [type(obj).__name__,
                {f.name: _meta(getattr(obj, f.name)) for f in dataclasses.fields(obj)}]
    if isinstance(obj, dict):
        return {str(k): _meta(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_meta(o) for o in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"plan_fingerprint: cannot describe a {type(obj).__name__}")


def plan_fingerprint(tree: Any) -> str:
    """Stable sha256 hex digest of a plan's structure, static numbers and
    array shapes and dtypes (dataclasses, tuples, dicts, numpy arrays and
    tensors)."""
    return hashlib.sha256(json.dumps(_meta(tree), sort_keys=True).encode()).hexdigest()


def check_consistent(tree: Any, name: str = "plan", group=None) -> str:
    """Raise RuntimeError if any rank of ``group`` disagrees on the
    fingerprint of ``tree``; return the fingerprint. Trivially consistent
    without a process group or with one rank."""
    fp = plan_fingerprint(tree)
    if not dist.is_initialized() or dist.get_world_size(group) <= 1:
        return fp
    digest = torch.tensor(list(bytes.fromhex(fp[:32])), dtype=torch.uint8,
                          device=current_device(group))
    parts = [torch.empty_like(digest) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, digest, group=group)
    me = dist.get_rank(group)
    bad = [r for r, d in enumerate(parts) if not torch.equal(d, parts[me])]
    if bad:
        raise RuntimeError(
            f"consistency check failed for {name!r}: ranks {bad} disagree with rank {me} "
            f"(local fingerprint {fp[:16]}...). All ranks must build identical plans: "
            f"check seeds and input data.")
    return fp
