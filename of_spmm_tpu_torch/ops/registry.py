"""Op registry: named ops with their implementations, oracle and sharding
rules.

Counterpart of the JAX package's ``of_spmm_tpu/ops/registry.py``, with
the same op names, oracles and sharding rules. ``impls`` are keyed
``"torch"`` (plain PyTorch) and, where the port has a kernel,
``"cuda"``, and ``spgemm``'s one impl ``"host"`` (a plan-time op). The
sharding rules are data: nothing consults them until the distributed
SpMM is ported. Importing the module registers the built-in ops; it
builds no kernel.

Atoms of a rule: "S0"/"S1" (split on that tensor axis), "B" (replicated),
"P" (partial sum: shards must be summed to be correct).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardingRule:
    """One legal (inputs -> outputs) sharding signature."""

    ins: Tuple[str, ...]
    outs: Tuple[str, ...]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class OpDef:
    name: str
    oracle: Callable
    impls: Dict[str, Callable]
    sharding_rules: Tuple[ShardingRule, ...]
    doc: str = ""

    def impl(self, name: str = "auto") -> Callable:
        """``"auto"``: the kernel where there is one and a card, else the
        plain version."""
        if name == "auto":
            name = "cuda" if "cuda" in self.impls and torch.cuda.is_available() else "torch"
        if name not in self.impls:
            raise KeyError(f"op {self.name!r} has no impl {name!r}; have {sorted(self.impls)}")
        return self.impls[name]


_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, oracle: Callable, impls: Dict[str, Callable],
                sharding_rules: Sequence[ShardingRule] = (), doc: str = "") -> OpDef:
    if name in _REGISTRY:
        raise ValueError(f"op {name!r} already registered")
    op = OpDef(name=name, oracle=oracle, impls=dict(impls),
               sharding_rules=tuple(sharding_rules), doc=doc)
    _REGISTRY[name] = op
    return op


def lookup(name: str) -> OpDef:
    if name not in _REGISTRY:
        raise KeyError(f"unknown op {name!r}; registered ops: {', '.join(all_ops())}")
    return _REGISTRY[name]


def all_ops() -> List[str]:
    return sorted(_REGISTRY)


def _populate() -> None:
    """Register the built-in op set (idempotent at import)."""
    if _REGISTRY:
        return
    from of_spmm_tpu_torch.ops import autograd as ag
    from of_spmm_tpu_torch.ops import reference as ref

    register_op(
        "gather", oracle=ref.gather, impls={"torch": ag.gather},
        sharding_rules=(
            ShardingRule(("B", "S0"), ("S0",), "indices split -> out split"),
            ShardingRule(("S0", "B"), ("P",),
                         "params row-split -> out partial-sum (zero fill off-shard)"),
            ShardingRule(("S1", "B"), ("S1",), "params col-split -> out col-split"),
        ),
        doc="out[i, :] = params[indices[i], :], out-of-range -> 0")
    register_op(
        "segment_sum", oracle=ref.segment_sum, impls={"torch": ag.segment_sum},
        sharding_rules=(
            ShardingRule(("S0", "S0"), ("P",), "data+ids split -> out partial-sum"),
            ShardingRule(("S1", "B"), ("S1",), "data col-split -> out col-split"),
            ShardingRule(("P", "B"), ("P",), "partial data -> partial out"),
        ),
        doc="out[ids[i], :] += data[i, :], out-of-range ids dropped")
    register_op(
        "spmv", oracle=ref.spmv, impls={"torch": ag.spmv},
        sharding_rules=(
            ShardingRule(("A:S0", "B"), ("S0",), "row-split A, replicated x"),
            ShardingRule(("A:S1", "S0"), ("P",), "col-split A, split x -> partial y"),
        ),
        doc="y = A @ x")
    register_op(
        "spmm", oracle=ref.spmm,
        impls={"torch": lambda b, x: ag._spmm_impl(b, x, "torch"),
               "cuda": lambda b, x: ag._spmm_impl(b, x, "cuda")},
        sharding_rules=(
            ShardingRule(("A:S0", "B"), ("S0",),
                         "row-split A, replicated X -> row-split Y (halo plan "
                         "makes the B requirement local: only halo rows move)"),
            ShardingRule(("A:S1", "S0"), ("P",),
                         "col-split A, row-split X -> partial Y (psum combine)"),
            ShardingRule(("A:B", "S1"), ("S1",), "feature-split X -> feature-split Y"),
        ),
        doc="Y = A @ X over a placed plan (binned, tiered or an engine's)")
    register_op(
        "sddmm", oracle=ref.sddmm, impls={"torch": ag.sddmm},
        sharding_rules=(
            ShardingRule(("S0", "B", "pattern:S0"), ("S0",),
                         "row-split lhs with row-split pattern"),
            ShardingRule(("S1", "S1", "pattern:B"), ("P",),
                         "feature-split contraction -> partial vals"),
        ),
        doc="vals[e] = lhs[rows[e]] . rhs[cols[e]]")
    register_op(
        "spmm_coo",
        oracle=lambda r, c, v, x, n: ref.segment_sum(v[:, None] * ref.gather(x, c), r, n),
        impls={"torch": ag.spmm_coo},
        sharding_rules=(
            ShardingRule(("S0", "S0", "S0", "B", "B"), ("P",),
                         "edge-split pattern+vals -> partial-sum out"),
        ),
        doc="Y = A @ X with run-time edge weights; differentiable in vals and x "
            "(GAT aggregation)")
    register_op(
        "segment_softmax", oracle=ag.segment_softmax, impls={"torch": ag.segment_softmax},
        sharding_rules=(ShardingRule(("B", "B"), ("B",), "replicated edge scores"),),
        doc="softmax over each segment (per-destination attention weights)")
    register_op(
        "spgemm", oracle=ref.spgemm, impls={"host": ref.spgemm},
        sharding_rules=(
            ShardingRule(("A:S0", "B:B"), ("C:S0",), "row-split A -> row-split C"),
        ),
        doc="C = A @ B, CSR x CSR -> CSR (plan-time, host)")


_populate()
