"""Auto-parallel: greedy min-copy-cost signature selection, the port of
the JAX package's parallel/auto_sharding.py (host Python, no tensors).

Every op enumerates its legal sharding signatures (the ``ShardingRule``s
of ops/registry.py), and ``choose_signature`` picks the one whose inputs
cost least to box from their producers' placements, as the reference's
``Operator::GreedilyFindMinCopyCostNdSbp`` (operator.cpp:713-812) does.
The cost of a transition on a mesh axis of size p is the bytes per shard
that its collective moves (ring algorithms):

    S->B   all_gather       (p-1)/p * nbytes
    P->B   all_reduce     2*(p-1)/p * nbytes
    P->S   reduce_scatter   (p-1)/p * nbytes
    S->S'  all_to_all       (p-1)/p * nbytes / p
    B->S   local slice      0
    B->P   zero-all-but-one 0

A transition with no direct collective goes through B, as the
reference's boxing collector bridges it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from of_spmm_tpu_torch.ops.registry import OpDef, ShardingRule, lookup

Atom = str  # "S<k>", "B", "P"

_INF = math.inf


def _strip(atom: str) -> Atom:
    """Rule atoms may carry an argument prefix: "A:S0" -> "S0"."""
    return atom.split(":", 1)[1] if ":" in atom else atom


def _is_split(a: Atom) -> bool:
    return a.startswith("S")


def direct_cost(src: Atom, dst: Atom, nbytes: float, p: int) -> float:
    """Bytes per shard moved by the one collective for src -> dst; inf
    when no single collective does it (S -> P)."""
    if p <= 1 or src == dst:
        return 0.0
    f = (p - 1) / p
    if src == "B":
        return 0.0  # a local slice (B -> S) or zeros (B -> P)
    if src == "P":
        if dst == "B":
            return 2.0 * f * nbytes  # all_reduce
        if _is_split(dst):
            return f * nbytes  # reduce_scatter
        return _INF
    if _is_split(src):
        if dst == "B":
            return f * nbytes  # all_gather
        if _is_split(dst):
            return f * nbytes / p  # all_to_all on 1/p-size shards
        return _INF
    return _INF


def boxing_cost(src: Atom, dst: Atom, nbytes: float, p: int) -> float:
    """The cheaper of the direct transition and the bridge through B."""
    c = direct_cost(src, dst, nbytes, p)
    via_b = direct_cost(src, "B", nbytes, p) + direct_cost("B", dst, nbytes, p)
    return min(c, via_b)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The signature chosen for one op."""

    op: str
    rule: ShardingRule
    in_atoms: Tuple[Atom, ...]  # the inputs' required atoms (prefixes stripped)
    out_atoms: Tuple[Atom, ...]
    copy_cost: float  # bytes per shard to box the producers into place
    per_input: Tuple[float, ...]


def choose_signature(op: OpDef, producer_atoms: Sequence[Atom],
                     input_nbytes: Sequence[float], p: int) -> Placement:
    """The op's signature of least copy cost from its producers' atoms;
    ties go to the rule declared first."""
    if not op.sharding_rules:
        raise ValueError(f"op {op.name!r} declares no sharding rules")
    if len(producer_atoms) and len(op.sharding_rules[0].ins) != len(producer_atoms):
        raise ValueError(f"op {op.name!r} rules take {len(op.sharding_rules[0].ins)} inputs, "
                         f"got {len(producer_atoms)} producer atoms")
    best: Optional[Placement] = None
    for rule in op.sharding_rules:
        req = tuple(_strip(a) for a in rule.ins)
        per = tuple(boxing_cost(src, dst, nb, p)
                    for src, dst, nb in zip(producer_atoms, req, input_nbytes))
        total = sum(per)
        if best is None or total < best.copy_cost:
            best = Placement(op=op.name, rule=rule, in_atoms=req,
                             out_atoms=tuple(_strip(a) for a in rule.outs),
                             copy_cost=total, per_input=per)
    return best


@dataclasses.dataclass(frozen=True)
class ChainStep:
    """One op of a linear chain: step i's output feeds input 0 of step
    i + 1. ``extra_atoms`` / ``extra_nbytes`` are its other inputs, whose
    placements are fixed."""

    op: str
    extra_atoms: Tuple[Atom, ...] = ()
    extra_nbytes: Tuple[float, ...] = ()
    out_nbytes: float = 0.0


def plan_chain(steps: Sequence[ChainStep], first_atom: Atom, first_nbytes: float,
               p: int) -> Tuple[List[Placement], float]:
    """Greedy placement along a chain of registered ops, each op seeing
    only its producers' fixed placements (no global search). Returns the
    placements and the total copy cost (bytes per shard)."""
    placements: List[Placement] = []
    cur_atom, cur_bytes = first_atom, first_nbytes
    total = 0.0
    for step in steps:
        pl = choose_signature(lookup(step.op), (cur_atom,) + tuple(step.extra_atoms),
                              (cur_bytes,) + tuple(step.extra_nbytes), p)
        placements.append(pl)
        total += pl.copy_cost
        cur_atom = pl.out_atoms[0]
        cur_bytes = step.out_nbytes or cur_bytes
    return placements, total


__all__ = ["direct_cost", "boxing_cost", "Placement", "choose_signature", "ChainStep",
           "plan_chain"]
