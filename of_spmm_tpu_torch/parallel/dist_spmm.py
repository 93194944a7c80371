"""Distributed SpMM: halo exchange, then the local SpMM of each shard.

The execution of a RowPartitionPlan (parallel/partition.py), the port of
the JAX package's parallel/dist_spmm.py. Each shard p runs one body
(``shard_body``): the local SpMM over [own X | halo | hub rows] with the
plan's remapped columns, or, on a split plan, the interior piece over
[own X | hub rows] plus the boundary piece over the whole. The body runs
in two forms, which differ only in how the halo and hub rows arrive:

- a shard mesh in one process (``ShardMesh``; the counterpart of the JAX
  package's ``shard_map`` over a device mesh): ``dist_spmm(plan, x, mesh)``
  takes the global X and returns the global Y. Rows move between shards
  with ``index_select`` and ``.to(device)``; autograd derives the reverse
  exchange. A mesh may hold one device several times.
- one rank per process over ``torch.distributed`` (``RankGroup``):
  ``dist_spmm(plan, x_block, group)`` takes this rank's padded X block,
  (cols_per_shard, d), and returns its Y block, (rows_per_shard, d). The
  padded halo is one all-to-all, a ragged halo one ring shift per offset k
  (send to (p + k) % S, receive from (p - k) % S), the hub rows an
  all-gather; each collective's backward is the reverse one (comm).

The local SpMM is an autograd Function whose backward runs the same engine
on the shard's transpose plan (dXcat = A_local^T @ dY), as ``spmm`` does
(ops/autograd.py); the plan arrays get no gradient. A plan built with
``with_transpose=False`` has no backward. On a split plan the backward is
the one combined transpose plan, and the interior input's gradient is a
structural zero (its contribution is inside dXcat).

``impl`` picks the local engine: ``"cuda"`` the bucket kernel on the
binned buckets (ops/cuda/spmm.py ``bucket_spmm_plan``), ``"torch"`` their
plain version, ``"panels"`` the panel kernel on the per-shard panel plans
(ops/cuda/panels.py ``panel_spmm``; its plain version on CPU tensors),
``"panels_torch"`` the panel plans' plain version, ``"auto"`` ``"cuda"``
for CUDA tensors and ``"torch"`` for CPU ones. The JAX package's names:
"xla" is "torch", "pallas" is "cuda". Shard-local binned plans have no
finish: their buckets combine by scatter-add.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from of_spmm_tpu_torch import comm
from of_spmm_tpu_torch.distributed import current_device
from of_spmm_tpu_torch.ops.autograd import _spmm_impl
from of_spmm_tpu_torch.ops.cuda.spmm import bucket_work
from of_spmm_tpu_torch.parallel.partition import RowPartitionPlan, make_panel_plan
from of_spmm_tpu_torch.sparse.binned import BinnedEll, EllBucket
from of_spmm_tpu_torch.sparse.panels import attach_windows, compact_masks, ensure_masks
from of_spmm_tpu_torch.utils.device import place_arrays

IMPLS = ("auto", "torch", "cuda", "panels", "panels_torch")


# ---------------------------------------------------------------------------
# Placement: one shard's plan on its device.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LocalOp:
    """One local matrix, placed: a BinnedEll with the bucket kernel's work
    list, or a PanelPlan with its windows (``work`` None)."""

    plan: Any
    work: Any = None


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Shard p's part of a RowPartitionPlan on ``device``: its send lists,
    hub indices and local matrices (None where the plan has none)."""

    p: int
    device: torch.device
    send_idx: torch.Tensor  # (S*H,) int64: own rows sent to q at [q*H, (q+1)*H)
    offset_send: Tuple[torch.Tensor, ...]  # ragged: (H_k,) own rows sent to (p+k)%S
    hub_idx: Optional[torch.Tensor]  # (Kmax,) own rows of p's hub slots
    hub_perm: Optional[torch.Tensor]  # (K,) gathered slab -> hub rank order
    gather_idx: torch.Tensor  # (halo + K,) rows of the padded global X (all-gather form)
    buckets: Optional[LocalOp]  # unsplit binned
    interior: Optional[LocalOp]  # split binned
    boundary: Optional[LocalOp]
    transpose: Optional[LocalOp]  # binned A_local^T
    panel_fwd: Optional[LocalOp]  # boundary piece on split plans
    panel_int: Optional[LocalOp]
    panel_bwd: Optional[LocalOp]


def _binned(stack, p: int, shape, device) -> Optional[LocalOp]:
    """Shard p's buckets of a stack, each cut after its last row with a
    nonzero value: the rows the stack pads a shard with (and bin_rows'
    own padding to a multiple of 8) repeat one row id with zero values,
    and their scatter-adds would all hit that one output row."""
    if stack is None:
        return None
    buckets = []
    for b in stack:
        live = np.flatnonzero(b.vals[p].any(axis=1))
        r = int(live[-1]) + 1 if live.size else 0
        if r:
            buckets.append(EllBucket(row_ids=b.row_ids[p, :r], cols=b.cols[p, :r],
                                     vals=b.vals[p, :r]))
    ell = place_arrays(BinnedEll(buckets=tuple(buckets), shape=shape, has_split_rows=True),
                       device)
    return LocalOp(ell, bucket_work(ell) if ell.buckets else None)


def _panels(stack, aux, p: int, device) -> Optional[LocalOp]:
    if stack is None:
        return None
    plan = make_panel_plan(tuple(a[p] for a in stack), aux)
    seg = plan.segments[0]
    edges, counts = compact_masks(seg.masks)
    seg = dataclasses.replace(seg, masks=None, mask_edges=edges, mask_counts=counts)
    plan = ensure_masks(attach_windows(dataclasses.replace(plan, segments=(seg,))), device)
    return LocalOp(place_arrays(plan, device))


def _long(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def place_shard(plan: RowPartitionPlan, p: int, device) -> ShardPlan:
    """Shard p's arrays on ``device``, with the bucket kernel's work lists
    and the panel plans' windows built once here."""
    device = torch.device(device)
    S, cps, H = plan.n_shards, plan.cols_per_shard, plan.halo_size
    n_xcat = cps + plan.halo_rows_total + plan.n_hubs
    # rows of the padded global X that p's halo and hub slots hold
    if plan.ragged:
        halo_rows = [((p - k) % S) * cps + plan.offset_send[k - 1][(p - k) % S]
                     for k in range(1, S)]
    else:
        halo_rows = [q * cps + plan.send_idx[q, p] for q in range(S)]
    hub_rows = []
    if plan.n_hubs:
        slab = np.arange(S)[:, None] * cps + plan.hub_local_idx
        hub_rows = [slab.reshape(-1)[plan.hub_perm]]
    aux_f, aux_b, aux_i = plan.panel_aux or (None, None, None)
    return ShardPlan(
        p=p, device=device,
        send_idx=_long(plan.send_idx[p].reshape(-1), device),
        offset_send=tuple(_long(s[p], device) for s in plan.offset_send or ()),
        hub_idx=_long(plan.hub_local_idx[p], device) if plan.n_hubs else None,
        hub_perm=_long(plan.hub_perm, device) if plan.n_hubs else None,
        gather_idx=_long(np.concatenate(halo_rows + hub_rows), device),
        buckets=None if plan.split else _binned(plan.buckets, p, (plan.rows_per_shard, n_xcat),
                                                device),
        interior=_binned(plan.interior_buckets, p, (plan.rows_per_shard, n_xcat), device),
        boundary=_binned(plan.boundary_buckets, p, (plan.rows_per_shard, n_xcat), device),
        transpose=_binned(plan.transpose_buckets, p, (n_xcat, plan.rows_per_shard), device),
        panel_fwd=_panels(plan.panel_fwd, aux_f, p, device),
        panel_int=_panels(plan.panel_int, aux_i, p, device),
        panel_bwd=_panels(plan.panel_bwd, aux_b, p, device))


# ---------------------------------------------------------------------------
# The two execution forms.
# ---------------------------------------------------------------------------


class _Placements:
    """What was placed for a plan object, built once per plan and ``key``
    (the plan is held, so ids stay unique)."""

    def __init__(self):
        self._placed: Dict[tuple, tuple] = {}

    def _cached(self, plan, build, *key):
        key = (id(plan),) + key
        hit = self._placed.get(key)
        if hit is None or hit[0] is not plan:
            hit = (plan, build())
            self._placed[key] = hit
        return hit[1]


class ShardMesh(_Placements):
    """S shards in one process, shard p on ``devices[p]``. A device may
    appear several times: ``ShardMesh(["cuda:0"] * 4)`` runs four shards on
    one card, ``ShardMesh(["cpu"] * 4)`` on the CPU."""

    def __init__(self, devices: Sequence):
        super().__init__()
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a ShardMesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def place(self, plan: RowPartitionPlan) -> List[ShardPlan]:
        """Every shard's part of ``plan`` on its device (once per plan)."""
        return self._cached(plan, lambda: [place_shard(plan, p, d)
                                           for p, d in enumerate(self.devices)])

    def index(self, plan: RowPartitionPlan, name: str, device) -> Optional[torch.Tensor]:
        """The plan's ``x_pack_idx`` or ``y_unpack_idx`` on ``device``
        (None on uniform plans), copied there once."""
        a = getattr(plan, name)
        if a is None:
            return None
        return self._cached(plan, lambda: _long(a, device), name, torch.device(device))


class RankGroup(_Placements):
    """This process's rank of a ``torch.distributed`` group (None: the
    default group), its shard on ``device`` (default: the current card
    under NCCL, the CPU under gloo)."""

    def __init__(self, group=None, device=None):
        super().__init__()
        if not dist.is_initialized():
            raise RuntimeError("RankGroup needs a process group: run "
                               "of_spmm_tpu_torch.distributed.initialize() first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device) if device is not None else current_device(group)

    def place(self, plan: RowPartitionPlan) -> ShardPlan:
        """This rank's part of ``plan`` on its device (once per plan)."""
        return self._cached(plan, lambda: place_shard(plan, self.rank, self.device))


def default_mesh(n_devices: Optional[int] = None) -> ShardMesh:
    """A mesh over cuda:0 .. cuda:n-1 (all cards by default); raises when
    fewer cards exist. Pass a device several times to ShardMesh to run
    more shards than cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if n < 1 or n > have:
        raise RuntimeError(f"default_mesh({n_devices}) needs {max(n, 1)} CUDA devices, "
                           f"found {have}; build ShardMesh(devices) to repeat a device")
    return ShardMesh([f"cuda:{i}" for i in range(n)])


# ---------------------------------------------------------------------------
# The local SpMM and the shard body.
# ---------------------------------------------------------------------------


def _no_transpose():
    return RuntimeError("this plan was built with partition_rows(..., with_transpose=False): "
                        "its local SpMM has no backward")


class _LocalSpmm(torch.autograd.Function):
    """y = A_local @ xcat; dxcat = A_local^T @ dy through the same engine."""

    @staticmethod
    def forward(ctx, xcat, fwd: LocalOp, t: Optional[LocalOp], route: str):
        ctx.t, ctx.route = t, route
        return _spmm_impl(fwd.plan, xcat.contiguous(), route, fwd.work)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if ctx.t is None:
            raise _no_transpose()
        return _spmm_impl(ctx.t.plan, dy.contiguous(), ctx.route, ctx.t.work), None, None, None


class _SplitLocalSpmm(torch.autograd.Function):
    """y = A_int @ x_int + A_bnd @ xcat, x_int = [own X | hub rows]. The
    backward runs the one combined transpose plan into dxcat; x_int's
    gradient is a structural zero (A_local = A_int + A_bnd in xcat's index
    space, so dxcat already holds it)."""

    @staticmethod
    def forward(ctx, x_int, xcat, interior: LocalOp, boundary: LocalOp, t: Optional[LocalOp],
                route: str):
        ctx.t, ctx.route = t, route
        y = _spmm_impl(interior.plan, x_int.contiguous(), route, interior.work)
        return y + _spmm_impl(boundary.plan, xcat.contiguous(), route, boundary.work)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        if ctx.t is None:
            raise _no_transpose()
        return (None, _spmm_impl(ctx.t.plan, dy.contiguous(), ctx.route, ctx.t.work),
                None, None, None, None)


def _route(impl: str) -> Tuple[bool, str]:
    """(panels?, "cuda" | "torch") of a resolved impl."""
    return impl.startswith("panels"), "torch" if impl in ("torch", "panels_torch") else "cuda"


def shard_body(sp: ShardPlan, impl: str, x_local: torch.Tensor, halo: torch.Tensor,
               hubs: Optional[torch.Tensor]) -> torch.Tensor:
    """Shard p's Y block (rows_per_shard, d) from its own X rows, its halo
    and its hub rows (None without hubs), through ``impl`` (resolved: not
    "auto")."""
    panels, route = _route(impl)
    tail = [] if hubs is None else [hubs]
    xcat = torch.cat([x_local, halo] + tail)
    if sp.interior is not None:  # a split plan
        x_int = torch.cat([x_local] + tail) if tail else x_local
        if panels:
            return _SplitLocalSpmm.apply(x_int, xcat, sp.panel_int, sp.panel_fwd, sp.panel_bwd,
                                         route)
        return _SplitLocalSpmm.apply(x_int, xcat, sp.interior, sp.boundary, sp.transpose, route)
    if panels:
        return _LocalSpmm.apply(xcat, sp.panel_fwd, sp.panel_bwd, route)
    return _LocalSpmm.apply(xcat, sp.buckets, sp.transpose, route)


def resolve_impl(plan: RowPartitionPlan, impl: str, x: torch.Tensor) -> str:
    """``impl`` with "auto" resolved, checked against the plan."""
    if impl == "auto":
        impl = "cuda" if x.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown dist_spmm impl {impl!r} (want {'|'.join(IMPLS)})")
    if impl.startswith("panels"):
        if plan.panel_fwd is None:
            raise ValueError("impl='panels' needs a plan built with "
                             "partition_rows(..., local_engine='panels')")
        if plan.split and plan.panel_int is None:
            raise ValueError("impl='panels' on a split plan needs partition_rows("
                             "..., split_boundary=True, local_engine='panels')")
    elif plan.split and plan.n_hubs:
        raise ValueError("split plan with replicated hubs requires impl='panels' "
                         "(the binned split body does not gather the hub slab)")
    return impl


def pad_x_for_plan(plan: RowPartitionPlan, x: torch.Tensor,
                   pack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global X rows laid out as the padded (S*cols_per_shard, d) shard
    grid: uniform plans zero-pad the tail; refined cuts gather through
    x_pack_idx (pad rows read row 0, which nothing references; ``pack``:
    that index on x's device already)."""
    if plan.x_pack_idx is not None:
        return x.index_select(0, _long(plan.x_pack_idx, x.device) if pack is None else pack)
    pad = plan.n_shards * plan.cols_per_shard - x.shape[0]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _unpack_y(plan: RowPartitionPlan, out: torch.Tensor,
             unpack: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The padded (S*rows_per_shard, d) shard-grid output in global row
    order (``unpack``: y_unpack_idx on out's device already)."""
    if plan.y_unpack_idx is not None:
        return out.index_select(0, _long(plan.y_unpack_idx, out.device)
                                if unpack is None else unpack)
    return out[: plan.shape[0]]


def _check_mesh(plan: RowPartitionPlan, size: int) -> None:
    if size != plan.n_shards:
        raise ValueError(f"plan built for {plan.n_shards} shards but the mesh has {size}")


def exchange(plan: RowPartitionPlan, x: torch.Tensor, mesh) -> list:
    """The halo exchange alone: per shard (x_local, halo, hub rows or
    None), on a ShardMesh from the global X, on a RankGroup (one triple)
    from this rank's X block."""
    S = plan.n_shards
    if isinstance(mesh, RankGroup):
        _check_mesh(plan, mesh.size)
        sp, g = mesh.place(plan), mesh.group
        if plan.ragged:
            halo = torch.cat([comm.send_recv_next(x.index_select(0, sk), g, shift=k)
                              for k, sk in enumerate(sp.offset_send, start=1)])
        else:
            halo = comm.all_to_all(x.index_select(0, sp.send_idx), g)
        hubs = None
        if plan.n_hubs:
            hubs = comm.all_gather(x.index_select(0, sp.hub_idx), g).index_select(0, sp.hub_perm)
        return [(x, halo, hubs)]
    _check_mesh(plan, mesh.size)
    shards = mesh.place(plan)
    cps, H = plan.cols_per_shard, plan.halo_size
    xp = pad_x_for_plan(plan, x, mesh.index(plan, "x_pack_idx", x.device))
    xs = [xp[p * cps:(p + 1) * cps].to(sp.device) for p, sp in enumerate(shards)]
    if plan.ragged:
        # segment k of p's halo: the rows (p - k) % S sends at offset k
        sent = [[x_q.index_select(0, sp.offset_send[k - 1]) for x_q, sp in zip(xs, shards)]
                for k in range(1, S)]
        halos = [torch.cat([sent[k - 1][(p - k) % S].to(sp.device) for k in range(1, S)])
                 for p, sp in enumerate(shards)]
    else:
        # block q of p's halo: what q sends to p
        sent = [x_q.index_select(0, sp.send_idx) for x_q, sp in zip(xs, shards)]
        halos = [torch.cat([s[p * H:(p + 1) * H].to(sp.device) for s in sent])
                 for p, sp in enumerate(shards)]
    hubs = [None] * S
    if plan.n_hubs:
        own = [x_q.index_select(0, sp.hub_idx) for x_q, sp in zip(xs, shards)]
        hubs = [torch.cat([o.to(sp.device) for o in own]).index_select(0, sp.hub_perm)
                for sp in shards]
    return list(zip(xs, halos, hubs))


def dist_spmm(plan: RowPartitionPlan, x: torch.Tensor, mesh, impl: str = "auto") -> torch.Tensor:
    """Y = A @ X with A row-partitioned per ``plan``, differentiable in x.

    On a ShardMesh ``x`` is the global (m, d) X on any device and the
    global (n, d) Y comes back on its device. On a RankGroup ``x`` is this
    rank's padded X block (cols_per_shard, d) and its Y block
    (rows_per_shard, d) comes back."""
    impl = resolve_impl(plan, impl, x)
    parts = exchange(plan, x, mesh)
    if isinstance(mesh, RankGroup):
        return shard_body(mesh.place(plan), impl, *parts[0])
    ys = [shard_body(sp, impl, *part).to(x.device)
          for sp, part in zip(mesh.place(plan), parts)]
    return _unpack_y(plan, torch.cat(ys), mesh.index(plan, "y_unpack_idx", x.device))


def dist_spmm_allgather(plan: RowPartitionPlan, x: torch.Tensor, mesh: ShardMesh,
                        impl: str = "auto") -> torch.Tensor:
    """Comms-volume baseline on a ShardMesh: every shard receives all of X
    (the ccl-s-to-b route of the reference's boxing algebra) and picks its
    halo and hub rows from it, then runs the same body. Strictly more
    communication than ``dist_spmm``; used to measure what the halo plan
    saves."""
    impl = resolve_impl(plan, impl, x)
    _check_mesh(plan, mesh.size)
    shards = mesh.place(plan)
    cps, tot = plan.cols_per_shard, plan.halo_rows_total
    xp = pad_x_for_plan(plan, x, mesh.index(plan, "x_pack_idx", x.device))
    ys = []
    for p, sp in enumerate(shards):
        xfull = xp.to(sp.device)
        rows = xfull.index_select(0, sp.gather_idx)
        ys.append(shard_body(sp, impl, xfull[p * cps:(p + 1) * cps], rows[:tot],
                             rows[tot:] if plan.n_hubs else None).to(x.device))
    return _unpack_y(plan, torch.cat(ys), mesh.index(plan, "y_unpack_idx", x.device))
