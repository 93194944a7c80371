"""Pipeline parallelism: GPipe and 1F1B micro-batch schedules over a mesh
axis, the port of the JAX package's parallel/pipeline.py.

Every stage is one shard of a ``stage`` mesh axis. All stages step in
lockstep, one tick (GPipe) or cycle (1F1B) at a time, and activations
move to the next stage with one permute per tick (comm's send/recv pairs
over ranks, a shift of the shard axis on a ShardMesh). The stage function
runs on each shard's own parameters through ``torch.func.vmap`` over the
leading shard axis (parallel/mesh.py), so one body serves both forms.

Constraints (GPipe on SPMD): every stage maps activations of one shape
to the same shape; ``stacked_params`` is a dict whose leaves are stacked
on a leading stage axis (``stack_stage_params``), split S(0) over the
stage axis so each shard holds its own stage's weights. The 1F1B step
takes a flat dict of parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.func import functional_call, vjp, vmap
from torch.utils.checkpoint import checkpoint

from of_spmm_tpu_torch.parallel.global_view import tree_map, sbp_for, shard, unshard
from of_spmm_tpu_torch.parallel.mesh import bcast


def stack_stage_params(per_stage: Sequence[Any]) -> Any:
    """Per-stage parameter dicts (one structure, one shape per leaf)
    stacked on a new leading stage axis."""
    first = per_stage[0]
    if isinstance(first, dict):
        if any(set(p) != set(first) for p in per_stage):
            raise ValueError("every stage needs the same parameter names")
        return {k: stack_stage_params([p[k] for p in per_stage]) for k in first}
    return torch.stack(list(per_stage))


def _stage_local(stacked_local: Any) -> Any:
    """A body's S(0) block of the stacked params, (L, 1, ...): each shard's
    own stage, (L, ...)."""
    return tree_map(lambda t: t[:, 0], stacked_local)


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per shard, an (L, ...) result of ``ndim`` dims: ``a`` where ``cond``
    (L,) holds, else ``b`` (either may lack the shard axis)."""
    return torch.where(bcast(cond, ndim), a, b)


def gpipe_spmd(stage_fn: Callable, n_stages: int, n_micro: int, axis,
               remat: bool = True) -> Callable:
    """The GPipe body ``body(stacked_local, x_micro) -> y`` over the mesh
    axis ``axis`` (``mesh.axis("stage")``). ``x_micro`` (n_micro, ...) is
    replicated (stage 0 reads it); the output (L, n_micro, ...) is the
    last stage's, zeros on the other stages. ``remat`` recomputes each
    stage in the backward (``torch.utils.checkpoint``)."""
    run = vmap(stage_fn)
    if remat:
        vmapped = run

        def run(p, x):
            return checkpoint(vmapped, p, x, use_reentrant=False)

    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]

    def body(stacked_local: Any, x_micro: torch.Tensor) -> torch.Tensor:
        params = _stage_local(stacked_local)
        sidx = axis.index(x_micro.device)
        is_first, is_last = sidx == 0, sidx == n_stages - 1
        nd = x_micro.dim()  # a body activation: (L, ...)
        cur = _where(is_first, x_micro[0], torch.zeros_like(x_micro[0]), nd)
        ys = []
        for t in range(n_micro + n_stages - 1):
            y = run(params, cur)
            moved = axis.permute(y, fwd_perm) if n_stages > 1 else torch.zeros_like(y)
            # stage 0's next input is micro-batch t + 1 (clamped: the drain's
            # inputs are never written out)
            cur = _where(is_first, x_micro[min(t + 1, n_micro - 1)], moved, nd)
            ys.append(y)
        # the last stage emits micro-batch m at tick m + n_stages - 1
        out = torch.stack(ys[n_stages - 1:], dim=1)
        return _where(is_last, out, torch.zeros_like(out), out.dim())

    return body


def pipeline_apply(stage_fn: Callable, stacked_params: Any, x_micro: torch.Tensor, mesh,
                   axis: str = "stage", n_micro: Optional[int] = None,
                   remat: bool = True) -> torch.Tensor:
    """The pipeline end to end: (n_micro, ...) outputs, the last stage's
    summed to every stage. ``stacked_params`` leaves are (n_stages, ...),
    split S(0) over ``axis``; ``x_micro`` is replicated. Differentiable:
    autograd runs the transposed schedule. The global output on a
    ShardMesh; over ranks every rank holds it whole."""
    n_stages = mesh.axis_size(axis)
    n_micro = x_micro.shape[0] if n_micro is None else n_micro
    ax = mesh.axis(axis)
    body = gpipe_spmd(stage_fn, n_stages, n_micro, ax, remat=remat)
    spec = sbp_for(mesh, **{axis: "S0"})
    local = tree_map(lambda t: shard(t, spec, mesh), stacked_params)
    return unshard(ax.psum(body(local, x_micro.to(mesh.device))), sbp_for(mesh), mesh)


# 1F1B: each cycle has one F slot and one B slot per stage (masked when
# the schedule idles there; lockstep burns the bubble as masked compute).
# With one permute hop per slot the schedule is closed-form:
#   forward micro-batch at stage s, cycle c:  f = c - s
#   backward micro-batch at stage s, cycle c: b = c - (2S - 2 - s)
# so there are M + 2(S - 1) cycles and at most 2(S - 1 - s) + 1 micro-
# batches in flight at stage s: bounded by the pipeline depth, not by M.
# The activation stash is a static (2 * n_stages) ring, the reference's
# regst budget (pipeline_buffer_pass.cpp:80-113), against GPipe's
# O(n_micro) stash.


def _fwd_mb(c, s, S: int):
    """Micro-batch forwarded by stage s at cycle c (-1: an idle F slot)."""
    f = c - s
    return torch.where(f >= 0, f, -1) if isinstance(f, torch.Tensor) else (f if f >= 0 else -1)


def _bwd_mb(c, s, S: int):
    """Micro-batch backwarded by stage s at cycle c (-1: an idle B slot)."""
    b = c - (2 * S - 2 - s)
    return torch.where(b >= 0, b, -1) if isinstance(b, torch.Tensor) else (b if b >= 0 else -1)


def new_stash(n_local: int, n_stages: int, like: torch.Tensor) -> torch.Tensor:
    """The 1F1B activation stash: (L, 2 * n_stages, *activation), whatever
    the number of micro-batches."""
    return torch.zeros((n_local, 2 * n_stages) + tuple(like.shape), dtype=like.dtype,
                       device=like.device)


def train_step_1f1b(stage_fn: Callable, loss_fn: Callable, n_stages: int, n_micro: int,
                    axis) -> Callable:
    """The 1F1B body ``step(stacked_local, x_micro, tgt_micro) -> (loss,
    stacked_grads_local)`` over the mesh axis ``axis``.

    ``stage_fn(params, x) -> y`` is the shape-uniform stage;
    ``loss_fn(y, tgt) -> scalar`` is applied by the last stage to each
    micro-batch and averaged. Each stage's backward is ``torch.func.vjp``
    of its forward, seeded with 1/M (last stage) or the gradient message
    from stage s + 1; the parameter gradients come out stacked like the
    parameters. The loss is summed to every stage."""
    S, M = n_stages, n_micro
    fwd_perm = [(i, i + 1) for i in range(S - 1)]
    bwd_perm = [(i + 1, i) for i in range(S - 1)]
    run = vmap(stage_fn)

    def fwd_loss(p, x, tgt):
        out = stage_fn(p, x)
        return loss_fn(out, tgt), out

    run_loss = vmap(fwd_loss)

    @torch.no_grad()
    def step(stacked_local: Any, x_micro: torch.Tensor, tgt_micro: Any):
        params = _stage_local(stacked_local)
        s = axis.index(x_micro.device)
        L = s.shape[0]
        is_first, is_last = s == 0, s == S - 1
        stash = new_stash(L, S, x_micro[0])
        in_msg = grad_msg = torch.zeros((L,) + tuple(x_micro.shape[1:]), dtype=x_micro.dtype,
                                        device=x_micro.device)
        gparams = {k: torch.zeros_like(v) for k, v in params.items()}
        loss = torch.zeros(L, device=x_micro.device)
        rows = torch.arange(L, device=s.device)
        for c in range(M + 2 * (S - 1)):
            f, b = _fwd_mb(c, s, S), _bwd_mb(c, s, S)
            do_f, do_b = (f >= 0) & (f < M), (b >= 0) & (b < M)
            fc, bc = f.clamp(0, M - 1), b.clamp(0, M - 1)

            # F slot
            x_in = _where(is_first, x_micro[fc], in_msg, in_msg.dim())
            y = run(params, x_in)
            put = torch.nn.functional.one_hot(fc % (2 * S), 2 * S).bool() & do_f[:, None]
            stash = torch.where(put.reshape(put.shape + (1,) * (stash.dim() - 2)), x_in[:, None],
                                stash)

            # B slot: the stage's vjp at the stashed input, seeded with 1/M
            # on the last stage, the gradient message elsewhere
            x_b = stash[rows, bc % (2 * S)]
            tgt_b = tree_map(lambda t: t[bc], tgt_micro)
            (lval, y_b), pull = vjp(lambda p, x: run_loss(p, x, tgt_b), params, x_b)
            seed_l = torch.where(is_last, 1.0 / M, 0.0).to(lval.dtype)
            seed_y = _where(is_last, torch.zeros_like(y_b), grad_msg.to(y_b.dtype), y_b.dim())
            dparams, dx = pull((seed_l, seed_y))
            mask = do_b.to(loss.dtype)
            gparams = {k: g + bcast(mask, g.dim()) * dparams[k] for k, g in gparams.items()}
            loss = loss + mask * torch.where(is_last, lval, 0.0) / M

            # communication
            y_send = _where(do_f, y, torch.zeros_like(y), y.dim())
            dx_send = _where(do_b, dx, torch.zeros_like(dx), dx.dim())
            in_msg = axis.permute(y_send, fwd_perm) if S > 1 else torch.zeros_like(y)
            grad_msg = axis.permute(dx_send, bwd_perm) if S > 1 else torch.zeros_like(dx)
        return axis.psum(loss), tree_map(lambda g: g[:, None], gparams)

    return step


def pipeline_train_step_1f1b(stage_fn: Callable, loss_fn: Callable, stacked_params: Any,
                             x_micro: torch.Tensor, tgt_micro: Any, mesh,
                             axis: str = "stage"):
    """1F1B (loss, stacked grads) over ``axis`` of ``mesh``: the training
    counterpart of ``pipeline_apply``. The grads are stacked like the
    parameters: global on a ShardMesh, this rank's stage over ranks."""
    n_stages = mesh.axis_size(axis)
    step = train_step_1f1b(stage_fn, loss_fn, n_stages, x_micro.shape[0], mesh.axis(axis))
    spec = sbp_for(mesh, **{axis: "S0"})
    local = tree_map(lambda t: shard(t, spec, mesh), stacked_params)
    loss, grads = step(local, x_micro.to(mesh.device), tgt_micro)
    return unshard(loss, sbp_for(mesh), mesh), tree_map(lambda g: unshard(g, spec, mesh), grads)


class PipelineModule(torch.nn.Module):
    """Homogeneous stages (modules of one structure), run as a pipeline:
    the analog of assigning blocks to stages with
    ``block.config.set_stage`` (block_config.py:32-114). ``init()`` stacks
    the stages' parameters (differentiably), ``apply`` runs them through
    ``pipeline_apply``."""

    def __init__(self, stages: Sequence[torch.nn.Module], axis: str = "stage",
                 remat: bool = True):
        super().__init__()
        self.stages = torch.nn.ModuleList(stages)
        self.axis, self.remat = axis, bool(remat)

    def init(self) -> dict:
        return stack_stage_params([dict(s.named_parameters()) for s in self.stages])

    def stage_fn(self) -> Callable:
        """Stage 0's module called with another stage's parameters."""
        s0 = self.stages[0]
        return lambda p, x: functional_call(s0, p, (x,))

    def apply(self, stacked_params: dict, x_micro: torch.Tensor, mesh) -> torch.Tensor:
        return pipeline_apply(self.stage_fn(), stacked_params, x_micro, mesh, axis=self.axis,
                              remat=self.remat)

    def forward(self, x_micro: torch.Tensor, mesh) -> torch.Tensor:
        return self.apply(self.init(), x_micro, mesh)


__all__ = ["stack_stage_params", "gpipe_spmd", "pipeline_apply", "train_step_1f1b",
           "pipeline_train_step_1f1b", "PipelineModule"]
