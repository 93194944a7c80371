"""graph: training and evaluation graphs, the counterpart of the JAX
package's graph/ (the nn.Graph analog).

There each pass of the reference's graph compiler is a functional
transform under ``jax.jit``; here each is the same transform in eager
PyTorch, on a ``torch.nn.Module``:

- AMP: the JAX policy, not ``torch.autocast``. The loss runs with the
  model's parameters and every floating batch tensor cast to bfloat16 at
  the boundary, so the whole loss computes in bfloat16 (LayerNorm,
  softmax and cross-entropy included, which autocast would keep in
  float32). The casts are differentiable (``torch.func.functional_call``
  on the module with its parameters swapped for ``p.to(bfloat16)``), so
  the grads arrive in float32 on the float32 master parameters.
- loss scaling (``GraphConfig.loss_scale``, an ``amp.GradScaler``): the
  loss is scaled, the grads unscaled and checked with ``all_finite``, the
  ``loss`` metric divided by the scale. A non-finite step leaves the
  parameters and the optimizer's state, its step counter included (so
  its schedule too), as they were: the optimizer's ``step()`` is not
  called.
- gradient clipping by global norm, after unscaling, on skipped steps too.
- gradient accumulation: the leading axis of every batch tensor split
  into K micro-batches, losses and grads summed and divided by K.
- activation checkpointing: the loss under
  ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``.
- ZeRO-1 (``zero_stage=1`` with a mesh): an optimizer-state leaf is held
  S(0) over ``dp_axis`` when it has at least ``zero_min_size`` elements
  and its first dimension divides by the axis size; the others stay
  replicated (logged at debug level, as in JAX). The optimizer updates
  the parameter's S(0) blocks (``OptState``) and the parameter is
  gathered back. On a ``ShardMesh`` the blocks are the global view's
  (parallel/global_view.py: every shard's, stacked, in one process);
  over ranks (``RankGroup``) each rank keeps and updates only its block
  and the update is all-gathered. The numbers are those of stage 0.

On a ``RankGroup`` the step is data parallel over ``dp_axis``: each
batch tensor is the global batch, each rank computes on its S(0) block,
and the loss and grads are averaged over the axis. On a ``ShardMesh``
the loss runs once on the global batch, as the JAX step does.

``train_graph(loss_fn, optimizer, config, mesh, dp_axis)`` returns
``(init, step)``: ``state = init(model)``; ``model, state, metrics =
step(model, state, *batch)`` (model and state updated in place).
``loss_fn(model, *batch)`` returns the scalar loss. ``TrainGraph``
holds them with the JAX call shape ``metrics = g(*batch)``; metrics hold
``loss``, ``did_step`` and, with clipping, ``grad_norm``.
``TrainGraph.state_dict()`` is the JAX tree: ``params`` and each
optimizer-state slot nested by parameter name (``layers.0.w`` ->
``{"layers": {"0": {"w": ...}}}``), ``state`` with ``opt`` (and
``scaler``), ``step_count``; ``save`` / ``load`` write and read it
through utils/checkpoint.py. ``OFS_DEBUG_PASS=1`` prints the passes a
graph turns on.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from of_spmm_tpu_torch import amp as amp_lib
from of_spmm_tpu_torch.optim.optimizers import Optimizer, clip_grad_norm
from of_spmm_tpu_torch.utils.tree import nest, tree_map, unnest

logger = logging.getLogger("of_spmm_tpu_torch.zero")


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Per-graph config (the JAX GraphConfig's fields and defaults)."""

    amp: bool = False  # bf16 compute + fp32 master params
    loss_scale: Optional[amp_lib.GradScaler] = None  # None = no scaling
    grad_accumulation_steps: int = 1  # micro-batch count (leading axis split)
    checkpoint_activations: bool = False  # recompute the forward in the backward
    zero_stage: int = 0  # 0 off; 1 shard optimizer state over the dp axis
    zero_min_size: int = 1024  # leave smaller state leaves replicated
    clip_grad_norm: Optional[float] = None


def _ranked(mesh) -> bool:
    return mesh is not None and len(mesh.local_coords()) < mesh.size


def _zero_rule(params: Sequence[torch.Tensor], slots: Sequence[str], n: int,
               min_size: int) -> List[bool]:
    """Which parameters' state leaves ZeRO-1 holds S(0); the skipped
    leaves logged at debug level (once per slot, as JAX's trace logs
    each leaf)."""
    picks = [p.dim() > 0 and p.numel() >= min_size and p.shape[0] % n == 0 for p in params]
    skipped = 0
    for _ in slots:
        for p, pick in zip(params, picks):
            if p.dim() > 0 and not pick:
                skipped += 1
                logger.debug("ZeRO-1: leaf shape %s replicated (size<%d or dim0 %% %d)",
                             tuple(p.shape), min_size, n)
    if skipped and not any(picks):
        logger.debug("ZeRO-1: NO optimizer-state leaf qualified for sharding "
                     "(%d leaves skipped) — state is fully replicated", skipped)
    return picks


class OptState:
    """A graph's optimizer and where its state lives.

    Without ZeRO the ``torch.optim.Optimizer`` (``opt``) holds the model's
    parameters. With ZeRO-1 it holds, for each parameter the rule picks,
    a leaf of the parameter's S(0) blocks over the dp axis (a
    GlobalTensor's ``local``: all shards' blocks on a ShardMesh, this
    rank's over ranks), so its state has the blocks' shape; ``step``
    updates the blocks and writes the gathered result into the
    parameter."""

    def __init__(self, optimizer: Optimizer, params: Sequence[torch.Tensor], mesh=None,
                 dp_axis: str = "x", zero: bool = False, min_size: int = 1024):
        self.optimizer, self.params, self.mesh = optimizer, list(params), mesh
        self.sharded = [False] * len(self.params)
        if zero and mesh is not None:
            from of_spmm_tpu_torch.parallel.global_view import sbp_for
            self.sbp = sbp_for(mesh, **{dp_axis: "S0"})
            self.sharded = _zero_rule(self.params, [s[0] for s in optimizer.slots],
                                      mesh.axis_size(dp_axis), min_size)
        self.leaves = [self._block(p.detach()).clone() if s else p
                       for p, s in zip(self.params, self.sharded)]
        self.opt = optimizer.init(self.leaves)
        if _ranked(mesh) and hasattr(self.opt, "reduce_sq"):  # LAMB's per-tensor norms
            axis = mesh.axis(dp_axis)
            for leaf, s in zip(self.leaves, self.sharded):
                if s:
                    self.opt.reduce_sq[id(leaf)] = axis.psum

    def _block(self, t: torch.Tensor) -> torch.Tensor:
        from of_spmm_tpu_torch.parallel.global_view import shard
        return shard(t, self.sbp, self.mesh)

    def _gathered(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of S(0) blocks: concatenated in one process,
        all-gathered over ranks."""
        if _ranked(self.mesh):
            return self._global(local).full()
        from of_spmm_tpu_torch.parallel.global_view import unshard
        return unshard(local, self.sbp, self.mesh)

    def _global(self, local: torch.Tensor):
        from of_spmm_tpu_torch.parallel.global_view import GlobalTensor
        return GlobalTensor(local, self.sbp, self.mesh)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        with torch.no_grad():
            for p, leaf, s in zip(self.params, self.leaves, self.sharded):
                if s:
                    leaf.copy_(self._block(p.detach()))
        for leaf, g, s in zip(self.leaves, grads, self.sharded):
            leaf.grad = self._block(g) if s else g
        self.opt.step()
        with torch.no_grad():
            for p, leaf, s in zip(self.params, self.leaves, self.sharded):
                if s:
                    p.copy_(self._gathered(leaf))
        for leaf in self.leaves:
            leaf.grad = None

    def state_tree(self) -> dict:
        """The state in the JAX layout, one entry per parameter in order;
        a ZeRO-held leaf as a GlobalTensor placed S(0)."""
        tree = self.optimizer.state_tree(self.opt)
        for name, _, _ in self.optimizer.slots:
            tree[name] = [self._global(v) if s else v
                          for v, s in zip(tree[name], self.sharded)]
        return tree

    def load_state_tree(self, tree: dict) -> None:
        """Load a state in the JAX layout; a leaf may be whole or, for a
        ZeRO-held one, a GlobalTensor."""
        from of_spmm_tpu_torch.parallel.global_view import GlobalTensor

        def leaf(v, s: bool):
            if isinstance(v, GlobalTensor):
                if s and v.sbp == self.sbp:
                    return v.local
                v = v.full()
            return self._block(torch.as_tensor(v).to(self.params[0].device)) if s else v

        tree = dict(tree)
        for name, _, _ in self.optimizer.slots:
            tree[name] = [leaf(v, s) for v, s in zip(tree[name], self.sharded)]
        self.optimizer.load_state_tree(self.opt, tree)


class _Bound(torch.nn.Module):
    """``fn(model, *args)`` as a module over ``model``, so that
    functional_call can swap the model's parameters for the call."""

    def __init__(self, fn: Callable, model: torch.nn.Module):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *args):
        return self.fn(self.model, *args)


def compute_call(fn: Callable, model: torch.nn.Module, policy: amp_lib.Policy, args):
    """``fn(model, *args)`` with the model's floating parameters and the
    floating tensors of ``args`` cast to the policy's compute dtype, the
    casts differentiable (the AMP pass of train_graph and EvalGraph)."""
    casts = {f"model.{n}": p.to(policy.compute_dtype)
             for n, p in model.named_parameters() if p.is_floating_point()}
    return torch.func.functional_call(_Bound(fn, model), casts,
                                      tuple(policy.cast_to_compute(tuple(args))))


def _split(x, k: int, i: int):
    if isinstance(x, torch.Tensor):
        return x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
    return x


def _maybe_debug_passes(config: GraphConfig, mesh) -> None:
    """OFS_DEBUG_PASS=1: print which passes a train graph turns on."""
    if not os.environ.get("OFS_DEBUG_PASS"):
        return
    passes = [
        ("amp(bf16)", config.amp),
        ("loss_scale", config.loss_scale is not None),
        (f"grad_accumulation(x{config.grad_accumulation_steps})",
         config.grad_accumulation_steps > 1),
        ("activation_checkpointing", config.checkpoint_activations),
        (f"zero(stage={config.zero_stage}, min={config.zero_min_size})",
         config.zero_stage >= 1 and mesh is not None),
        (f"clip_grad_norm({config.clip_grad_norm})", config.clip_grad_norm is not None),
    ]
    on = [name for name, enabled in passes if enabled]
    off = [name for name, enabled in passes if not enabled]
    print(f"[ofs graph passes] on={on or ['(none)']} off={off}", file=sys.stderr, flush=True)


def train_graph(loss_fn: Callable, optimizer: Optimizer, config: GraphConfig = GraphConfig(),
                mesh=None, dp_axis: str = "x") -> Tuple[Callable, Callable]:
    """``(init, step)`` of a training graph: ``state = init(model)``;
    ``model, state, metrics = step(model, state, *batch)``."""
    policy = amp_lib.DEFAULT_POLICY if config.amp else amp_lib.FP32_POLICY
    scaler = config.loss_scale
    ranked = _ranked(mesh)

    def run(model, *batch):
        if config.amp:
            return compute_call(loss_fn, model, policy, batch)
        return loss_fn(model, *batch)

    def forward_loss(model, scaler_state, batch):
        if config.checkpoint_activations:
            loss = torch.utils.checkpoint.checkpoint(run, model, *batch, use_reentrant=False)
        else:
            loss = run(model, *batch)
        return scaler.scale(loss, scaler_state) if scaler is not None else loss

    def value_and_grads(model, params, scaler_state, batch):
        loss = forward_loss(model, scaler_state, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def grads_of(model, params, scaler_state, batch):
        k = config.grad_accumulation_steps
        if k <= 1:
            return value_and_grads(model, params, scaler_state, batch)
        loss_sum, acc = torch.zeros((), dtype=torch.float32, device=params[0].device), None
        for i in range(k):
            micro = tree_map(lambda x: _split(x, k, i), tuple(batch))
            loss, g = value_and_grads(model, params, scaler_state, micro)
            loss_sum = loss_sum + loss
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
        inv = 1.0 / k
        return loss_sum * inv, [a * inv for a in acc]

    def init(model: torch.nn.Module) -> dict:
        params = [p for _, p in model.named_parameters()]
        state = {"opt": OptState(optimizer, params, mesh, dp_axis,
                                 zero=config.zero_stage >= 1, min_size=config.zero_min_size)}
        if scaler is not None:
            state["scaler"] = scaler.init(params[0].device)
        return state

    def step(model: torch.nn.Module, state: dict, *batch):
        opt_state: OptState = state["opt"]
        params = opt_state.params
        scaler_state = state.get("scaler")
        if ranked:
            from of_spmm_tpu_torch.parallel.global_view import sbp_for, shard
            spec = sbp_for(mesh, **{dp_axis: "S0"})
            batch = tree_map(lambda b: shard(b, spec, mesh)[0]
                             if isinstance(b, torch.Tensor) else b, tuple(batch))
        loss, grads = grads_of(model, params, scaler_state, batch)
        if ranked:
            axis = mesh.axis(dp_axis)
            loss, grads = axis.pmean(loss), [axis.pmean(g) for g in grads]
        if config.amp:
            grads = policy.cast_to_param(grads)
        metrics = {}
        if scaler is not None:
            grads, state["scaler"], did_step = scaler.unscale_and_update(grads, scaler_state)
            loss = loss / scaler_state["scale"]
        else:
            did_step = torch.ones((), dtype=torch.bool, device=loss.device)
        if config.clip_grad_norm is not None:
            grads, metrics["grad_norm"] = clip_grad_norm(grads, config.clip_grad_norm)
        if scaler is None or bool(did_step):
            opt_state.step(grads)
        metrics["loss"] = loss
        metrics["did_step"] = did_step
        return model, state, metrics

    _maybe_debug_passes(config, mesh)
    return init, step


class TrainGraph:
    """``g = TrainGraph(loss_fn, optimizer, model, config, mesh, dp_axis)``;
    ``metrics = g(*batch)`` takes one step on ``model`` in place. The
    graph owns the optimizer state (``g.state``) and counts its calls
    (``g.step_count``, skipped steps included)."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer, model: torch.nn.Module,
                 config: GraphConfig = GraphConfig(), mesh=None, dp_axis: str = "x"):
        self._init, self._step = train_graph(loss_fn, optimizer, config=config, mesh=mesh,
                                             dp_axis=dp_axis)
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.state = self._init(model)
        self.step_count = 0

    @property
    def params(self) -> dict:
        """The model's parameters as a tree nested by name."""
        return nest(dict(self.model.named_parameters()))

    def __call__(self, *batch) -> dict:
        _, self.state, metrics = self._step(self.model, self.state, *batch)
        self.step_count += 1
        return metrics

    # --- checkpoint surface: the JAX tree ------------------------------

    def state_dict(self) -> dict:
        """{"params", "state": {"opt"[, "scaler"]}, "step_count"}; the
        tensors are the live ones (detached), as Module.state_dict's."""
        opt = self.state["opt"].state_tree()
        tree = {name: nest(dict(zip(self.names, vals))) if isinstance(vals, list) else vals
                for name, vals in opt.items()}
        state = {"opt": tree}
        if "scaler" in self.state:
            state["scaler"] = dict(self.state["scaler"])
        return {"params": nest({n: p.detach() for n, p in self.model.named_parameters()}),
                "state": state,
                "step_count": torch.tensor(self.step_count, dtype=torch.int64)}

    def load_state_dict(self, sd: dict) -> None:
        """Load a state_dict tree; ``step_count`` may be int32 (as the JAX
        package writes it without x64) or int64."""
        params = unnest(sd["params"])
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                p.copy_(torch.as_tensor(params[n]).to(device=p.device, dtype=p.dtype))
        tree = {name: [unnest(v)[n] for n in self.names] if isinstance(v, dict) else v
                for name, v in sd["state"]["opt"].items()}
        self.state["opt"].load_state_tree(tree)
        if "scaler" in self.state:
            dev = self.state["scaler"]["scale"].device
            self.state["scaler"] = {k: torch.as_tensor(v).to(dev).clone()
                                    for k, v in sd["state"]["scaler"].items()}
        self.step_count = int(sd["step_count"])

    def save(self, path: str) -> None:
        from of_spmm_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(path, self.state_dict())

    def load(self, path: str) -> None:
        from of_spmm_tpu_torch.utils.checkpoint import load_checkpoint

        self.load_state_dict(load_checkpoint(path, self.state_dict()))


class EvalGraph:
    """An inference graph: ``out = g(model, *args)`` runs
    ``apply_fn(model, *args)`` without autograd; under AMP in bfloat16
    with the output cast back to float32."""

    def __init__(self, apply_fn: Callable, config: GraphConfig = GraphConfig()):
        self.apply_fn, self.config = apply_fn, config

    def __call__(self, model: torch.nn.Module, *args) -> Any:
        with torch.no_grad():
            if not self.config.amp:
                return self.apply_fn(model, *args)
            policy = amp_lib.DEFAULT_POLICY
            return policy.cast_output(compute_call(self.apply_fn, model, policy, args))


__all__ = ["GraphConfig", "OptState", "compute_call", "train_graph", "TrainGraph", "EvalGraph"]
