"""Optimizers: the counterpart of the JAX package's optim/optimizers.py.

The JAX factories return an ``(init, update)`` pair before any parameter
exists (``TrainGraph(loss_fn, optim.adam(1e-3), params)``). Here too:
``adam(lr=...)`` returns an ``Optimizer`` whose ``init(parameters)``
builds a ``torch.optim.Optimizer`` over them, and whose ``update(grads,
opt)`` sets each parameter's grad and takes ``opt.step()``.

- ``sgd``, ``adam``, ``adamw``, ``rmsprop``, ``adagrad`` and ``adadelta``
  build ``torch.optim``'s classes, whose update rules are the JAX ones:
  momentum without dampening (the first step's buffer is the grad, as
  0.9 * 0 + g), L2 decay added to the grads, AdamW's decoupled decay on
  the pre-update parameter, centred RMSprop subtracting the squared mean.
- ``lamb`` and ``ftrl`` are written here (``Lamb``, ``Ftrl``): torch has
  neither. LAMB's trust ratio is per parameter tensor, the JAX leaf.
  FTRL's accumulator starts at 0.1.

``lr`` is a float or a schedule ``step -> lr``. As in JAX, the k-th update
(k from 1) uses ``lr(k)``: a step pre-hook counts the optimizer's own
updates in each param group (``"step_count"``, saved with the
optimizer's ``state_dict``) and sets ``"lr"`` before the update. A step
that is never taken (a skipped non-finite step) moves neither.

``Optimizer.state_tree(opt)`` reads the optimizer's state in the JAX
layout: ``{"step": int32, "m": [...], "v": [...]}`` for Adam, one list
entry per parameter in ``opt``'s order (``{"step", "accum", "z"}`` for
FTRL, ``{"step", "sq"[, "g_avg"][, "buf"]}`` for RMSprop, ...);
``load_state_tree`` writes one back. ``graph.TrainGraph`` nests the lists
by parameter name.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from of_spmm_tpu_torch.utils.tree import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]


def _lr_at(lr: Schedule, step: int) -> float:
    return float(lr(step)) if callable(lr) else float(lr)


def _advance(opt: torch.optim.Optimizer, args, kwargs, lr: Schedule) -> None:
    """Step pre-hook: the update about to run is the optimizer's k-th."""
    for group in opt.param_groups:
        group["step_count"] = group.get("step_count", 0) + 1
        group["lr"] = _lr_at(lr, group["step_count"])


class Lamb(torch.optim.Optimizer):
    """LAMB: the Adam direction (bias-corrected, plus ``weight_decay * p``)
    rescaled per parameter tensor by ||p|| / ||u|| (1 where either is 0).
    ``reduce_sq`` maps ``id(p)`` of a parameter held in blocks (ZeRO-1
    over ranks) to the function that sums a squared norm over its
    blocks."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.reduce_sq: Dict[int, Callable[[torch.Tensor], torch.Tensor]] = {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                reduce_sq = self.reduce_sq.get(id(p), lambda sq: sq)
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = float(st["step"])
                g, m, v = p.grad, st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                u = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                pn = torch.sqrt(reduce_sq((p.float() ** 2).sum()))
                un = torch.sqrt(reduce_sq((u.float() ** 2).sum()))
                trust = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
                p.sub_(group["lr"] * trust.to(p.dtype) * u)
        return loss


class Ftrl(torch.optim.Optimizer):
    """FTRL-Proximal: n' = n + g^2, sigma = (n'^-lr_power - n^-lr_power) / lr,
    z' = z + g - sigma p, p' = 0 where |z'| <= lambda1, else
    -(z' - sign(z') lambda1) / ((beta + sqrt(n')) / lr + lambda2). The
    accumulator n starts at 0.1."""

    def __init__(self, params, lr: float = 1e-1, lr_power: float = -0.5, lambda1: float = 0.0,
                 lambda2: float = 0.0, beta: float = 0.0):
        super().__init__(params, dict(lr=lr, lr_power=lr_power, lambda1=lambda1,
                                      lambda2=lambda2, beta=beta))

    @torch.no_grad()
    def step(self, closure=None):
        loss = closure() if closure is not None else None
        for group in self.param_groups:
            lr, power = group["lr"], group["lr_power"]
            l1, l2, beta = group["lambda1"], group["lambda2"], group["beta"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["accum"] = torch.full_like(p, 0.1)
                    st["z"] = torch.zeros_like(p)
                g, n, z = p.grad, st["accum"], st["z"]
                n_new = n + g * g
                sigma = (n_new.pow(-power) - n.pow(-power)) / lr
                z.add_(g - sigma * p)
                denom = (beta + torch.sqrt(n_new)) / lr + l2
                p.copy_(torch.where(z.abs() <= l1, torch.zeros_like(p),
                                    -(z - torch.sign(z) * l1) / denom))
                n.copy_(n_new)
        return loss


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A factory of one ``torch.optim.Optimizer`` configuration.

    ``init(parameters)`` builds it; ``update(grads, opt)`` takes one step
    with the given grads (one per parameter, in ``opt``'s order).
    ``slots`` map the JAX state names to the torch state keys and their
    values before the first step; ``per_param_step`` says the torch class
    keeps a "step" of its own in each parameter's state (kept equal to
    the group's count on load)."""

    make: Callable[[list, float], torch.optim.Optimizer]
    lr: Schedule
    slots: Tuple[Tuple[str, str, float], ...]
    per_param_step: bool = True

    def init(self, params) -> torch.optim.Optimizer:
        opt = self.make(list(params), _lr_at(self.lr, 1))
        for group in opt.param_groups:
            group["step_count"] = 0
        opt.register_step_pre_hook(functools.partial(_advance, lr=self.lr))
        return opt

    def update(self, grads: Sequence[torch.Tensor], opt: torch.optim.Optimizer) -> None:
        for p, g in zip(_params(opt), grads):
            p.grad = g
        opt.step()

    def state_tree(self, opt: torch.optim.Optimizer) -> dict:
        """The state in the JAX layout (lists in parameter order)."""
        params = _params(opt)
        tree = {"step": torch.tensor(_count(opt), dtype=torch.int32)}
        for name, key, init in self.slots:
            tree[name] = [opt.state[p][key] if key in opt.state.get(p, {})
                          else torch.full_like(p, init).detach() for p in params]
        return tree

    def load_state_tree(self, opt: torch.optim.Optimizer, tree: dict) -> None:
        """Write a state in the JAX layout into ``opt`` (copies)."""
        k = int(tree["step"])
        for group in opt.param_groups:
            group["step_count"] = k
            group["lr"] = _lr_at(self.lr, max(k, 1))
        for i, p in enumerate(_params(opt)):
            st = opt.state[p]
            for name, key, _ in self.slots:
                st[key] = torch.as_tensor(tree[name][i]).detach().to(
                    device=p.device, dtype=p.dtype).clone()
            if self.per_param_step:
                st["step"] = torch.tensor(float(k))


def _params(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in opt.param_groups for p in group["params"]]


def _count(opt: torch.optim.Optimizer) -> int:
    return int(opt.param_groups[0].get("step_count", 0)) if opt.param_groups else 0


def sgd(lr: Schedule = 1e-2, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD with optional momentum (m <- beta m + g), nesterov (g + beta m)
    and L2 weight decay: torch.optim.SGD with dampening 0."""
    return Optimizer(
        make=lambda ps, lr0: torch.optim.SGD(ps, lr=lr0, momentum=momentum,
                                             weight_decay=weight_decay, nesterov=nesterov),
        lr=lr, slots=(("m", "momentum_buffer", 0.0),) if momentum else (),
        per_param_step=False)


_ADAM_SLOTS = (("m", "exp_avg", 0.0), ("v", "exp_avg_sq", 0.0))


def adam(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction; ``weight_decay`` is L2 (added to the
    grads): torch.optim.Adam."""
    return Optimizer(
        make=lambda ps, lr0: torch.optim.Adam(ps, lr=lr0, betas=(b1, b2), eps=eps,
                                              weight_decay=weight_decay),
        lr=lr, slots=_ADAM_SLOTS)


def adamw(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-2) -> Optimizer:
    """AdamW: decoupled decay p <- p - lr wd p: torch.optim.AdamW."""
    return Optimizer(
        make=lambda ps, lr0: torch.optim.AdamW(ps, lr=lr0, betas=(b1, b2), eps=eps,
                                               weight_decay=weight_decay),
        lr=lr, slots=_ADAM_SLOTS)


def lamb(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         weight_decay: float = 0.0) -> Optimizer:
    """LAMB (``Lamb``): Adam rescaled per parameter by ||p|| / ||update||."""
    return Optimizer(
        make=lambda ps, lr0: Lamb(ps, lr=lr0, betas=(b1, b2), eps=eps,
                                  weight_decay=weight_decay),
        lr=lr, slots=_ADAM_SLOTS)


def ftrl(lr: Schedule = 1e-1, lr_power: float = -0.5, lambda1: float = 0.0,
         lambda2: float = 0.0, beta: float = 0.0) -> Optimizer:
    """FTRL-Proximal (``Ftrl``)."""
    return Optimizer(
        make=lambda ps, lr0: Ftrl(ps, lr=lr0, lr_power=lr_power, lambda1=lambda1,
                                  lambda2=lambda2, beta=beta),
        lr=lr, slots=(("accum", "accum", 0.1), ("z", "z", 0.0)), per_param_step=False)


def rmsprop(lr: Schedule = 1e-2, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
            weight_decay: float = 0.0, centered: bool = False) -> Optimizer:
    """RMSprop (torch conventions: optional centred and momentum
    variants): torch.optim.RMSprop."""
    slots = (("sq", "square_avg", 0.0),)
    if centered:
        slots += (("g_avg", "grad_avg", 0.0),)
    if momentum:
        slots += (("buf", "momentum_buffer", 0.0),)
    return Optimizer(
        make=lambda ps, lr0: torch.optim.RMSprop(ps, lr=lr0, alpha=alpha, eps=eps,
                                                 momentum=momentum, weight_decay=weight_decay,
                                                 centered=centered),
        lr=lr, slots=slots)


def adagrad(lr: Schedule = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0,
            initial_accumulator_value: float = 0.0) -> Optimizer:
    """Adagrad: torch.optim.Adagrad (no lr decay)."""
    return Optimizer(
        make=lambda ps, lr0: torch.optim.Adagrad(
            ps, lr=lr0, eps=eps, weight_decay=weight_decay,
            initial_accumulator_value=initial_accumulator_value),
        lr=lr, slots=(("sum", "sum", initial_accumulator_value),))


def adadelta(lr: Schedule = 1.0, rho: float = 0.9, eps: float = 1e-6,
             weight_decay: float = 0.0) -> Optimizer:
    """Adadelta: torch.optim.Adadelta."""
    return Optimizer(
        make=lambda ps, lr0: torch.optim.Adadelta(ps, lr=lr0, rho=rho, eps=eps,
                                                  weight_decay=weight_decay),
        lr=lr, slots=(("sq", "square_avg", 0.0), ("acc_delta", "acc_delta", 0.0)))


def clip_grad_norm(grads, max_norm: float):
    """Global-norm clipping of a tree of grads: (the grads times
    min(1, max_norm / (total + 1e-6)), the float32 total norm)."""
    leaves = tree_leaves(grads)
    if not leaves:
        return grads, torch.zeros(())
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), total


__all__ = ["Optimizer", "Lamb", "Ftrl", "sgd", "adam", "adamw", "lamb", "ftrl", "rmsprop",
           "adagrad", "adadelta", "clip_grad_norm", "Schedule"]
