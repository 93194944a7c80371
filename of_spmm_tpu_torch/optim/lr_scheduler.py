"""Learning-rate schedules as plain ``step -> lr`` functions.

Counterparts of the JAX package's ``of_spmm_tpu/optim/lr_scheduler.py``:
``constant``, ``step_lr``, ``multistep_lr``, ``exponential_lr``,
``cosine_annealing``, ``polynomial_lr`` and the ``warmup`` wrapper. The
step counts optimizer updates from 1, as there: every JAX optimizer
evaluates its schedule at ``state.step + 1``, and so do the port's
(optim/optimizers.py).

``lambda_lr`` drives a ``torch.optim`` optimizer with such a schedule.
``LambdaLR`` evaluates its factor at k - 1 for the k-th update (once at
construction, then after each ``scheduler.step()``), so the factor is
``schedule(k + 1) / lr``; without the + 1 every step would take the
previous step's rate and warmup would start one step late.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], float]


def constant(lr: float) -> Schedule:
    return lambda step: float(lr)


def step_lr(lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """Decay by ``gamma`` every ``step_size`` steps: lr gamma^((step - 1) // step_size)."""
    return lambda step: lr * gamma ** ((step - 1) // step_size)


def multistep_lr(lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """lr gamma^k, k the number of milestones below ``step``."""
    ms = sorted(int(m) for m in milestones)
    return lambda step: lr * gamma ** sum(step > m for m in ms)


def exponential_lr(lr: float, gamma: float) -> Schedule:
    return lambda step: lr * gamma ** (step - 1)


def polynomial_lr(lr: float, decay_steps: int, end_lr: float = 0.0,
                  power: float = 1.0) -> Schedule:
    """(lr - end_lr) (1 - t / decay_steps)^power + end_lr with
    t = clip(step - 1, 0, decay_steps)."""

    def f(step: int) -> float:
        t = min(max(step - 1, 0), decay_steps)
        return (lr - end_lr) * (1 - t / decay_steps) ** power + end_lr

    return f


def cosine_annealing(lr: float, t_max: int, eta_min: float = 0.0) -> Schedule:
    """eta_min + (lr - eta_min) (1 + cos(pi t / t_max)) / 2 with
    t = clip(step - 1, 0, t_max)."""

    def f(step: int) -> float:
        t = min(max(step - 1, 0), t_max)
        return eta_min + 0.5 * (lr - eta_min) * (1 + math.cos(math.pi * t / t_max))

    return f


def warmup(schedule: Schedule, warmup_steps: int, start_factor: float = 0.0) -> Schedule:
    """``schedule`` scaled linearly from ``start_factor`` to 1 over the
    first ``warmup_steps`` steps (1 from then on)."""

    def f(step: int) -> float:
        base = schedule(step)
        if step > warmup_steps:
            return base
        t = min(max(step, 0), warmup_steps)
        return base * (start_factor + (1 - start_factor) * t / max(warmup_steps, 1))

    return f


def lambda_lr(optimizer: torch.optim.Optimizer, schedule: Schedule, lr: float
              ) -> torch.optim.lr_scheduler.LambdaLR:
    """A ``LambdaLR`` under which the k-th ``optimizer.step()`` (k from 1)
    uses ``schedule(k)``, given the optimizer's base rate ``lr``; call its
    ``step()`` after each ``optimizer.step()``."""
    if lr <= 0:
        raise ValueError(f"lambda_lr needs a positive base rate, got {lr}")
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda e: schedule(e + 1) / lr)
