"""Full-batch GCN training through the port: graph load -> operator plan
-> GCN -> TrainGraph (Adam with a warmup + cosine schedule, gradient
clipping, optional bf16 AMP) -> accuracy. Counterpart of the JAX
package's ``examples/train_gcn.py``.

    python -m of_spmm_tpu_torch.examples.train_gcn [--graph cora] [--epochs 100]
        [--hidden 64] [--lr 1e-2] [--amp] [--device cpu]

Runs on the card unless ``--device`` names another device; there every
SpMM of the step (forward and the transpose-plan backward) runs the
port's kernels. ``main`` and ``train`` build the JAX example's graph:
``TrainGraph`` with ``optim.adam(lr=warmup(cosine_annealing(lr,
epochs), 10))`` and ``GraphConfig(amp=..., clip_grad_norm=5.0)``; under
``--amp`` the loss runs in bfloat16 on float32 master parameters
(graph/). ``make_optimizer`` and ``train_step`` are the same step on
``torch.optim.Adam`` with ``LambdaLR`` and ``clip_grad_norm_`` (scale
min(1, max / (norm + 1e-6)), as the JAX ``clip_grad_norm``).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import torch

from of_spmm_tpu_torch import optim
from of_spmm_tpu_torch.data import load_graph, random_features
from of_spmm_tpu_torch.graph import GraphConfig, TrainGraph
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops import make_operator
from of_spmm_tpu_torch.ops.autograd import SpmmOperator
from of_spmm_tpu_torch.optim.lr_scheduler import cosine_annealing, lambda_lr, warmup
from of_spmm_tpu_torch.utils.device import resolve_device

WARMUP_STEPS = 10
CLIP_NORM = 5.0


def make_optimizer(model: torch.nn.Module, lr: float, epochs: int):
    """Adam and the LambdaLR that gives its k-th step
    ``warmup(cosine_annealing(lr, epochs), 10)(k)``."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return opt, lambda_lr(opt, warmup(cosine_annealing(lr, epochs), WARMUP_STEPS), lr)


def train_step(model: torch.nn.Module, op: SpmmOperator, x: torch.Tensor, y: torch.Tensor,
               opt: torch.optim.Optimizer, mask: Optional[torch.Tensor] = None,
               impl: str = "auto") -> torch.Tensor:
    """One update: loss, backward, clip at CLIP_NORM, the optimizer's
    step. Returns the loss before the update (detached, not synced)."""
    opt.zero_grad(set_to_none=True)
    loss = model.loss_fn(op, x, y, mask=mask, impl=impl)
    loss.backward()
    torch.nn.utils.clip_grad_norm_(model.parameters(), CLIP_NORM)
    opt.step()
    return loss.detach()


def accuracy(model: torch.nn.Module, op: SpmmOperator, x: torch.Tensor, y: torch.Tensor,
             impl: str = "auto") -> float:
    with torch.no_grad():
        return float((model(op, x, impl=impl).argmax(-1) == y).float().mean())


def make_graph(model: torch.nn.Module, op: SpmmOperator, lr: float, epochs: int,
               amp: bool = False, mask: Optional[torch.Tensor] = None,
               impl: str = "auto") -> TrainGraph:
    """The JAX example's TrainGraph on ``model``: ``g(x, y)`` takes one
    step of Adam at ``warmup(cosine_annealing(lr, epochs), 10)`` with
    clipping at CLIP_NORM, in bfloat16 under ``amp``."""
    return TrainGraph(
        lambda m, xx, yy: m.loss_fn(op, xx, yy, mask=mask, impl=impl),
        optim.adam(lr=warmup(cosine_annealing(lr, epochs), WARMUP_STEPS)), model,
        config=GraphConfig(amp=amp, clip_grad_norm=CLIP_NORM))


def train(model: torch.nn.Module, op: SpmmOperator, x: torch.Tensor, y: torch.Tensor,
          epochs: int, lr: float, mask: Optional[torch.Tensor] = None, impl: str = "auto",
          log_every: int = 0, log: Callable[[str], None] = print,
          amp: bool = False) -> torch.Tensor:
    """``epochs`` full-batch updates through ``make_graph``; returns each
    step's loss (before its update) as one float32 tensor. With
    ``log_every``, logs loss and accuracy every that many epochs and at
    the last."""
    graph = make_graph(model, op, lr, epochs, amp=amp, mask=mask, impl=impl)
    losses = []
    t0 = time.perf_counter()
    for epoch in range(epochs):
        losses.append(graph(x, y)["loss"].float())
        if log_every and (epoch % log_every == 0 or epoch == epochs - 1):
            log(f"epoch {epoch:4d}  loss {float(losses[-1]):.4f}  "
                f"acc {accuracy(model, op, x, y, impl):.3f}  ({time.perf_counter() - t0:.1f}s)")
    return torch.stack(losses)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graph", default="cora")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--amp", action="store_true",
                    help="bfloat16 compute on float32 master parameters")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    csr, cfg = load_graph(args.graph, symmetrize=True)
    op = make_operator(normalized_adjacency(csr), device=dev)
    x_np, y_np = random_features(cfg)
    x, y = torch.from_numpy(x_np).to(dev), torch.from_numpy(y_np).long().to(dev)
    model = GCN((cfg.feature_dim, args.hidden, cfg.n_classes), device=dev,
                generator=torch.Generator().manual_seed(0))
    print(f"params: {sum(p.numel() for p in model.parameters()):,}")
    train(model, op, x, y, args.epochs, args.lr, log_every=10, amp=args.amp)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
