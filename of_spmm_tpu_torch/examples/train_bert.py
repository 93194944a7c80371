"""Masked-language-model pretraining of the BERT-style encoder through
TrainGraph: a synthetic token stream -> TransformerEncoder hidden states
-> a head tied to the token embeddings -> masked mean cross-entropy ->
AdamW with warmup + cosine, optional bf16 AMP and gradient accumulation.
Counterpart of the JAX package's ``examples/train_bert.py``.

    python -m of_spmm_tpu_torch.examples.train_bert [--steps 20] [--batch 8]
        [--seq 128] [--vocab 1024] [--lr 1e-4] [--amp] [--grad-acc 1] [--device cpu]

Runs on the card unless ``--device`` names another device. The JAX
example's model (width 128, 4 heads, 4 layers, MLP 512, max_len = seq),
stream (numpy ``default_rng(0)``: tokens in [1, vocab), 15% of them
masked to id 0) and loss (logits = h @ tok.weight^T / sqrt(128), the
constant as the JAX file writes it whatever the width, cross-entropy
averaged over the masked positions). The blocks use the dense attention
core, as the JAX model's do, so this path launches no port kernel.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch import optim
from of_spmm_tpu_torch.graph import GraphConfig, TrainGraph
from of_spmm_tpu_torch.models import TransformerEncoder
from of_spmm_tpu_torch.nn import losses
from of_spmm_tpu_torch.optim.lr_scheduler import cosine_annealing, warmup
from of_spmm_tpu_torch.utils.device import resolve_device

HEAD_SCALE = 1.0 / math.sqrt(128)  # the JAX example's np.sqrt(128)
MASK_RATE = 0.15
MASK_ID = 0


def make_model(vocab: int = 1024, seq: int = 128, embed_dim: int = 128, num_heads: int = 4,
               num_layers: int = 4, mlp_dim: int = 512, device=None, seed: int = 0
               ) -> TransformerEncoder:
    """The example's encoder (hidden states out), weights seeded."""
    return TransformerEncoder(vocab_size=vocab, max_len=seq, embed_dim=embed_dim,
                              num_heads=num_heads, num_layers=num_layers, mlp_dim=mlp_dim,
                              device=device, generator=torch.Generator().manual_seed(seed))


def batch_stream(batch: int, seq: int, vocab: int, device, seed: int = 0
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """(inputs, targets, mask) batches: the JAX example's numpy stream."""
    rng = np.random.default_rng(seed)
    while True:
        tokens = rng.integers(1, vocab, (batch, seq))
        mask = rng.random((batch, seq)) < MASK_RATE
        inputs = np.where(mask, MASK_ID, tokens)
        yield (torch.from_numpy(inputs).to(device), torch.from_numpy(tokens).to(device),
               torch.from_numpy(mask).to(device))


def mlm_loss(model: TransformerEncoder, inputs: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy of the tied head over the masked
    positions (at least one counted)."""
    h = model(inputs)
    logits = (h @ model.tok.weight.T) * HEAD_SCALE
    nll = losses.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                               reduction="none")
    m = mask.reshape(-1).to(nll.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def make_graph(model: TransformerEncoder, steps: int, lr: float = 1e-4, amp: bool = False,
               grad_acc: int = 1, weight_decay: float = 0.01, zero_stage: int = 0, mesh=None,
               loss_fn: Callable = mlm_loss) -> TrainGraph:
    """The example's TrainGraph: AdamW at warmup(cosine_annealing(lr,
    max(steps, 2)), max(steps // 10, 1))."""
    sched = warmup(cosine_annealing(lr, max(steps, 2)), max(steps // 10, 1))
    return TrainGraph(loss_fn, optim.adamw(sched, weight_decay=weight_decay), model,
                      config=GraphConfig(amp=amp, grad_accumulation_steps=grad_acc,
                                         zero_stage=zero_stage), mesh=mesh)


def train(graph: TrainGraph, stream: Iterator, steps: int,
          log: Optional[Callable[[str], None]] = None) -> List[float]:
    """``steps`` steps of ``graph`` on the stream's batches; each step's
    loss (before its update). Logs every max(steps // 10, 1) steps."""
    out = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        out.append(graph(*next(stream))["loss"].float())
        if log is not None and (step % max(steps // 10, 1) == 0 or step == 1):
            log(f"step {step:4d}  mlm_loss {float(out[-1]):.4f}  "
                f"({(time.perf_counter() - t0) / step * 1e3:.0f} ms/step avg)")
    return [float(v) for v in out]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--amp", action="store_true",
                    help="bfloat16 compute on float32 master parameters")
    ap.add_argument("--grad-acc", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = make_model(args.vocab, args.seq, device=dev)
    graph = make_graph(model, args.steps, args.lr, amp=args.amp, grad_acc=args.grad_acc)
    t0 = time.perf_counter()
    train(graph, batch_stream(args.batch, args.seq, args.vocab, dev), args.steps, log=print)
    tok_s = args.steps * args.batch * args.seq / (time.perf_counter() - t0)
    print(f"done: {tok_s:,.0f} tokens/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
