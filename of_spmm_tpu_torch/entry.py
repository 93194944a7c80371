"""Entry points: the one-card check and the multi-shard dry run,
the counterparts of the repository's ``__graft_entry__.py`` for the JAX
package.

- ``entry(device=None, canary_graph="products-small")`` returns
  ``(fn, example_args)``: ``fn`` a module whose forward is a GCN on cora
  ((feature_dim, 64, n_classes), the default operator) with one
  fused-engine SpMM on the canary graph (d = 128) and one binned SpMM,
  both ``impl="cuda"`` (through their ops on any device), and one causal
  flash-attention call added into the logits at a scale of 1e-30, so one
  forward launches the hand-written kernels of those engines while the
  output stays the (2708, 7) logits. Before it returns it checks, on the
  device, that the expansion plans' bf16 value halves keep the residual
  of 1 + 2^-20.
- ``dryrun_multichip(n, device=None)`` runs one distributed GCN training
  step and every parallel strategy once on ``ShardMesh([device] * n)``
  and returns their losses and outputs, each checked finite.

Both run on the card unless ``device`` names another (``"cpu"``):

    python -m of_spmm_tpu_torch.entry                     # the card
    python -m of_spmm_tpu_torch.entry --device cpu --canary-graph cora
"""

from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from of_spmm_tpu_torch.data.graphs import load_graph, random_features
from of_spmm_tpu_torch.models import GCN, normalized_adjacency
from of_spmm_tpu_torch.ops.autograd import make_operator, spmm, spmm_internal
from of_spmm_tpu_torch.ops.cuda.expansion import bf16_tensor_value
from of_spmm_tpu_torch.ops.flash_attention import flash_attention
from of_spmm_tpu_torch.sparse.expansion import bf16_pair_bits
from of_spmm_tpu_torch.utils.device import resolve_device

CANARY_VALUE = 1.0 + 2.0 ** -20  # its bf16 residual is 2^-20, not 0
HIDDEN = 64
SMOKE_SCALE = 1e-30


def excess_precision_canary(device) -> float:
    """The largest bf16 residual of 1 + 2^-20 as the device reads the
    lane-value halves (sparse/expansion.py ``bf16_pair_bits``, decoded by
    ops/cuda/expansion.py ``bf16_tensor_value``); raises if it is 0, that
    is if the expansion engines' values would lose their low half."""
    v = np.full((8, 128), CANARY_VALUE, np.float32)
    hi, lo = bf16_pair_bits(v)
    hi_t = torch.from_numpy(hi).to(device)
    lo_t = torch.from_numpy(lo).to(device)
    residual = torch.from_numpy(v).to(device) - bf16_tensor_value(hi_t)
    lo_max = float(bf16_tensor_value(lo_t).abs().max())
    if lo_max <= 0 or float(residual.abs().max()) <= 0:
        raise RuntimeError(f"the bf16 residual of {CANARY_VALUE!r} is 0 on {device}: the "
                           "expansion plans' value halves would lose their low half")
    return lo_max


class EntryForward(torch.nn.Module):
    """The entry's forward: the GCN logits plus the three engines' smoke
    sums times 1e-30."""

    def __init__(self, model: GCN, op, fused_op):
        super().__init__()
        self.model = model
        self.op, self.fused_op = op, fused_op

    def forward(self, x: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
        logits = self.model(self.op, x)
        y_fused = spmm_internal(self.fused_op, xp, impl="cuda")
        y_binned = spmm(self.op, x[:, :128].contiguous(), impl="cuda")
        qkv = x[:256, :128].reshape(1, 2, 128, 128)
        att = flash_attention(qkv[:, 0], qkv[:, 1], qkv[:, 1], is_causal=True)
        smoke = (y_fused.sum() + y_binned.sum() + att.sum()) * SMOKE_SCALE
        return logits + smoke


def entry(device=None, canary_graph: str = "products-small"
          ) -> Tuple[EntryForward, Tuple[torch.Tensor, torch.Tensor]]:
    """``(fn, example_args)``: the entry's forward (``fn(*example_args)``
    gives the (2708, 7) logits) and its inputs, cora's features and the
    canary graph's (n, 128) X, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    csr, cfg = load_graph("cora")
    op = make_operator(normalized_adjacency(csr), device=dev)
    model = GCN((cfg.feature_dim, HIDDEN, cfg.n_classes), device=dev,
                generator=torch.Generator().manual_seed(0))
    x, _ = random_features(cfg)
    excess_precision_canary(dev)
    pcsr, _ = load_graph(canary_graph, symmetrize=True)
    fused_op = make_operator(normalized_adjacency(pcsr), layout="fused", device=dev,
                             keep_coo=False)
    rng = np.random.default_rng(0)
    xp = rng.standard_normal((fused_op.shape[1], 128)).astype(np.float32)
    return (EntryForward(model, op, fused_op),
            (torch.from_numpy(x).to(dev), torch.from_numpy(xp).to(dev)))


def _finite(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"dryrun_multichip: {name} is not finite")


def dryrun_multichip(n_devices: int, device=None,
                     gcn_params: Optional[Mapping[str, torch.Tensor]] = None
                     ) -> Dict[str, object]:
    """One training step and every parallel strategy over
    ``ShardMesh([device] * n_devices)`` at small shapes (the JAX dry
    run's, its data from ``np.random.default_rng(0)``): a distributed GCN
    SGD step; the ragged, panel and split-panel ``dist_spmm`` with grads;
    the tensor-parallel MLP; Ulysses and ring attention; the GPipe
    forward with grads; a 1F1B step; MoE with grads. ``gcn_params`` (a
    ``state_dict``) replaces the GCN's seeded initial weights. Returns
    each result (losses as floats), all checked finite."""
    from of_spmm_tpu_torch.nn import Linear
    from of_spmm_tpu_torch.parallel import (
        MoELayer, RingAttention, SequenceParallelAttention, ShardMesh, dist_spmm,
        init_tp_mlp, make_tp_mlp, partition_rows, pipeline_apply,
        pipeline_train_step_1f1b, shard_tp_mlp, stack_stage_params)
    from of_spmm_tpu_torch.sparse.formats import CSR
    from of_spmm_tpu_torch.train import make_dist_train_step

    dev = resolve_device(device)
    S = n_devices
    out: Dict[str, object] = {}

    def mesh(axis: str) -> ShardMesh:
        return ShardMesh([dev] * S, axis_names=(axis,))

    rng = np.random.default_rng(0)
    n, d, h, c = 8 * S, 16, 8, 4
    dense = (rng.random((n, n)) < 0.2).astype(np.float32)
    np.fill_diagonal(dense, 0)
    csr = normalized_adjacency(CSR.from_dense(dense))
    model = GCN((d, h, c), device=dev, generator=torch.Generator().manual_seed(0))
    if gcn_params is not None:
        model.load_state_dict(gcn_params)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, c, n).astype(np.int64)).to(dev)
    step = make_dist_train_step(model, partition_rows(csr, S), mesh("x"))
    out["loss"] = float(step(x, labels))
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"dryrun_multichip: non-finite loss {out['loss']}")

    # ragged per-offset halo with min-cut refined boundaries: one forward
    rplan = partition_rows(csr, S, ragged=True, refine_slack=0.2, with_transpose=False,
                           replicate_hubs="auto")
    out["y_ragged"] = dist_spmm(rplan, x, mesh("x")).detach()
    # per-shard panel plans, then the split body (interior / boundary,
    # replicated hubs), each with its grad
    for key, kwargs in (("panels", {}), ("split_panels", dict(split_boundary=True,
                                                               replicate_hubs=8))):
        plan = partition_rows(csr, S, ragged=True, local_engine="panels", **kwargs)
        xg = x.clone().requires_grad_(True)
        y = dist_spmm(plan, xg, mesh("x"), impl="panels")
        y.sum().backward()
        out[f"y_{key}"], out[f"g_{key}"] = y.detach(), xg.grad
    _finite("dist_spmm", out["y_ragged"], out["y_panels"], out["g_panels"],
            out["y_split_panels"], out["g_split_panels"])

    # tensor parallelism: the column / row Linear pair over "tp"
    tp_mesh = mesh("tp")
    tp_params = init_tp_mlp(16, 32, device=dev, generator=torch.Generator().manual_seed(1))
    out["y_tp"] = make_tp_mlp(tp_mesh)(shard_tp_mlp(tp_params, tp_mesh), x[:, :16]).detach()

    # sequence parallelism: Ulysses and the KV ring on a sequence axis
    E, H = 16, S if S % 2 == 0 else 2 * S
    xs = torch.randn((2, 8 * S, E), generator=torch.Generator().manual_seed(3)).to(dev)
    sp = SequenceParallelAttention(E, H, device=dev, generator=torch.Generator().manual_seed(2))
    ring = RingAttention(E, 4, device=dev, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        out["y_sp"] = sp.make_sharded_apply(mesh("sp"))(xs)
        out["y_ring"] = ring.make_sharded_apply(mesh("ring"), is_causal=True)(xs)
    _finite("tp / sp / ring", out["y_tp"], out["y_sp"], out["y_ring"])

    # pipeline parallelism: GPipe over "stage", then one 1F1B step
    pp_mesh = mesh("stage")
    lins = [Linear(E, E, device=dev, generator=torch.Generator().manual_seed(10 + i))
            for i in range(S)]
    stacked = {k: v.detach().requires_grad_(True) for k, v in stack_stage_params(
        [{"w": m.w, "b": m.b} for m in lins]).items()}
    x_micro = torch.randn((2 * S, 4, E), generator=torch.Generator().manual_seed(5)).to(dev)

    def stage(prm, a):
        return torch.tanh(a @ prm["w"] + prm["b"])

    pp_loss = (pipeline_apply(stage, stacked, x_micro, pp_mesh, axis="stage") ** 2).sum()
    pp_loss.backward()
    out["pp_loss"] = float(pp_loss.detach())
    out["pp_grads"] = {k: v.grad for k, v in stacked.items()}
    tgt = torch.randn(x_micro.shape, generator=torch.Generator().manual_seed(8)).to(dev)
    loss_1f1b, g_1f1b = pipeline_train_step_1f1b(
        stage, lambda yv, t: ((yv - t) ** 2).mean(),
        {k: v.detach() for k, v in stacked.items()}, x_micro, tgt, pp_mesh, axis="stage")
    out["loss_1f1b"], out["g_1f1b"] = float(loss_1f1b), g_1f1b
    _finite("pipeline", torch.tensor([out["pp_loss"], out["loss_1f1b"]]),
            *out["pp_grads"].values(), *g_1f1b.values())

    # expert parallelism: MoE token dispatch over "ep"
    moe = MoELayer(E, 2 * S, 4 * E, top_k=2, device=dev,
                   generator=torch.Generator().manual_seed(6))
    tokens = torch.randn((8 * S, E), generator=torch.Generator().manual_seed(7)).to(dev)
    moe_loss = (moe.make_sharded_apply(mesh("ep"))(tokens) ** 2).sum()
    moe_loss.backward()
    out["moe_loss"] = float(moe_loss.detach())
    out["moe_grads"] = {k: p.grad for k, p in moe.named_parameters()}
    _finite("moe", torch.tensor([out["moe_loss"]]), *out["moe_grads"].values())
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--canary-graph", default="products-small")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)
    fn, example = entry(args.device, args.canary_graph)
    with torch.no_grad():
        out = fn(*example)
    print("entry ok:", tuple(out.shape), "finite:", bool(torch.isfinite(out).all()))
    res = dryrun_multichip(args.shards, args.device)
    print(f"dryrun_multichip({args.shards}) ok: loss {res['loss']:.6f}")


if __name__ == "__main__":
    main()
