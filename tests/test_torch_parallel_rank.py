"""The rank form of the parallel strategies over gloo, on the CPU, against
their one-process form.

One function, ``drive``, runs every strategy on meshes that a factory
makes: in this process on ``ShardMesh(["cpu"] * n, shape, axis_names)``,
and in rank processes, started once per world size through the port's
launcher (``python -m of_spmm_tpu_torch.distributed.launch``) on a script
written to ``tmp_path``, on ``RankGroup(shape=..., axis_names=...)``
(one process group per mesh axis, ``init_device_mesh`` over gloo; the
group meets at a ``file://`` store there). World size 2 runs 1-D meshes;
world size 4 runs tensor parallelism on (2, 2) dp x tp, the pipeline on
(2, 2) stage x data and the global view's every 2-D transition on
(2, 2), the rest (the sharded embedding among them) on 1-D meshes of
4; ZeRO-1 of a TrainGraph (Adam, the optimizer state S(0) over the
ranks) on 1-D meshes of both sizes, with a save_sharded / load_sharded
round trip. Each rank saves what it got as ``.npy``; each case is then
its own test at rtol 1e-4 / atol 1e-5: a rank's block against the same
block of the one-process result, a replicated result against the whole,
and a gradient as the sum of the ranks' shares (each rank's loss is its
share of the global loss). The rank processes import the port only,
never JAX.
"""

import inspect
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from of_spmm_tpu_torch.parallel import ShardMesh, to_global, to_local
from tests.conftest import ATOL, RTOL

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 240


def drive(make_mesh, world, workdir):
    """Every strategy on meshes from ``make_mesh(shape, axis_names)``:
    {name: (kind, tensor, (shape, axis_names, sbp) or None)}; kind
    "block" (each shard's block of a global value under sbp), "same"
    (every rank holds the whole value), "share" (a gradient: the ranks'
    shares sum to it), "local" (stacked GlobalTensor blocks)."""
    import itertools
    import os

    import numpy as np
    import torch

    from of_spmm_tpu_torch import parallel as par
    from of_spmm_tpu_torch.nn import Linear
    from of_spmm_tpu_torch.parallel.global_view import sbp_for

    out = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def rnd(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(
            np.float32))

    def share(loss, mesh, sbp):
        """Over ranks, each rank's share of a loss of a value placed sbp."""
        if len(mesh.local_coords()) == mesh.size:
            return loss
        return loss / math.prod(n for n, a in zip(mesh.shape, sbp) if a == "B")

    def grads(prefix, named):
        for k, p in named:
            out[f"{prefix}.grad.{k}"] = ("share", p.grad, None)

    # tensor parallelism: 1-D tp, or (2, 2) dp x tp
    shape, names, dp = ((2,), ("tp",), None) if world == 2 else ((2, 2), ("dp", "tp"), "dp")
    mesh = make_mesh(shape, names)
    p = {k: v.requires_grad_() for k, v in
         par.init_tp_mlp(16, 32, device="cpu", generator=gen(1)).items()}
    y = par.make_tp_mlp(mesh, dp_axis=dp)(par.shard_tp_mlp(p, mesh), rnd((8, 16), 2))
    sbp = sbp_for(mesh, **({dp: "S0"} if dp else {}))
    share((y ** 2).sum(), mesh, sbp).backward()
    out["tp.y"] = ("block", y, (shape, names, sbp))
    grads("tp", p.items())

    # Ulysses and the ring, 1-D; grads for one case of each
    for cls, name in ((par.SequenceParallelAttention, "sp"), (par.RingAttention, "ring")):
        mesh = make_mesh((world,), (name,))
        for causal in (False, True):
            mod = cls(16, 4, device="cpu", generator=gen(3))
            y = mod.make_sharded_apply(mesh, name, is_causal=causal)(rnd((2, 16, 16), 4))
            out[f"{name}.causal{int(causal)}.y"] = ("block", y, ((world,), (name,), ("S1",)))
            if causal == (name == "ring"):
                (y ** 2).sum().backward()
                grads(f"{name}.causal{int(causal)}", mod.named_parameters())

    # experts, 1-D
    mesh = make_mesh((world,), ("ep",))
    moe = par.MoELayer(8, 8, 16, top_k=2, capacity_factor=1.5, device="cpu", generator=gen(5))
    y, aux = moe.make_sharded_apply(mesh, return_aux=True)(rnd((4 * world, 8), 6),
                                                           moe.shard_params(mesh))
    (y ** 2).sum().backward()
    out["ep.y"] = ("block", y, ((world,), ("ep",), ("S0",)))
    out["ep.aux"] = ("same", aux, None)
    grads("ep", moe.named_parameters())

    # pipeline: 1-D of 2 stages, or (2, 2) stage x data
    shape, names = ((2,), ("stage",)) if world == 2 else ((2, 2), ("stage", "data"))
    mesh = make_mesh(shape, names)
    lins = [Linear(8, 8, device="cpu", generator=gen(7 + i)) for i in range(2)]
    stacked = {k: v.detach().requires_grad_() for k, v in par.stack_stage_params(
        [dict(m.named_parameters()) for m in lins]).items()}
    x, tgt = rnd((4, 3, 8), 9), rnd((4, 3, 8), 10)

    def stage(prm, h):
        return torch.relu(h @ prm["w"] + prm["b"])

    y = par.pipeline_apply(stage, stacked, x, mesh, axis="stage")
    share(((y - tgt) ** 2).mean(), mesh, ("B",) * len(shape)).backward()
    out["gpipe.y"] = ("same", y, None)
    grads("gpipe", stacked.items())
    loss, g = par.pipeline_train_step_1f1b(stage, lambda a, t: ((a - t) ** 2).mean(),
                                           {k: v.detach() for k, v in stacked.items()}, x, tgt,
                                           mesh, axis="stage")
    out["1f1b.loss"] = ("same", loss, None)
    for k, v in g.items():
        out[f"1f1b.grad.{k}"] = ("block", v, (shape, names, sbp_for(mesh, stage="S0")))

    # the global view: every transition of S0 / S1 / B / P
    shape, names = ((world,), ("x",)) if world == 2 else ((2, 2), ("a", "b"))
    mesh = make_mesh(shape, names)
    atoms = ["S0", "S1", "B", "P"]
    sbps = atoms if len(shape) == 1 else list(itertools.product(atoms, atoms))
    xx = torch.arange(64.0).reshape(8, 8)
    moved = [par.reshard(par.to_global(xx, s, mesh), d) for s in sbps for d in sbps]
    out["reshard.local"] = ("local", torch.cat([r.local.flatten(1) for r in moved], 1), None)
    out["reshard.full"] = ("same", torch.stack([r.full() for r in moved]), None)

    # data parallelism, 1-D: one SGD step, every rank's parameters after it
    mesh = make_mesh((world,), ("x",))
    model = Linear(8, 4, device="cpu", generator=gen(11))
    par.broadcast_params(dict(model.named_parameters()), mesh)
    step = par.ddp_train_step(lambda a, b: ((model(a) - b) ** 2).mean(),
                              torch.optim.SGD(model.parameters(), lr=0.1), mesh)
    out["ddp.loss"] = ("same", step(rnd((16, 8), 12), rnd((16, 4), 13)), None)
    for k, v in model.named_parameters():
        out[f"ddp.param.{k}"] = ("same", v, None)

    # the sharded embedding, 1-D: the id-shuffle lookup (ids outside
    # [0, 30) among them) and the table's grad, each rank's block
    from of_spmm_tpu_torch.models import ShardedEmbedding
    mesh = make_mesh((world,), ("x",))
    emb = ShardedEmbedding(30, 4)
    table = emb.init(gen(17), mesh)
    ids = torch.from_numpy(np.random.default_rng(18).integers(-3, 34, 4 * world))
    y = emb.apply(table, ids, mesh)
    (y ** 2).sum().backward()
    out["emb.y"] = ("block", y, ((world,), ("x",), ("S0",)))
    out["emb.grad"] = ("local", table["weight"].local.grad, None)

    # ZeRO-1, 1-D: 3 Adam steps of a TrainGraph holding the optimizer state
    # S(0) over "x" (the loss over ranks: each rank's block of the batch);
    # each rank's state blocks, the parameters, stage 0 in this process,
    # and a save_sharded / load_sharded round trip of the graph's state
    from of_spmm_tpu_torch import optim
    from of_spmm_tpu_torch.graph import GraphConfig, TrainGraph
    from of_spmm_tpu_torch.utils.checkpoint import load_sharded, save_sharded
    from of_spmm_tpu_torch.utils.tree import tree_map, unnest

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer_0 = Linear(8, 64, device="cpu", generator=gen(14))
            self.layer_2 = Linear(64, 8, device="cpu", generator=gen(15))

        def forward(self, a):
            return self.layer_2(torch.relu(self.layer_0(a)))

    mesh = make_mesh((world,), ("x",))
    batches = [(rnd((16, 8), 16 + s), rnd((16, 8), 20 + s)) for s in range(3)]
    graphs = {}
    # LAMB's trust ratio reads whole tensors: over ranks its norms of a
    # ZeRO-held parameter sum over the blocks
    for opt, prefix in ((optim.adam(1e-2), "zero"),
                        (optim.lamb(1e-2, weight_decay=0.01), "zero.lamb")):
        for stage, m in ((1, mesh), (0, None)):
            zm = MLP()
            graphs[prefix, stage] = TrainGraph(lambda mod, a, b: ((mod(a) - b) ** 2).mean(), opt,
                                               zm, GraphConfig(zero_stage=stage, zero_min_size=64),
                                               mesh=m)
            for a, b in batches:
                loss = graphs[prefix, stage](a, b)["loss"]
            for k, v in zm.named_parameters():
                out[f"{prefix}.{'param' if stage else 'stage0.param'}.{k}"] = ("same", v, None)
        out[f"{prefix}.loss"] = ("same", loss, None)
    graphs = {stage: graphs["zero", stage] for stage in (1, 0)}
    sd = graphs[1].state_dict()
    for k, v in unnest(sd["state"]["opt"]).items():
        if isinstance(v, par.GlobalTensor):
            out[f"zero.state.{k}"] = ("local", v.local, None)
    ck = os.path.join(workdir, "zero_ck")
    save_sharded(ck, sd)
    back = load_sharded(ck, tree_map(lambda v: par.GlobalTensor(torch.zeros_like(v.local), v.sbp,
                                                                v.mesh)
                                     if isinstance(v, par.GlobalTensor) else torch.zeros_like(v),
                                     sd))
    flat, got = unnest(sd), unnest(back)
    same = [torch.equal(*(t.local if isinstance(t, par.GlobalTensor) else t
                          for t in (flat[k], got[k]))) for k in flat]
    out["zero.ckpt_roundtrip"] = ("same", torch.tensor(all(same)), None)
    return out


RANK_MAIN = '''
import math, os, sys
import numpy as np
import torch
from of_spmm_tpu_torch import distributed
from of_spmm_tpu_torch.parallel import RankGroup

out_dir, store = sys.argv[1], sys.argv[2]
rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
distributed.initialize(backend="gloo", init_method="file://" + store, world_size=size, rank=rank)
for name, (kind, t, _) in drive(lambda shape, names: RankGroup(shape=shape, axis_names=names),
                                size, out_dir).items():
    np.save(os.path.join(out_dir, f"{name}.r{rank}.npy"), t.detach().numpy())
np.save(os.path.join(out_dir, f"isolation.r{rank}.npy"), np.array(not any(
    m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "of_spmm_tpu"
    or m.startswith("of_spmm_tpu.") for m in sys.modules)))
distributed.barrier()
distributed.destroy()
'''


def _mesh_results(world, workdir):
    return drive(lambda shape, names: ShardMesh(["cpu"] * math.prod(shape), shape=shape,
                                                axis_names=names), world, str(workdir))


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{world}")
    script = tmp / "rank_main.py"
    script.write_text("import math\n\n" + textwrap.dedent(inspect.getsource(drive)) + RANK_MAIN)
    out = tmp / "out"
    out.mkdir()
    cmd = [sys.executable, "-m", "of_spmm_tpu_torch.distributed.launch", "--nproc_per_node",
           str(world), str(script), str(out), str(tmp / "store")]
    env = {**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    def load(name):
        return [np.load(out / f"{name}.r{r}.npy") for r in range(world)]
    mesh_dir = tmp / "mesh"
    mesh_dir.mkdir()
    return world, load, _mesh_results(world, mesh_dir)


CASES = ["tp.y", "tp.grad.w_in", "tp.grad.b_in", "tp.grad.w_out", "tp.grad.b_out",
         "sp.causal0.y", "sp.causal1.y", "ring.causal0.y", "ring.causal1.y",
         *(f"{m}.grad.{k}" for m in ("sp.causal0", "ring.causal1")
           for k in ("in_w", "out_w", "in_b", "out_b")),
         "ep.y", "ep.aux", *(f"ep.grad.{k}" for k in ("wg", "w1", "b1", "w2", "b2")),
         "gpipe.y", "gpipe.grad.w", "gpipe.grad.b", "1f1b.loss", "1f1b.grad.w", "1f1b.grad.b",
         "reshard.local", "reshard.full", "emb.y", "emb.grad",
         "ddp.loss", "ddp.param.w", "ddp.param.b",
         *(f"zero.{w}.{k}" for w in ("param", "stage0.param")
           for k in ("layer_0.w", "layer_0.b", "layer_2.w", "layer_2.b")),
         *(f"zero.lamb.{w}.{k}" for w in ("param", "stage0.param")
           for k in ("layer_0.w", "layer_0.b", "layer_2.w", "layer_2.b")),
         "zero.loss", "zero.lamb.loss", "zero.ckpt_roundtrip",
         *(f"zero.state.{s}.{k}" for s in ("m", "v") for k in ("layer_0.w", "layer_0.b",
                                                                 "layer_2.w"))]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cases_cover_every_result(ranks):
    _, _, mesh = ranks
    assert sorted(mesh) == sorted(CASES)


@pytest.mark.parametrize("name", CASES)
def test_rank_form_equals_shard_mesh(ranks, name):
    world, load, mesh = ranks
    kind, want, placement = mesh[name]
    want = want.detach()
    got = load(name)
    if kind == "same":
        for g in got:
            _close(g, want.numpy())
    elif kind == "share":
        _close(sum(got), want.numpy())
    elif kind == "local":  # the S shards' blocks against each rank's one
        for r, g in enumerate(got):
            _close(g[0], want[r].numpy())
    else:
        shape, names, sbp = placement
        blocks = to_local(to_global(want, sbp, ShardMesh(["cpu"] * math.prod(shape),
                                                         shape=shape, axis_names=names)))
        for g, w in zip(got, blocks):
            _close(g, w.numpy())


def test_rank_zero1_holds_blocks_and_equals_stage0(ranks):
    """Each rank holds 1/world of each S(0) state leaf (the 8-row weight's
    moments, the 64-row bias's and weight's) and, after 3 Adam (and 3
    LAMB) steps, the parameters of stage 0 (one process, the whole
    batch)."""
    world, load, mesh = ranks
    for s in ("m", "v"):
        for k, rows in (("layer_0.w", 8), ("layer_0.b", 64), ("layer_2.w", 64)):
            assert all(b.shape[:2] == (1, rows // world) for b in load(f"zero.state.{s}.{k}"))
    for prefix in ("zero", "zero.lamb"):
        for k in ("layer_0.w", "layer_0.b", "layer_2.w", "layer_2.b"):
            for got in load(f"{prefix}.param.{k}"):
                _close(got, mesh[f"{prefix}.stage0.param.{k}"][1].detach().numpy())
    assert all(bool(r) for r in load("zero.ckpt_roundtrip"))


def test_rank_processes_load_no_jax(ranks):
    _, load, _ = ranks
    assert all(bool(r) for r in load("isolation"))
