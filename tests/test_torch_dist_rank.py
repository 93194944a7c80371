"""The rank form of the distributed SpMM over gloo, on the CPU.

Ranks are separate processes started through the port's launcher
(``python -m of_spmm_tpu_torch.distributed.launch``) on a script written
to ``tmp_path``; the process group meets at a ``file://`` store there, so
no port is needed. Each rank drives ``dist_spmm`` on its padded X block
(``RankGroup``) for the padded, ragged, hub, split and panels bodies,
forward and the gradient of sum(Y * W), one ``make_dist_train_step``
step, every comm wrapper, and ``check_consistent`` on a plan one rank
builds differently, and writes what it got as ``.npy``. The ranks start
once per world size (2 and 4); each case is then its own test, held
against the shard-mesh form in this process (the same body, rows moved
by index_select) at rtol 1e-4 / atol 1e-5. The rank processes import the
port only, never JAX. Last, the launcher ends the group when one rank
exits 1.
"""

import inspect
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from of_spmm_tpu_torch.models import GCN
from of_spmm_tpu_torch.parallel import ShardMesh, dist_spmm, partition_rows
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.train import make_dist_train_step
from tests.conftest import ATOL, RTOL

# six test workers share the host's cores: one intra-op thread each, so that
# PyTorch's thread pools do not contend with one another and with XLA's
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT = 240


def _matrix(n, seed):
    """Rank-1 values (sym-normalized), a band plus random far edges and a
    few dense columns (hubs): every body has work across the shards."""
    rng = np.random.default_rng(seed)
    d = (rng.random((n, n)) < 0.02).astype(np.float32)
    i = np.arange(n)
    for o in (-2, -1, 0, 1, 2):
        d[i, (i + o) % n] = 1
    d[:, [3, n // 3, n // 2 + 1, n - 5]] = rng.random((n, 4)) < 0.4
    r, c = d.sum(1) ** -0.5, d.sum(0) ** -0.5
    return (d * r[:, None] * np.nan_to_num(c)[None, :]).astype(np.float32)


# name -> partition options and impl
CASES = {
    "padded": (dict(), "cuda"),
    "ragged": (dict(ragged=True), "torch"),
    "hubs": (dict(replicate_hubs=4), "cuda"),
    "ragged_refined_hubs": (dict(ragged=True, refine_slack=0.2, replicate_hubs=4), "cuda"),
    "split": (dict(split_boundary=True), "cuda"),
    "ragged_refined_split": (dict(ragged=True, refine_slack=0.2, split_boundary=True), "torch"),
    "panels": (dict(ragged=True, local_engine="panels"), "panels"),
    "panels_split_hubs": (dict(split_boundary=True, replicate_hubs=4, local_engine="panels"),
                          "panels"),
}
GCN_DIMS = (8, 16, 4)
N_ROWS, D = 150, 8


def _inputs(n, d):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, GCN_DIMS[-1], n).astype(np.int64)
    return x, w, labels


def _blocks(plan, a):
    """The (S*cps, ...) padded layout of global rows ``a`` (row-ordered)."""
    if plan.x_pack_idx is not None:
        return a[plan.x_pack_idx]
    pad = plan.n_shards * plan.cols_per_shard - a.shape[0]
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


RANK_MAIN = '''
import os, sys, time
import numpy as np
import torch
from of_spmm_tpu_torch import comm, distributed
from of_spmm_tpu_torch.models import GCN
from of_spmm_tpu_torch.parallel import RankGroup, check_consistent, dist_spmm, partition_rows
from of_spmm_tpu_torch.sparse.formats import CSR
from of_spmm_tpu_torch.train import make_dist_train_step

out, store, mode = sys.argv[1], sys.argv[2], sys.argv[3]
rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
if mode == "fail":  # rank 0 sleeps; rank 1 fails once rank 0 is up
    pid_file = os.path.join(out, "pid")
    if rank == 0:
        with open(pid_file + ".tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(pid_file + ".tmp", pid_file)
        time.sleep(120)
        sys.exit(0)
    deadline = time.time() + 60
    while not os.path.exists(pid_file) and time.time() < deadline:
        time.sleep(0.05)
    sys.exit(1)
distributed.initialize(backend="gloo", init_method="file://" + store, world_size=size, rank=rank)
assert distributed.get_world_size() == size and distributed.get_rank() == rank
rg = RankGroup()


def save(name, t):
    np.save(os.path.join(out, f"{name}.r{rank}.npy"), t.detach().numpy())


a = CSR.from_dense(_matrix(N_ROWS, 5))
x, w, labels = _inputs(N_ROWS, D)
for name, (kw, impl) in CASES.items():
    plan = partition_rows(a, size, **kw)
    check_consistent(plan, name)
    cps, rps = plan.cols_per_shard, plan.rows_per_shard
    xb = torch.from_numpy(_blocks(plan, x)[rank * cps:(rank + 1) * cps]).requires_grad_()
    wb = torch.from_numpy(_blocks(plan, w)[rank * rps:(rank + 1) * rps])
    y = dist_spmm(plan, xb, rg, impl=impl)
    (y * wb).sum().backward()
    save(f"{name}.y", y)
    save(f"{name}.g", xb.grad)

plan = partition_rows(a, size, ragged=True, replicate_hubs=4)
model = GCN(GCN_DIMS, device="cpu", generator=torch.Generator().manual_seed(0))
step = make_dist_train_step(model, plan, rg, lr=1e-2, impl="cuda")
cps = plan.cols_per_shard
xb = torch.from_numpy(_blocks(plan, x)[rank * cps:(rank + 1) * cps])
lb = torch.from_numpy(_blocks(plan, labels)[rank * cps:(rank + 1) * cps])
save("train.loss", step(xb, lb))
for pname, p in model.named_parameters():
    save(f"train.{pname}", p)

# the comm wrappers on v = 10 * rank + arange, and two of their grads
v = (torch.arange(2 * size * 3, dtype=torch.float32).reshape(2 * size, 3) + 10 * rank)
save("comm.all_reduce", comm.all_reduce(v))
save("comm.all_reduce_mean", comm.all_reduce_mean(v))
save("comm.all_gather", comm.all_gather(v, dim=1))
save("comm.reduce_scatter", comm.reduce_scatter(v))
save("comm.all_to_all", comm.all_to_all(v, split_dim=0, concat_dim=1))
save("comm.broadcast", comm.broadcast(v, root=size - 1))
save("comm.reduce", comm.reduce(v, root=1))
save("comm.permute", comm.permute(v, [(0, 1), (1, 0)]))
save("comm.send_recv_next", comm.send_recv_next(v, shift=size - 1))
save("comm.send_recv", comm.send_recv(v, src=1, dst=0))
save("comm.send_recv_pairs", comm.send_recv_pairs(v, [(i, size - 1 - i) for i in range(size)]))
save("comm.transfer", comm.transfer(v, "cpu"))
vg = v.clone().requires_grad_()
(comm.all_gather(vg) * (rank + 1)).sum().backward()
save("comm.all_gather_grad", vg.grad)
vg = v.clone().requires_grad_()
(comm.send_recv_next(vg, shift=1) * (rank + 1)).sum().backward()
save("comm.send_recv_next_grad", vg.grad)

# a rank that builds another plan: every rank's check raises
odd = partition_rows(a, size, ragged=rank == 0)
try:
    check_consistent(odd, "odd")
    raised = False
except RuntimeError as e:
    raised = "consistency check failed" in str(e)
save("consistency.raised", torch.tensor(raised))
save("isolation.jax_free", torch.tensor(not any(
    m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "of_spmm_tpu"
    or m.startswith("of_spmm_tpu.") for m in sys.modules)))
distributed.barrier()
distributed.destroy()
'''


def _script():
    """The rank script: this module's shared helpers, then RANK_MAIN."""
    head = "\n\n".join(textwrap.dedent(inspect.getsource(f)) for f in (_matrix, _inputs, _blocks))
    consts = (f"CASES = {CASES!r}\nGCN_DIMS = {GCN_DIMS!r}\nN_ROWS, D = {N_ROWS}, {D}\n")
    return "import numpy as np\n\n" + consts + head + RANK_MAIN


def _launch(tmp, size, mode):
    script = tmp / "rank_main.py"
    script.write_text(_script())
    out = tmp / "out"
    out.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "of_spmm_tpu_torch.distributed.launch", "--nproc_per_node",
           str(size), str(script), str(out), str(tmp / "store"), mode]
    env = {**os.environ, "PYTHONPATH": _REPO, "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(tmp), env=env, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT)
    return proc, out, time.perf_counter() - t0


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    size = request.param
    proc, out, _ = _launch(tmp_path_factory.mktemp(f"ranks{size}"), size, "run")
    assert proc.returncode == 0, proc.stdout + proc.stderr

    def load(name):
        return [np.load(out / f"{name}.r{r}.npy") for r in range(size)]
    return size, load


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _mesh_case(name, size):
    kw, impl = CASES[name]
    plan = partition_rows(CSR.from_dense(_matrix(N_ROWS, 5)), size, **kw)
    x, w, _ = _inputs(N_ROWS, D)
    xt = torch.from_numpy(x).requires_grad_()
    y = dist_spmm(plan, xt, ShardMesh(["cpu"] * size), impl=impl)
    (y * torch.from_numpy(w)).sum().backward()
    return plan, y.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_forward_equals_shard_mesh(ranks, name):
    size, load = ranks
    plan, y, _ = _mesh_case(name, size)
    got = np.concatenate(load(f"{name}.y"))
    assert got.shape == (size * plan.rows_per_shard, D)
    if plan.y_unpack_idx is not None:
        got = got[plan.y_unpack_idx]
    _close(got[:N_ROWS], y)


@pytest.mark.parametrize("name", list(CASES))
def test_gradient_equals_shard_mesh(ranks, name):
    size, load = ranks
    plan, _, g = _mesh_case(name, size)
    padded = np.concatenate(load(f"{name}.g"))
    if plan.x_pack_idx is not None:
        got = np.zeros_like(g)
        np.add.at(got, plan.x_pack_idx, padded)
    else:
        got = padded[:N_ROWS]
        assert not padded[N_ROWS:].any()
    _close(got, g)


def test_train_step_equals_shard_mesh(ranks):
    size, load = ranks
    plan = partition_rows(CSR.from_dense(_matrix(N_ROWS, 5)), size, ragged=True,
                          replicate_hubs=4)
    model = GCN(GCN_DIMS, device="cpu", generator=torch.Generator().manual_seed(0))
    x, _, labels = _inputs(N_ROWS, D)
    step = make_dist_train_step(model, plan, ShardMesh(["cpu"] * size), lr=1e-2, impl="cuda")
    loss = step(torch.from_numpy(x), torch.from_numpy(labels))
    for got in load("train.loss"):
        _close(got, loss.numpy())
    for pname, p in model.named_parameters():
        for got in load(f"train.{pname}"):  # every rank keeps the same parameters
            _close(got, p.detach().numpy())


def _comm_want(name, size):
    """What rank r of ``size`` should hold after comm.<name>, per rank."""
    v = [np.arange(2 * size * 3, dtype=np.float32).reshape(2 * size, 3) + 10 * r
         for r in range(size)]
    total = sum(v)
    zero = np.zeros_like(v[0])
    if name == "all_reduce":
        return [total] * size
    if name == "all_reduce_mean":
        return [total / size] * size
    if name == "all_gather":
        return [np.concatenate(v, axis=1)] * size
    if name == "reduce_scatter":
        return [total[2 * r:2 * r + 2] for r in range(size)]
    if name == "all_to_all":
        return [np.concatenate([v[q][2 * r:2 * r + 2] for q in range(size)], axis=1)
                for r in range(size)]
    if name == "broadcast":
        return [v[size - 1]] * size
    if name == "reduce":
        return [total if r == 1 else zero for r in range(size)]
    if name == "permute":
        return [v[1], v[0]] + [zero] * (size - 2)
    if name == "send_recv_next":
        return [v[(r + 1) % size] for r in range(size)]
    if name == "send_recv":
        return [v[1]] + [zero] * (size - 1)
    if name == "send_recv_pairs":
        return [v[size - 1 - r] for r in range(size)]
    if name == "transfer":
        return v
    if name == "all_gather_grad":  # reduce-scatter of the (rank + 1) weights
        return [np.full_like(v[0], sum(range(1, size + 1)))] * size
    if name == "send_recv_next_grad":  # rank r's value was weighted on rank r + 1
        return [np.full_like(v[0], (r + 1) % size + 1) for r in range(size)]
    raise KeyError(name)


COMM = ("all_reduce", "all_reduce_mean", "all_gather", "reduce_scatter", "all_to_all",
        "broadcast", "reduce", "permute", "send_recv_next", "send_recv", "send_recv_pairs",
        "transfer", "all_gather_grad", "send_recv_next_grad")


@pytest.mark.parametrize("name", COMM)
def test_comm_wrappers(ranks, name):
    size, load = ranks
    for got, want in zip(load(f"comm.{name}"), _comm_want(name, size)):
        np.testing.assert_array_equal(got, want)


def test_check_consistent_raises_on_every_rank(ranks):
    _, load = ranks
    assert all(bool(r) for r in load("consistency.raised"))


def test_rank_processes_load_no_jax(ranks):
    _, load = ranks
    assert all(bool(r) for r in load("isolation.jax_free"))


def test_launcher_ends_the_group_when_a_rank_fails(tmp_path):
    """Rank 1 exits 1 while rank 0 sleeps: the launcher returns 1 at once
    and rank 0 is gone (terminated and reaped)."""
    proc, out, seconds = _launch(tmp_path, 2, "fail")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert seconds < 90
    pid = int((out / "pid").read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
