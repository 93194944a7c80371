"""One run of one cell of the benchmark of of_spmm_tpu_torch.

A cell is a configuration (``configs/<name>.json``: the model family, its
widths, the graph, the optimizer) under a traffic mix
(``traffic/<name>.json``: the loop and its parameters), both named in
``BENCHMARK.json``. Everything is found by name: the family's port
adapter (``models/<family>.py``) and plain reference
(``reference/<family>.py``), the cell's limits (``limits/<cell>.json``)
and each metric's reader (``metrics/<metric>.py``). A later cell, family
or metric is new files and entries, not an edit.

A run makes the inputs and weights from the seed on the device, builds
the system under test through the port's normal path (its adjacency
preprocessing, ``make_operator`` with the default layout, the model, and
for training ``make_optimizer`` and ``train_step``), warms up, measures
for ``seconds``, then frees the program's state and holds what the window
produced against the plain reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import graphs, readers
from benchmark import trace as tracing
from benchmark.counts import SpmmTraffic
from benchmark.reference import common as refc

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

from of_spmm_tpu_torch.examples.train_gcn import make_optimizer, train_step  # noqa: E402
from of_spmm_tpu_torch.ops import make_operator  # noqa: E402
from of_spmm_tpu_torch.sparse.formats import CSR  # noqa: E402


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str = BENCH_DIR


def resolve(spec: dict, workload: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of the benchmark ``spec`` (BENCHMARK.json's
    content), with its configuration, traffic and limits read from their
    files, and the metrics it reports."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r}; have {[w['name'] for w in spec['workloads']]}")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=workload, config_name=c["name"],
                config=read_json(os.path.join(root, c["file"])),
                traffic=read_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
                limits=read_json(os.path.join(bench_dir, "limits", workload + ".json")),
                end_to_end=e2e, per_layer=per_layer, bench_dir=bench_dir)


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(config: dict):
    """(port adapter, plain reference) modules of the configuration's family."""
    name = config["family"]
    return (importlib.import_module(f"benchmark.models.{name}"),
            importlib.import_module(f"benchmark.reference.{name}"))


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for one of the run's streams of random numbers."""
    return (int(seed) * 16 + stream) % (1 << 63)


@dataclasses.dataclass
class Inputs:
    weights: Dict[str, torch.Tensor]
    features: List[torch.Tensor]
    labels: torch.Tensor
    mask: torch.Tensor


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """Weights, feature matrices, labels and the training mask, drawn from
    ``seed`` by generators on ``device`` in a few large calls."""
    _, ref = family(config)
    dims = config["dims"]
    n = int(config["graph"]["nodes"])
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, 1))
    spec = ref.leaves(dims)
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    u = torch.rand(sum(sizes), generator=g, device=device)
    weights, off = {}, 0
    for (name, (shape, init)), size in zip(spec.items(), sizes):
        if init == "glorot":
            limit = math.sqrt(6.0 / (shape[0] + shape[-1]))
            weights[name] = ((u[off:off + size] * 2 - 1) * limit).reshape(shape)
        else:
            weights[name] = torch.zeros(shape, device=device)
        off += size
    g.manual_seed(stream_seed(seed, 2))
    k = int(traffic.get("feature_sets", 1))
    x = torch.randn((k, n, dims[0]), generator=g, device=device)
    labels = torch.randint(0, dims[-1], (n,), generator=g, device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=g, device=device)[:int(config["train_nodes"])]] = True
    return Inputs(weights=weights, features=list(x.unbind(0)), labels=labels, mask=mask)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_operator(config: dict, indptr: np.ndarray, cols: np.ndarray, device):
    """The port's operator of the configuration's graph: its own adjacency
    preprocessing, then ``make_operator`` with the default layout.
    Returns (operator, plan_s), ``plan_s`` the host seconds of
    ``make_operator`` ended by a synchronize."""
    adapter, _ = family(config)
    n = int(config["graph"]["nodes"])
    csr = CSR.from_arrays(indptr, cols, np.ones(cols.shape[0], np.float32), (n, n))
    adj = adapter.adjacency(csr)
    del csr
    t = time.perf_counter()
    op = make_operator(adj, device=device)
    sync(device)
    return op, time.perf_counter() - t


class Program:
    """The system under test on an operator: the port's model and, in
    training, Adam with its schedule from ``make_optimizer``, stepped by
    ``train_step``."""

    def __init__(self, config: dict, op, inputs: Inputs, device, train: bool):
        adapter, _ = family(config)
        self.op = op
        self.model = adapter.model(config["dims"], device)
        self.model.load_state_dict(inputs.weights, strict=True)
        self.x, self.labels, self.mask = inputs.features[0], inputs.labels, inputs.mask
        if train:
            opt = config["optimizer"]
            self.opt, self.sched = make_optimizer(self.model, float(opt["lr"]), int(opt["epochs"]))

    def step(self) -> torch.Tensor:
        loss = train_step(self.model, self.op, self.x, self.labels, self.opt, mask=self.mask)
        self.sched.step()
        return loss

    def answer(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """One request: the predicted class of every node, on the host."""
        return self.model(self.op, x).argmax(-1).to(dtype).cpu()


def answer_dtype(config: dict) -> torch.dtype:
    return torch.uint8 if config["dims"][-1] <= 256 else torch.int32


def train_window(prog: Program, seconds: float, device) -> List[torch.Tensor]:
    """Steps back to back until ``seconds`` have passed on the host's
    clock, then a synchronize; the losses stay on the device."""
    deadline = time.perf_counter() + seconds
    losses = []
    while True:
        losses.append(prog.step())
        if time.perf_counter() >= deadline:
            break
    sync(device)
    return losses


def serve_window(prog: Program, features: List[torch.Tensor], rng, seconds: float,
                 dtype: torch.dtype) -> tuple:
    """One client's closed loop until ``seconds`` have passed: each request
    takes the feature set the seed's stream draws, and ends when its
    answer is on the host. Returns (answers, feature-set ids, latencies)."""
    deadline = time.perf_counter() + seconds
    answers, sets, lat = [], [], []
    with torch.inference_mode():
        while True:
            k = int(rng.integers(len(features)))
            a = time.perf_counter()
            answers.append(prog.answer(features[k], dtype))
            lat.append(time.perf_counter() - a)
            sets.append(k)
            if time.perf_counter() >= deadline:
                break
    return answers, sets, lat


def request_stream(seed: int):
    """The seed's stream of feature-set draws."""
    return np.random.default_rng([int(seed) % (1 << 63), 7])


def train_readings(prog: Program, steps: int) -> dict:
    """The program's first ``steps`` updates, through the window's own
    call: each loss, each leaf's norm of the first gradient as Adam got it
    (its first moment after one update over 1 - beta1), and each leaf's
    norm of the change of its parameters over the steps."""
    params = dict(prog.model.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    beta1 = prog.opt.param_groups[0]["betas"][0]
    losses, grad = [], {}
    for i in range(steps):
        losses.append(prog.step())
        if i == 0:
            grad = {k: float(torch.linalg.vector_norm(prog.opt.state[p]["exp_avg"]) / (1 - beta1))
                    for k, p in params.items()}
    change = {k: float(torch.linalg.vector_norm(p.detach() - start[k])) for k, p in params.items()}
    return {"losses": [float(x) for x in losses], "grad": grad, "change": change}


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep) -> float:
    floor = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keep)


def compare_train(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers held against the limits: the worst step's relative gap
    of the loss; the worst leaf's gap between the program's and the
    reference's norm of the first gradient, and of the change over the
    steps, each over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the change."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    floor = statistics.median(ref["grad"].values())
    moved = [k for k, v in ref["grad"].items() if v >= 1e-3 * floor]
    return {"loss": loss, "grad": _worst_leaf(prog["grad"], ref["grad"], ref["grad"]),
            "change": _worst_leaf(prog["change"], ref["change"], moved)}


def serve_gaps(answers: List[torch.Tensor], sets: List[int], logits: Dict[int, torch.Tensor]
               ) -> List[float]:
    """Each answer's widest gap by which a served class's reference logit
    lies below the reference's best for that node."""
    best = {k: v.max(-1).values for k, v in logits.items()}
    out = []
    for ans, k in zip(answers, sets):
        served = ans.to(logits[k].device).long()
        out.append(float((best[k] - logits[k].gather(1, served[:, None])[:, 0]).max()))
    return out


def reference_trainer(config: dict, op_ref, inputs: Inputs, mask=None,
                      frozen: bool = False) -> refc.Trainer:
    """The plain reference's training on the run's inputs and initial
    weights (``mask`` and ``frozen`` plant faults)."""
    _, ref = family(config)
    dims = config["dims"]
    return refc.Trainer(lambda p, x: ref.forward(p, op_ref, x, dims), inputs.weights,
                        config["optimizer"], inputs.features[0], inputs.labels,
                        inputs.mask if mask is None else mask, frozen=frozen)


def reference_logits(config: dict, op_ref, inputs: Inputs, sets) -> Dict[int, torch.Tensor]:
    """The plain reference's logits of each feature set in ``sets``."""
    _, ref = family(config)
    with torch.no_grad():
        return {k: ref.forward(inputs.weights, op_ref, inputs.features[k], config["dims"])
                for k in sorted(sets)}


@contextlib.contextmanager
def step_spans(opt):
    """``bench.backward``, ``bench.clip`` and ``bench.optimizer`` spans
    around the step's calls of ``Tensor.backward``,
    ``torch.nn.utils.clip_grad_norm_`` and ``opt.step``."""
    rf = torch.profiler.record_function
    orig_backward, orig_clip = torch.Tensor.backward, torch.nn.utils.clip_grad_norm_
    own_step = opt.__dict__.get("step")
    orig_step = opt.step

    def backward(self, *a, **k):
        with rf("bench.backward"):
            return orig_backward(self, *a, **k)

    def clip(*a, **k):
        with rf("bench.clip"):
            return orig_clip(*a, **k)

    def step(*a, **k):
        with rf("bench.optimizer"):
            return orig_step(*a, **k)

    torch.Tensor.backward, torch.nn.utils.clip_grad_norm_, opt.step = backward, clip, step
    try:
        yield
    finally:
        torch.Tensor.backward, torch.nn.utils.clip_grad_norm_ = orig_backward, orig_clip
        if own_step is None:
            del opt.step
        else:
            opt.step = own_step


@contextlib.contextmanager
def profiled(enabled: bool, device):
    """A ``torch.profiler`` capture (host, and the card's operations) when
    ``enabled``; yields a holder whose ``summary`` is filled at exit."""
    holder = type("Traced", (), {"summary": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.summary = tracing.summarize(prof)


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads (``metrics/<name>.py``: ``read(run)``)."""

    cell: str
    loop: str
    setup_s: float
    plan_s: float
    wall_s: float  # the window, on the host's clock
    units: int  # steps or requests completed in the window
    latencies_s: List[float]
    flops_per_unit: int  # model FLOPs of a step or a request, from shapes
    spmm_bytes_per_unit: int  # compulsory bytes of its SpMMs, from shapes
    device_name: str
    trace: Optional[tracing.TraceSummary]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)
             ) -> dict:
    """One run: set-up, the window, then the check. Returns the result
    line's object (``checks`` last)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    loop = traffic["loop"]
    if loop not in ("train", "serve"):
        raise ValueError(f"unknown loop {loop!r} in the traffic of {cell.name}")
    train = loop == "train"
    _, ref = family(config)
    dims = config["dims"]
    n = int(config["graph"]["nodes"])

    indptr, cols, hit = graphs.load_graph(cell.config_name, config["graph"])
    log(f"[{cell.name}] graph {n:,} nodes, {cols.shape[0]:,} nonzeros "
        f"({'cache' if hit else 'built'}, {time.perf_counter() - t0:.1f}s)")
    inputs = make_inputs(config, traffic, seed, device)
    op, plan_s = build_operator(config, indptr, cols, device)
    prog = Program(config, op, inputs, device, train)
    del op
    op_nnz = ref.operator_nnz(indptr, cols)
    log(f"[{cell.name}] program built ({time.perf_counter() - t0:.1f}s): plan {plan_s:.2f}s, "
        f"operator nnz {op_nnz:,}")

    widths = ref.spmm_widths(dims, train)
    flops = ref.flops(n, op_nnz, dims, train)
    spmm_bytes = sum(SpmmTraffic(op_nnz, n, n, d).compulsory_bytes for d in widths)

    ans_dtype = answer_dtype(config)
    readings = None
    if train:
        readings = train_readings(prog, int(traffic["check_steps"]))
    else:
        with torch.inference_mode():
            for i in range(int(traffic["warmup_requests"])):
                prog.answer(inputs.features[i % len(inputs.features)], ans_dtype)
    sync(device)

    losses, answers, sets, lat = [], [], [], []
    with profiled(trace, device) as traced:
        spans = step_spans(prog.opt) if (trace and train) else contextlib.nullcontext()
        with spans, torch.profiler.record_function(tracing.WINDOW_SPAN):
            t_start = time.perf_counter()
            setup_s = t_start - t0
            if train:
                losses = train_window(prog, seconds, device)
            else:
                answers, sets, lat = serve_window(prog, inputs.features, request_stream(seed),
                                                  seconds, ans_dtype)
            t_end = time.perf_counter()
    units = len(losses) if train else len(answers)
    log(f"[{cell.name}] setup {setup_s:.2f}s; window {t_end - t_start:.3f}s, {units} "
        f"{'steps' if train else 'requests'}")

    on_card = torch.device(device).type == "cuda"
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    record = RunRecord(cell=cell.name, loop=loop, setup_s=setup_s,
                       plan_s=plan_s, wall_s=t_end - t_start, units=units,
                       latencies_s=lat, flops_per_unit=flops, spmm_bytes_per_unit=spmm_bytes,
                       device_name=dev_info["kind"], trace=traced.summary)
    if trace:
        spmm_ops = record.trace.top_device_ops(pred=record.trace.launched_in(*readers.SPMM_SPANS))
        log(f"[{cell.name}] device ms a {'step' if train else 'request'} inside the SpMM: "
            + ", ".join(f"{name} {1e3 * t / max(units, 1):.4f}" for name, t in spmm_ops))
    window_losses = torch.stack(losses).float().cpu() if train else None

    # the program's state goes before the reference runs
    del prog, losses
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    op_ref = ref.operator(indptr, cols, device)
    if train:
        want = refc.readings(reference_trainer(config, op_ref, inputs),
                             int(traffic["check_steps"]))
        numbers = compare_train(readings, want)
        bad = int((~torch.isfinite(window_losses)).sum())
        numbers["nonfinite"] = float(bad)
        failed = bad
    else:
        gaps = serve_gaps(answers, sets, reference_logits(config, op_ref, inputs, set(sets)))
        numbers = {"gap": max(gaps)}
        failed = sum(g > cell.limits["gap"] for g in gaps)
    log(f"[{cell.name}] check {time.perf_counter() - t_check:.2f}s")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(v <= cell.limits[k] for k, v in numbers.items())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = metric_reader(m["name"], cell.bench_dir)(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics,
              "device": dev_info}
    if trace:
        s = record.trace
        result["device"].update(busy_s=s.busy_s(), window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.top_device_ops(), "idle_gaps": s.idle_gaps()}
    result["checks"] = checks
    return result
