"""Nothing the benchmark loads is JAX or the JAX package (top-level
module names compared whole), and a run without a CUDA card prints no
result and fails."""

import json
import os
import subprocess
import sys

from benchmark import run

from .bench_fixtures import ROOT

PROBE = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import run
import os
os.environ.update(run.CACHE_ENV)
import torch
torch.set_num_threads(1)
from benchmark import graphs, harness
graphs.CACHE_DIR = {cache!r}
import benchmark.calibrate
spec = json.load(open({spec!r}))
for w in [w["name"] for w in spec["workloads"]]:
    cell = harness.resolve(spec, w)
    cell.config["graph"].update(nodes=400, edges=3000)
    cell.config["train_nodes"] = 100
    for m in cell.end_to_end + cell.per_layer:
        harness.metric_reader(m["name"])
    harness.run_cell(cell, 3, 0.2, True, torch.device("cpu"), time.perf_counter(),
                     log=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_module_is_loaded(tmp_path):
    code = PROBE.format(root=ROOT, cache=str(tmp_path), spec=os.path.join(ROOT, "BENCHMARK.json"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "of_spmm_tpu_torch" in top and "benchmark" in top
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"of_spmm_tpu_torch": None, "of_spmm_tpu_torch.ops": None, "jaxtyping": None}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.loaded_forbidden() == []
    fake["of_spmm_tpu.ops"] = None
    fake["jax.numpy"] = None
    assert run.loaded_forbidden() == ["jax", "of_spmm_tpu"]


def test_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", "gcn-arxiv.train", "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
