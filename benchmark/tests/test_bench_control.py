"""The control on the card: the plain reference, put in the program's
place and computed in TF32, has to come out as not correct under each
cell's limits, at the cell's own size. Needs the card; run there with
``python -m pytest -m cuda benchmark/tests/``."""

import json
import os

import pytest
import torch

from .bench_fixtures import ROOT

CELLS = ["gcn-arxiv.train", "gcn-arxiv.infer", "sage-products.train", "sage-products.infer"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (TF32 exists only there)")
    from benchmark import calibrate, graphs, harness, run

    os.environ.update(run.CACHE_ENV)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), workload)
    dev = torch.device("cuda", 0)
    _, ref = harness.family(cell.config)
    indptr, cols, _ = graphs.load_graph(cell.config_name, cell.config["graph"])
    torch.backends.cuda.matmul.allow_tf32 = False
    op_ref = ref.operator(indptr, cols, dev)
    numbers = calibrate.control_readings(cell, op_ref, 2**31 + 77, dev)["control"]
    assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
