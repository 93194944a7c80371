"""Shared fixtures of the benchmark's own tests (imported by each test
module): a tiny copy of a cell, run on the CPU, with its graph cached in
a temporary directory."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(1)

TINY_GRAPH = {"nodes": 600, "edges": 6000}


@pytest.fixture
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny(spec, tmp_path, monkeypatch):
    """``tiny(workload)``: the cell with a 600-node graph and 200 training
    nodes, its graph cached under ``tmp_path``."""
    from benchmark import graphs, harness

    monkeypatch.setattr(graphs, "CACHE_DIR", str(tmp_path / "graphs"))

    def make(workload):
        cell = harness.resolve(spec, workload)
        cell.config = copy.deepcopy(cell.config)
        cell.config["graph"].update(TINY_GRAPH)
        cell.config["train_nodes"] = 200
        return cell
    return make
