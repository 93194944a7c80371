"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, the files each entry names, and that every cell reports the
metrics its per-layer metrics move."""

import os
import re

import pytest

from benchmark import harness

from .bench_fixtures import ROOT, spec  # noqa: F401 (fixtures)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"][0] == "python3" and len(spec["command"]) <= 32
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    cells = len(spec["workloads"])
    full = 2 + 14 * 24
    assert full * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


def test_entries(spec):
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(spec["paths"][0] + "/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in spec["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in spec["end_to_end"])
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "sage-products.train",
                                      "gcn-arxiv.infer", "sage-products.infer"])
def test_cell_files_and_reported_metrics(spec, workload):
    cell = harness.resolve(spec, workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
