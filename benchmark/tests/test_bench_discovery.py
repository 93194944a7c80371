"""A configuration, a traffic mix and a per-layer metric added from new
files and entries alone: the harness finds each by name and runs the new
cell, with no edit of a file it already has."""

import json
import shutil
import time

import torch

from benchmark import harness

from .bench_fixtures import ROOT, TINY_GRAPH, spec  # noqa: F401 (fixtures)


def test_new_config_traffic_and_metric_from_files(spec, tmp_path, monkeypatch):
    from benchmark import graphs

    monkeypatch.setattr(graphs, "CACHE_DIR", str(tmp_path / "graphs"))
    bench = tmp_path / "bench"
    shutil.copytree(f"{ROOT}/benchmark/metrics", bench / "metrics")
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir()
    config = json.load(open(f"{ROOT}/benchmark/configs/gcn-ogbn-arxiv.json"))
    config["graph"].update(TINY_GRAPH, dataset="throwaway")
    config["dims"] = [16, 8, 3]
    config["train_nodes"] = 100
    (bench / "configs" / "throwaway.json").write_text(json.dumps(config))
    (bench / "traffic" / "short_train.json").write_text(
        json.dumps({"loop": "train", "check_steps": 2}))
    (bench / "limits" / "throwaway.short_train.json").write_text(
        json.dumps({"loss": 1e-4, "grad": 1e-4, "change": 1e-3, "nonfinite": 0}))
    (bench / "metrics" / "steps_seen.train.py").write_text(
        "def read(run):\n    return float(run.units) if run.trace is not None else None\n")

    spec["configs"].append({"name": "throwaway", "source": "https://example.org/throwaway",
                            "file": "bench/configs/throwaway.json", "reduced": [],
                            "why": "a test"})
    spec["workloads"].append({"name": "throwaway.short_train", "config": "throwaway",
                              "traffic": "short_train", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("epoch_ms", "plan_s"):
            m["workloads"].append("throwaway.short_train")
    spec["per_layer"].append({"name": "steps_seen.train", "unit": "steps",
                              "better": "higher", "source": "program_counter",
                              "layer": "model step", "moves": "epoch_ms",
                              "workloads": ["throwaway.short_train"]})
    cell = harness.resolve(spec, "throwaway.short_train", root=str(tmp_path),
                           bench_dir=str(bench))
    assert cell.config["dims"] == [16, 8, 3]
    assert cell.traffic["check_steps"] == 2
    assert [m["name"] for m in cell.end_to_end] == ["epoch_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["plan_s", "steps_seen.train"]

    r = harness.run_cell(cell, 5, 0.3, False, torch.device("cpu"), time.perf_counter(),
                         log=lambda s: None)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"epoch_ms", "setup_s"}
    r = harness.run_cell(cell, 5, 0.3, True, torch.device("cpu"), time.perf_counter(),
                         log=lambda s: None)
    assert r["metrics"]["steps_seen.train"]["value"] == r["attempted"]
    assert r["metrics"]["steps_seen.train"]["unit"] == "steps"
    # the cell's e2e metric set decides which per-layer metrics without a
    # workloads key it reports; an existing cell is untouched by the new metric
    old = harness.resolve(spec, "gcn-arxiv.train")
    assert "steps_seen.train" not in [m["name"] for m in old.per_layer]
