"""The plain reference against the port on a tiny graph on the CPU, and
whole runs of the harness (the chip's look aside) that see ``correct``
come out true for the port and false when the timed path is broken
underneath it, once for each fault a cell can have."""

import time

import numpy as np
import pytest
import torch

from benchmark import graphs, harness

from .bench_fixtures import spec, tiny  # noqa: F401 (fixtures)

SEED = 2**31 + 11


def _inputs(cell):
    indptr, cols, _ = graphs.load_graph(cell.config_name, cell.config["graph"])
    return indptr, cols, harness.make_inputs(cell.config, cell.traffic, SEED, "cpu")


@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "sage-products.train"])
def test_reference_forward_matches_port(tiny, workload):
    cell = tiny(workload)
    indptr, cols, inputs = _inputs(cell)
    _, ref = harness.family(cell.config)
    op, _ = harness.build_operator(cell.config, indptr, cols, "cpu")
    prog = harness.Program(cell.config, op, inputs, "cpu", train=False)
    with torch.no_grad():
        got = prog.model(prog.op, inputs.features[0])
        want = ref.forward(inputs.weights, ref.operator(indptr, cols, "cpu"),
                           inputs.features[0], cell.config["dims"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    assert int(op.nnz) == ref.operator_nnz(indptr, cols)


def test_inputs_repeat_by_seed(tiny):
    cell = tiny("gcn-arxiv.infer")
    a = harness.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    b = harness.make_inputs(cell.config, cell.traffic, SEED, "cpu")
    c = harness.make_inputs(cell.config, cell.traffic, SEED + 1, "cpu")
    assert len(a.features) == cell.traffic["feature_sets"]
    assert all(torch.equal(x, y) for x, y in zip(a.features, b.features))
    assert torch.equal(a.weights["layers.0.w"], b.weights["layers.0.w"])
    assert not torch.equal(a.weights["layers.0.w"], c.weights["layers.0.w"])
    assert int(a.mask.sum()) == cell.config["train_nodes"]


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.3, trace, torch.device("cpu"), time.perf_counter(),
                            log=lambda s: None)


@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "sage-products.train",
                                      "gcn-arxiv.infer", "sage-products.infer"])
def test_sound_run_is_correct(tiny, workload):
    r = _run(tiny(workload))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert {m["name"] for m in tiny(workload).end_to_end} == set(r["metrics"])


def _unchanged_step(orig):
    """A step that returns its state unchanged: the update is undone."""
    def step(model, *a, **k):
        before = [p.detach().clone() for p in model.parameters()]
        loss = orig(model, *a, **k)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return loss
    return step


def _half_batch_step(orig):
    """A step whose loss leaves out half of the batch and takes the mean
    over the rest."""
    def step(model, op, x, y, opt, mask=None, **k):
        half = mask.clone()
        half[torch.nonzero(mask)[::2, 0]] = False
        return orig(model, op, x, y, opt, mask=half, **k)
    return step


@pytest.mark.parametrize("workload", ["gcn-arxiv.train", "sage-products.train"])
@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch_step])
def test_broken_step_is_not_correct(tiny, monkeypatch, workload, fault):
    monkeypatch.setattr(harness, "train_step", fault(harness.train_step))
    r = _run(tiny(workload))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["gcn-arxiv.infer", "sage-products.infer"])
def test_altered_answer_is_not_correct(tiny, monkeypatch, workload):
    from of_spmm_tpu_torch.models import GCN
    from of_spmm_tpu_torch.models.sage import GraphSAGE

    cls = GCN if workload.startswith("gcn") else GraphSAGE
    forward = cls.forward

    def altered(self, op, x, **k):
        out = forward(self, op, x, **k).clone()
        node = 7
        out[node, (int(out[node].argmax()) + 1) % out.shape[1]] = out[node].max() + 1.0
        return out
    monkeypatch.setattr(cls, "forward", altered)
    r = _run(tiny(workload))
    assert not r["correct"], r["checks"]
    assert r["failed"] == r["attempted"]
