"""The readings each cell's limits are set from (``limits/<cell>.json``).

    python3 benchmark/calibrate.py --workload <name> --seeds 101-112 \\
        --control-seeds 201-203 [--seconds 10] [--out readings.json]

On the card, in one process (the graph and the port's operator are built
once): for each of ``--seeds``, the numbers the run's check compares for
sound runs of the program, through the same calls as a run (training: the
first checked steps; serving: a window of ``--seconds`` of requests). For
each of ``--control-seeds``, the same numbers of the control, the plain
reference put in the program's place and computed in TF32 (the precision
below the configuration's float32 with TF32 off), and of the planted
faults the cell can have: training, a step that leaves the parameters
unchanged and a loss over half of the batch; serving, an answer altered
where it is produced. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


@contextlib.contextmanager
def tf32():
    """Float32 products in TF32, as far as the device does it."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def free(device) -> None:
    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def control_readings(cell, op_ref, seed: int, device) -> dict:
    """The control's and each planted fault's numbers on one seed."""
    import torch
    from benchmark import harness
    from benchmark.reference import common as refc

    config, traffic = cell.config, cell.traffic
    inputs = harness.make_inputs(config, traffic, seed, device)
    out = {}
    if traffic["loop"] == "train":
        steps = int(traffic["check_steps"])
        want = refc.readings(harness.reference_trainer(config, op_ref, inputs), steps)
        with tf32():
            got = refc.readings(harness.reference_trainer(config, op_ref, inputs), steps)
        out["control"] = harness.compare_train(got, want)
        g = torch.Generator(device=device)
        g.manual_seed(harness.stream_seed(seed, 3))
        half = inputs.mask & (torch.rand(inputs.mask.shape, generator=g, device=device) < 0.5)
        got = refc.readings(harness.reference_trainer(config, op_ref, inputs, mask=half), steps)
        out["half_batch"] = harness.compare_train(got, want)
        got = refc.readings(harness.reference_trainer(config, op_ref, inputs, frozen=True), steps)
        out["unchanged"] = harness.compare_train(got, want)
    else:
        sets = range(len(inputs.features))
        want = harness.reference_logits(config, op_ref, inputs, sets)
        with tf32():
            ctrl = harness.reference_logits(config, op_ref, inputs, sets)
        dtype = harness.answer_dtype(config)
        answers = [ctrl[k].argmax(-1).to(dtype).cpu() for k in sets]
        out["control"] = {"gap": max(harness.serve_gaps(answers, list(sets), want))}
        altered = [want[k].argmax(-1).to(dtype).cpu() for k in sets]
        altered[0][0] = (int(altered[0][0]) + 1) % config["dims"][-1]
        out["altered"] = {"gap": max(harness.serve_gaps(altered, list(sets), want))}
    return out


def program_readings(cell, op, op_ref, seed: int, seconds: float, device) -> dict:
    """A sound run's numbers on one seed, through the run's own calls."""
    import torch
    from benchmark import harness
    from benchmark.reference import common as refc

    config, traffic = cell.config, cell.traffic
    inputs = harness.make_inputs(config, traffic, seed, device)
    train = traffic["loop"] == "train"
    prog = harness.Program(config, op, inputs, device, train)
    if train:
        steps = int(traffic["check_steps"])
        got = harness.train_readings(prog, steps)
        del prog
        free(device)
        want = refc.readings(harness.reference_trainer(config, op_ref, inputs), steps)
        return harness.compare_train(got, want)
    with torch.inference_mode():
        for x in inputs.features[:int(traffic["warmup_requests"])]:
            prog.answer(x, harness.answer_dtype(config))
    answers, sets, _ = harness.serve_window(prog, inputs.features,
                                            harness.request_stream(seed), seconds,
                                            harness.answer_dtype(config))
    del prog
    free(device)
    gaps = harness.serve_gaps(answers, sets,
                              harness.reference_logits(config, op_ref, inputs, set(sets)))
    return {"gap": max(gaps), "requests": len(gaps)}


def calibrate(cell, seed_list, control_list, seconds: float, device, log=print) -> dict:
    import torch
    from benchmark import graphs, harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, ref = harness.family(cell.config)
    indptr, cols, _ = graphs.load_graph(cell.config_name, cell.config["graph"])
    op, plan_s = harness.build_operator(cell.config, indptr, cols, device)
    op_ref = ref.operator(indptr, cols, device)
    out = {"cell": cell.name, "plan_s": plan_s, "program": {}, "faults": {}}
    for s in seed_list:
        t = time.perf_counter()
        out["program"][s] = program_readings(cell, op, op_ref, s, seconds, device)
        free(device)
        log(f"program seed {s}: {out['program'][s]} ({time.perf_counter() - t:.1f}s)")
    for s in control_list:
        out["faults"][s] = control_readings(cell, op_ref, s, device)
        free(device)
        log(f"control seed {s}: {out['faults'][s]}")
    names = next(iter(out["program"].values())).keys()
    out["lower"] = {k: max(r[k] for r in out["program"].values()) for k in names}
    out["upper"] = {}
    for r in out["faults"].values():
        for fault, numbers in r.items():
            low = out["upper"].setdefault(fault, dict(numbers))
            for k, v in numbers.items():
                low[k] = min(low[k], v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="101-112")
    ap.add_argument("--control-seeds", default="201-203")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == BENCH_DIR:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from benchmark import run

    os.environ.update(run.CACHE_ENV)
    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibration measures the card; no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), args.workload)
    out = calibrate(cell, seeds(args.seeds), seeds(args.control_seeds), args.seconds,
                    torch.device("cuda", 0))
    out["device"] = torch.cuda.get_device_name(0)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({"lower": out["lower"], "upper": out["upper"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
