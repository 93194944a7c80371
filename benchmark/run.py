"""Run one cell of the benchmark of of_spmm_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints progress and, last, each number the
check compared beside its limit on standard error, and one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` last.
Exits non-zero, printing no result, without a CUDA card, or when JAX or
the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(BENCH_DIR, "_cache")
# every build and kernel cache at a fixed place inside the checkout
CACHE_ENV = {
    "OFS_TORCH_NATIVE_CACHE": os.path.join(CACHE, "native"),
    "OFS_TORCH_CACHE_DIR": os.path.join(CACHE, "data"),
    "TRITON_CACHE_DIR": os.path.join(CACHE, "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
    "CUDA_CACHE_PATH": os.path.join(CACHE, "nv"),
    "USE_FLAX": "0",
}
FORBIDDEN = ("jax", "jaxlib", "flax", "of_spmm_tpu")


def loaded_forbidden() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``of_spmm_tpu_torch`` is not ``of_spmm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.update(CACHE_ENV)
    if sys.path and os.path.abspath(sys.path[0]) == BENCH_DIR:
        sys.path.pop(0)
    sys.path.insert(0, ROOT)

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    chips = next(w["chips"] for w in spec["workloads"] if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from benchmark import harness

    cell = harness.resolve(spec, args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = loaded_forbidden()
    if found:
        print(f"JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
