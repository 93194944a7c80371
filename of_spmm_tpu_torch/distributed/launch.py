"""Per-rank process launcher: python -m of_spmm_tpu_torch.distributed.launch.

Spawns one process per local rank with MASTER_ADDR, MASTER_PORT,
WORLD_SIZE, RANK and LOCAL_RANK set, forwards SIGINT and SIGTERM to them,
and kills the whole group when any child fails (no elastic recovery), as
the reference launcher does (python/oneflow/distributed/launch.py:
103-237). ``distributed.initialize()`` in the child reads the environment.

Usage:
    python -m of_spmm_tpu_torch.distributed.launch --nproc_per_node 4 train.py args...
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="of_spmm_tpu_torch multi-process launcher")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--master_addr", default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument("-m", dest="module", action="store_true",
                   help="run the script as a module (python -m)")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def launch(args) -> int:
    """Run the ranks; the first non-zero exit code ends the group and is
    returned (0 when every rank succeeds)."""
    world_size = args.nnodes * args.nproc_per_node
    procs: List[subprocess.Popen] = []
    base_env = dict(os.environ)
    base_env.update(MASTER_ADDR=args.master_addr, MASTER_PORT=str(args.master_port),
                    WORLD_SIZE=str(world_size))
    for local_rank in range(args.nproc_per_node):
        env = dict(base_env)
        env["RANK"] = str(args.node_rank * args.nproc_per_node + local_rank)
        env["LOCAL_RANK"] = str(local_rank)
        cmd = [sys.executable, "-u"] + (["-m"] if args.module else [])
        cmd += [args.training_script, *args.training_script_args]
        procs.append(subprocess.Popen(cmd, env=env))

    def kill_all(signum=None, frame=None):
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    signal.signal(signal.SIGINT, kill_all)
    signal.signal(signal.SIGTERM, kill_all)

    ret = 0
    alive = list(procs)
    while alive:
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0:
                ret = rc
                kill_all()
                alive = []
                break
        time.sleep(0.05)
    return ret


def main(argv=None) -> int:
    return launch(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
