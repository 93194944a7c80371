"""distributed: multi-process bootstrap over ``torch.distributed``.

The port of the JAX package's distributed module, on the same environment
contract as the reference's launcher (python/oneflow/framework/
env_util.py:155-164): MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, all
or none, plus LOCAL_RANK for the device. ``initialize()`` starts the
process group: NCCL on ``cuda:LOCAL_RANK`` unless the caller asks for
gloo (and then the CPU). NCCL takes one card per rank: two ranks on one
card are refused. Importing this module starts nothing.

    python -m of_spmm_tpu_torch.distributed.launch --nproc_per_node 4 train.py ...
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def env_spec() -> dict:
    """The launcher's environment, all-or-nothing: {} when none of
    ENV_KEYS is set, else the init method, world size and rank."""
    present = [k for k in ENV_KEYS if k in os.environ]
    if not present:
        return {}
    if len(present) != len(ENV_KEYS):
        missing = set(ENV_KEYS) - set(present)
        raise RuntimeError(f"partial distributed env: {sorted(present)} set but "
                           f"{sorted(missing)} missing (all four are required)")
    return {"init_method": f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            "world_size": int(os.environ["WORLD_SIZE"]), "rank": int(os.environ["RANK"])}


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize(backend: str = "nccl", init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> torch.device:
    """Start the process group and return this rank's device.

    ``backend="nccl"`` (the default) runs on ``cuda:LOCAL_RANK`` (made the
    current card) and raises without one; ``backend="gloo"`` runs on the
    CPU. The group's address, size and rank come from the arguments or,
    failing those, from the environment (env_spec); with neither, the
    process runs alone and no group is started. A second call starts
    nothing."""
    if dist.is_initialized():
        return current_device()
    spec = env_spec()
    if init_method is not None:
        spec = {"init_method": init_method, "world_size": int(world_size), "rank": int(rank)}
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl|gloo, got {backend!r}")
    device = torch.device("cpu")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs a CUDA device; pass backend='gloo' "
                               "to run on the CPU")
        device = torch.device("cuda", get_local_rank())
        torch.cuda.set_device(device)
    if spec:
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=spec["init_method"],
                                world_size=spec["world_size"], rank=spec["rank"], **kw)
    return device


def current_device(group=None) -> torch.device:
    """This rank's device: the current card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multi_client() -> bool:
    return get_world_size() > 1


def barrier() -> None:
    """Wait for every rank; a no-op when the process runs alone."""
    if dist.is_initialized():
        dist.barrier()


def destroy() -> None:
    """End the process group started by ``initialize``."""
    if dist.is_initialized():
        dist.destroy_process_group()


__all__ = ["ENV_KEYS", "env_spec", "initialize", "current_device", "get_rank",
           "get_world_size", "get_local_rank", "is_multi_client", "barrier", "destroy"]
