"""Build, load and guard the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled with ``nvcc -arch=sm_90a`` into its
own shared library with a plain C interface at first use, and bound with
ctypes. Libraries go to ``_build/`` beside the package, keyed by the
source's hash, the shared headers' (``csrc/*.cuh``) and the flags, so a
changed source or header builds anew and an unchanged one loads at once.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its path went through the kernels; for the eight main-path kernels the
count is taken in their ``torch.library`` op's CUDA implementation
(ops/cuda/library.py), so a saved program's launches count too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {"bucket_spmm": 0, "gather_rows": 0, "panel_spmm": 0,
                            "fused_spmm": 0, "ranges_spmm": 0, "expansion_spmm": 0,
                            "expansion2_spmm": 0, "flash_attention": 0,
                            "microbench_blockfma_a": 0, "microbench_blockfma_b": 0,
                            "microbench_mxu": 0, "microbench_cond": 0, "proto_fused": 0,
                            "gather_vmem_loop": 0, "gather_vmem_take": 0, "gather_onehot": 0,
                            "gather_block_slice": 0, "gather_row_dma": 0,
                            "gather2_onehot_pair": 0, "gather2_take_fused": 0,
                            "gather2_dma_deep": 0, "gather2_window_pair": 0,
                            "gather2_twosided": 0, "dyngather_take_along": 0,
                            "dyngather_smem_cap": 0}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build(source: str) -> Dict[str, object]:
    """Compile ``csrc/<source>`` into _build/ unless the library for this
    source and these flags is there already. Returns the library path, the
    build seconds (0 when it was there) and the compiler's report
    (registers, spills). Raises if the compiler fails."""
    src_path = os.path.join(CSRC, source)
    with open(src_path, "rb") as f:
        src = f.read()
    for header in sorted(os.listdir(CSRC)):
        if header.endswith(".cuh"):
            with open(os.path.join(CSRC, header), "rb") as f:
                src += f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{key}.so")
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return {"path": out, "seconds": 0.0, "log": log}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, src_path, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    with open(log_path, "w") as f:
        f.write(log)
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<source>``, built and bound (``bind`` sets
    each function's argtypes and restype) on first use."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source)["path"])
            lib.ofs_error_string.argtypes = [ctypes.c_int]
            lib.ofs_error_string.restype = ctypes.c_char_p
            bind(lib)
            _LIBS[source] = lib
        return lib


def raise_if(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ofs_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def same_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    return dev


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
