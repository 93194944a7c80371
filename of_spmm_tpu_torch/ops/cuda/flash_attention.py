"""The flash-attention forward kernel, its plain version and its launcher.

``flash_attention(q, k, v, causal)`` computes, for each of BH heads,
O = softmax(q k^T / sqrt(d)) v over contiguous (BH, Tq, d) / (BH, Tk, d)
tensors of one dtype (float32, bfloat16 or float16), with a top-left
causal mask (key j is seen by query i iff j <= i) when ``causal``. It
replaces the TPU kernel
``of_spmm_tpu/ops/pallas/flash_attention.py::_flash_kernel`` (launched by
``_flash_fwd``); the kernel is in ``csrc/flash_attention.cu`` (design
notes there).

The wrapper calls ``torch.ops.ofs.flash_attention`` (ops/cuda/library.py):
on the CPU the op runs ``flash_attention_torch``; on the card it launches
the kernel or raises, and never falls back. Each launch adds one
to ``LAUNCHES["flash_attention"]`` (ops/cuda/build.py).

The float32 kernel takes each product on the tensor cores as three TF32
products (3xTF32). ``split_tf32`` and ``flash_attention_tf32x3_torch``
repeat that arithmetic on the CPU for the tests; the wrapper never calls
them.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Tuple

import torch

from of_spmm_tpu_torch.ops.cuda import build as _build
from of_spmm_tpu_torch.ops.cuda import library

SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30  # the score of a masked key, as in the TPU kernel


def build() -> Dict[str, object]:
    """Compile csrc/flash_attention.cu into _build/ (ops/cuda/build.py)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.ofs_flash_attention.argtypes = [p, p, p, p, i64, i64, i64, i64, ctypes.c_float,
                                        i32, i32, i32, p]
    lib.ofs_flash_attention.restype = i32


def _lib() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: q (BH, Tq, d), k and v (BH, Tk, d), one
    dtype of float32 / bfloat16 / float16, 1 <= d <= 256, contiguous, on
    one device. Raises TypeError or ValueError otherwise."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32, bfloat16 or float16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D (BH, T, d), got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v {tuple(v.shape)} "
                         "must be (BH, Tq, d), (BH, Tk, d), (BH, Tk, d)")
    if not 1 <= q.shape[2] <= MAX_HEAD_DIM:
        raise ValueError(f"head width d = {q.shape[2]} is outside 1..{MAX_HEAD_DIM}, the "
                         "widths the kernel takes")
    _build.same_device(q, k, v)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``x`` as the kernel's tensor cores read them:
    hi = x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest,
    ties away from zero, the 13 low bits cleared; inf and NaN unchanged),
    lo = x - hi truncated to TF32 (the kernel passes x - hi whole and the
    tensor core drops its 13 low bits). Emulated on the float's bits.
    |x - (hi + lo)| <= 2^-21 |x| for finite x."""
    bits = x.view(torch.int32)
    # half a TF32 ulp added to the magnitude bits, then truncation, rounds
    # ties away from zero; only a NaN's bits could carry into the sign
    hi = torch.where(torch.isfinite(x), ((bits + 0x1000) & ~0x1FFF).view(torch.float32), x)
    lo = ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 as the kernel's tensor cores take it: lo·hi and
    hi·lo first, then hi·hi (a product of two TF32 values is exact in
    float32)."""
    a_hi, a_lo = split_tf32(a.contiguous())
    b_hi, b_lo = split_tf32(b.contiguous())
    return (torch.matmul(a_lo, b_hi) + torch.matmul(a_hi, b_lo)) + torch.matmul(a_hi, b_hi)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, block_q: int = 256, block_k: int = 256, *,
                          matmul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                          = torch.matmul) -> torch.Tensor:
    """Plain version of the kernel, repeating the TPU kernel's arithmetic
    tile by tile (tiles of min(block, T) rows; T need not divide them):
    float32 scores times 1/sqrt(d), masked keys at -1e30, running float32
    row max m, row sum l and accumulator; P cast to v's dtype before P v;
    KV tiles wholly above the diagonal skipped; a row with l = 0 divided
    by 1; the result in q's dtype. ``matmul`` takes both float32 products
    (Q K^T and P V)."""
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    bq, bk = max(min(block_q, Tq), 1), max(min(block_k, Tk), 1)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    kf, vf = k.float(), v.float()
    for q0 in range(0, Tq, bq):
        q1 = min(q0 + bq, Tq)
        qt = q[:, q0:q1].float()
        m = torch.full((BH, q1 - q0, 1), float("-inf"), device=q.device)
        row_sum = torch.zeros((BH, q1 - q0, 1), device=q.device)
        acc = torch.zeros((BH, q1 - q0, d), device=q.device)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        for k0 in range(0, Tk, bk):
            if causal and k0 > q0 + bq - 1:
                break
            k1 = min(k0 + bk, Tk)
            s = matmul(qt, kf[:, k0:k1].transpose(1, 2)) * scale
            if causal:
                keep = torch.arange(k0, k1, device=q.device)[None, :] <= qpos
                s = torch.where(keep, s, _NEG)
            m_next = torch.maximum(m, s.amax(dim=2, keepdim=True))
            fresh = m_next == float("-inf")
            alpha = torch.where(fresh, 1.0, torch.exp(m - m_next))
            p = torch.exp(s - torch.where(fresh, 0.0, m_next))
            if causal:
                p = torch.where(keep, p, 0.0)
            row_sum = alpha * row_sum + p.sum(dim=2, keepdim=True)
            acc = alpha * acc + matmul(p.to(v.dtype).float(), vf[:, k0:k1])
            m = m_next
        out[:, q0:q1] = (acc / torch.where(row_sum == 0.0, 1.0, row_sum)).to(q.dtype)
    return out


def flash_attention_tf32x3_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 causal: bool, block_q: int = 256,
                                 block_k: int = 256) -> torch.Tensor:
    """``flash_attention_torch`` with each float32 product taken as three
    TF32 products (``tf32x3_matmul``), the float32 kernel's arithmetic.
    For the tests; never on the main path."""
    return flash_attention_torch(q, k, v, causal, block_q, block_k, matmul=tf32x3_matmul)


def _flash_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    return flash_attention_torch(q, k, v, causal)


def _flash_cuda(q, k, v, causal) -> torch.Tensor:
    dev = _build.same_device(q, k, v)
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    out = torch.empty_like(q)
    if BH == 0 or Tq == 0:
        return out
    lib = _lib()
    rc = lib.ofs_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 BH, Tq, Tk, d, 1.0 / math.sqrt(d), int(causal),
                                 DTYPES[q.dtype], dev.index or 0, _build.stream(dev))
    _build.raise_if(lib, rc, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out


def _flash_fake(q, k, v, causal) -> torch.Tensor:
    return torch.empty_like(q)


# ofs::flash_attention(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor
_flash_op = library.define("flash_attention", _flash_cpu, _flash_cuda, _flash_fake)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Attention forward (BH, Tq, d) in q's dtype (see the module
    docstring), through ``torch.ops.ofs.flash_attention``. On the card
    this launches the kernel, which picks its own tiles
    (csrc/flash_attention.cu); on the CPU it runs
    ``flash_attention_torch`` with the TPU kernel's default tiles."""
    check_inputs(q, k, v)
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {dev}")
    return _flash_op(q, k, v, bool(causal))
