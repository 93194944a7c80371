"""Flash attention: the fused online-softmax attention forward.

``flash_attention(q, k, v, is_causal=False, block_q=256, block_k=256)``
is the counterpart of ``of_spmm_tpu/ops/pallas/flash_attention.py::
flash_attention``: (..., T, d) inputs, leading dimensions flattened to
(BH, T, d), the same result as ``nn.attention.scaled_dot_product_attention``
without an explicit mask, and the (T, T) score matrix never stored. The
forward is the hand-written kernel of ``ops/cuda/flash_attention.py`` on
the card and its plain version on the CPU.

``block_q`` / ``block_k`` keep only their JAX contract: Tq and Tk must be
divisible by min(block, T), else ``ValueError``. The kernel picks its own
tiles, so results differ from the TPU's only by summation order. JAX's
``interpret`` switch has no counterpart: the device of q decides.

The backward is not a kernel, as in the JAX package (whose custom_vjp
recomputes through the dense attention): the forward saves q, k and v,
and the backward differentiates the port's dense
``scaled_dot_product_attention`` on them with torch autograd.
"""

from __future__ import annotations

import torch

from of_spmm_tpu_torch.ops.cuda import flash_attention as _kernel


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _kernel.flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        from of_spmm_tpu_torch.nn.attention import scaled_dot_product_attention

        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            o = scaled_dot_product_attention(q, k, v, is_causal=ctx.causal)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    is_causal: bool = False, block_q: int = 256,
                    block_k: int = 256) -> torch.Tensor:
    """(..., Tq, d) attention of q over k, v (..., Tk, d); leading dims are
    batch and heads. Non-contiguous inputs (a head split's transposed
    view) are copied to contiguous (BH, T, d) first."""
    lead = q.shape[:-2]
    Tq, d = q.shape[-2:]
    Tk = k.shape[-2]
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    if Tq % bq or Tk % bk:
        raise ValueError(f"sequence lengths ({Tq}, {Tk}) must be divisible by the "
                         f"block sizes ({bq}, {bk})")
    qf = q.reshape(-1, Tq, d).contiguous()
    kf = k.reshape(-1, Tk, d).contiguous()
    vf = v.reshape(-1, Tk, d).contiguous()
    return _Flash.apply(qf, kf, vf, bool(is_causal)).reshape(*lead, Tq, d)
