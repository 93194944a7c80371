"""Numpy interpreter of a FusedPlan: the TPU kernel's step-exact oracle.

The port of the JAX package's sparse/fused_sim.py. It replays what the
TPU kernel does per step (staging copies into the parity buffers, the
hi/lo bf16 split at the first step of a tile, one-hot or multi-hot
gathers from the [hot | staged] window, the scatter into the tile), so a
plan bug separates from a kernel bug. It is a second oracle beside the
JAX package's kernel: the port's own kernel computes in fp32 and shares
none of this machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from of_spmm_tpu_torch.sparse.fused import _L, FusedPlan


def _hilo(a: np.ndarray) -> np.ndarray:
    """[hi | lo] bf16 pair of ``a`` as float32 columns (round to nearest
    even, as the JAX package's cast)."""
    def bf16(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            torch.bfloat16).to(torch.float32).numpy()

    hi = bf16(a)
    return np.concatenate([hi, bf16(a - hi)], 1)


def stage_table(seg, xs: np.ndarray, stage_tier: int) -> np.ndarray:
    """The chunks-mode take phase: per-tier takes (indices clamped to the
    tier) into the tier-major [hi | lo] table."""
    ptr = seg.stage_tier_ptr
    take = np.asarray(seg.stage_take)
    parts = []
    for t in range(len(ptr) - 1):
        if ptr[t + 1] == ptr[t]:
            continue
        xt = xs[t * stage_tier:min((t + 1) * stage_tier, xs.shape[0])]
        parts.append(xt[np.minimum(take[ptr[t]:ptr[t + 1]], xt.shape[0] - 1)])
    d = xs.shape[1]
    return _hilo(np.concatenate(parts)) if parts else np.zeros((_L, 2 * d), np.float32)


def group_contrib(plan, seg, slot: int, win: np.ndarray, d: int) -> np.ndarray:
    """One lane group's (128, d) contribution from its 128-row [hi | lo]
    window, in the TPU kernel's numerics: multi-hot selection sums, or
    one-hot gathers folded with the value pair as vh*(ghi+glo) + vl*ghi."""
    if plan.multihot:
        mw = np.asarray(seg.lidx[slot]).astype(np.uint32)     # (4, 128)
        rep = np.repeat(mw, 32, axis=0)                        # (128, 128)
        oh_t = ((rep >> (np.arange(_L) % 32)[:, None]) & 1).astype(np.float32)
        gath = oh_t.T @ win
    else:
        gath = win[np.asarray(seg.lidx[slot])]
    if seg.val_hi is None:
        return gath[:, :d] + gath[:, d:]
    vh = np.asarray(seg.val_hi[slot], np.float32)[:, None]
    vl = np.asarray(seg.val_lo[slot], np.float32)[:, None]
    return vh * (gath[:, :d] + gath[:, d:]) + vl * gath[:, :d]


def simulate(plan: FusedPlan, x: np.ndarray) -> np.ndarray:
    n, m = plan.shape
    d = x.shape[1]
    R, G = plan.R, plan.T // _L
    xs = np.asarray(x, np.float32)
    if plan.col_scale is not None:
        xs = xs * np.asarray(plan.col_scale)[:, None]
    hot_hilo = (_hilo(xs[np.asarray(plan.hot_ids)]) if plan.n_hot
                else np.zeros((0, 2 * d), np.float32))
    H_blocks = plan.n_hot // _L
    chunks = plan.staging == "chunks"
    out_tiles = []
    for seg in plan.segments:
        ctrl = np.asarray(seg.ctrl)
        if chunks:
            pairs = np.asarray(seg.scols)       # (steps, 2, DMAX)
            table = stage_table(seg, xs, plan.stage_tier)
        else:
            scols = np.asarray(seg.scols).reshape(seg.n_steps, -1)
        lrow = np.asarray(seg.lrow)
        blk = np.asarray(seg.blk)
        stage = np.zeros((2 * plan.S_buf, d), np.float32)
        hilo = np.zeros((2 * plan.S_buf, 2 * d), np.float32)
        out = np.zeros((seg.n_tiles * R, d), np.float32)
        for i in range(seg.n_steps):
            tile, first, base, cnt, _, split_base = ctrl[i, 0, :6]
            zero_out = ctrl[i, 0, 9]
            if cnt:
                if chunks:
                    cq = plan.cq
                    for k in range(cnt):
                        sb, db = pairs[i, 0, k], pairs[i, 1, k]
                        hilo[db * cq:(db + 1) * cq] = table[sb * cq:(sb + 1) * cq]
                else:
                    stage[base:base + cnt] = xs[scols[i, :cnt]]
            if tile >= 0 and first and zero_out:
                out[tile * R:(tile + 1) * R] = 0.0
            if tile >= 0 and first and not chunks:
                hilo[:plan.S_buf] = _hilo(stage[split_base:split_base + plan.S_buf])
            if tile < 0:
                continue
            for g in range(G):
                b = blk[i, 0, g]
                if b < H_blocks:
                    win = hot_hilo[b * _L:(b + 1) * _L]
                else:
                    sb = b - H_blocks
                    if chunks:
                        sb += split_base // _L  # read-parity region
                    win = hilo[sb * _L:(sb + 1) * _L]
                contrib = group_contrib(plan, seg, i * G + g, win, d)
                rows = lrow[i * G + g]
                if plan.window:
                    # a window-homogeneous step: rows land in the step's
                    # 128-row dst window of the tile
                    dst0 = tile * R + ctrl[i, 0, 10] * _L
                    valid = rows < _L
                else:
                    dst0 = tile * R
                    valid = rows < R
                np.add.at(out, dst0 + np.where(valid, rows, 0),
                          np.where(valid[:, None], contrib, 0.0))
        out_tiles.append(out)
    y = np.concatenate(out_tiles, axis=0)[:n]
    if plan.row_scale is not None:
        y = y * np.asarray(plan.row_scale)[:, None]
    return y
