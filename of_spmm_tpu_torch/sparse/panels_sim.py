"""Numpy interpreter of a PanelPlan: the TPU kernel's step-exact oracle.

The port of the JAX package's sparse/panels_sim.py. It replays what the
TPU kernel does per step (linear-table scattered copies, range copies
with parity ping-pong, hi/lo bf16 splits at first-of-range and
first-of-tile, dense-mask groups), so a plan bug separates from a kernel
bug. It is a second oracle beside the JAX package's kernel: the port's
own kernel computes in fp32 and shares none of this machinery.
"""

from __future__ import annotations

import numpy as np
import torch

from of_spmm_tpu_torch.sparse.panels import _L, SCQ, TQ, PanelPlan, ensure_masks


def _hilo(a: np.ndarray) -> np.ndarray:
    """[hi | lo] bf16 pair of ``a`` as float32 columns (round to nearest
    even, as the JAX package's cast)."""
    def bf16(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            torch.bfloat16).to(torch.float32).numpy()

    hi = bf16(a)
    lo = bf16(a - hi)
    return np.concatenate([hi, lo], 1)


def simulate(plan: PanelPlan, x: np.ndarray) -> np.ndarray:
    plan = ensure_masks(plan)
    n, m = plan.shape
    d = x.shape[1]
    R, T, RC, RQ = plan.R, plan.T, plan.RC, plan.RQ
    G = T // _L
    xs = np.asarray(x, np.float32) * np.asarray(plan.col_scale)[:, None]
    target = max(-(-m // _L) * _L, RC)
    if target > m:
        xs = np.concatenate([xs, np.zeros((target - m, d), np.float32)])
    hot = xs[np.asarray(plan.hot_ids)] if plan.n_hot else \
        np.zeros((0, d), np.float32)
    hot_hilo = _hilo(hot) if plan.n_hot else np.zeros((0, 2 * d), np.float32)
    H_blocks = plan.n_hot // _L
    RCB = RC // _L

    out_tiles = []
    for seg in plan.segments:
        ctrl = np.asarray(seg.ctrl)
        rcopy = np.asarray(seg.rcopy)
        masks = np.asarray(seg.masks)
        blk = np.asarray(seg.blk)
        take = np.asarray(seg.stage_take)
        # linear take phase: f32 rows in consumption order
        table = xs[np.minimum(take, xs.shape[0] - 1)]
        if seg.stage_scale is not None:
            table = table * np.asarray(seg.stage_scale)[:, None]
        range_f32 = np.zeros((2 * RC, d), np.float32)
        scat_f32 = np.zeros((2 * plan.S_buf, d), np.float32)
        hilo = np.zeros(
            (H_blocks * _L + 2 * RC + 2 * plan.S_buf, 2 * d), np.float32)
        hilo[:H_blocks * _L] = hot_hilo
        SCAT0 = H_blocks * _L + 2 * RC
        out = np.zeros((seg.n_tiles * R, d), np.float32)
        dsrc = np.asarray(seg.dsrc)
        for i in range(seg.n_steps):
            c = ctrl[i, 0]
            (tile, g_cnt1, s_src, s_big, r_cnt, s_dst, _p6, s_tail, _p8,
             zero_out, r_first, r_read, _p12, s_read, s_ext,
             t_first) = c[:16]
            d_cnt, _p17, d_dst = c[16], c[17], c[18]
            pos = 0
            for k in range(s_big):
                table_sl = table[s_src + pos:s_src + pos + SCQ]
                scat_f32[s_dst + pos:s_dst + pos + SCQ] = table_sl
                pos += SCQ
            for k in range(s_tail):
                table_sl = table[s_src + pos:s_src + pos + TQ]
                scat_f32[s_dst + pos:s_dst + pos + TQ] = table_sl
                pos += TQ
            for k in range(d_cnt):
                scat_f32[d_dst + k] = xs[dsrc[i, 0, k]]
            for k in range(r_cnt):
                src, dst = rcopy[i, 0, k], rcopy[i, 1, k]
                range_f32[dst:dst + RQ] = xs[src:src + RQ]
            if tile >= 0 and zero_out:
                out[tile * R:(tile + 1) * R] = 0.0
            if tile >= 0 and r_first:
                hilo[H_blocks * _L + r_read:
                     H_blocks * _L + r_read + RC] = _hilo(
                    range_f32[r_read:r_read + RC])
            if tile >= 0 and t_first and s_ext:
                hilo[SCAT0 + s_read:SCAT0 + s_read + s_ext] = _hilo(
                    scat_f32[s_read:s_read + s_ext])
            if tile < 0:
                continue
            # g_cnt1 = real groups + 1 (0 = run all); a step with no real
            # groups computes nothing
            if g_cnt1 == 1:
                continue
            acc = np.zeros((R, 2 * d), np.float32)
            for g in range(G):
                b = blk[i, 0, g]
                if b < H_blocks:
                    off = b * _L
                elif b < H_blocks + RCB:
                    off = b * _L + r_read
                else:
                    off = b * _L + RC + s_read
                win = hilo[off:off + _L]
                mw = masks[i * G + g].astype(np.uint32)
                rep = np.repeat(mw, 32, axis=0)
                shift = (np.arange(_L) % 32)[:, None]
                ohT = ((rep >> shift) & 1).astype(np.float32)  # (w, r)
                acc += ohT.T @ win
            out[tile * R:(tile + 1) * R] += acc[:, :d] + acc[:, d:]
        out_tiles.append(out)
    y = np.concatenate(out_tiles, axis=0)[:n]
    return y * np.asarray(plan.row_scale)[:, None]
