"""Numpy interpreter of a RangesPlan: the TPU kernel's step-exact oracle.

The port of the JAX package's sparse/ranges_sim.py. It replays what the
TPU kernel does per step (scattered chunk copies, range copies with
parity ping-pong, hi/lo bf16 splits at the first step of a range, lane
groups over the [hot | range | scattered] window, the scatter into the
tile). It mirrors sparse/fused_sim.py and shares its group numerics.
"""

from __future__ import annotations

import numpy as np

from of_spmm_tpu_torch.sparse.fused_sim import _hilo, group_contrib, stage_table
from of_spmm_tpu_torch.sparse.ranges import _L, RangesPlan


def simulate(plan: RangesPlan, x: np.ndarray) -> np.ndarray:
    n, m = plan.shape
    d = x.shape[1]
    R, RC, RQ = plan.R, plan.RC, plan.RQ
    G = plan.T // _L
    xs = np.asarray(x, np.float32)
    if plan.col_scale is not None:
        xs = xs * np.asarray(plan.col_scale)[:, None]
    target = max(-(-m // _L) * _L, RC)
    if target > m:
        xs = np.concatenate([xs, np.zeros((target - m, d), np.float32)])
    H_blocks = plan.n_hot // _L
    RCB = RC // _L
    out_tiles = []
    for seg in plan.segments:
        ctrl = np.asarray(seg.ctrl)
        scols = np.asarray(seg.scols)
        rcopy = np.asarray(seg.rcopy)
        lrow = np.asarray(seg.lrow)
        blk = np.asarray(seg.blk)
        cq = plan.cq
        table = stage_table(seg, xs, plan.stage_tier)
        range_f32 = np.zeros((2 * RC, d), np.float32)
        # window: [hot | range p0 | range p1 | scattered p0 | scattered p1]
        hilo = np.zeros((H_blocks * _L + 2 * RC + 2 * plan.S_buf, 2 * d), np.float32)
        if plan.n_hot:
            hilo[:H_blocks * _L] = _hilo(xs[np.asarray(plan.hot_ids)])
        scat0 = H_blocks * _L + 2 * RC
        out = np.zeros((seg.n_tiles * R, d), np.float32)
        for i in range(seg.n_steps):
            tile, s_cnt, r_cnt, s_read = (ctrl[i, 0, 0], ctrl[i, 0, 3], ctrl[i, 0, 4],
                                          ctrl[i, 0, 5])
            zero_out, r_first, r_read = ctrl[i, 0, 9], ctrl[i, 0, 10], ctrl[i, 0, 11]
            for k in range(s_cnt):
                sb, db = scols[i, 0, k], scols[i, 1, k]
                hilo[scat0 + db * cq:scat0 + (db + 1) * cq] = table[sb * cq:(sb + 1) * cq]
            for k in range(r_cnt):
                src, dst = rcopy[i, 0, k], rcopy[i, 1, k]
                range_f32[dst:dst + RQ] = xs[src:src + RQ]
            if tile >= 0 and zero_out:
                out[tile * R:(tile + 1) * R] = 0.0
            if tile >= 0 and r_first:
                w0 = H_blocks * _L + r_read
                hilo[w0:w0 + RC] = _hilo(range_f32[r_read:r_read + RC])
            if tile < 0:
                continue
            for g in range(G):
                b = blk[i, 0, g]
                if b < H_blocks:
                    off = b * _L
                elif b < H_blocks + RCB:
                    off = b * _L + r_read
                else:
                    off = b * _L + RC + s_read
                contrib = group_contrib(plan, seg, i * G + g, hilo[off:off + _L], d)
                rows = lrow[i * G + g]
                valid = rows < R
                np.add.at(out, tile * R + np.where(valid, rows, 0),
                          np.where(valid[:, None], contrib, 0.0))
        out_tiles.append(out)
    y = np.concatenate(out_tiles, axis=0)[:n]
    if plan.row_scale is not None:
        y = y * np.asarray(plan.row_scale)[:, None]
    return y
