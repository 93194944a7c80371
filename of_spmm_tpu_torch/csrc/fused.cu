// Hand-written Hopper (sm_90a) kernel of the fused engine.
//
// fused_spmm replaces of_spmm_tpu/ops/pallas/fused.py::_kernel (launched there by _segment_call,
// one pallas_call per plan segment). It runs one segment of a FusedPlan
// (sparse/fused.py) over the window [hot | staged]: hot rows are the
// plan's hot table, staged rows the (virtual) tile's cold columns, which
// the TPU kernel copied row by row from X (staging="rows") or in cq-row
// blocks from a take table ("chunks"). Window mode (dst 128-row window
// per step) is supported. There is no range region (RC = 0).
//
// The kernel, its bound and its design are in staged_spmm.cuh, which the
// fused and the ranges engines share: the engines differ only in where a
// window row comes from, and the window provenance placement derives
// (sparse/staged_windows.py) says that for both.

#include "staged_spmm.cuh"

extern "C" {

// One segment of a placed plan against x float32 (m, d); adds the
// segment's rows into out float32 (n, d), which the caller has zeroed.
// Every pointer is a contiguous device array (see ofs_staged::Args;
// val_hi/val_lo, col_scale, row_scale and range_rows may be null).
// out_row0 is the segment's first output row. Returns a cudaError_t.
int ofs_fused_spmm(const void* ctrl, const void* blk, const void* lidx, const void* lrow,
                    const void* val_hi, const void* val_lo, const void* step_win,
                    const void* range_rows, const void* staged_rows, const void* hot_ids,
                    const void* col_scale, const void* row_scale, const void* x, void* out,
                    int64_t m, int64_t xs_rows, int64_t n, int64_t d, int64_t out_row0,
                    int64_t n_steps, int G, int R, int n_hot, int RC, int RQ, int multihot,
                    int window, int device, void* stream) {
  ofs_staged::Args a{};
  a.ctrl = static_cast<const int32_t*>(ctrl);
  a.blk = static_cast<const int32_t*>(blk);
  a.lidx = static_cast<const int32_t*>(lidx);
  a.lrow = static_cast<const int32_t*>(lrow);
  a.val_hi = static_cast<const float*>(val_hi);
  a.val_lo = static_cast<const float*>(val_lo);
  a.step_win = static_cast<const int32_t*>(step_win);
  a.range_rows = static_cast<const int32_t*>(range_rows);
  a.staged_rows = static_cast<const int32_t*>(staged_rows);
  a.hot_ids = static_cast<const int32_t*>(hot_ids);
  a.col_scale = static_cast<const float*>(col_scale);
  a.row_scale = static_cast<const float*>(row_scale);
  a.x = x;
  a.out = out;
  a.m = m;
  a.xs_rows = xs_rows;
  a.n = n;
  a.out_row0 = out_row0;
  a.G = G;
  a.R = R;
  a.n_hot = n_hot;
  a.RC = RC;
  a.RQ = RQ;
  a.multihot = multihot;
  a.window = window;
  return ofs_staged::launch(a, d, n_steps, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
