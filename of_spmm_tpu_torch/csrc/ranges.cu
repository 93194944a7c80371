// Hand-written Hopper (sm_90a) kernel of the ranges engine.
//
// ranges_spmm replaces of_spmm_tpu/ops/pallas/ranges.py::_kernel (launched there by _segment_call,
// one pallas_call per plan segment). It runs one segment of a RangesPlan
// (sparse/ranges.py) over the window [hot | range | scattered]: range
// rows are RQ-row chunks of a contiguous X range (copied at the clamped
// chunk start, rows past the end of X read as the TPU wrapper's zero
// padding), scattered rows the tile's remaining columns, which the TPU
// kernel copied in cq-row blocks from a take table.
//
// The kernel, its bound and its design are in staged_spmm.cuh, which the
// fused and the ranges engines share: the engines differ only in where a
// window row comes from, and the window provenance placement derives
// (sparse/staged_windows.py) says that for both.

#include "staged_spmm.cuh"

extern "C" {

// One segment of a placed plan against x float32 (m, d); writes the
// segment's rows [out_row0, out_row0 + n_tiles * R) (those below n) of out
// float32 (n, d): one zeroing block per split key, then one block per
// work unit, 128-row pass and column slab of the segment's work list
// (unit_slots, units, split_keys: sparse/staged_windows.py StagedWindows).
// Every pointer is a contiguous device array (see ofs_staged::Args;
// val_hi/val_lo, col_scale, row_scale and range_rows may be null).
// Returns a cudaError_t.
int ofs_ranges_spmm(const void* blk, const void* lidx, const void* lrow,
                    const void* val_hi, const void* val_lo, const void* step_win,
                    const void* range_rows, const void* staged_rows, const void* hot_ids,
                    const void* col_scale, const void* row_scale, const void* unit_slots,
                    const void* units, const void* split_keys, const void* x, void* out,
                    int64_t m, int64_t xs_rows, int64_t n, int64_t d, int64_t out_row0,
                    int64_t n_units, int64_t n_split, int G, int R, int n_hot, int RC, int RQ,
                    int multihot, int window, int device, void* stream) {
  return ofs_staged::spmm_segment(blk, lidx, lrow, val_hi, val_lo, step_win, range_rows,
                                  staged_rows, hot_ids, col_scale, row_scale, unit_slots, units,
                                  split_keys, x, out, m, xs_rows, n, d, out_row0, n_units,
                                  n_split, G, R, n_hot, RC, RQ, multihot, window, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
