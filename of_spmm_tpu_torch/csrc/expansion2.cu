// Hand-written Hopper (sm_90a) kernel of the one-hot expansion engine v2
// (spmm_expansion2).
//
// expansion2_spmm replaces of_spmm_tpu/ops/pallas/expansion2.py::_kernel
// (launched there by _group_call, one pallas_call per plan group) together
// with its wrapper's tier-major, column-scaled staging (_stage) and row
// scaling. It runs one group of an Expansion2Plan (sparse/expansion2.py):
// per step, G groups of 128 lanes, each group on one 128-row staging block
// (blk_of); padding lanes carry the row sentinel R. Rank-1 plans carry no
// values: the lane's scale is stage_scale[u] * row_scale[output row].
// General plans carry each value as a bf16 pair.
//
// The kernel, its bound and its design are in expansion.cuh, shared with
// the expansion engine.

#include "expansion.cuh"

extern "C" {

// One group of a placed plan against x float32 (m, d); adds the group's
// rows into out float32 (n, d), which the caller has zeroed. Every pointer
// is a contiguous device array (see ofs_expansion::Args; val_hi/val_lo are
// null on rank-1 plans, stage_scale and row_scale on general ones).
// out_row0 is the group's first output row, groups_per_step = G, nblk is
// unused. Returns a cudaError_t.
int ofs_expansion2_spmm(const void* lidx, const void* lrow, const void* val_hi,
                        const void* val_lo, const void* blk, const void* tile_of,
                        const void* stage_row, const void* stage_scale, const void* row_scale,
                        const void* x, void* out, int64_t m, int64_t n, int64_t d,
                        int64_t out_row0, int64_t n_steps, int64_t n_staged,
                        int groups_per_step, int nblk, int R, int device, void* stream) {
  return ofs_expansion::run<true>(lidx, lrow, val_hi, val_lo, blk, tile_of, stage_row,
                                  stage_scale, row_scale, x, out, m, n, d, out_row0, n_steps,
                                  n_staged, groups_per_step, nblk, R, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
