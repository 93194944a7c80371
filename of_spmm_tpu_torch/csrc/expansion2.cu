// Hand-written Hopper (sm_90a) kernel of the one-hot expansion engine v2
// (spmm_expansion2).
//
// expansion2_spmm replaces of_spmm_tpu/ops/pallas/expansion2.py::_kernel
// (launched there by _group_call, one pallas_call per plan group) together
// with its wrapper's tier-major, column-scaled staging (_stage) and row
// scaling. It runs every group of an Expansion2Plan (sparse/expansion2.py)
// in one launch: per step, G groups of 128 lanes, each group on one
// 128-row staging block (blk_of); padding lanes carry the row sentinel R.
// Rank-1 plans carry no values: the lane's scale is stage_scale[u] *
// row_scale[output row]. General plans carry each value as a bf16 pair.
//
// The kernel, its bound and its design are in expansion.cuh, shared with
// the expansion engine.

#include "expansion.cuh"

extern "C" {

// One SpMM of a placed plan against x float32 (m, d) into out float32
// (n, d): the zeroing of the split keys' rows, then one launch over every
// work unit of every group. table int64 (groups, 8), lanes, units and
// split_keys int32 are the plan's LaneWork (sparse/expansion.py;
// ops/cuda/expansion.py place_plan; the table's val_hi / val_lo are 0 on
// rank-1 plans, its stage_scale 0 on general ones); row_scale is null on
// general plans; tile_lanes and nblk are unused. Every pointer is a
// contiguous device array. Returns a cudaError_t.
int ofs_expansion2_spmm(const void* table, const void* lanes, const void* units,
                        const void* split_keys, const void* row_scale, const void* x, void* out,
                        int64_t m, int64_t n, int64_t d, int64_t n_units, int64_t n_split, int R,
                        int tile_lanes, int nblk, int device, void* stream) {
  return ofs_expansion::run<true>(table, lanes, units, split_keys, row_scale, x, out, m, n, d,
                                  n_units, n_split, R, tile_lanes, nblk, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
