// Hand-written Hopper (sm_90a) kernel of the one-hot expansion engine
// (layout="expansion").
//
// expansion_spmm replaces of_spmm_tpu/ops/pallas/expansion.py::_expansion_kernel
// (launched there by _group_call, one pallas_call per plan group) together
// with its wrapper's tier-major staging (_stage_hilo). It runs every group
// of an ExpansionPlan (sparse/expansion.py) in one launch: per step, TILE
// lanes whose staged rows lie in a window of CW/128 arbitrary 128-row
// staging blocks (base_blk), each lane carrying its value as a bf16 pair.
//
// The kernel, its bound and its design are in expansion.cuh, which the
// expansion and the expansion2 engines share: they differ only in where a
// lane's staging block comes from and where its scale does.

#include "expansion.cuh"

extern "C" {

// One SpMM of a placed plan against x float32 (m, d) into out float32
// (n, d): the zeroing of the split keys' rows, then one launch over every
// work unit of every group. table int64 (groups, 8), lanes, units and
// split_keys int32 are the plan's LaneWork (sparse/expansion.py;
// ops/cuda/expansion.py place_plan); row_scale is null for this engine;
// tile_lanes = TILE, nblk = CW / 128. Every pointer is a contiguous device
// array. Returns a cudaError_t.
int ofs_expansion_spmm(const void* table, const void* lanes, const void* units,
                       const void* split_keys, const void* row_scale, const void* x, void* out,
                       int64_t m, int64_t n, int64_t d, int64_t n_units, int64_t n_split, int R,
                       int tile_lanes, int nblk, int device, void* stream) {
  return ofs_expansion::run<false>(table, lanes, units, split_keys, row_scale, x, out, m, n, d,
                                   n_units, n_split, R, tile_lanes, nblk, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
