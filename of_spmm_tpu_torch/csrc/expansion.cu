// Hand-written Hopper (sm_90a) kernel of the one-hot expansion engine
// (layout="expansion").
//
// expansion_spmm replaces of_spmm_tpu/ops/pallas/expansion.py::_expansion_kernel
// (launched there by _group_call, one pallas_call per plan group) together
// with its wrapper's tier-major staging (_stage_hilo). It runs one group of
// an ExpansionPlan (sparse/expansion.py): per step, TILE lanes whose staged
// rows lie in a window of CW/128 arbitrary 128-row staging blocks
// (base_blk), each lane carrying its value as a bf16 pair.
//
// The kernel, its bound and its design are in expansion.cuh, which the
// expansion and the expansion2 engines share: they differ only in where a
// lane's staging block comes from and where its scale does.

#include "expansion.cuh"

extern "C" {

// One group of a placed plan against x float32 (m, d); adds the group's
// rows into out float32 (n, d), which the caller has zeroed. Every pointer
// is a contiguous device array (see ofs_expansion::Args; stage_scale and
// row_scale are null for this engine). out_row0 is the group's first
// output row, nblk = CW / 128, groups_per_step = TILE / 128. Returns a
// cudaError_t.
int ofs_expansion_spmm(const void* lidx, const void* lrow, const void* val_hi,
                       const void* val_lo, const void* blk, const void* tile_of,
                       const void* stage_row, const void* stage_scale, const void* row_scale,
                       const void* x, void* out, int64_t m, int64_t n, int64_t d,
                       int64_t out_row0, int64_t n_steps, int64_t n_staged, int groups_per_step,
                       int nblk, int R, int device, void* stream) {
  return ofs_expansion::run<false>(lidx, lrow, val_hi, val_lo, blk, tile_of, stage_row,
                                   stage_scale, row_scale, x, out, m, n, d, out_row0, n_steps,
                                   n_staged, groups_per_step, nblk, R, device, stream);
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
