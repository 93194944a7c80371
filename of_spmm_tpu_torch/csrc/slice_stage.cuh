// A column slice of a table resident in each block's shared memory, and
// ranges of indices and weights staged beside it by TMA: the device pieces
// (mbarriers, 2-D TMA copies into a block's own ring of stages, the
// swizzled read of what they wrote, TMA stores of the output) and the host
// pieces (2-D tensor maps, a launch sized to keep every block resident)
// of csrc/microbench_blockfma.cu's sliced kernel.
//
// The pattern: each block keeps its own column slice of a table in shared
// memory and walks a range of rows. A producer warp copies each range's
// indices and weights from L2 into a ring of stages. A stage's "full"
// mbarrier expects the stage's bytes; its "empty" mbarrier counts the
// block's consumer warps, so the producer refills a stage only once all
// its readers are done with it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ofs_slice {

// ---- device -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the block's barriers initialised and visible to its TMA copies (the
// caller then synchronises its threads)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of the given parity to complete. A phase still open
// after 2^35 clocks (~17 s) traps: a stage that never arrives stops the
// kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// Arrive on the mbarrier, releasing this thread's reads of the stage it
// guards.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// The box of `map` at element (c0, c1) into this block's dst, completing
// on the mbarrier bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The box of `map` at element (c0, c1) from src (shared memory, 128-byte
// aligned) to global memory, in this thread's bulk group; elements past the
// array's edge are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1,
                                          const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// This thread's bulk stores issued so far, closed as one group.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk store groups still read shared
// memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until this thread's bulk stores are done.
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// This thread's shared-memory writes, made visible to TMA (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk q of row r in a 1024-byte aligned tile of
// `row_bytes`-byte rows (16, 32, 64 or 128) that a TMA copy wrote with the
// swizzle of that width (tensor_map_2d): address bits [4, 4 + b) XORed with
// bits [7, 7 + b), b = log2(row_bytes / 16), so that 8 consecutive rows'
// chunk q falls on 8 distinct 16-byte bank groups.
__device__ __forceinline__ uint32_t swizzled(uint32_t r, uint32_t q, uint32_t row_bytes) {
  const uint32_t off = r * row_bytes + q * 16;
  return off ^ (((off >> 7) & (row_bytes / 16 - 1)) << 4);
}

// a += w x, each of the 4 columns one fused multiply-add
__device__ __forceinline__ void fma_slice(float4& a, float w, const float4 x) {
  a.x = fmaf(w, x.x, a.x);
  a.y = fmaf(w, x.y, a.y);
  a.z = fmaf(w, x.z, a.z);
  a.w = fmaf(w, x.w, a.w);
}

// Stage the column slice [col0, col0 + 4) of a (C, 128) float32 table
// into shared memory ([row][4]): thread `tid` of `n` copies rows tid,
// tid + n, ... with cp.async; the caller waits (cp_async_wait_all) and
// synchronises its threads.
__device__ __forceinline__ void stage_slice(float4* dst, const float* table, int64_t C,
                                            int col0, int tid, int n) {
  for (int64_t c = tid; c < C; c += n) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + c)),
                 "l"(table + c * 128 + col0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a barrier of the first n threads of the block (n a multiple of 32)
__device__ __forceinline__ void sync_threads(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// The n consumer threads' output rows, one a thread (4 floats at column
// col0 of row row0 + tid): each thread puts its 16 bytes in a
// shared-memory tile of n rows (two tiles in turn, `turn` flips), and
// thread 0 writes the tile with TMA stores of 256 rows (`map`: the
// (rows, 128) output in boxes of 4 x 256; rows past its end are not
// written), so that the block's pieces of the rows leave the SM in bulk
// instead of as n scattered 16-byte stores, which held up the threads'
// shared-memory loads behind them (2.5x the kernel's time at K 8).
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const float4 acc,
                                          float4* tiles, int& turn, int tid, int n, int64_t row0,
                                          int col0) {
  float4* tile = tiles + turn * n;
  if (tid == 0) tma_store_wait_read<1>();  // the store that read this tile last is done
  sync_threads(n);
  tile[tid] = acc;
  fence_proxy_async();
  sync_threads(n);
  if (tid == 0) {
    for (int r = 0; r < n; r += 256) tma_store(map, col0, static_cast<int>(row0 + r), tile + r);
    tma_store_commit();
  }
  turn ^= 1;
}

// ---- host ---------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda).
inline cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// A tensor map of a row-major (rows, cols) array of 4-byte elements, ld
// elements a row (ld a multiple of 4, base 16-byte aligned), in boxes of
// box_cols x box_rows, written swizzled to their row width (box_cols x 4 =
// 16: none, 32, 64 or 128 bytes; see swizzled). Elements past the array's
// edge arrive as 0 and count in the box's bytes.
inline cudaError_t tensor_map_2d(CUtensorMap* map, const void* base, bool is_float,
                                 uint64_t rows, uint64_t cols, uint64_t ld, uint32_t box_cols,
                                 uint32_t box_rows) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * 4};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const uint32_t row_bytes = box_cols * 4;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUtensorMapDataType type =
      is_float ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_INT32;
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch kernel on a grid of `slices` blocks along x by row groups along
// y, with `smem` bytes of dynamic shared memory: as many row groups as
// keep every block resident at once (a second wave of blocks would
// restage their slices), at most one a unit of rows and none left empty by
// the rounding. An error is cleared from the runtime's last-error state
// before it returns.
template <typename... Params, typename... Args>
cudaError_t launch_resident(void (*kernel)(Params...), int slices, int64_t units, int threads,
                            size_t smem, cudaStream_t stream, Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err == cudaSuccess) {
    const int64_t fit = static_cast<int64_t>(per_sm) * sms / slices;
    int64_t groups = units < fit ? units : (fit > 0 ? fit : 1);
    const int64_t per = (units + groups - 1) / groups;  // units a group
    groups = (units + per - 1) / per;                   // none left empty
    kernel<<<dim3(slices, static_cast<unsigned>(groups)), threads, smem, stream>>>(args...);
  }
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace ofs_slice
