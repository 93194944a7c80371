// Hand-written Hopper (sm_90a) kernels of the block gather-FMA
// microbenchmark (of_spmm_tpu_torch/tools/microbench_blockfma.py).
//
// blockfma_a replaces tools/microbench_blockfma.py::bench_A's kernel
// (pallas_call at :61). Per step r (an 8-row output block) and slot k < K:
//     out[8r + j, :] += w[8r + j, k] * tier[s_k + j, :],  j < 8,
// with s_k = starts[8r + k % 8, k / 8]: an unaligned 8-row block of the
// tier, weighted row by row.
//
// blockfma_b replaces bench_B's kernel (pallas_call at :98). Per step r and
// slot k, with c = starts[8r + k % 8, k / 8] and v = vals[8r + k % 8, k / 8]:
//     out[8r + c % 8, :] += v * tier[c, :].
// The TPU loads the aligned 8-row block holding row c and multiplies all
// 8 sublanes, 7 of them by 0; here only row c is read and added.
//
// What bounds them on the H100: A by the tier words it reads out of the
// on-chip tier, slots x 8 x 128 (1.07 G at the tool's defaults, 0.128 ms
// at 32 shared-memory words a clock on 132 SMs), the TPU's VMEM reads,
// over its operations (2 K * 8 * 128 flops a step, 2.15 GFLOP, 0.032 ms
// at 67 TFLOP/s fp32) and its bytes (w, starts, tier and out once: 58.7
// MB, 0.0175 ms); B by its bytes (starts, vals, tier and out once: 29.4
// MB, 0.0088 ms). utils/roofline.py blockfma_work counts both.
//
// Design of A from L2 (blockfma_a_kernel): one block of 8 warps per
// step, so every block owns its own 8 output rows and no two blocks write
// the same memory. Warp j computes row 8r + j, each lane 4 columns as one
// float4, and walks the K slots in order, as the TPU's unrolled loop does
// (fused multiply-adds: one rounding where the TPU takes two). The step's
// starts and w are first copied to shared memory, so each slot's index is
// a broadcast read. The 4 MB tier stays in the 50 MB L2 across blocks.
//
// Design of B: each slot names one row c of the tier and one output row
// c % 8, so a warp that walks all K slots for its row skips 7 of 8 and,
// with the branch in its loop, keeps about one load in flight. Here one
// block of 8 warps per step stages the step's K starts and vals in shared
// memory in slot order (one coalesced read of the step's contiguous
// (8, K / 8) block, one barrier); then warp j bins its own slots: 32
// slots a ballot, each hit writing its slot number to the warp's list at
// the count of hits before it, so the list keeps slot order. The warp then
// walks only its list, about K / 8 slots, kInFlight tier rows loaded into
// registers before their fused multiply-adds run in slot order. Every row
// is stored once, 0 where no slot names it. No barrier after the staging:
// each warp's list is its own. (On the card, 2 or 4 steps a block and 2,
// 6, 8 or 16 rows in flight were slower.) Every slot reads its 512-byte
// row out of L2 (rows repeat at random across steps), 537 MB at the
// tool's defaults: that read, not HBM, bounds B.
//
// A start outside the tier stops either kernel with a device-side assertion.
//
// Design of A on the card, two paths chosen from C and the card's opt-in
// shared memory (ops/cuda/microbench_blockfma.a_plan, never on a failure):
//
// The sliced kernel (blockfma_a_sliced_kernel), from C 2,304 to as many
// rows as fit (9,336 on an H100), keeps columns [4s, 4s + 4) of the tier
// resident in shared memory: 16 bytes a row, 128 KB at C 8192. Grid: the
// 32 slices along x times row groups of steps along y, as many as keep
// every block resident at once; the 32 blocks of a row group walk the same
// steps. 256 consumer threads a block, one per (step, row j) of 32 steps a
// stage, each owning its row's 4 columns: per slot it takes the start (lane j of a step reads row j of the start box,
// shuffles hand each slot's start round the step's 8 lanes), the weight
// and the slice row s + j: a step's 8 lanes read 8 consecutive rows, 128
// contiguous bytes, no bank conflict. All of a stage's starts are checked
// before its tier reads, so that they issue together. The sums run in
// slot order with fused multiply-adds, as the L2 kernel's, so the two give
// the same bits. A stage holds 32 steps x 32 slots of w (a 2-D TMA box of
// 256 rows x 128 bytes, swizzled 128B so that a step's 8 rows reading the
// same 16-byte chunk hit 8 bank groups) and of starts (256 rows x 4
// columns); a producer warp fills a ring of 2 or more stages out of L2
// (csrc/slice_stage.cuh). Each of the 32 slices' blocks reads a stage's w
// and starts: 32 x 33.5 MB of w at the tool's defaults, 1.07 GB out of L2
// (PERF.md). A finished stage's rows leave through a shared-memory tile and
// one TMA store. On the card (PERF.md): clusters of 2 blocks, each copying
// half a stage and multicasting it to its peer, ran 5.5% slower than this
// per-block form, clusters of 4, 8 and 16 1.3x slower; 64 steps x 16 slots
// a stage (16 warps) slower; 2- and 1-column slices (C past 9,336) 1.3x
// and 2.3x slower than the L2 kernel.
// Shared-memory words bound it: 1.07 G tier words at the tool's defaults,
// 0.128 ms at 32 words a clock on 132 SMs (utils/roofline.py
// blockfma_work).
//
// The L2 kernel (blockfma_a_kernel) is the path below C 2,304 (a tier of
// 1 MB or less, read out of L1 and L2 faster) and where no slice fits.

#undef NDEBUG  // the index checks below are asserts and must stay on
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

#include "slice_stage.cuh"

namespace {

using namespace ofs_slice;

constexpr int kD = 128;         // tier and output width
constexpr int kRows = 8;        // output rows per step
constexpr int kThreads = kRows * 32;
constexpr int kInFlight = 4;    // B: tier rows a warp loads before adding them
constexpr unsigned kFull = 0xffffffffu;

// variant A; w is (8R, K) float32
__global__ void __launch_bounds__(kThreads)
blockfma_a_kernel(const int32_t* __restrict__ starts, const float* __restrict__ w,
                  const float4* __restrict__ tier, float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_start = reinterpret_cast<int32_t*>(smem_raw);  // (K,) in slot order
  float* s_w = reinterpret_cast<float*>(s_start + K);       // (8, K)
  const int64_t r = blockIdx.x;
  const int kk = K / kRows;
  for (int e = threadIdx.x; e < K; e += kThreads) {
    // slot k = 8 * (k / 8) + k % 8 reads row 8r + k % 8, column k / 8
    const int64_t at = (r * kRows + e % kRows) * kk + e / kRows;
    const int32_t s = starts[at];
    assert(s >= 0 && s + kRows <= C);
    s_start[e] = s;
  }
  for (int e = threadIdx.x; e < kRows * K; e += kThreads) {
    s_w[e] = w[r * kRows * K + e];
  }
  __syncthreads();

  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float wk = s_w[j * K + k];
    const float4 v = tier[static_cast<int64_t>(s_start[k] + j) * (kD / 4) + lane];
    acc.x = fmaf(wk, v.x, acc.x);
    acc.y = fmaf(wk, v.y, acc.y);
    acc.z = fmaf(wk, v.z, acc.z);
    acc.w = fmaf(wk, v.w, acc.w);
  }
  out[(r * kRows + j) * (kD / 4) + lane] = acc;
}

// ---- A, sliced: a column slice of the tier resident in shared memory -----------

constexpr int kSliceCols = 4;                      // tier columns a block holds
constexpr int kAStageSteps = 32;                   // steps a stage holds
constexpr int kAStageSlots = 32;                   // slots a stage holds
constexpr int kAConsumers = kAStageSteps * kRows;  // one thread per (step, row)
constexpr int kAWBytes = kAConsumers * kAStageSlots * 4;  // w: 256 rows of 128 bytes
constexpr int kAStageBytes = kAWBytes + kAConsumers * 16;  // then starts: 4 columns a row
constexpr int kMaxStages = 8;
constexpr int kBarrierBytes = kMaxStages * 16;  // the stages' full and empty mbarriers
constexpr int kATileBytes = 2 * kAConsumers * 16;  // two output tiles

size_t smem_a_sliced(int64_t C, int stages) {
  return 1024 + static_cast<size_t>(stages) * kAStageBytes + kBarrierBytes + kATileBytes +
         static_cast<size_t>(C) * kSliceCols * 4;
}

__device__ __forceinline__ int32_t word(const int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One (step, row)'s slots of a stage, run by every consumer lane: lane j of
// a step holds row j of the step's 8 rows of the start box (slot kk: row
// kk % 8, column kk / 8) and hands slot kk's start to the step's lanes by
// shuffle. All starts are checked before any tier read, so that the reads
// issue together; a lane of a step past the last (valid false) adds row j.
// kWhole: all 32 slots run.
template <bool kWhole>
__device__ __forceinline__ void a_slots(float4& acc, const unsigned char* w_rows, const int4 own,
                                        const float4* slice, int lr, int j, int nk, bool valid,
                                        int64_t C) {
  const int base = (threadIdx.x % 32) & ~(kRows - 1);
  int32_t s[kAStageSlots];
  bool inside = true;
#pragma unroll
  for (int kk = 0; kk < kAStageSlots; ++kk) {
    s[kk] = __shfl_sync(kFull, word(own, kk / kRows), base | (kk % kRows));
    if (kWhole || kk < nk) inside &= !valid | ((s[kk] >= 0) & (s[kk] + kRows <= C));
    s[kk] = valid ? s[kk] : 0;
  }
  assert(inside);
#pragma unroll
  for (int q = 0; q < kAStageSlots / 4; ++q) {
    if (kWhole || 4 * q < nk) {
      const float4 w4 =
          *reinterpret_cast<const float4*>(w_rows + swizzled(lr, q, kAStageSlots * 4));
      const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = 4 * q + m;
        if (kWhole || kk < nk) fma_slice(acc, wq[m], slice[s[kk] + j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kAConsumers + 32, 1)
blockfma_a_sliced_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap s_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const float* __restrict__ tier, int64_t R, int K, int stages,
                         int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kAStageBytes);
  uint64_t* empty = full + stages;
  float4* tiles = reinterpret_cast<float4*>(ring + stages * kAStageBytes + kBarrierBytes);
  float4* slice = tiles + 2 * kAConsumers;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kSliceCols;
  // row group blockIdx.y: an equal share of the stages of 32 steps
  const int64_t group_steps =
      ((R + kAStageSteps - 1) / kAStageSteps + gridDim.y - 1) / gridDim.y * kAStageSteps;
  const int64_t step_lo = blockIdx.y * group_steps;
  const int64_t step_hi = min(R, step_lo + group_steps);
  const int n_kc = (K + kAStageSlots - 1) / kAStageSlots;
  const int64_t n_stages =
      step_hi > step_lo ? (step_hi - step_lo + kAStageSteps - 1) / kAStageSteps * n_kc : 0;
  if (tid == 0) {
    for (int b = 0; b < stages; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], kAConsumers / 32);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid >= kAConsumers) {  // the producer warp: every lane waits, lane 0 copies
    for (int64_t i = 0; i < n_stages; ++i) {
      const int b = static_cast<int>(i % stages);
      const auto u = static_cast<uint32_t>(i / stages);
      if (i >= stages) mbar_wait(&empty[b], (u - 1) & 1);  // every reader is done
      const int64_t row0 = (step_lo + (i / n_kc) * kAStageSteps) * kRows;
      const int k0 = static_cast<int>(i % n_kc) * kAStageSlots;
      if (tid == kAConsumers) {  // rows and slots past the edge arrive as 0, counted
        unsigned char* st = ring + b * kAStageBytes;
        mbar_expect_tx(&full[b], kAStageBytes);
        tma_load(st, &w_map, k0, static_cast<int>(row0), &full[b]);
        tma_load(st + kAWBytes, &s_map, k0 / kRows, static_cast<int>(row0), &full[b]);
      }
      __syncwarp();
    }
  } else {
    stage_slice(slice, tier, C, col0, tid, kAConsumers);
    cp_async_wait_all();
    sync_threads(kAConsumers);
    const int ls = tid / kRows, j = tid % kRows, lane = tid % 32;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int turn = 0;
    for (int64_t i = 0; i < n_stages; ++i) {
      const int b = static_cast<int>(i % stages);
      mbar_wait(&full[b], static_cast<uint32_t>(i / stages) & 1);
      const int kc = static_cast<int>(i % n_kc);
      const int64_t step0 = step_lo + (i / n_kc) * kAStageSteps;
      const int nk = min(kAStageSlots, K - kc * kAStageSlots);
      if (kc == 0) acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const unsigned char* st = ring + b * kAStageBytes;
      const int4 own = reinterpret_cast<const int4*>(st + kAWBytes)[tid];  // row 8 ls + j
      const bool valid = step0 + ls < step_hi;
      if (nk == kAStageSlots) {
        a_slots<true>(acc, st, own, slice, tid, j, nk, valid, C);
      } else {
        a_slots<false>(acc, st, own, slice, tid, j, nk, valid, C);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[b]);  // the warp is done with stage b
      if (kc == n_kc - 1) {  // the stage's 32 steps are summed
        store_rows(&o_map, acc, tiles, turn, tid, kAConsumers, step0 * kRows, col0);
      }
    }
    if (tid == 0) tma_store_wait_all();
  }
}

int launch_a_sliced(const void* starts, const void* w, const void* tier, void* out, int64_t R,
                    int K, int64_t C, int ld_starts, int stages, cudaStream_t st) {
  if (stages < 2 || stages > kMaxStages || ld_starts % 4 != 0 || ld_starts < K / kRows ||
      R * kRows > 0x7fffffff || reinterpret_cast<uintptr_t>(starts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap w_map, s_map, o_map;
  cudaError_t err = tensor_map_2d(&w_map, w, true, R * kRows, K, K, kAStageSlots, kAConsumers);
  if (err == cudaSuccess) {
    err = tensor_map_2d(&s_map, starts, false, R * kRows, K / kRows, ld_starts, 4, kAConsumers);
  }
  if (err == cudaSuccess) err = tensor_map_2d(&o_map, out, true, R * kRows, kD, kD, 4, 256);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t units = (R + kAStageSteps - 1) / kAStageSteps;
  return static_cast<int>(launch_resident(blockfma_a_sliced_kernel, kD / kSliceCols, units,
                                          kAConsumers + 32, smem_a_sliced(C, stages), st, w_map,
                                          s_map, o_map, static_cast<const float*>(tier), R, K,
                                          stages, C));
}

// shared memory of B: starts and vals (K each, slot order), then the 8
// warps' lists of slot numbers (K each: a step's slots may all name one
// row)
size_t smem_b(int K) { return static_cast<size_t>(K) * (2 * 4 + kRows * 2); }

// variant B; vals is (8R, K / 8) float32
__global__ void __launch_bounds__(kThreads)
blockfma_b_kernel(const int32_t* __restrict__ starts, const float* __restrict__ vals,
                  const float4* __restrict__ tier, float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ unsigned char smem_raw[];
  int32_t* s_c = reinterpret_cast<int32_t*>(smem_raw);
  float* s_v = reinterpret_cast<float*>(s_c + K);
  const int64_t r = blockIdx.x;
  const int kk = K / kRows;
  // the step's (8, K / 8) block is contiguous: element e is slot
  // (e % kk) * 8 + e / kk
  for (int e = threadIdx.x; e < K; e += kThreads) {
    const int32_t c = starts[r * K + e];
    const float v = vals[r * K + e];
    assert(c >= 0 && c < C);
    const int k = (e % kk) * kRows + e / kk;
    s_c[k] = c;
    s_v[k] = v;
  }
  __syncthreads();

  const int j = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint16_t* list = reinterpret_cast<uint16_t*>(s_v + K) + static_cast<size_t>(j) * K;
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const bool hit = k < K && (s_c[k] & (kRows - 1)) == j;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = static_cast<uint16_t>(k);
    n += __popc(m);
  }
  __syncwarp();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += kInFlight) {
    float4 x[kInFlight];
    float v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u < n) {
        const int k = list[i0 + u];
        v[u] = s_v[k];
        x[u] = __ldg(tier + static_cast<int64_t>(s_c[k]) * (kD / 4) + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u < n) {
        acc.x = fmaf(v[u], x[u].x, acc.x);
        acc.y = fmaf(v[u], x[u].y, acc.y);
        acc.z = fmaf(v[u], x[u].z, acc.z);
        acc.w = fmaf(v[u], x[u].w, acc.w);
      }
    }
  }
  out[(r * kRows + j) * (kD / 4) + lane] = acc;
}

}  // namespace

extern "C" {

// variant 0 (A) or 1 (B). starts int32 (8R, K/8); w float32 (8R, K) for A,
// vals float32 (8R, K/8) for B; tier float32 (C, 128); out float32
// (8R, 128), every row written. Contiguous device arrays, K a multiple of
// 8. A with `stages` > 0 runs the sliced kernel (a ring of that many
// stages; starts ld_starts int32 a row, a multiple of 4, starts and w
// 16-byte aligned), with 0 the L2 kernel (ld_starts = K / 8); B ignores
// the two. Returns a cudaError_t.
int ofs_blockfma(int variant, const void* starts, const void* w, const void* tier, void* out,
                 int64_t R, int K, int64_t C, int ld_starts, int stages, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  if (K <= 0 || K % kRows != 0 || R > 0x7fffffff || C <= 0 || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* s = static_cast<const int32_t*>(starts);
  auto* wv = static_cast<const float*>(w);
  auto* t = static_cast<const float4*>(tier);
  auto* o = static_cast<float4*>(out);
  if (variant == 0 && stages != 0) {
    return launch_a_sliced(s, wv, t, o, R, K, C, ld_starts, stages, st);
  }
  if (variant == 0) {
    if (ld_starts != K / kRows) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(int32_t) * K + sizeof(float) * kRows * K;
    err = cudaFuncSetAttribute(blockfma_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_a_kernel<<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  } else {
    if (K > 0xffff) return static_cast<int>(cudaErrorInvalidValue);  // uint16 slot numbers
    const size_t smem = smem_b(K);
    err = cudaFuncSetAttribute(blockfma_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    blockfma_b_kernel<<<static_cast<unsigned>(R), kThreads, smem, st>>>(s, wv, t, o, K, C);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
