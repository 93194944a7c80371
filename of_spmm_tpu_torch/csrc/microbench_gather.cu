// Hand-written Hopper (sm_90a) kernels of the gather microbenchmark
// (of_spmm_tpu_torch/tools/microbench_gather.py), one per TPU kernel of
// tools/microbench_gather.py (pallas_call line):
//
//   vmem_loop    bench_vmem_loop (:138): out[o] = sum_k vals[o, k] tier[cols[o, k]],
//                K = 128, the tier (C, 128) float32 resident.
//                ell_reduce_kernel: one warp per output row, the row's
//                indices and values loaded 32 at a time and broadcast with
//                a shuffle, the sum in k order with fused multiply-adds, the
//                tier read through L2. Exported as ofs_gather_ell_reduce,
//                which also serves take_fused (csrc/microbench_gather2.cu's
//                tool, K = 8). A form that kept a 4-column slice of the tier
//                in each block's shared memory, cols and vals staged by TMA
//                and multicast to a cluster, ran slower than this kernel at
//                every C measured on an H100 (PERF.md).
//   vmem_take    bench_vmem_take (:175): out[t] = tier[cols[t]].
//   onehot       bench_onehot_mxu (:219): out[t] = sum_c [cols[t] == c] tier[c],
//                that is f32(tier[cols[t]]), an index outside [0, C) giving a
//                zero row. The TPU forms it as a (TILE, C) x (C, 128) one-hot
//                product on its matrix unit; its cost grows with C while the
//                function is a row gather, so here it is one.
//                Both: csrc/gather.cuh's row_gather_kernel<Tier, kZeroFill>
//                (one thread per float4 of the output, the tier read through
//                L1 / L2, a bfloat16 tier 8 bytes a thread and widened, the
//                512 MB output written with streaming stores), with one
//                table and no base: the template that onehot_pair and
//                window_pair (csrc/microbench_gather2.cu) instantiate too.
//                vmem_take asserts its index, onehot stores a zero row.
//   block_slice  bench_block_slice (:263): out[8i + j] = sum_{r < 8, k < K}
//                tier[starts[8i + r, k] + j], unaligned 8-row blocks.
//                Two paths, chosen by the host from the shapes and the card
//                (ops/cuda/microbench_gather.py block_slice_plan):
//                block_count_kernel, the counts of 16 steps' starts times
//                the shifted tier on the tensor cores (design below), and
//                where the tier has many rows for its starts,
//                block_slice_kernel: one block per 8-row output step, warp
//                j adding tier[s + j] for each start s out of L2.
//   row_dma      bench_row_dma (:314): out[o] = sum_{m < 16} table[cols.flat[16 o + m]]
//                from a 1 GiB table in device memory. row_sum_async_kernel:
//                W rows in flight per warp, each lane copying its 16 bytes
//                of W rows into a shared-memory ring W rows deep (cp.async,
//                one commit group), the warp waiting for the wave and adding
//                it: the Hopper form of the TPU's W-deep DMA waves. Exported
//                as ofs_gather_row_sum, which also serves dma_deep (128 rows
//                an output row).
//
// What bounds them on the H100 (utils/roofline.py counts each from its
// inputs): bytes. vmem_take writes 512 MB at the tool's defaults; vmem_loop
// moves ~16 MB of indices, values, tier and output, though its warps read
// 512 MB of tier rows from L2; row_dma reads 128 MB of random table rows;
// onehot writes its 512 MB output. The C x 128 one-hot multiply-adds per
// row that the TPU kernel prescribes are reported beside the bound as the
// TPU's count; this kernel performs none. block_slice: its 134 M float32
// adds (0.0020 ms) or its 5 MB of bytes; the L2 kernel reads 537 MB of
// tier rows out of L2 at the tool's defaults (~0.075 ms at the ~7 TB/s
// measured), the count-matrix kernel 33 MB, and runs 3.2 G bf16
// multiply-adds (8 shifts x 128 steps x 8,192 rows x 128 columns x 3
// pieces; utils/roofline.block_slice_macs).
//
// An index outside the table stops vmem_loop, vmem_take, block_slice and
// row_dma with a device-side assertion; onehot's zero row is its result.

#include "gather.cuh"

namespace {

using namespace ofs_gather;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void fma4(float4& a, const float w, const float4 b) {
  a.x = fmaf(w, b.x, a.x);
  a.y = fmaf(w, b.y, a.y);
  a.z = fmaf(w, b.z, a.z);
  a.w = fmaf(w, b.w, a.w);
}

// The card's opt-in dynamic shared memory per block, in bytes.
cudaError_t smem_optin(int device, int* bytes) {
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// ---- ELL gather-reduce from L2 -------------------------------------------------

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_reduce_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                  const float4* __restrict__ table, float4* __restrict__ out, int64_t n_out,
                  int K, int64_t C) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (o >= n_out) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const int32_t* c_row = cols + o * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int n = min(32, K - k0);
    int32_t c = 0;
    float v = 0.f;
    if (lane < n) {
      c = c_row[k0 + lane];
      assert(c >= 0 && c < C);
      v = vals[o * K + k0 + lane];
    }
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int64_t ck = __shfl_sync(kFull, c, k);
      fma4(acc, __shfl_sync(kFull, v, k), __ldg(table + ck * kD4 + lane));
    }
  }
  out[o * kD4 + lane] = acc;
}

// ---- ELL row sum from device memory, W rows in flight per warp ------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_wave() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's warps each own a ring of W rows (W * 512 bytes of dynamic
// shared memory): as many as fit the card's opt-in limit, 1 to 4.
int warps_per_block(int W, int optin_bytes) {
  const int fit = optin_bytes / (W * kD * 4);
  return fit < 1 ? 1 : (fit > 4 ? 4 : fit);
}

__global__ void __launch_bounds__(4 * 32)
row_sum_async_kernel(const int32_t* __restrict__ cols, const float4* __restrict__ table,
                     float4* __restrict__ out, int64_t n_out, int K, int W, int64_t C) {
  extern __shared__ float4 ring[];  // (warps, W, 32)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (o >= n_out) return;  // the whole warp; no block-wide barrier below
  float4* my = ring + static_cast<int64_t>(warp) * W * kD4;
  const int32_t* c_row = cols + o * K;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k0 = 0; k0 < K; k0 += W) {
    const int n = min(W, K - k0);
    for (int j0 = 0; j0 < n; j0 += 32) {  // issue the wave, 32 indices at a time
      const int m = min(32, n - j0);
      int32_t c = 0;
      if (lane < m) {
        c = c_row[k0 + j0 + lane];
        assert(c >= 0 && c < C);
      }
      for (int j = 0; j < m; ++j) {
        const int64_t cj = __shfl_sync(kFull, c, j);
        cp_async16(my + (j0 + j) * kD4 + lane, table + cj * kD4 + lane);
      }
    }
    cp_async_wait_wave();  // each lane reads back only the bytes it copied
    for (int j = 0; j < n; ++j) add4(acc, my[j * kD4 + lane]);
    __syncwarp();  // the wave is read before the next one is issued
  }
  out[o * kD4 + lane] = acc;
}

// Block i sums the 8 K blocks of step i into output rows 8i .. 8i + 7:
// warp j adds tier[s + j] for every start s, in the TPU's order (k, then r).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_slice_kernel(const int32_t* __restrict__ starts, const float4* __restrict__ tier,
                   float4* __restrict__ out, int K, int64_t C) {
  extern __shared__ int32_t s_start[];  // (K, 8): slot k * 8 + r
  const int64_t i = blockIdx.x;
  for (int e = threadIdx.x; e < 8 * K; e += kWarpsPerBlock * 32) {
    const int r = e / K, k = e % K;
    const int32_t s = starts[i * 8 * K + e];
    assert(s >= 0 && s + 8 <= C);
    s_start[k * 8 + r] = s;
  }
  __syncthreads();
  const int j = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int e = 0; e < 8 * K; ++e) {
    add4(acc, __ldg(tier + static_cast<int64_t>(s_start[e] + j) * kD4 + lane));
  }
  out[(i * 8 + j) * kD4 + lane] = acc;
}

// ---- block_slice as a count matrix on the tensor cores -------------------------
//
// With N[i, s] the number of (r, k) with starts[8i + r, k] = s,
//     out[8i + j] = sum_s N[i, s] tier[s + j] = sum_c N[i, c - j] tier[c],
// so the 16 steps of a group times the 8 shifts are the 128 rows of one
// product: A[8i + j, c] = N[i, c - j] (the counts shifted by the row's
// shift), B = the tier. Block (group, chunk) owns steps [16 group, + 16)
// and tier rows [c0, c0 + Kc), Kc a multiple of 64 (the host's plan):
//   count  the group's 16 x 8K starts counted into uint32 N[i, s - c0 + 8]
//          in shared memory for s in [c0 - 7, c0 + Kc): each warp queues
//          its hits (a ballot) and adds them with whole-warp shared atomics.
//          The starts are checked in block_finish_kernel: an assert here
//          (a call) slowed the whole kernel on an H100.
//   digits bf16 holds integers exactly only up to 256, so each count goes
//          in as base-256 digits, digit d as the bf16 value digit x 256^d
//          (8 significant bits: exact), every digit into the same
//          accumulators (as csrc/microbench_mxu.cu); a block runs the
//          digits some count of its chunk has. Digit d's counts are laid
//          out twice in bf16, at even and at odd offsets, so that every
//          pair (c - j, c - j + 1) of an A fragment is one aligned 32-bit
//          shared load whatever the shift; stage by stage, while the stage
//          before runs.
//   stage  64 tier rows at a time through registers (the next stage's loads
//          in flight during this one's products), each float32 split
//          exactly into three bf16 pieces by bit masks: hi = x's top 16
//          bits, mid = the top 16 bits of x - hi, lo = x - hi - mid (8
//          significant bits each; exact for finite |x| >= 2^-110 and 0),
//          stored as K-major core matrices (8 columns x 8 k, 128 bytes;
//          8-column groups 1,040 bytes apart, so that a warp's 16-byte
//          stores spread over the banks); three stages in turn.
//   mma    each warpgroup (4 warps) its 64 rows x 128 columns: wgmma
//          m64n128k16 bf16, A (the shifted digits) in registers as
//          mma.sync m16n8k16 holds it, B (a piece) out of shared memory,
//          float32 accumulators, the three pieces into the same
//          accumulators; a stage's 12 products one group, the next stage
//          laid out while it runs, the group before waited for.
//   out    the block's 128 x 128 partial through shared memory into
//          partial[chunk] (or, with one chunk, into out); block_finish_kernel
//          adds the chunks in chunk order. No float atomics: the result is
//          the same from run to run.
// A non-finite tier value reaches every output row of the groups whose
// chunk holds it (0 x inf is NaN in the product), where the L2 kernel
// carries it only to the rows that read it.

constexpr int kBsSteps = 16;              // steps a block: 128 rows with the 8 shifts
constexpr int kBsSub = 64;                // tier rows staged at a time
constexpr int kBsLbo = 128;               // B: bytes between core matrices along k
constexpr int kBsSbo = 8 * 128 + 16;      // B: bytes between 8-column groups (16 pad: banks)
constexpr int kBsPiece = kD / 8 * kBsSbo; // bytes of a staged piece (64 k x 128 columns)
constexpr int kBsStages = 3;              // staged in turn: one read, one running, one filling
constexpr int kBsThreads = 256;
constexpr int kBsLoads = kBsSub * kD4 / kBsThreads;  // tier float4 a thread a stage
constexpr int kBsGap = 32;                // bf16 between the even and odd counts: 16 banks
constexpr int kBsInFlight = 8;            // int4 loads of starts in flight a thread
constexpr int kBsLdO = kD + 8;            // padded row of the partial in shared memory (float)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d (this warp's 16 of the warpgroup's 64 rows x 128 columns, float32) +=
// a b on the tensor cores: wgmma m64n128k16 bf16, A (the warp's 16 x 16) in
// registers as mma.sync m16n8k16 holds it, B (16 x 128) in shared memory as
// K-major core matrices by its descriptor (bs_desc). Asynchronous: d and a
// are not touched until wgmma_wait.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warp's products run.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators stay where the asynchronous products left them: no
// access of the compiler's moves across this point.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A registers of a group in flight stay live (and unmoved) up to here.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kBsSub / 16][4]) {
#pragma unroll
  for (int kb = 0; kb < kBsSub / 16; ++kb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kb][i])::"memory");
  }
}

// Shared-memory stores made visible to the tensor cores' (async proxy) reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of a K-major B tile at p: core matrices of 8 columns x 8
// k (128 bytes), kBsLbo bytes apart along k and kBsSbo apart along the
// columns, no swizzle.
__device__ __forceinline__ uint64_t bs_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(kBsLbo >> 4) << 16) | (static_cast<uint64_t>(kBsSbo >> 4) << 32);
}

// digit d of two counts as bf16 values digit x 256^d (exact), lo in the
// low half
__device__ __forceinline__ uint32_t digit_pair(uint32_t lo, uint32_t hi, int d, float scale) {
  const float flo = __uint2float_rn((lo >> (8 * d)) & 0xffu) * scale;
  const float fhi = __uint2float_rn((hi >> (8 * d)) & 0xffu) * scale;
  return (__float_as_uint(flo) >> 16) | (__float_as_uint(fhi) & 0xffff0000u);
}

// The three bf16 pieces (hi, mid, lo) of a float32, hi + mid + lo == x,
// each as a float32 whose low 16 bits are 0.
__device__ __forceinline__ void split3(float x, uint32_t (&p)[3]) {
  p[0] = __float_as_uint(x) & 0xffff0000u;
  const float r = x - __uint_as_float(p[0]);
  p[1] = __float_as_uint(r) & 0xffff0000u;
  p[2] = __float_as_uint(r - __uint_as_float(p[1]));
}

// The bf16 pair (a, b) of two pieces, a in the low half.
__device__ __forceinline__ uint32_t bf16_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// The shared memory of a block of Kc-row chunks, in bytes.
size_t bs_smem(int Kc) {
  return sizeof(uint32_t) * kBsSteps * (Kc + 8) +                     // counts
         sizeof(uint16_t) * (2 * kBsSteps * (Kc + 16) + kBsGap) +     // even, odd digits
         kBsStages * 3 * kBsPiece;                                    // stages of pieces
}

__global__ void __launch_bounds__(kBsThreads, 1)
block_count_kernel(const int32_t* __restrict__ starts, const float4* __restrict__ tier,
                   float* __restrict__ dst, int64_t R, int K, int64_t C, int Kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldN = Kc + 8, ldE = Kc + 16;
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(smem);                        // (16, ldN)
  uint16_t* s_even = reinterpret_cast<uint16_t*>(s_cnt + kBsSteps * ldN);     // (16, ldE)
  uint16_t* s_odd = s_even + kBsSteps * ldE + kBsGap;                          // (16, ldE)
  unsigned char* s_p = reinterpret_cast<unsigned char*>(s_odd + kBsSteps * ldE);  // stages x 3
  __shared__ uint32_t s_or;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kBsSteps;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * Kc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // count the group's starts that a row of this chunk reads
  for (int e = threadIdx.x; e < kBsSteps * ldN / 4; e += kBsThreads) {
    reinterpret_cast<uint4*>(s_cnt)[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) s_or = 0u;
  __syncthreads();
  const int per_step = 8 * K;  // a multiple of 8: whole int4s
  const int n4 = static_cast<int>((R - i0 < kBsSteps ? R - i0 : kBsSteps) * per_step / 4);
  const int4* st4 = reinterpret_cast<const int4*>(starts + i0 * per_step);
  const unsigned window = static_cast<unsigned>(Kc + 7);
  // the warp's hits, (step << 16) | (s - c0 + 8), queued in the stage buffer
  // (free until the products) and counted with whole-warp shared atomics
  uint32_t* queue = reinterpret_cast<uint32_t*>(s_p) + warp * (32 * 4 * kBsInFlight);
  const uint32_t below = (1u << lane) - 1u;
  for (int e0 = 0; e0 < n4; e0 += kBsInFlight * kBsThreads) {  // uniform across the block
    int4 v[kBsInFlight];
#pragma unroll
    for (int u = 0; u < kBsInFlight; ++u) {
      const int e = e0 + threadIdx.x + u * kBsThreads;
      if (e < n4) v[u] = __ldg(st4 + e);
    }
    int n = 0;
#pragma unroll
    for (int u = 0; u < kBsInFlight; ++u) {
      const int e = e0 + threadIdx.x + u * kBsThreads;
      const bool in = e < n4;
      const int step = 4 * e / per_step;
      const int s[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned d = static_cast<unsigned>(s[q] - c0 + 7);  // s - c0 + 8 - 1
        const bool hit = in && d < window;
        const unsigned b = __ballot_sync(kFull, hit);
        if (hit) queue[n + __popc(b & below)] = (static_cast<uint32_t>(step) << 16) | (d + 1u);
        n += __popc(b);
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const uint32_t h = queue[i];
      atomicAdd(s_cnt + (h >> 16) * ldN + (h & 0xffffu), 1u);
    }
    __syncwarp();
  }
  __syncthreads();
  uint32_t bits = 0u;
  for (int e = threadIdx.x; e < kBsSteps * ldN; e += kBsThreads) bits |= s_cnt[e];
  bits = __reduce_or_sync(kFull, bits);
  if (lane == 0 && bits != 0u) atomicOr(&s_or, bits);
  __syncthreads();
  const uint32_t used = s_or;

  // warp w: rows [16 w, + 16) (steps 2w and 2w + 1 at the 8 shifts), all
  // 128 columns; warps 0-3 and 4-7 each one warpgroup of 64 rows
  const int g = lane / 4, t = lane % 4;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  // the lane's A pairs (c - g, c - g + 1): even g at even offsets, odd g at
  // odd ones, both one aligned 32-bit load
  const uint16_t* a_row = ((g % 2 == 0) ? s_even + 8 - g : s_odd + 9 - g) + 2 * warp * ldE;
  const int nsub = Kc / kBsSub;
  float scale = 1.f;
  for (int d = 0; d < 4; ++d, scale *= 256.f) {
    if (((used >> (8 * d)) & 0xffu) == 0u) continue;
    // thread (warp, lane) stages tier rows [8 warp, + 8) of a stage, columns
    // [4 lane, + 4): 8 k of one column a 16-byte store
    float4 v[kBsLoads];
    auto load = [&](int sub) {
#pragma unroll
      for (int u = 0; u < kBsLoads; ++u) {
        const int64_t c = c0 + sub * kBsSub + 8 * warp + u;
        v[u] = c < C ? __ldg(tier + c * kD4 + lane) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    // digit d of the counts at [q0, q1) (even) into the even and odd copies:
    // stage sub reads [64 sub + 1, 64 sub + 72), so each stage lays out
    // [64 sub + 8, + 64) (stage 0 from 0) while the stage before runs
    auto digits = [&](int q0, int q1) {
      const int pairs = (q1 - q0) / 2;
      for (int e = threadIdx.x; e < kBsSteps * pairs; e += kBsThreads) {
        const int i = e / pairs, q = q0 + 2 * (e % pairs);
        const uint32_t* n = s_cnt + i * ldN + q;
        *reinterpret_cast<uint32_t*>(s_even + i * ldE + q) = digit_pair(n[0], n[1], d, scale);
        *reinterpret_cast<uint32_t*>(s_odd + i * ldE + q) =
            digit_pair(q == 0 ? 0u : n[-1], n[0], d, scale);
      }
    };
    load(0);          // in flight while the digits are laid out
    __syncthreads();  // the previous digit's products are done with the digits
    digits(0, kBsSub + 8);
    // column i of the thread's 4 as pieces into stage sub % kBsStages
    auto stage_column = [&](int sub, int i) {
      unsigned char* dst = s_p + (sub % kBsStages) * 3 * kBsPiece + warp * kBsLbo;
      uint32_t x[kBsLoads][3];
#pragma unroll
      for (int u = 0; u < kBsLoads; ++u) {
        split3(i == 0 ? v[u].x : i == 1 ? v[u].y : i == 2 ? v[u].z : v[u].w, x[u]);
      }
      const int n = 4 * lane + i;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        *reinterpret_cast<uint4*>(dst + p * kBsPiece + (n / 8) * kBsSbo + (n % 8) * 16) =
            make_uint4(bf16_pair(x[0][p], x[1][p]), bf16_pair(x[2][p], x[3][p]),
                       bf16_pair(x[4][p], x[5][p]), bf16_pair(x[6][p], x[7][p]));
      }
    };
    // stage sub's products: A (the digits) in af, issued as one group; the
    // next stage laid out while they run; then the wait for the group
    // before (its A registers, before, and its stage free again)
    auto run_stage = [&](int sub, uint32_t (&af)[kBsSub / 16][4],
                         uint32_t (&before)[kBsSub / 16][4]) {
#pragma unroll
      for (int kb = 0; kb < kBsSub / 16; ++kb) {
        const uint16_t* a0 = a_row + sub * kBsSub + 16 * kb + 2 * t;
        af[kb][0] = *reinterpret_cast<const uint32_t*>(a0);
        af[kb][1] = *reinterpret_cast<const uint32_t*>(a0 + ldE);
        af[kb][2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
        af[kb][3] = *reinterpret_cast<const uint32_t*>(a0 + ldE + 8);
      }
      const unsigned char* pieces = s_p + (sub % kBsStages) * 3 * kBsPiece;
      const bool more = sub + 1 < nsub;
      wgmma_fence();
      fence_regs(acc);
#pragma unroll
      for (int kb = 0; kb < kBsSub / 16; ++kb) {
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          wgmma_bf16(acc, af[kb], bs_desc(pieces + p * kBsPiece + kb * 2 * kBsLbo));
        }
      }
      wgmma_commit();
      if (more) {
#pragma unroll
        for (int i = 0; i < 4; ++i) stage_column(sub + 1, i);
        fence_async_smem();
        if (sub + 2 < nsub) load(sub + 2);
        digits((sub + 1) * kBsSub + 8, (sub + 2) * kBsSub + 8);
      }
      wgmma_wait<1>();
      fence_regs(acc);
      fence_regs(before);
      __syncthreads();  // stage sub + 1 is in place; stage sub - 1 is free for sub + 2
    };
#pragma unroll
    for (int i = 0; i < 4; ++i) stage_column(0, i);
    fence_async_smem();
    if (nsub > 1) load(1);
    __syncthreads();  // the digits and stage 0 are in place
    uint32_t af0[kBsSub / 16][4], af1[kBsSub / 16][4];
    for (int sub = 0; sub < nsub; sub += 2) {  // two register sets of A in turn
      run_stage(sub, af0, af1);
      if (sub + 1 < nsub) run_stage(sub + 1, af1, af0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(af0);
    fence_regs(af1);
  }
  __syncthreads();  // every warpgroup's products are done with the stages
  // the partial through shared memory (over the stages), then whole rows:
  // row 16 warp + g (+ 8) is output row 128 group + that
  float* s_out = reinterpret_cast<float*>(s_p);  // (128, kBsLdO)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<float2*>(s_out + (16 * warp + g + 8 * h) * kBsLdO + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  __syncthreads();
  const int64_t rows = 8 * R;
  float4* part = reinterpret_cast<float4*>(dst + static_cast<int64_t>(blockIdx.y) * rows * kD);
  for (int e = threadIdx.x; e < 8 * kBsSteps * kD4; e += kBsThreads) {
    const int64_t row = 8 * i0 + e / kD4;
    if (row < rows) {
      part[row * kD4 + e % kD4] = *reinterpret_cast<const float4*>(s_out + (e / kD4) * kBsLdO +
                                                                   4 * (e % kD4));
    }
  }
}

// The count kernel's second launch: every start checked (a start outside
// [0, C - 8] stops it with a device-side assertion; the count kernel holds
// no assert, whose call would constrain its code, and counts only starts
// inside its window, so a bad start reads nothing outside its arrays),
// then, with more than one chunk, out[e] = the sum over chunks q in order
// of partial[q][e], e a float4 of the (rows, 128) output.
__global__ void __launch_bounds__(kGatherThreads)
block_finish_kernel(const int4* __restrict__ starts4, int64_t n_starts4, int64_t C,
                    const float4* __restrict__ partial, float4* __restrict__ out, int64_t n4,
                    int chunks) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kGatherThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGatherThreads;
  bool bad = false;
  for (int64_t i = e; i < n_starts4; i += stride) {
    const int4 s = __ldg(starts4 + i);
    bad |= s.x < 0 || s.y < 0 || s.z < 0 || s.w < 0;
    bad |= s.x > C - 8 || s.y > C - 8 || s.z > C - 8 || s.w > C - 8;
  }
  assert(!bad);
  if (chunks == 1 || e >= n4) return;
  float4 acc = partial[e];
  for (int q0 = 1; q0 < chunks; q0 += 8) {  // 8 loads in flight, added in chunk order
    float4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = q0 + u < chunks ? partial[(q0 + u) * n4 + e] : v[0];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (q0 + u < chunks) add4(acc, v[u]);
    }
  }
  out[e] = acc;
}

}  // namespace

extern "C" {

// Every array is a contiguous device array, float4-aligned where it holds
// rows; each function returns a cudaError_t.

// cols int32 (n_out, K), vals float32 (n_out, K), tier float32 (C, 128),
// out float32 (n_out, 128).
int ofs_gather_ell_reduce(const void* cols, const void* vals, const void* tier, void* out,
                          int64_t n_out, int K, int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (K <= 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ell_reduce_kernel<<<blocks_for(n_out, kWarpsPerBlock), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float*>(vals),
      static_cast<const float4*>(tier), static_cast<float4*>(out), n_out, K, C);
  return static_cast<int>(cudaGetLastError());
}

// cols int32 (T,), tier float32 (C, 128), out float32 (T, 128).
int ofs_gather_vmem_take(const void* cols, const void* tier, void* out, int64_t T, int64_t C,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_row_gather<float, false>(cols, nullptr, T, tier, nullptr, out, T, C, C,
                                         static_cast<cudaStream_t>(stream));
}

// bf16: tier bfloat16 (else float32) (C, 128); cols int32 (T,); out
// float32 (T, 128).
int ofs_gather_onehot(int bf16, const void* cols, const void* tier, void* out, int64_t T,
                      int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_row_gather<__nv_bfloat16, true>(cols, nullptr, T, tier, nullptr, out, T,
                                                       C, C, st)
              : launch_row_gather<float, true>(cols, nullptr, T, tier, nullptr, out, T, C, C, st);
}

// starts int32 (8 R, K), tier float32 (C, 128), out float32 (8 R, 128).
// Kc = 0: the L2 kernel. Else the count-matrix kernel on chunks of Kc tier
// rows (a multiple of 64), starts 16-byte aligned, and where C > Kc
// partial float32 (ceil(C / Kc), 8 R, 128) (else unused).
int ofs_gather_block_slice(const void* starts, const void* tier, void* out, void* partial,
                           int64_t R, int K, int64_t C, int Kc, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  int optin = 0;
  err = smem_optin(device, &optin);
  if (err != cudaSuccess) return fail(err);
  if (K <= 0 || C < 8 || R > 0x7fffffff || Kc < 0 || Kc % kBsSub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (Kc == 0) {
    const size_t smem = sizeof(int32_t) * 8 * static_cast<size_t>(K);
    if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(block_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return fail(err);
    block_slice_kernel<<<static_cast<unsigned>(R), kWarpsPerBlock * 32, smem, st>>>(
        static_cast<const int32_t*>(starts), static_cast<const float4*>(tier),
        static_cast<float4*>(out), K, C);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t chunks = (C + Kc - 1) / Kc, groups = (R + kBsSteps - 1) / kBsSteps;
  const size_t smem = bs_smem(Kc);
  if (smem > static_cast<size_t>(optin) || chunks > 65535 ||
      reinterpret_cast<uintptr_t>(starts) % 16 != 0 || (chunks > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaFuncSetAttribute(block_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  block_count_kernel<<<dim3(static_cast<unsigned>(groups), static_cast<unsigned>(chunks)),
                       kBsThreads, smem, st>>>(
      static_cast<const int32_t*>(starts), static_cast<const float4*>(tier),
      static_cast<float*>(chunks > 1 ? partial : out), R, K, C, Kc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = 8 * R * kD4, n_starts4 = 8 * R * K / 4;
  const int64_t threads = chunks > 1 ? n4 : n_starts4 / 8;  // the check alone: 8 loads a thread
  block_finish_kernel<<<blocks_for(threads > 0 ? threads : 1, kGatherThreads), kGatherThreads, 0,
                        st>>>(static_cast<const int4*>(starts), n_starts4, C,
                              static_cast<const float4*>(partial), static_cast<float4*>(out), n4,
                              static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

// cols int32 (n_out K,), table float32 (C, 128), out float32 (n_out, 128);
// W rows in flight per warp, 1 <= W <= 256.
int ofs_gather_row_sum(const void* cols, const void* table, void* out, int64_t n_out, int K,
                       int W, int64_t C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  if (K <= 0 || W <= 0 || W > 256 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = smem_optin(device, &optin);
  if (err != cudaSuccess) return fail(err);
  const int warps = warps_per_block(W, optin);
  const size_t smem = static_cast<size_t>(warps) * W * kD * sizeof(float);
  err = cudaFuncSetAttribute(row_sum_async_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  row_sum_async_kernel<<<blocks_for(n_out, warps), warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const float4*>(table),
      static_cast<float4*>(out), n_out, K, W, C);
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
