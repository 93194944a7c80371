// Hand-written Hopper (sm_90a) kernels of the second-round gather
// microbenchmark (of_spmm_tpu_torch/tools/microbench_gather2.py), for the
// TPU kernels of tools/microbench_gather2.py (pallas_call line):
//
//   onehot_pair  bench_onehot_pair (:57): out[t] = f32(hi[c]) + f32(lo[c]),
//                c = cols[t], an index outside [0, C) giving a zero row.
//   window_pair  bench_window_pair (:210): out[t] = f32(hi[b + l]) + f32(lo[b + l]),
//                l = lidx[t], b the base of step t / TILE, an l outside
//                [0, CW) giving a zero row.
//                The TPU forms both as one-hot products over the C- or
//                CW-row window on its matrix unit, one one-hot feeding the
//                hi and the lo product; its cost grows with the window
//                while the function is a row gather. So here both are
//                csrc/gather.cuh's row_gather_kernel<__nv_bfloat16, true>,
//                the kernel of vmem_take and onehot, with a second table
//                and (window_pair) a base per step: one thread per float4
//                of the output, the row's index and base loaded once for
//                its 32 threads, 8 bytes of hi and 8 of lo a thread read
//                through L1 / L2 (the tables are 32-64 KB for onehot_pair,
//                4.3 MB each for window_pair) and widened, hi + lo added in
//                float32, the 512 MB output written with streaming stores.
//                Each one-hot sum held one product of 1 by a bf16 value, so
//                the result is the same bit for bit.
//   take_fused   bench_take_fused (:95): out[n] = sum_{k < 8} vals[n, k]
//                tier[cols[n, k]]; and
//   dma_deep     bench_dma_deep (:150): out[o] = sum_{m < 128}
//                table[cols.flat[128 o + m]] from a 1 GiB table in device
//                memory, W rows in flight per warp: the same functions as
//                vmem_loop and row_dma at other widths, so they launch
//                csrc/microbench_gather.cu's ofs_gather_ell_reduce and
//                ofs_gather_row_sum (ops/cuda/microbench_gather2.py).
//   twosided     bench_twosided (:294): out (R, 128) = sum over every lane t of
//                f32(c_hi) + f32(c_lo) into row rows[t], where c is the
//                window pair gather of lane t times vals[t], c_hi = bf16(c)
//                and c_lo = bf16(c - f32(c_hi)), rounded to nearest even.
//                The TPU carries an (R, 128) accumulator across its
//                sequential grid, and gathers and scatters with one-hot
//                products. Hopper has no sequential grid, and both products
//                are row moves. twosided_kernel below: about one block of
//                1,024 threads per SM, each over a contiguous range of
//                lanes; each lane's window row of hi and lo loaded directly
//                (the lanes come sorted by source row, so L1 serves the
//                repeats); a warp adds one lane's 128 columns at a time,
//                with four lanes' loads in flight, into the block's own
//                float32 (S, 128) partial in shared memory, 4 columns a
//                thread with one 16-byte compare-and-swap (S rows as many
//                as the opt-in limit holds, row slices on gridDim.z);
//                then each block adds its partial into the zeroed output
//                once, with float4 atomics (red.global.add.v4.f32): about
//                132-way contention per address where one atomic per lane
//                and float4 had about 4,096-way at R = 256. Atomics rather
//                than partials and a second reduction kernel: one launch,
//                and the partials stay in L2. The order of the adds varies
//                from run to run (the tolerance is normwise). What holds it
//                above its bound is the instruction rate, not bytes: some
//                40 instructions a thread per lane, most of them the bf16
//                split and the compare-and-swap.
//
// What bounds them on the H100 (utils/roofline.py): bytes, the rows the
// lanes select and the float32 output (twosided: its (R, 128) output and
// the lanes' rows and values). The one-hot multiply-adds the TPU kernels
// prescribe (C or CW x 128 per lane and table) are reported beside the
// bound as the TPU's count; these kernels perform none.
//
// A row outside [0, R) stops twosided with a device-side assertion, as
// does a window base with b + CW past the table (window_pair, twosided);
// an index outside a one-hot window gives a zero row.

#include "gather.cuh"

namespace {

using namespace ofs_gather;

// c split into bf16 halves, each rounded to nearest even, and added back,
// two values at a time.
__device__ __forceinline__ float2 split2(const float a, const float b) {
  const float2 h = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  const float2 l = __bfloat1622float2(__floats2bfloat162_rn(a - h.x, b - h.y));
  return make_float2(h.x + l.x, h.y + l.y);
}

// acc[0 .. 3] += c in shared memory as one 16-byte compare-and-swap loop
// (atom.shared.cas.b128): a float32 atomic add to shared memory is itself
// a compare-and-swap loop on this card, one per value.
__device__ __forceinline__ void add4_shared(float* acc, const float4 c) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(acc));
  float4 old = *reinterpret_cast<const float4*>(acc);
  for (;;) {
    const unsigned long long o0 = (static_cast<unsigned long long>(__float_as_uint(old.y)) << 32) |
                                  __float_as_uint(old.x);
    const unsigned long long o1 = (static_cast<unsigned long long>(__float_as_uint(old.w)) << 32) |
                                  __float_as_uint(old.z);
    const unsigned long long n0 =
        (static_cast<unsigned long long>(__float_as_uint(old.y + c.y)) << 32) |
        __float_as_uint(old.x + c.x);
    const unsigned long long n1 =
        (static_cast<unsigned long long>(__float_as_uint(old.w + c.w)) << 32) |
        __float_as_uint(old.z + c.z);
    unsigned long long r0, r1;
    asm volatile(
        "{\n\t.reg .b128 cmp, val, res;\n\t"
        "mov.b128 cmp, {%2, %3};\n\t"
        "mov.b128 val, {%4, %5};\n\t"
        "atom.shared.cas.b128 res, [%6], cmp, val;\n\t"
        "mov.b128 {%0, %1}, res;\n\t}"
        : "=l"(r0), "=l"(r1)
        : "l"(o0), "l"(o1), "l"(n0), "l"(n1), "r"(at)
        : "memory");
    if (r0 == o0 && r1 == o1) return;
    old = make_float4(__uint_as_float(static_cast<unsigned>(r0)),
                      __uint_as_float(static_cast<unsigned>(r0 >> 32)),
                      __uint_as_float(static_cast<unsigned>(r1)),
                      __uint_as_float(static_cast<unsigned>(r1 >> 32)));
  }
}

constexpr int kTsThreads = 1024;
constexpr int kTsBatch = 4;  // lanes a warp has in flight

// Block (x, 0, z) adds lanes [x L, x L + L) into output rows [z S, z S + S).
// A warp takes 32 lanes at a time, one per thread (its row, window row and
// value), keeps those whose row is the block's and whose window index is
// in [0, cw) (ballot), and adds them kTsBatch at a time, their loads in
// flight together: one lane's 128 columns per warp instruction, 4 a
// thread, into the block's partial acc (S, 128) in shared memory with one
// 16-byte compare-and-swap per thread. (A warp that adds to several rows in one
// instruction serialises on this card's shared atomics, so a warp adds one
// row at a time.) The lanes come sorted by window row: a warp loads and
// widens a window row once for its run of lanes (about 5). A lane outside
// its window adds c = 0 x vals[t], which (for a finite value) changes
// nothing: it is skipped. Then the block adds its partial into out, one
// float4 atomic per nonzero piece.
__global__ void __launch_bounds__(kTsThreads, 1)
twosided_kernel(const int32_t* __restrict__ bases, const int32_t* __restrict__ lidx,
                const int32_t* __restrict__ rows, const float* __restrict__ vals,
                const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ lo,
                float* __restrict__ out, int64_t T, int64_t tile, int cw, int64_t n_rows, int R,
                int S, int64_t L) {
  extern __shared__ float4 acc4[];
  float* acc = reinterpret_cast<float*>(acc4);
  const int r0 = blockIdx.z * S, nr = min(S, R - r0);
  for (int e = threadIdx.x; e < nr * 32; e += kTsThreads) acc4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int64_t t_end = min(T, static_cast<int64_t>(blockIdx.x + 1) * L);
  int last = -1;  // the window row in g (warp-uniform)
  float4 g;
  for (int64_t t0 = blockIdx.x * L + (threadIdx.x / 32) * 32; t0 < t_end; t0 += kTsThreads) {
    int m_row = 0, m_src = 0;
    float m_val = 0.f;
    bool mine = false;
    if (t0 + lane < t_end) {
      const int64_t t = t0 + lane;
      const int32_t row = rows[t], l = lidx[t];
      const int64_t b = bases[t / tile];
      assert(row >= 0 && row < R);
      assert(b >= 0 && b + cw <= n_rows);
      mine = row >= r0 && row - r0 < nr && l >= 0 && l < cw;
      if (mine) {
        m_row = row - r0;
        m_src = static_cast<int>(b + l);
        m_val = vals[t];
      }
    }
    for (unsigned mask = __ballot_sync(kFull, mine); mask != 0;) {
      int row[kTsBatch], src[kTsBatch];
      float v[kTsBatch];
      uint2 wh[kTsBatch], wl[kTsBatch];
#pragma unroll
      for (int u = 0; u < kTsBatch; ++u) {  // mask is the warp's: every branch is uniform
        const int j = mask == 0 ? 0 : __ffs(mask) - 1;
        row[u] = mask == 0 ? -1 : __shfl_sync(kFull, m_row, j);
        src[u] = __shfl_sync(kFull, m_src, j);
        v[u] = __shfl_sync(kFull, m_val, j);
        mask &= mask - 1;
        if (row[u] >= 0 && src[u] != (u == 0 ? last : src[u - 1])) {
          const int64_t at = static_cast<int64_t>(src[u]) * kD;
          wh[u] = __ldg(reinterpret_cast<const uint2*>(hi + at) + lane);
          wl[u] = __ldg(reinterpret_cast<const uint2*>(lo + at) + lane);
        }
      }
#pragma unroll
      for (int u = 0; u < kTsBatch; ++u) {
        if (row[u] < 0) continue;
        if (src[u] != last) {
          const float4 h = widen4(wh[u]), l = widen4(wl[u]);
          g = make_float4(h.x + l.x, h.y + l.y, h.z + l.z, h.w + l.w);
          last = src[u];
        }
        const float2 c01 = split2(g.x * v[u], g.y * v[u]);
        const float2 c23 = split2(g.z * v[u], g.w * v[u]);
        add4_shared(acc + row[u] * kD + 4 * lane, make_float4(c01.x, c01.y, c23.x, c23.y));
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * 32; e += kTsThreads) {
    const float4 add = acc4[e];
    if (add.x != 0.f || add.y != 0.f || add.z != 0.f || add.w != 0.f) {
      atomicAdd(reinterpret_cast<float4*>(out + static_cast<int64_t>(r0) * kD) + e, add);
    }
  }
}

int check_window(int64_t T, int64_t tile, int cw, int64_t n_rows) {
  if (tile <= 0 || T % tile != 0 || cw <= 0 || cw > n_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// Every array is a contiguous device array, float4-aligned where it holds
// rows; each function returns a cudaError_t.

// cols int32 (T,); hi, lo bfloat16 (C, 128); out float32 (T, 128).
int ofs_gather2_onehot_pair(const void* cols, const void* hi, const void* lo, void* out, int64_t T,
                            int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (const int rc = check_window(T, T, C, C)) return rc;
  return launch_row_gather<__nv_bfloat16, true>(cols, nullptr, T, hi, lo, out, T, C, C,
                                                static_cast<cudaStream_t>(stream));
}

// bases int32 (T / tile,), lidx int32 (T,), hi, lo bfloat16 (n_rows, 128),
// out float32 (T, 128); tile dividing T; 0 < cw <= n_rows.
int ofs_gather2_window_pair(const void* bases, const void* lidx, const void* hi, const void* lo,
                            void* out, int64_t T, int64_t tile, int cw, int64_t n_rows,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (const int rc = check_window(T, tile, cw, n_rows)) return rc;
  return launch_row_gather<__nv_bfloat16, true>(lidx, bases, tile, hi, lo, out, T, cw, n_rows,
                                                static_cast<cudaStream_t>(stream));
}

// As window_pair, plus rows int32 (T,) in [0, R) and vals float32 (T,); out
// float32 (R, 128), zeroed by the caller and added into. The table has at
// most 2^31 - 1 rows.
int ofs_gather2_twosided(const void* bases, const void* lidx, const void* rows, const void* vals,
                         const void* hi, const void* lo, void* out, int64_t T, int64_t tile,
                         int cw, int64_t n_rows, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) return 0;
  if (R <= 0 || n_rows > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (const int rc = check_window(T, tile, cw, n_rows)) return rc;
  int optin = 0, sms = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return fail(err);
  // S rows a block, as many as the opt-in limit holds (512 bytes a row),
  // balanced over gz row slices; about one block per SM
  const int row_bytes = kD * static_cast<int>(sizeof(float));
  const int gz = (R + optin / row_bytes - 1) / (optin / row_bytes);
  const int S = (R + gz - 1) / gz;
  const size_t smem = static_cast<size_t>(S) * row_bytes;
  err = cudaFuncSetAttribute(twosided_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return fail(err);
  const int gx = max(1, sms / gz);
  const int64_t L = (T + 32LL * gx - 1) / (32LL * gx) * 32;
  twosided_kernel<<<dim3(gx, 1, gz), kTsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bases), static_cast<const int32_t*>(lidx),
      static_cast<const int32_t*>(rows), static_cast<const float*>(vals),
      static_cast<const __nv_bfloat16*>(hi), static_cast<const __nv_bfloat16*>(lo),
      static_cast<float*>(out), T, tile, cw, n_rows, R, S, L);
  return static_cast<int>(cudaGetLastError());
}

const char* ofs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
