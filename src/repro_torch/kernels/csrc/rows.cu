// Per-row compression kernels of the fleet engine's client pass, for Hopper
// (sm_90a). One row is one client's flattened D-dim message; rows come from a
// client block of the engine (4096 x 32 at the headline fleet config).
//
//   topk_rows     <- repro/kernels/topk_mask.py::topk_rows_pallas
//   qsgd_rows     <- repro/kernels/qsgd.py::qsgd_rows_pallas
//   sign_ef_rows  <- repro/kernels/sign_ef.py::sign_ef_rows_pallas
//
// All three are bound by device-memory bytes (a few flops per element):
// topk reads x and writes the masked row (8 B/elem), qsgd reads x, u and
// writes the output (12 B/elem + one norm per row), sign_ef reads x, e and
// writes c, e' (16 B/elem). The design keeps every reduction on-chip:
//
// * rows of width <= 1024 map to one warp each, eight rows per 256-thread
//   block; a lane keeps its VPT = pow2ceil(D/32) values in registers, so a
//   32-wide row costs one load per lane and the 25 bisection reductions of
//   topk are warp shuffles, with no shared memory and no second read;
// * wider rows get a 512-thread block each. topk caches the row in dynamic
//   shared memory when it fits (D <= 50176 floats) and otherwise re-reads it
//   per step (from L2); sign_ef reduces in one pass and recomputes in a
//   second;
// * qsgd needs no reduction once the per-row norms are an operand, so it is
//   a flat elementwise pass;
// * no padding: each kernel masks the ragged edge itself, and sign_ef divides
//   by the real width d.
//
// Numerics: topk is exact (max, halvings and integer counts below 2^24), and
// qsgd is bitwise equal to its plain PyTorch version when built with
// -fmad=false (IEEE division is nvcc's default). sign_ef sums in another
// order than the plain version and agrees to a tolerance.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBisect = 24;          // N_BISECT of the TPU kernel
constexpr int kWarpRowsMax = 1024;   // widest row on the warp-per-row path
constexpr int kRowThreads = 512;     // threads of the block-per-row path
constexpr int kSmemRowMax = 50176;   // floats of a row cached in shared memory

__device__ __forceinline__ float sgnf(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block-wide reductions over kRowThreads threads; `red` holds 32 slots. Each
// call starts with a barrier so that `red` may be reused back to back.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  return red[0];
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  return red[0];
}

__device__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum_int(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0;
  if (warp == 0) v = warp_sum_int(v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  return red[0];
}

// ---------------------------------------------------------------- top-k ---
// Per row: hi = max|x|, lo = 0; 24 times mid = 0.5 (lo + hi), count |x| >= mid
// and move lo up when the count exceeds k; keep x where |x| >= lo.

template <int VPT>
__global__ void topk_rows_warp(const float* __restrict__ x,
                               float* __restrict__ out, int rows, int d,
                               const float* __restrict__ kp) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const float k = *kp;
  const float* xr = x + (size_t)row * d;
  float v[VPT], a[VPT];
  float hi = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < d ? xr[c] : 0.f;
    a[j] = c < d ? fabsf(v[j]) : -1.f;  // never counted: mid >= 0
    hi = fmaxf(hi, a[j]);
  }
  hi = warp_max(hi);
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) cnt += a[j] >= mid;
    cnt = warp_sum_int(cnt);
    const bool take_hi = (float)cnt > k;
    lo = take_hi ? mid : lo;
    hi = take_hi ? hi : mid;
  }
  float* orow = out + (size_t)row * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if (c < d) orow[c] = a[j] >= lo ? v[j] : 0.f;
  }
}

__global__ void topk_rows_block(const float* __restrict__ x,
                                float* __restrict__ out, int d,
                                const float* __restrict__ kp, int cache) {
  extern __shared__ float smem[];
  float* red = smem;         // 32 reduction slots
  float* row = smem + 32;    // the cached row, when `cache`
  const float k = *kp;
  const float* xr = x + (size_t)blockIdx.x * d;
  float hi = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float xv = xr[c];
    if (cache) row[c] = xv;
    hi = fmaxf(hi, fabsf(xv));
  }
  hi = block_max(hi, red);  // its barriers also publish `row`
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      cnt += fabsf(cache ? row[c] : xr[c]) >= mid;
    cnt = block_sum_int(cnt, reinterpret_cast<int*>(red));
    const bool take_hi = (float)cnt > k;
    lo = take_hi ? mid : lo;
    hi = take_hi ? hi : mid;
  }
  float* orow = out + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float xv = cache ? row[c] : xr[c];
    orow[c] = fabsf(xv) >= lo ? xv : 0.f;
  }
}

// ----------------------------------------------------------------- QSGD ---
// scaled = |x| / max(norm, 1e-30) * L; q = (floor(scaled) + [u < frac]) / L;
// out = sign(x) * q * norm. `levels` is already clamped to >= 1.

__global__ void qsgd_rows_kernel(const float* __restrict__ x,
                                 const float* __restrict__ u,
                                 const float* __restrict__ norms,
                                 float* __restrict__ out, unsigned n,
                                 unsigned d, const float* __restrict__ lp) {
  const float levels = *lp;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float nm = norms[i / d];
    const float xv = x[i];
    const float scaled = fabsf(xv) / fmaxf(nm, 1e-30f) * levels;
    const float lower = floorf(scaled);
    const float up = u[i] < scaled - lower ? 1.f : 0.f;
    const float q = (lower + up) / levels;
    out[i] = sgnf(xv) * q * nm;
  }
}

// --------------------------------------------------- scaled sign + EF ---
// corr = x + e; scale = sum|corr| / d; c = scale * sign(corr); e' = corr - c.

template <int VPT>
__global__ void sign_ef_rows_warp(const float* __restrict__ x,
                                  const float* __restrict__ e,
                                  float* __restrict__ c_out,
                                  float* __restrict__ e_out, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * d;
  float corr[VPT];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    corr[j] = c < d ? x[base + c] + e[base + c] : 0.f;
    s += fabsf(corr[j]);
  }
  const float scale = warp_sum(s) / (float)d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if (c < d) {
      const float cv = scale * sgnf(corr[j]);
      c_out[base + c] = cv;
      e_out[base + c] = corr[j] - cv;
    }
  }
}

__global__ void sign_ef_rows_block(const float* __restrict__ x,
                                   const float* __restrict__ e,
                                   float* __restrict__ c_out,
                                   float* __restrict__ e_out, int d) {
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    s += fabsf(x[base + c] + e[base + c]);
  const float scale = block_sum(s, red) / (float)d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float corr = x[base + c] + e[base + c];
    const float cv = scale * sgnf(corr);
    c_out[base + c] = cv;
    e_out[base + c] = corr - cv;
  }
}

int vpt_for(int d) {
  int v = 1;
  while (32 * v < d) v <<= 1;
  return v;
}

}  // namespace

extern "C" int topk_rows_launch(const float* x, float* out, int rows, int d,
                                const float* k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (d <= kWarpRowsMax) {
    const int grid = (rows + 7) / 8;
    switch (vpt_for(d)) {
      case 1: topk_rows_warp<1><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
      case 2: topk_rows_warp<2><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
      case 4: topk_rows_warp<4><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
      case 8: topk_rows_warp<8><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
      case 16: topk_rows_warp<16><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
      default: topk_rows_warp<32><<<grid, 256, 0, s>>>(x, out, rows, d, k); break;
    }
  } else {
    const int cache = d <= kSmemRowMax;
    const size_t smem = (32 + (cache ? (size_t)d : 0)) * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          topk_rows_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return err;
    }
    topk_rows_block<<<rows, kRowThreads, smem, s>>>(x, out, d, k, cache);
  }
  return cudaGetLastError();
}

extern "C" int qsgd_rows_launch(const float* x, const float* u,
                                const float* norms, float* out, int rows,
                                int d, const float* levels, void* stream) {
  const unsigned n = (unsigned)rows * (unsigned)d;
  if (n == 0) return 0;
  const unsigned threads = 256;
  unsigned grid = (n + threads - 1) / threads;
  if (grid > 132u * 32u) grid = 132u * 32u;  // grid-stride beyond ~32 waves
  qsgd_rows_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, u, norms, out, n, (unsigned)d, levels);
  return cudaGetLastError();
}

extern "C" int sign_ef_rows_launch(const float* x, const float* e,
                                   float* c_out, float* e_out, int rows,
                                   int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (d <= kWarpRowsMax) {
    const int grid = (rows + 7) / 8;
    switch (vpt_for(d)) {
      case 1: sign_ef_rows_warp<1><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
      case 2: sign_ef_rows_warp<2><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
      case 4: sign_ef_rows_warp<4><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
      case 8: sign_ef_rows_warp<8><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
      case 16: sign_ef_rows_warp<16><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
      default: sign_ef_rows_warp<32><<<grid, 256, 0, s>>>(x, e, c_out, e_out, rows, d); break;
    }
  } else {
    sign_ef_rows_block<<<rows, kRowThreads, 0, s>>>(x, e, c_out, e_out, d);
  }
  return cudaGetLastError();
}
