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
//   block (the warp-row code of warp_rows.cuh, shared with the tile
//   kernels); a lane keeps its VPT = pow2ceil(D/32) values in registers, so
//   a 32-wide row costs one load per lane and the 25 bisection reductions of
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

#include "warp_rows.cuh"

namespace {

constexpr int kRowThreads = 512;     // threads of the block-per-row path
constexpr int kSmemRowMax = 50176;   // floats of a row cached in shared memory

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

template <int VPT>
__global__ void topk_rows_warp(const float* __restrict__ x,
                               float* __restrict__ out, int rows, int d,
                               const float* __restrict__ kp) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps leave together
  topk_warp_row<VPT>(x, out, (size_t)row * d, d, (size_t)rows * d, *kp,
                     threadIdx.x & 31);
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
    const bool take_hi = over_budget(cnt, k);
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
// `levels` is already clamped to >= 1; each row has its own norm.

__global__ void qsgd_rows_kernel(const float* __restrict__ x,
                                 const float* __restrict__ u,
                                 const float* __restrict__ norms,
                                 float* __restrict__ out, unsigned n,
                                 unsigned d, const float* __restrict__ lp) {
  const float levels = *lp;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = qsgd_elem(x[i], u[i], norms[i / d], levels);
}

// --------------------------------------------------- scaled sign + EF ---

template <int VPT>
__global__ void sign_ef_rows_warp(const float* __restrict__ x,
                                  const float* __restrict__ e,
                                  float* __restrict__ c_out,
                                  float* __restrict__ e_out, int rows, int d) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;
  sign_ef_warp_row<VPT>(x, e, c_out, e_out, (size_t)row * d, d,
                        (size_t)rows * d, threadIdx.x & 31);
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

}  // namespace

extern "C" int topk_rows_launch(const float* x, float* out, int rows, int d,
                                const float* k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return 0;
  if (d <= kWarpRowsMax) {
    const int grid = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    VPT_SWITCH(d, topk_rows_warp<VPT><<<grid, 256, 0, s>>>(x, out, rows, d, k))
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
    const int grid = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    VPT_SWITCH(d, sign_ef_rows_warp<VPT><<<grid, 256, 0, s>>>(
                      x, e, c_out, e_out, rows, d))
  } else {
    sign_ef_rows_block<<<rows, kRowThreads, 0, s>>>(x, e, c_out, e_out, d);
  }
  return cudaGetLastError();
}
