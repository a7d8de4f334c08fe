// Whole-tensor compression kernels for Hopper (sm_90a): one gradient of any
// shape, flattened and walked as 1024-wide rows, in float32 or bf16.
//
//   topk_tiles     <- repro/kernels/topk_mask.py::block_topk_pallas
//   qsgd_tiles     <- repro/kernels/qsgd.py::qsgd_pallas
//   sign_ef_tiles  <- repro/kernels/sign_ef.py::sign_ef_pallas
//
// The TPU wrappers zero-pad the flat tensor to (8k, 1024) tiles before the
// kernels; these kernels take the flat tensor as it is. A row is `cols`
// (1024 from the API) consecutive elements, and the last row is masked at
// the tensor's end `n`: its missing elements count as the zeros of the
// reference's padding in every reduction and are never read or written.
//
// All three are bound by device-memory bytes:
// * topk_tiles reads x and writes the kept values: 8 B per element in
//   float32, 4 B in bf16. One warp per row (the warp-row code of
//   warp_rows.cuh that the engine's row kernel runs too): 32 values per lane
//   in registers, one read and one write. 1024-wide rows (every call of
//   the API) go through a persistent grid that copies each warp's next row
//   into shared memory with cp.async while it works on the current one,
//   since a warp alone cannot keep enough of its row's loads in flight; a
//   tensor that does not start on 16 bytes (a view with an offset) is read
//   from device memory directly by the same kernel. It
//   selects, then replays: the K-th largest of the 32 lane maxima bounds
//   the row's K-th largest |x| t from below, the few values above it go to
//   a 64-slot buffer in shared memory where t is found by rank, and the
//   reference's 24 halvings run against t with no reduction. Rows with
//   more candidates (ties, constant rows) or k >= 32 take the counting
//   bisection inside the kernel. The budget is the reference's static
//   int k.
// * qsgd_tiles reads x and u and writes the output: 12 B per element in
//   float32, 10 B with bf16 x, plus the one global norm, read through a
//   device pointer so the host never waits for it. A grid-stride
//   elementwise pass with 16-byte loads and stores where every operand is
//   16-byte aligned (4 float32 or 8 bf16 values per thread and step).
// * sign_ef_tiles reads x and e and writes c and e': 16 B per element, 14 B
//   with bf16 x. One warp per row, as topk_tiles; the mean divides by the
//   row width 1024, the tail's zeros included, as the TPU kernel's does.
//
// bf16 x is read as bf16 (half the bytes) and computed in float32; top-k and
// QSGD write x's type, scaled sign + EF writes float32. Built with
// -fmad=false, top-k and QSGD are bitwise equal to their plain PyTorch
// versions; scaled sign + EF sums in another order and agrees to a
// tolerance. Every entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError().

#include "warp_rows.cuh"

namespace {

template <int VPT, typename T>
__global__ void __launch_bounds__(kWarpRowsPerBlock * 32,
                                  topk_blocks_per_sm(VPT))
topk_tiles_warp(const T* __restrict__ x, T* __restrict__ out, long long n,
                int cols, int rows, int k) {
  __shared__ unsigned cand[kWarpRowsPerBlock][kCandMax];
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // whole warps leave together
  const size_t base = (size_t)row * cols;
  const int valid = (int)min((long long)cols, n - (long long)base);
  topk_warp_row<VPT>(x + base, out + base, cols, valid, k, threadIdx.x & 31,
                     cand[threadIdx.x >> 5]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 1024-wide rows, each warp persistent over rows w, w + W, ...: a row is
// copied into the warp's shared-memory buffer with cp.async (16 bytes a
// lane and copy) while the warp selects on the row before it, so the loads
// of the next row overlap the selection and the stores of this one. The
// ragged last row, and every row of an x that is not 16-byte aligned
// (`aligned` false), is read from device memory directly.
template <typename T>
__global__ void __launch_bounds__(kWarpRowsPerBlock * 32,
                                  topk_blocks_per_sm(32))
topk_tiles_staged(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int rows, int k, bool aligned) {
  constexpr int kCols = 1024;
  constexpr int kChunks = kCols * (int)sizeof(T) / 16 / 32;  // per lane
  extern __shared__ __align__(16) unsigned char staged[];
  __shared__ unsigned cand[kWarpRowsPerBlock][kCandMax];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* buf = reinterpret_cast<T*>(staged) + (size_t)warp * 2 * kCols;
  const int stride = gridDim.x * kWarpRowsPerBlock;
  const auto from_smem = [&](int r) {
    return aligned && (long long)(r + 1) * kCols <= n;
  };
  const auto fetch = [&](int r, int slot) {
    if (r < rows && from_smem(r)) {
      const uint4* src =
          reinterpret_cast<const uint4*>(x + (size_t)r * kCols);
      uint4* dst = reinterpret_cast<uint4*>(buf + slot * kCols);
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        cp_async16(dst + lane + 32 * q, src + lane + 32 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int r = blockIdx.x * kWarpRowsPerBlock + warp;
  fetch(r, 0);
  for (int i = 0; r < rows; r += stride, ++i) {
    fetch(r + stride, (i + 1) & 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncwarp();
    const size_t base = (size_t)r * kCols;
    if (from_smem(r))
      topk_warp_row<32>(buf + (i & 1) * kCols, out + base, kCols, kCols, k,
                        lane, cand[warp]);
    else
      topk_warp_row<32>(x + base, out + base, kCols,
                        (int)min((long long)kCols, n - (long long)base), k,
                        lane, cand[warp]);
    __syncwarp();  // the slot is refilled by the next iteration's fetch
  }
}

template <int VPT, typename T>
__global__ void sign_ef_tiles_warp(const T* __restrict__ x,
                                   const float* __restrict__ e,
                                   float* __restrict__ c_out,
                                   float* __restrict__ e_out, long long n,
                                   int cols, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;
  sign_ef_warp_row<VPT>(x, e, c_out, e_out, (size_t)row * cols, cols,
                        (size_t)n, threadIdx.x & 31);
}

// V elements per thread and step: 16 bytes of x (4 float32 or 8 bf16) when
// kVec, else 1. Elements past the last whole group of V go one by one.
template <typename T, bool kVec>
__global__ void qsgd_tiles_kernel(const T* __restrict__ x,
                                  const float* __restrict__ u,
                                  const float* __restrict__ normp,
                                  T* __restrict__ out, long long n,
                                  float levels) {
  constexpr int V = kVec ? 16 / (int)sizeof(T) : 1;
  const float nm = *normp;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t groups = (size_t)n / V;
  for (size_t g = first; g < groups; g += stride) {
    alignas(16) T xv[V];
    alignas(16) float uv[V];
    alignas(16) T ov[V];
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(xv) =
          reinterpret_cast<const uint4*>(x)[g];
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(uv)[q] =
            reinterpret_cast<const float4*>(u)[g * (V / 4) + q];
    } else {
      xv[0] = x[g];
      uv[0] = u[g];
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      ov[j] = from_f<T>(qsgd_elem(to_f(xv[j]), uv[j], nm, levels));
    if constexpr (kVec) {
      reinterpret_cast<uint4*>(out)[g] = *reinterpret_cast<const uint4*>(ov);
    } else {
      out[g] = ov[0];
    }
  }
  for (size_t i = groups * V + first; i < (size_t)n; i += stride)
    out[i] = from_f<T>(qsgd_elem(to_f(x[i]), u[i], nm, levels));
}

int warp_grid(int rows) {
  return (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
}

int tile_rows(long long n, int cols) {
  return (int)((n + cols - 1) / cols);
}

template <typename T>
int topk_tiles(const void* x, void* out, long long n, int cols, int k,
               cudaStream_t s) {
  const int rows = tile_rows(n, cols);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (cols == 1024) {
    // two resident blocks on every SM of the current device; the shared
    // memory attribute is set for it at every call
    const size_t smem = kWarpRowsPerBlock * 2 * 1024 * sizeof(T);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(topk_tiles_staged<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err != cudaSuccess) return err;
    const int grid = min(topk_blocks_per_sm(32) * sms, warp_grid(rows));
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    topk_tiles_staged<T><<<grid, 256, smem, s>>>(xt, ot, n, rows, k, aligned);
  } else {
    VPT_SWITCH(cols, topk_tiles_warp<VPT, T><<<warp_grid(rows), 256, 0, s>>>(
                         xt, ot, n, cols, rows, k))
  }
  return cudaGetLastError();
}

template <typename T>
int sign_ef_tiles(const void* x, const float* e, float* c_out, float* e_out,
                  long long n, int cols, cudaStream_t s) {
  const int rows = tile_rows(n, cols);
  const T* xt = static_cast<const T*>(x);
  VPT_SWITCH(cols, sign_ef_tiles_warp<VPT, T><<<warp_grid(rows), 256, 0, s>>>(
                       xt, e, c_out, e_out, n, cols, rows))
  return cudaGetLastError();
}

template <typename T>
int qsgd_tiles(const void* x, const float* u, const float* norm, void* out,
               long long n, float levels, cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long per_thread = vec ? 16 / (long long)sizeof(T) : 1;
  const unsigned threads = 256;
  long long grid = (n / per_thread + threads - 1) / threads;
  if (grid < 1) grid = 1;                  // the tail alone
  if (grid > 132 * 32) grid = 132 * 32;    // grid-stride beyond ~32 waves
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vec)
    qsgd_tiles_kernel<T, true><<<(unsigned)grid, threads, 0, s>>>(
        xt, u, norm, ot, n, levels);
  else
    qsgd_tiles_kernel<T, false><<<(unsigned)grid, threads, 0, s>>>(
        xt, u, norm, ot, n, levels);
  return cudaGetLastError();
}

}  // namespace

// `bf16` selects the type of x (and of top-k's and QSGD's output): 0 for
// float32, 1 for bfloat16. `cols` <= 1024.
extern "C" int topk_tiles_launch(const void* x, void* out, long long n,
                                 int cols, int k, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return bf16 ? topk_tiles<__nv_bfloat16>(x, out, n, cols, k, s)
              : topk_tiles<float>(x, out, n, cols, k, s);
}

extern "C" int qsgd_tiles_launch(const void* x, const float* u,
                                 const float* norm, void* out, long long n,
                                 float levels, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return bf16 ? qsgd_tiles<__nv_bfloat16>(x, u, norm, out, n, levels, s)
              : qsgd_tiles<float>(x, u, norm, out, n, levels, s);
}

extern "C" int sign_ef_tiles_launch(const void* x, const float* e,
                                    float* c_out, float* e_out, long long n,
                                    int cols, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return bf16 ? sign_ef_tiles<__nv_bfloat16>(x, e, c_out, e_out, n, cols, s)
              : sign_ef_tiles<float>(x, e, c_out, e_out, n, cols, s);
}
