// Device code shared by the row kernels (rows.cu) and the tile kernels
// (tiles.cu): one warp per row of up to 1024 values held in registers, every
// reduction a warp shuffle, and QSGD's elementwise rule.
//
// A warp row is described by where it starts in a flat tensor (`base`), its
// width `cols` and the tensor's length `n`:
//   * columns at or past `cols` are absent (lanes beyond a narrow row);
//   * columns inside the row but at or past `n` (the ragged last row of a
//     flat tensor walked as 1024-wide rows) read as zeros, the values the
//     reference's zero padding gives them: they take part in every
//     reduction and are never written.
// For the engine's (rows, d) client rows n = rows * d, so no column is past
// `n` and the same code is the row kernels' path.
//
// Values are read in their stored type (float or bf16) and computed in
// float, as the TPU kernels upcast. A lane holds VPT = pow2ceil(cols / 32)
// values; VPT_SWITCH instantiates the six widths.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBisect = 24;          // N_BISECT of the TPU kernels
constexpr int kWarpRowsMax = 1024;   // widest row on the warp-per-row path
constexpr int kWarpRowsPerBlock = 8; // 256-thread blocks

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// The bisection's "more than k kept" test: the row kernel compares a float
// count with a float budget (B2), the tile kernel an int count with a static
// int budget (B4). Both are exact below 2^24, so they decide alike.
__device__ __forceinline__ bool over_budget(int cnt, float k) {
  return (float)cnt > k;
}
__device__ __forceinline__ bool over_budget(int cnt, int k) { return cnt > k; }

// ---------------------------------------------------------------- top-k ---
// hi = max|x|, lo = 0; 24 times mid = 0.5 (lo + hi), count |x| >= mid and
// move lo up when the count exceeds k; keep x where |x| >= lo. Every step is
// exact, so the result is bitwise the reference's.
template <int VPT, typename T, typename K>
__device__ __forceinline__ void topk_warp_row(const T* __restrict__ x,
                                              T* __restrict__ out,
                                              size_t base, int cols,
                                              size_t n, K k, int lane) {
  float v[VPT], a[VPT];
  float hi = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    const bool in_x = c < cols && base + c < n;
    v[j] = in_x ? to_f(x[base + c]) : 0.f;
    a[j] = c < cols ? fabsf(v[j]) : -1.f;  // absent: never counted, mid >= 0
    hi = fmaxf(hi, a[j]);
  }
  hi = warp_max(hi);
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) cnt += a[j] >= mid;
    const bool take_hi = over_budget(warp_sum_int(cnt), k);
    lo = take_hi ? mid : lo;
    hi = take_hi ? hi : mid;
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    // a kept value is written back in its own type: bf16 -> float -> bf16
    // is exact
    if (c < cols && base + c < n) out[base + c] = from_f<T>(a[j] >= lo ? v[j] : 0.f);
  }
}

// --------------------------------------------------- scaled sign + EF ---
// corr = x + e; scale = sum|corr| / cols; c = scale * sign(corr);
// e' = corr - c. The divisor is the row width: the engine's real d for
// client rows, and 1024 for a tile row, its zero tail included (the TPU
// tile kernel's mean runs over the padded row).
template <int VPT, typename T>
__device__ __forceinline__ void sign_ef_warp_row(const T* __restrict__ x,
                                                 const float* __restrict__ e,
                                                 float* __restrict__ c_out,
                                                 float* __restrict__ e_out,
                                                 size_t base, int cols,
                                                 size_t n, int lane) {
  float corr[VPT];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    corr[j] = c < cols && base + c < n ? to_f(x[base + c]) + e[base + c]
                                       : 0.f;
    s += fabsf(corr[j]);
  }
  const float scale = warp_sum(s) / (float)cols;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if (c < cols && base + c < n) {
      const float cv = scale * sgnf(corr[j]);
      c_out[base + c] = cv;
      e_out[base + c] = corr[j] - cv;
    }
  }
}

// ----------------------------------------------------------------- QSGD ---
// scaled = |x| / max(norm, 1e-30) * L; q = (floor(scaled) + [u < frac]) / L;
// out = sign(x) * q * norm. Compiled with -fmad=false and IEEE division, it
// rounds as PyTorch's plain version does.
__device__ __forceinline__ float qsgd_elem(float xv, float uv, float nm,
                                           float levels) {
  const float scaled = fabsf(xv) / fmaxf(nm, 1e-30f) * levels;
  const float lower = floorf(scaled);
  const float up = uv < scaled - lower ? 1.f : 0.f;
  const float q = (lower + up) / levels;
  return sgnf(xv) * q * nm;
}

inline int vpt_for(int cols) {
  int v = 1;
  while (32 * v < cols) v <<= 1;
  return v;
}

}  // namespace

// Run STMT with `constexpr int VPT` set to the lane width for `cols` <= 1024.
#define VPT_SWITCH(cols, ...)                                   \
  switch (vpt_for(cols)) {                                      \
    case 1: { constexpr int VPT = 1; __VA_ARGS__; } break;      \
    case 2: { constexpr int VPT = 2; __VA_ARGS__; } break;      \
    case 4: { constexpr int VPT = 4; __VA_ARGS__; } break;      \
    case 8: { constexpr int VPT = 8; __VA_ARGS__; } break;      \
    case 16: { constexpr int VPT = 16; __VA_ARGS__; } break;    \
    default: { constexpr int VPT = 32; __VA_ARGS__; } break;    \
  }
