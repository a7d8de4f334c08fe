// Device code shared by the row kernels (rows.cu) and the tile kernels
// (tiles.cu): one warp per row of up to 1024 values held in registers,
// QSGD's elementwise rule, and the row-group layout of the row kernels (a
// group of threads a row, a few values a thread; see "row groups" below).
//
// A warp row is described by where it starts in a flat tensor (`base`), its
// width `cols` and the tensor's length `n` (top-k takes the row's start and
// `valid = n - base`, its present columns):
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
//
// Top-k is select-then-replay. The reference bisects [0, max|x|] 24 times,
// and each step asks one question: is count(|x| >= mid) > k? With
// K = floor(k) + 1 and t the K-th largest counted |x| (the columns inside
// the row, tail zeros included; NaN never counts), that count exceeds k
// exactly when t >= mid. So a row finds t once and replays the 24 halvings
// as scalar float arithmetic, with no reduction in the loop (topk_lo):
//   * rows of at most 32 columns (one value per lane): t is the K-th
//     largest of the lanes' keys, K rounds of a warp max;
//   * rows of 33-1024 columns, K <= 32: the K-th largest lane maximum m is
//     a lower bound of t; the values >= m (about K of them on random data)
//     are compacted into a 64-slot buffer in shared memory and t is chosen
//     there by rank. A row with more than 64 candidates (ties, constant
//     rows) or K > 32 takes the counting bisection, in the kernel;
//   * k < 0 (every step moves lo), K > cols (no step does) and rows that
//     hold a NaN (max|x| is NaN, as jnp.max gives it, so every mid is NaN
//     and counts 0) need no t.
// Keys are the bits of |x| plus one (0 for an absent column): unsigned
// order is float order, and a NaN sorts above +inf. Denormal |x| and mid
// count as zero, as the reference's XLA flushes them. Every decision equals
// the count's, so the kept set is bitwise the reference's.
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

// The counting bisection's "more than k kept" test: the row kernel compares
// a float count with a float budget (B2), the tile kernel an int count with
// a static int budget (B4). Both are exact below 2^24, so they decide alike.
__device__ __forceinline__ bool over_budget(int cnt, float k) {
  return (float)cnt > k;
}
__device__ __forceinline__ bool over_budget(int cnt, int k) { return cnt > k; }

// ---------------------------------------------------------------- top-k ---
constexpr int kCandMax = 64;  // candidate slots per warp row
// Resident 256-thread blocks per SM the top-k warp kernels are built for:
// a lane's VPT values stay in registers without spills (up to 128, 85 and
// 64 registers a thread), and 16 or more warps keep their rows' loads in
// flight.
constexpr int topk_blocks_per_sm(int vpt) {
  return vpt >= 32 ? 2 : vpt >= 16 ? 3 : 4;
}

// The budget as the replay needs it: `always`, every step moves lo (k < 0);
// `have`, some step may (K <= cols); K = floor(k) + 1. A NaN k has neither.
struct TopkBudget {
  bool always, have;
  int K;
};
__device__ __forceinline__ TopkBudget topk_budget(float k, int cols) {
  const bool have = k >= 0.f && k < (float)cols;
  return {0.f > k, have, have ? (int)floorf(k) + 1 : 0};
}
__device__ __forceinline__ TopkBudget topk_budget(int k, int cols) {
  const bool have = k >= 0 && k < cols;
  return {k < 0, have, have ? k + 1 : 0};
}

// |x| and mid as the reference compares them: its XLA flushes denormals to
// zero on the CPU and the TPU. abs_bits is the bit pattern of |x| so
// flushed; a NaN keeps its bits, above +inf's.
__device__ __forceinline__ unsigned abs_bits(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b < 0x00800000u ? 0u : b;
}
__device__ __forceinline__ float flush_abs(float v) {
  return __uint_as_float(abs_bits(v));
}
__device__ __forceinline__ float flush(float m) {
  return m < 1.17549435e-38f ? 0.f : m;  // FLT_MIN, the least normal
}

// What the replay takes in place of k and t: kTakeNever (K past the row, a
// NaN k, or a row that holds a NaN), kTakeAlways (k < 0), or the key of t
// (its bits plus one). kLoReady marks a row whose lo is already known.
constexpr unsigned kTakeNever = 0u, kTakeAlways = 0x7fffffffu;
constexpr unsigned kLoReady = 0xffffffffu;

// lo of a row: the 24 halvings of [0, hi], lo moving up where the count
// would exceed k: always, or where t reaches mid (never for a NaN mid). A
// mid below the least normal is flushed to zero, as the reference's XLA
// does. Where tkey is kLoReady, hi already holds lo.
__device__ __forceinline__ float topk_lo(float hi, unsigned tkey) {
  if (tkey == kLoReady) return hi;
  const bool always = tkey == kTakeAlways;
  const bool have = tkey != kTakeNever && !always;
  const float t = __uint_as_float(tkey - 1u);
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = flush(0.5f * (lo + hi));
    const bool take_hi = always || (have && t >= mid);
    lo = take_hi ? mid : lo;
    hi = take_hi ? hi : mid;
  }
  return lo;
}

// The K-th largest (1 <= K <= 32) of the warp's 32 keys, with multiplicity,
// given their maximum mx. The next maximum is reduced while the ties at
// this one are counted.
__device__ __forceinline__ unsigned warp_kth(unsigned key, unsigned mx,
                                             int K) {
  for (;;) {
    const bool at = key == mx;
    const unsigned rest = at ? 0u : key;
    const unsigned next = __reduce_max_sync(kFull, rest);
    const int c = __popc(__ballot_sync(kFull, at));
    if (c >= K) return mx;
    K -= c;
    key = rest;
    mx = next;
  }
}

// The key of a lane's j-th value. The lanes' lower half of values always
// lies inside the row (cols > 16 VPT), so only the upper half is checked.
template <int VPT>
__device__ __forceinline__ unsigned topk_key(float v, int j, int lane,
                                             int cols) {
  return j < VPT / 2 || lane + 32 * j < cols ? abs_bits(v) + 1u : 0u;
}

// The K-th largest key of a warp row, given a lower bound m of it: the keys
// >= m are compacted into `cand` and t is the least candidate with fewer
// than K candidates above it. 0 when more than kCandMax keys reach m.
template <int VPT>
__device__ __forceinline__ unsigned candidates_kth(const float (&v)[VPT],
                                                   int cols, int lane,
                                                   unsigned m, int K,
                                                   unsigned* cand) {
  int mine = 0;
#pragma unroll
  for (int j = 0; j < VPT; ++j) mine += topk_key<VPT>(v[j], j, lane, cols) >= m;
  int incl = mine;  // inclusive scan of the candidate counts over lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    incl += lane >= o ? y : 0;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (total > kCandMax) return 0u;
  int pos = incl - mine;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const unsigned key = topk_key<VPT>(v[j], j, lane, cols);
    if (key >= m) cand[pos++] = key;
  }
  __syncwarp();
  const unsigned c0 = lane < total ? cand[lane] : 0u;
  const unsigned c1 = lane + 32 < total ? cand[lane + 32] : 0u;
  int gt0 = 0, gt1 = 0;
  for (int i = 0; i < total; ++i) {
    const unsigned u = cand[i];
    gt0 += u > c0;
    gt1 += u > c1;
  }
  unsigned best = lane < total && gt0 < K ? c0 : ~0u;
  best = lane + 32 < total && gt1 < K ? min(best, c1) : best;
  return __reduce_min_sync(kFull, best);
}

// The reference's counting bisection, for rows the selection leaves out.
template <int VPT, typename K>
__device__ __forceinline__ float topk_count_bisect(const float (&v)[VPT],
                                                   int cols, int lane,
                                                   float hi, K k) {
  float lo = 0.f;
  for (int it = 0; it < kBisect; ++it) {
    const float mid = flush(0.5f * (lo + hi));
    // key >= bits(mid) + 1 is |x| >= mid: the row holds no NaN, mid >= 0
    const unsigned mid_key = __float_as_uint(mid) + 1u;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      cnt += topk_key<VPT>(v[j], j, lane, cols) >= mid_key;
    const bool take_hi = over_budget(__reduce_add_sync(kFull, cnt), k);
    lo = take_hi ? mid : lo;
    hi = take_hi ? hi : mid;
  }
  return lo;
}

// A warp row's selection: the lane's values of the row's `cols` go to v,
// read from `src` (global or shared memory), of which only the first
// `valid` are present (the rest read as zeros); hi = max|x| (NaN if the row
// holds one) and tkey are what topk_lo needs. A row the candidate buffer
// cannot hold is bisected by counting here and comes back as its lo in hi,
// with tkey = kLoReady. `cand` is the warp's kCandMax slots of shared
// memory.
template <int VPT, typename T, typename K>
__device__ __forceinline__ void topk_warp_select(const T* src, int cols,
                                                 int valid, K k, int lane,
                                                 unsigned* cand,
                                                 float (&v)[VPT], float& hi,
                                                 unsigned& tkey) {
  unsigned top = 0;  // the lane's largest key
  const bool whole = valid >= cols;  // not the ragged last tile row
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    v[j] = (j < VPT / 2 || c < cols) && (whole || c < valid) ? to_f(src[c])
                                                             : 0.f;
    top = max(top, topk_key<VPT>(v[j], j, lane, cols));
  }
  const unsigned top_max = __reduce_max_sync(kFull, top);
  hi = __uint_as_float(top_max - 1u);
  const TopkBudget b = topk_budget(k, cols);
  if (b.always) {
    tkey = kTakeAlways;
  } else if (!b.have || hi != hi) {
    tkey = kTakeNever;
  } else {
    unsigned t = 0;  // the K-th largest key; 0 where the selection gives up
    if constexpr (VPT == 1) {
      t = warp_kth(top, top_max, b.K);
    } else if (b.K <= 32) {
      t = candidates_kth<VPT>(v, cols, lane, warp_kth(top, top_max, b.K),
                              b.K, cand);
    }
    tkey = t ? t : kLoReady;
    if (!t) hi = topk_count_bisect<VPT>(v, cols, lane, hi, k);
  }
}

// Keep x where |x| >= lo, written to `dst` in x's own type (bf16 -> float
// -> bf16 is exact); absent and missing columns are not written.
template <int VPT, typename T>
__device__ __forceinline__ void topk_warp_write(const float (&v)[VPT],
                                                T* __restrict__ dst,
                                                int cols, int valid,
                                                int lane, float lo) {
  const bool whole = valid >= cols;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int c = lane + 32 * j;
    if ((j < VPT / 2 || c < cols) && (whole || c < valid))
      dst[c] = from_f<T>(flush_abs(v[j]) >= lo ? v[j] : 0.f);
  }
}

// A whole warp row: select, replay on every lane, write.
template <int VPT, typename T, typename K>
__device__ __forceinline__ void topk_warp_row(const T* src,
                                              T* __restrict__ dst, int cols,
                                              int valid, K k, int lane,
                                              unsigned* cand) {
  float v[VPT], hi;
  unsigned tkey;
  topk_warp_select<VPT>(src, cols, valid, k, lane, cand, v, hi, tkey);
  topk_warp_write<VPT>(v, dst, cols, valid, lane, topk_lo(hi, tkey));
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

// The TPU kernel's L = max(levels, 1); a NaN stays NaN, as jnp.maximum
// keeps it.
__device__ __forceinline__ float clamp_levels(float levels) {
  return levels < 1.f ? 1.f : levels;
}

// ----------------------------------------------------------- row groups ---
// A row of d columns as a group of G = pow2ceil(ceil(d / V)) <= 1024
// threads, thread q of the group holding columns Vq..Vq+V-1 (V = row_vals(d)
// neighbouring values). VEC: every operand starts on 4V bytes, so a
// thread's values are one access; else V 4-byte ones in the same layout, so
// the order of a row's sum depends on d alone. Groups of up to 32 threads
// share a warp (32 / G rows a warp) and sum by xor shuffles at offsets G/2
// down to 1. Wider groups take G / 32 warps of one block: each warp sums by
// shuffles (offsets 16 down to 1), puts its sum in shared memory, and every
// warp adds the row's G / 32 warp sums by shuffles again. A block holds
// max(G, 256) threads; a thread finds its row and columns from its
// position, with no division by d. Threads past the row or past the last
// row hold zeros and join every shuffle and barrier.
constexpr int kGroupBlock = 256;

// Values a thread: two up to d = 64, where the engine's (4096, 32) client
// block makes a one-wave kernel whose time is a thread's chain of work
// (QSGD's IEEE divisions, two an element, each ending in a branch to its
// slow path, run one after another: with four values a thread QSGD took
// about a fifth longer there on an H100); four above, where rows span waves
// and 16-byte accesses halve the instructions; fewer where d is odd or not
// a multiple of four.
inline int row_vals(int cols) {
  return cols % 4 == 0 && cols > 64 ? 4 : cols % 2 == 0 ? 2 : 1;
}

inline int group_threads(int cols, int vals) {
  int g = 1;
  while (vals * g < cols) g <<= 1;
  return g;
}

__host__ __device__ constexpr int group_block(int g) {
  return g > kGroupBlock ? g : kGroupBlock;
}

struct GroupLane {
  int row;
  bool live;   // the thread holds columns of a row
  size_t off;  // where they start
};

template <int G, int V>
__device__ __forceinline__ GroupLane group_lane(int rows, int cols) {
  constexpr int kRows = group_block(G) / G;  // rows a block
  const int row = blockIdx.x * kRows + threadIdx.x / G;
  const int q = threadIdx.x % G;
  return {row, row < rows && V * q < cols, (size_t)row * cols + V * q};
}

template <int V, bool VEC>
__device__ __forceinline__ void load_vals(const float* __restrict__ p,
                                          bool live, float (&v)[V]) {
  if (!live) {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  } else if constexpr (VEC && V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (VEC && V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V, bool VEC>
__device__ __forceinline__ void store_vals(float* __restrict__ p,
                                           const float (&v)[V]) {
  if constexpr (VEC && V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC && V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

// The sum over a row's group; every thread of the group gets the same bits
// (IEEE addition commutes). `red` is 32 floats of shared memory, used and
// behind a barrier when G > 32, so the whole block must call this.
template <int G>
__device__ __forceinline__ float group_sum(float v, float* red) {
  constexpr int kWarps = G > 32 ? G / 32 : 1;
  constexpr int kFirst = G > 32 ? 16 : G / 2;
#pragma unroll
  for (int o = kFirst; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if constexpr (kWarps > 1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[warp / kWarps * kWarps + lane % kWarps];
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(kFull, v, o);
  }
  return v;
}

inline int vpt_for(int cols) {
  int v = 1;
  while (32 * v < cols) v <<= 1;
  return v;
}

inline bool aligned(int bytes, const void* a, const void* b, const void* c,
                    const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          (uintptr_t)(bytes - 1)) == 0;
}

}  // namespace

// Run STMT with `constexpr int G, V` set to `g` (a power of two up to 1024)
// and `v` (1, 2 or 4), and `constexpr bool VEC` to `vec` (false for v = 1).
#define GROUP_CASE(N, V_, VEC_, ...)                                    \
  case N: {                                                             \
    constexpr int G = N, V = V_;                                        \
    constexpr bool VEC = VEC_;                                          \
    __VA_ARGS__;                                                        \
  } break;
#define GROUP_CASES(g, V_, VEC_, ...)                                   \
  switch (g) {                                                          \
    GROUP_CASE(1, V_, VEC_, __VA_ARGS__)                                \
    GROUP_CASE(2, V_, VEC_, __VA_ARGS__)                                \
    GROUP_CASE(4, V_, VEC_, __VA_ARGS__)                                \
    GROUP_CASE(8, V_, VEC_, __VA_ARGS__)                                \
    GROUP_CASE(16, V_, VEC_, __VA_ARGS__)                               \
    GROUP_CASE(32, V_, VEC_, __VA_ARGS__)                               \
    GROUP_CASE(64, V_, VEC_, __VA_ARGS__)                               \
    GROUP_CASE(128, V_, VEC_, __VA_ARGS__)                              \
    GROUP_CASE(256, V_, VEC_, __VA_ARGS__)                              \
    GROUP_CASE(512, V_, VEC_, __VA_ARGS__)                              \
    GROUP_CASE(1024, V_, VEC_, __VA_ARGS__)                             \
  }
#define GROUP_SWITCH(g, v, vec, ...)                                    \
  if ((v) == 4 && (vec)) {                                              \
    GROUP_CASES(g, 4, true, __VA_ARGS__)                                \
  } else if ((v) == 4) {                                                \
    GROUP_CASES(g, 4, false, __VA_ARGS__)                               \
  } else if ((v) == 2 && (vec)) {                                       \
    GROUP_CASES(g, 2, true, __VA_ARGS__)                                \
  } else if ((v) == 2) {                                                \
    GROUP_CASES(g, 2, false, __VA_ARGS__)                               \
  } else {                                                              \
    GROUP_CASES(g, 1, false, __VA_ARGS__)                               \
  }

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
