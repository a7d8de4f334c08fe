// Per-row compression kernels of the fleet engine's client pass, for Hopper
// (sm_90a). One row is one client's flattened D-dim message; rows come from a
// client block of the engine (4096 x 32 at the headline fleet config).
//
//   topk_rows     <- repro/kernels/topk_mask.py::topk_rows_pallas
//   qsgd_rows     <- repro/kernels/qsgd.py::qsgd_rows_pallas
//   sign_ef_rows  <- repro/kernels/sign_ef.py::sign_ef_rows_pallas
//
// All three are bound by device-memory bytes once each element costs a few
// operations: topk reads x and writes the masked row (8 B/elem), qsgd reads
// x, u and writes the output (12 B/elem; its per-row norms are computed
// here from the same x), sign_ef reads x, e and writes c, e' (16 B/elem).
// At the engine's block each is one wave of about 2 us, most of it the
// launch and one load's latency (the floor lines of chip_smoke.py), so the
// design keeps every reduction on-chip and the chain from load to store
// short:
//
// * qsgd, and sign_ef on rows that take at most 32 threads, hold rows in
//   the row groups of warp_rows.cuh: a group of threads a row, two or four
//   neighbouring values a thread (row_vals), the row's sum in log2(G)
//   shuffles and, past a warp, one trip through shared memory; no division
//   by d;
// * other rows of width <= 1024 map to one warp each, eight rows per
//   256-thread block (the warp-row code of warp_rows.cuh, shared with the
//   tile kernels); a lane keeps its VPT = pow2ceil(D/32) values in
//   registers, so a row costs one read and one write;
// * topk selects, then replays (warp_rows.cuh): the row's K-th largest |x|
//   t answers each of the reference's 24 count questions, so the 24
//   halvings run as scalar arithmetic. A 32-wide row finds t in K rounds of
//   a warp max; rows up to 1024 by a lane-maximum bound and a 64-slot
//   candidate buffer in shared memory, with the counting bisection as the
//   in-kernel path for rows the buffer cannot hold. One warp replays the
//   block's eight rows, a lane each: on every lane of every warp the
//   replay's issue slots, not its latency, bounded the 32-wide rows;
// * wider rows get a 512-thread block each. topk caches the row in dynamic
//   shared memory when it fits (D <= 50176 floats), else re-reads it from
//   L2, and finds t by a radix select of four 8-bit digits (four passes
//   over the row in place of the reference's 24); sign_ef and qsgd's norm
//   reduce in one pass and compute in a second (qsgd given its norms: one
//   flat pass);
// * no padding: each kernel masks the ragged edge itself, and sign_ef divides
//   by the real width d.
//
// Numerics: topk is exact (its row maximum keeps NaN as jnp.max does, every
// decision of the replay is the count's, integer counts below 2^24), and
// qsgd, built with -fmad=false (squares and sums rounded apart, as PyTorch
// rounds them; IEEE division and sqrtf are nvcc's defaults), is bitwise
// equal to its plain PyTorch version given the same norms, or computing
// them in the same order (ref.lane_order_norms). sign_ef sums in another
// order than the plain version and agrees to a tolerance.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include "warp_rows.cuh"

namespace {

constexpr int kRowThreads = 512;     // threads of the block-per-row path
constexpr int kSmemRowMax = 50176;   // floats of a row cached in shared memory
constexpr int kLoads = 8;            // loads in flight a thread, top-k passes

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

// The block-wide maximum of unsigned keys; `red` holds 32 slots.
__device__ unsigned block_max_u(unsigned v, unsigned* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_max_sync(kFull, v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? red[threadIdx.x] : 0u;
  if (warp == 0) v = __reduce_max_sync(kFull, v);
  if (threadIdx.x == 0) red[0] = v;
  __syncthreads();
  return red[0];
}

// ---------------------------------------------------------------- top-k ---

// Each warp selects on its row; then warp 0 replays the block's eight rows
// side by side, one lane each, so a row's 24 halvings are issued once and
// not by all 32 lanes of its warp (at the engine's 32-wide rows, issuing
// them on every warp was most of the kernel's time); then each warp writes.
template <int VPT>
__global__ void __launch_bounds__(kWarpRowsPerBlock * 32,
                                  topk_blocks_per_sm(VPT))
topk_rows_warp(const float* __restrict__ x, float* __restrict__ out, int rows,
               int d, const float* __restrict__ kp) {
  __shared__ unsigned cand[kWarpRowsPerBlock][kCandMax];
  __shared__ float row_hi[kWarpRowsPerBlock];  // hi, then lo
  __shared__ unsigned row_tkey[kWarpRowsPerBlock];
  const float k = __ldg(kp);  // issued ahead of the row's load
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kWarpRowsPerBlock;
  const bool live = first + warp < rows;  // whole warps alike
  const size_t base = (size_t)(first + warp) * d;
  float v[VPT];
  if (live) {
    float hi;
    unsigned tkey;
    topk_warp_select<VPT>(x + base, d, d, k, lane, cand[warp], v, hi, tkey);
    if (lane == 0) {
      row_hi[warp] = hi;
      row_tkey[warp] = tkey;
    }
  }
  __syncthreads();
  if (warp == 0 && lane < kWarpRowsPerBlock && first + lane < rows)
    row_hi[lane] = topk_lo(row_hi[lane], row_tkey[lane]);
  __syncthreads();
  if (live) topk_warp_write<VPT>(v, out + base, d, d, lane, row_hi[warp]);
}

// The K-th largest |x| bit pattern of a row of d values (K <= d, no NaN):
// a radix select over four 8-bit digits from the top (the first holds the
// exponent's 7 high bits, as bit 31 of |x| is 0), each a histogram of the
// values that match the digits found so far (shared atomics, aggregated
// per warp over lanes with the same digit). `sh` holds 32 slots.
__device__ unsigned block_kth(const float* r, int d, int K, unsigned* hist,
                              unsigned* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned prefix = 0, fixed = 0;  // the digits found so far, and their bits
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    // kLoads values a thread are loaded before any is counted, so that a
    // row re-read from L2 keeps that many loads in flight; the trip count
    // is uniform over the block
    for (int c0 = 0; c0 < d; c0 += kLoads * blockDim.x) {
      unsigned key[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int c = c0 + u * blockDim.x + threadIdx.x;
        key[u] = c < d ? abs_bits(r[c]) : ~0u;  // ~0u: past the row
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const bool match = key[u] != ~0u && (key[u] & fixed) == prefix;
        if (__any_sync(kFull, match)) {
          const unsigned dig = match ? (key[u] >> shift) & 255u : 256u;
          const unsigned peers = __match_any_sync(kFull, dig);
          if (match && lane == __ffs(peers) - 1)
            atomicAdd(&hist[dig], (unsigned)__popc(peers));
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 8l..8l+7; the digit is the highest bin at which
      // the count of matching keys from the top reaches K
      unsigned h[8], own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) own += h[b] = hist[8 * lane + b];
      unsigned from = own;  // keys in this lane's bins and above
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_down_sync(kFull, from, o);
        from += lane + o < 32 ? y : 0u;
      }
      unsigned above = from - own;
      if (above < (unsigned)K && (unsigned)K <= from) {
        for (int b = 7; b >= 0; --b) {
          if (above + h[b] >= (unsigned)K) {
            sh[0] = 8 * lane + b;
            sh[1] = K - above;
            break;
          }
          above += h[b];
        }
      }
    }
    __syncthreads();
    prefix |= sh[0] << shift;
    fixed |= 255u << shift;
    K = (int)sh[1];
    __syncthreads();  // sh and hist are rewritten by the next digit
  }
  return prefix;
}

// One block per row: hi = max|x| and the radix select of t over the row
// (cached in shared memory when `cache`, re-read from L2 otherwise), the
// replay, and the write.
__global__ void topk_rows_block(const float* __restrict__ x,
                                float* __restrict__ out, int d,
                                const float* __restrict__ kp, int cache) {
  extern __shared__ unsigned smem[];
  unsigned* hist = smem;                               // 256 bins
  unsigned* red = smem + 256;                          // 32 slots
  float* row = reinterpret_cast<float*>(smem + 288);   // the cached row
  const float k = *kp;
  const float* xr = x + (size_t)blockIdx.x * d;
  unsigned top = 0;
#pragma unroll 8
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float xv = xr[c];
    if (cache) row[c] = xv;
    top = max(top, abs_bits(xv));
  }
  const float hi = __uint_as_float(block_max_u(top, red));  // publishes row
  const TopkBudget b = topk_budget(k, d);
  const float* r = cache ? row : xr;
  const unsigned tkey =
      b.always              ? kTakeAlways
      : !b.have || hi != hi ? kTakeNever
                            : block_kth(r, d, b.K, hist, red) + 1u;
  const float lo = topk_lo(hi, tkey);
  float* orow = out + (size_t)blockIdx.x * d;
#pragma unroll 8
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float xv = r[c];
    orow[c] = flush_abs(xv) >= lo ? xv : 0.f;
  }
}

// ----------------------------------------------------------------- QSGD ---
// L = max(levels, 1) is taken here, as the TPU kernel takes it. With
// `norms` null each row's L2 norm is summed from the x already loaded
// (squares in order within a thread, then across the row's threads;
// ref.lane_order_norms gives the same order) and rounded by the IEEE sqrtf.

// Rows in row groups (warp_rows.cuh), the engine's path, norms given or
// computed.
template <int G, int V, bool VEC>
__global__ void __launch_bounds__(group_block(G))
qsgd_rows_group(const float* __restrict__ x, const float* __restrict__ u,
                const float* __restrict__ norms, float* __restrict__ out,
                int rows, int d, const float* __restrict__ lp) {
  __shared__ float red[32];
  const float levels = clamp_levels(__ldg(lp));
  const GroupLane l = group_lane<G, V>(rows, d);
  float xv[V], uv[V], ov[V];
  load_vals<V, VEC>(x + l.off, l.live, xv);
  load_vals<V, VEC>(u + l.off, l.live, uv);
  float nm;
  if (norms) {
    nm = l.row < rows ? norms[l.row] : 0.f;
  } else {
    float s = xv[0] * xv[0];
#pragma unroll
    for (int j = 1; j < V; ++j) s += xv[j] * xv[j];
    nm = sqrtf(group_sum<G>(s, red));
  }
  if (!l.live) return;
#pragma unroll
  for (int j = 0; j < V; ++j) ov[j] = qsgd_elem(xv[j], uv[j], nm, levels);
  store_vals<V, VEC>(out + l.off, ov);
}

// Wider rows with their norms given: no reduction left, a flat pass. The
// count and the index are 64-bit: rows * d passes 2^32 at six rows of a
// 744M-parameter model's message.
__global__ void qsgd_rows_flat(const float* __restrict__ x,
                               const float* __restrict__ u,
                               const float* __restrict__ norms,
                               float* __restrict__ out, long long n,
                               long long d, const float* __restrict__ lp) {
  const float levels = clamp_levels(*lp);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = qsgd_elem(x[i], u[i], norms[i / d], levels);
}

// Wider rows, norms computed: a block per row sums the squares in a first
// pass and quantizes in a second, re-reading x; kLoads values a thread in
// flight in both.
__global__ void qsgd_rows_block(const float* __restrict__ x,
                                const float* __restrict__ u,
                                float* __restrict__ out, int d,
                                const float* __restrict__ lp) {
  __shared__ float red[32];
  const float levels = clamp_levels(*lp);
  const float* xr = x + (size_t)blockIdx.x * d;
  const float* ur = u + (size_t)blockIdx.x * d;
  float* orow = out + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int c0 = 0; c0 < d; c0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * blockDim.x + threadIdx.x;
      v[k] = c < d ? xr[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) s += v[k] * v[k];
  }
  const float nm = sqrtf(block_sum(s, red));
  for (int c0 = 0; c0 < d; c0 += kLoads * blockDim.x) {
    float v[kLoads], w[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * blockDim.x + threadIdx.x;
      v[k] = c < d ? xr[c] : 0.f;
      w[k] = c < d ? ur[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * blockDim.x + threadIdx.x;
      if (c < d) orow[c] = qsgd_elem(v[k], w[k], nm, levels);
    }
  }
}

// --------------------------------------------------- scaled sign + EF ---

// Rows of up to 32 threads in row groups (d <= 128 with d % 4 == 0, other
// even d <= 64, odd d <= 32; the engine's d = 32): a row's sum takes
// log2(G) shuffles (4 at d = 32, where a warp row takes 5), then the IEEE
// division by d and the writes of c and e'.
template <int G, int V, bool VEC>
__global__ void __launch_bounds__(group_block(G))
sign_ef_rows_group(const float* __restrict__ x, const float* __restrict__ e,
                   float* __restrict__ c_out, float* __restrict__ e_out,
                   int rows, int d) {
  __shared__ float red[32];
  const GroupLane l = group_lane<G, V>(rows, d);
  float xv[V], ev[V], corr[V], cv[V], rv[V];
  load_vals<V, VEC>(x + l.off, l.live, xv);
  load_vals<V, VEC>(e + l.off, l.live, ev);
#pragma unroll
  for (int j = 0; j < V; ++j) corr[j] = xv[j] + ev[j];
  float s = fabsf(corr[0]);
#pragma unroll
  for (int j = 1; j < V; ++j) s += fabsf(corr[j]);
  const float scale = group_sum<G>(s, red) / (float)d;
  if (!l.live) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    cv[j] = scale * sgnf(corr[j]);
    rv[j] = corr[j] - cv[j];
  }
  store_vals<V, VEC>(c_out + l.off, cv);
  store_vals<V, VEC>(e_out + l.off, rv);
}

template <int VPT>
__global__ void sign_ef_rows_warp(const float* __restrict__ x,
                                  const float* __restrict__ e,
                                  float* __restrict__ c_out,
                                  float* __restrict__ e_out, int rows, int d) {
  const long long row =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
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
    const size_t smem = (288 + (cache ? (size_t)d : 0)) * sizeof(float);
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

// `norms` may be null: each row's norm is then computed in the kernel.
// Row groups take 4V-byte accesses where x, u and out all start on 4V
// bytes, 4-byte ones in the same layout otherwise.
extern "C" int qsgd_rows_launch(const float* x, const float* u,
                                const float* norms, float* out, int rows,
                                int d, const float* levels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || d == 0) return 0;
  const int v = row_vals(d), g = group_threads(d, v);
  if (g <= 1024) {
    const bool vec = aligned(4 * v, x, u, out, out);
    const int block = group_block(g), per = block / g;  // rows a block
    const int grid = (rows + per - 1) / per;
    GROUP_SWITCH(g, v, vec,
                 qsgd_rows_group<G, V, VEC><<<grid, block, 0, s>>>(
                     x, u, norms, out, rows, d, levels))
  } else if (norms) {
    const long long n = (long long)rows * d;
    long long grid = (n + 255) / 256;
    if (grid > 132 * 32) grid = 132 * 32;  // grid-stride beyond ~32 waves
    qsgd_rows_flat<<<(unsigned)grid, 256, 0, s>>>(x, u, norms, out, n, d,
                                                  levels);
  } else {
    qsgd_rows_block<<<rows, kRowThreads, 0, s>>>(x, u, out, d, levels);
  }
  return cudaGetLastError();
}

extern "C" int sign_ef_rows_launch(const float* x, const float* e,
                                   float* c_out, float* e_out, int rows,
                                   int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || d == 0) return 0;
  const int v = row_vals(d), g = group_threads(d, v);
  if (g <= 32) {
    const bool vec = aligned(4 * v, x, e, c_out, e_out);
    const int block = group_block(g), per = block / g;
    const int grid = (rows + per - 1) / per;
    GROUP_SWITCH(g, v, vec,
                 sign_ef_rows_group<G, V, VEC><<<grid, block, 0, s>>>(
                     x, e, c_out, e_out, rows, d))
  } else if (d <= kWarpRowsMax) {
    const int grid = (rows + kWarpRowsPerBlock - 1) / kWarpRowsPerBlock;
    VPT_SWITCH(d, sign_ef_rows_warp<VPT><<<grid, 256, 0, s>>>(
                      x, e, c_out, e_out, rows, d))
  } else {
    sign_ef_rows_block<<<rows, kRowThreads, 0, s>>>(x, e, c_out, e_out, d);
  }
  return cudaGetLastError();
}
