// The importance sampler's inverse-CDF draws, written for Hopper (sm_90a),
// with a plain C interface bound by ctypes
// (soccernerfs_tpu_torch/ops/kernels/sampler_kernels.py).
//
// No TPU kernel: these replace the JAX package's C++ sampler,
// snt_weighted_sample (native/snt_loader.cpp:172), which its
// DynamicBasedPixelSampler calls once per visited image on the host.  Per
// map it builds a sequential f64 CDF of the f32 weights (:174-179), draws
// uniforms u = total * r from std::mt19937_64(seed) (:181-182), takes
// lower_bound(cdf, u) of each, clipped to the last cell, and without
// replacement rejects an index it has kept until it has k or 8k + 64
// attempts are spent (:185-197), then fills the rest from the next draws
// with replacement (:198-204).  Here a step's visited maps go through two
// launches: the uniforms r come from the host (the wrapper's MT19937-64
// stream, the C++'s own), everything that reads a map runs on the card.
//
// snt_cdf_scan_f64: cdf[m, :] = inclusive f64 prefix sums of maps[ids[m], :]
//   (f16 or f32 weights).  One 1024-thread block per map walks it in tiles
//   of 16,384 cells; a warp takes 512 contiguous cells in 16 rounds of 32
//   (coalesced loads and 256-byte stores).  Every level adds a carry to a
//   local prefix, and each carry is the level below's last value with the
//   same operands: a round's values are chain + scan[lane], the next round
//   starts from chain + scan[31]; a warp's values get its warp base, the
//   next warp's base is base + the warp's last value; a tile's values get
//   the tile carry, the next carry is carry + the tile's last value.  A
//   round's scan is a Kogge-Stone sum made non-decreasing by a max-scan.
//   So no CDF step decreases, whatever the rounding.  For f16 maps whose
//   total is below 2**29 (every IST, ISG and ISS map: values in [0, 1])
//   every partial sum is a multiple of 2**-24 below 2**53 of them, exact in
//   f64: the order of the adds does not matter, the max-scan changes
//   nothing, and the CDF is bit-equal to the C++'s sequential one.
// snt_cdf_draw: one warp per map.  In rounds of 32 attempts each lane
//   scales its uniform by the map's total (the CDF's last value) and
//   binary-searches it; then the warp walks the round's attempts in order,
//   the lanes checking the candidate against the indices kept so far
//   (written to the output, read back by the warp) and lane 0 keeping it
//   if none holds it.  After the budget the rest are filled from the next
//   uniforms, 32 at a time.  The plan row of a map is (offset of its
//   uniforms, k, replacement, offset of its output).
//
// Bound on the card: bytes.  The scan must read each visited f16 cell once
// and write its f64 CDF value once, 10 B a cell: 9 maps of 540 x 960 (the
// registered k-planes' IST step, num_ist = 614) move 46.7 MB, 0.014 ms at
// 3.35 TB/s; one add and one max a cell are far below the f64 rate.  The
// draw must read its uniforms, the ~log2(S) CDF values of each search
// and write its indices: a few tens of kB, below a launch's own latency.
// Design for now: simple and right first.  One block per map leaves most
// SMs idle when a step visits 9 maps, and the 16 warp scans a tile spend
// their time in shuffles; PERF.md has the times beside the bound.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int ROUNDS = 16;                          // rounds of 32 per warp
constexpr int64_t WARP_CELLS = 32 * ROUNDS;
constexpr int64_t TILE = SCAN_WARPS * WARP_CELLS;   // 16,384 cells

__device__ __forceinline__ double weight(const __half* p, int64_t i) {
  return (double)__half2float(p[i]);
}

__device__ __forceinline__ double weight(const float* p, int64_t i) {
  return (double)p[i];
}

// inclusive scan of the warp's 32 values, non-decreasing along the lanes:
// a Kogge-Stone sum, then a max-scan (exact, so it only lifts a value that
// the sum's rounding put below an earlier lane's)
__device__ __forceinline__ double warp_scan(double v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = fmax(v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
cdf_scan_kernel(const T* __restrict__ maps, const int64_t* __restrict__ ids,
                int64_t size, double* __restrict__ cdf) {
  __shared__ double warp_last[SCAN_WARPS];
  __shared__ double warp_base[SCAN_WARPS + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* src = maps + ids[blockIdx.x] * size;
  double* dst = cdf + (int64_t)blockIdx.x * size;
  double carry = 0.0;                               // the CDF before the tile
  for (int64_t tile = 0; tile < size; tile += TILE) {
    const int64_t first = tile + warp * WARP_CELLS + lane;
    double v[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int64_t i = first + 32 * r;
      v[r] = i < size ? weight(src, i) : 0.0;
    }
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) v[r] = warp_scan(v[r], lane);
    double chain = 0.0;                             // the warp's cells so far
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const double last = __shfl_sync(FULL, v[r], 31);
      v[r] = chain + v[r];
      chain = chain + last;                         // lane 31's v[r]
    }
    if (lane == 0) warp_last[warp] = chain;
    __syncthreads();
    if (threadIdx.x == 0) {
      double base = 0.0;
      for (int w = 0; w < SCAN_WARPS; ++w) {
        warp_base[w] = base;
        base = base + warp_last[w];
      }
      warp_base[SCAN_WARPS] = base;
    }
    __syncthreads();
    const double base = warp_base[warp];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int64_t i = first + 32 * r;
      if (i < size) dst[i] = carry + (base + v[r]);
    }
    carry = carry + warp_base[SCAN_WARPS];
    __syncthreads();                                // warp_base is rewritten
  }
}

// std::lower_bound: the first i with !(c[i] < u), clipped to size - 1
__device__ __forceinline__ int64_t lower_bound(const double* __restrict__ c,
                                               int64_t size, double u) {
  int64_t lo = 0, len = size;
  while (len > 0) {
    const int64_t half = len >> 1;
    if (c[lo + half] < u) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo < size ? lo : size - 1;
}

__global__ void __launch_bounds__(32)
cdf_draw_kernel(const double* __restrict__ cdf, int64_t size,
                const double* __restrict__ uniforms,
                const int64_t* __restrict__ plan, int64_t* out) {
  const int lane = threadIdx.x;
  const double* c = cdf + (int64_t)blockIdx.x * size;
  const int64_t* p = plan + 4 * (int64_t)blockIdx.x;
  const double* uni = uniforms + p[0];
  const int64_t k = p[1];
  const bool replace = p[2] != 0;
  int64_t* kept = out + p[3];
  const double total = c[size - 1];
  const int64_t budget = replace ? k : 8 * k + 64;
  int64_t produced = 0, attempt = 0;
  while (produced < k && attempt < budget) {
    const int64_t j = attempt + lane;
    const int64_t mine = j < budget ? lower_bound(c, size, uni[j] * total) : 0;
    const int n = budget - attempt < 32 ? (int)(budget - attempt) : 32;
    for (int a = 0; a < n && produced < k; ++a) {
      const int64_t cand = __shfl_sync(FULL, mine, a);
      ++attempt;
      bool held = false;
      if (!replace)
        for (int64_t q = lane; q < produced; q += 32) held |= kept[q] == cand;
      if (__any_sync(FULL, held)) continue;
      if (lane == 0) kept[produced] = cand;
      ++produced;
      __syncwarp();                                 // kept[] seen by the warp
    }
  }
  // the budget spent: the rest with replacement, from the next uniforms
  for (; produced < k; produced += 32, attempt += 32) {
    if (produced + lane < k)
      kept[produced + lane] = lower_bound(c, size, uni[attempt + lane] * total);
  }
}

}  // namespace

extern "C" {

// cdf [m, size] f64 from maps [*, size] (f16 when half_weights, else f32)
// at rows ids [m]; returns the launch's CUDA error (0 when it launched)
int snt_cdf_scan_f64(const void* maps, int half_weights, const int64_t* ids,
                     int m, int64_t size, double* cdf, cudaStream_t stream) {
  if (m <= 0 || size <= 0) return 0;
  if (half_weights)
    cdf_scan_kernel<__half><<<m, SCAN_THREADS, 0, stream>>>(
        static_cast<const __half*>(maps), ids, size, cdf);
  else
    cdf_scan_kernel<float><<<m, SCAN_THREADS, 0, stream>>>(
        static_cast<const float*>(maps), ids, size, cdf);
  return (int)cudaGetLastError();
}

// the draws of m maps from their CDFs cdf [m, size] f64, uniforms in
// [0, 1) and plan [m, 4] int64; writes out [sum of k] int64
int snt_cdf_draw(const double* cdf, int m, int64_t size,
                 const double* uniforms, const int64_t* plan, int64_t* out,
                 cudaStream_t stream) {
  if (m <= 0 || size <= 0) return 0;
  cdf_draw_kernel<<<m, 32, 0, stream>>>(cdf, size, uniforms, plan, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
