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
//   (f16 or f32 weights).  Each map is one thread-block cluster of up to
//   16 CTAs of 512 threads (as many as keep two CTAs an SM busy over the
//   step's maps: 16 for the 9-10 maps of an IST step and for one map),
//   which walks the map in cluster tiles of ranks x 8,192 cells; rank r
//   takes the r-th 8,192.  A thread takes 16 contiguous cells (two 16-byte
//   loads of f16, four of f32; scalar loads when a row is not 16-byte
//   aligned) and sums them in registers, in order: no shuffles.  Then four
//   carries, each a sum in order of the level below's totals: a lane's, of
//   the lower lanes' sums (read from shared memory); a warp's, of the
//   lower warps'; a CTA's, of the lower ranks' CTA totals, which every CTA
//   pushed into every CTA's shared memory (distributed shared memory, one
//   cluster barrier a tile, two buffers); a tile's, of the cluster's CTA
//   totals after the tile before.  A cell's value is
//   cta + (warp + (lane + running sum)): every level adds its carry to the
//   level below's value, and each carry is the level below's last value
//   with the same operands (the next lane's carry is this lane's carry +
//   its sum, which is its last value's inner sum, and so up).  Adding a
//   non-negative weight never lowers an f64, so no CDF step decreases,
//   whatever the rounding, and no max-scan is needed: no level sums in a
//   tree.  For f16 maps whose total is below 2**29 (every IST, ISG and ISS
//   map: values in [0, 1]) every partial sum is a multiple of 2**-24 below
//   2**53 of them, exact in f64, and the CDF is bit-equal to the C++'s
//   sequential one.  The values go through 4 KB of shared memory a warp
//   (an XOR swizzle of the cell by the lane: no bank conflicts either way)
//   and leave as 256-byte coalesced stores.  The next tile's cells are
//   loaded before this tile's carries are summed.
// snt_cdf_draw: one cluster of 8 CTAs of 1,024 threads per map.  Each CTA
//   loads an eighth of a coarse index (the last CDF value of each window
//   of ceil(S / 4096) cells: 127 cells, 4,082 windows at 540 x 960) and
//   writes it into every CTA's shared memory (32 KB); one cluster barrier.
//   Attempts go in rounds (the first ~1.25 k + 8, at least 128, rounded
//   up to a warp; then all the rest, up to 1,024), split over the CTAs:
//   a thread binary-searches the coarse index for the first window whose
//   last value is not below u; then one warp a window, two windows a warp
//   at once: its lanes load the window's cells 32 apart and a ballot
//   counts the cells below u.  So the index is std::lower_bound's by
//   construction (a non-decreasing CDF: every cell before the window is
//   below u, the window's last is not), clipped to S - 1.  Each CTA writes
//   its indices into every CTA's round buffer (two, by round parity); one
//   cluster barrier.  Then every CTA walks the round alike, in shared
//   memory, and the first writes the output: an attempt within the 8k + 64
//   budget is new unless an earlier attempt of the round (a hash table of
//   the round's indices keeps each one's first attempt, atomicMin) or a
//   kept index (the first 2,048 in shared memory, the rest read back from
//   the output through L2) holds its index; past the budget every attempt
//   is new (the fill with replacement).  The new ones take their slots in
//   attempt order (a ballot and a count a warp); the k-th one ends it.
//
// Bound on the card: bytes.  The scan must read each visited f16 cell once
// and write its f64 CDF value once, 10 B a cell: 10 maps of 540 x 960 (the
// registered k-planes' IST step, num_ist = 614, and chip_smoke's 3-cell
// map) move 51.8 MB, 0.0155 ms at 3.35 TB/s; four adds a cell are far
// below the f64 rate.  The draw must read its uniforms, the CDF cells its
// searches read and write its indices: ~75 kB, 2.2e-5 ms, far below an
// empty kernel's launch (0.0047 ms, chip_smoke.py's floor_ms).
//
// What each lever did (H100 80GB HBM3 at 700 W, CUDA events, L2 flushed,
// median of 5 x 20; chip_smoke.py's step / single-map / two full-HD map
// cases; the design before this one: 0.4711 / 0.4642 / 1.8551 ms and
// 0.0437 / 0.0421 / 0.0467 ms):
// - scan, 0.0359 / 0.0235 / 0.0806 ms (0.43 of the bound at the step;
//   torch.cumsum in f64 0.994 / 0.022 / 3.80).  Thread-sequential sums
//   alone, one CTA a map: 0.2395 / 0.2325 / 0.9285; clusters of 4, 8, 16
//   CTAs a map: 0.0715, 0.0449, 0.0359 at the step.  The staged coalesced
//   stores against each thread storing its own 128 bytes: 0.1598 / 0.0652
//   / 0.2731 without.  The prefetch of the next tile: 2-3 % (0.0367 /
//   0.0243 / 0.0813 without).  The lane carry's 31 adds in 4 groups of 8
//   (10 in a row, one more add a cell): 1-4 % faster, not kept; its loads
//   hoisted by hand: no change.  The single map is latency-bound (16 SMs,
//   4 cluster tiles in turn) and runs at torch.cumsum's time.
// - draw, 0.0142 / 0.0123 ms (torch.searchsorted of every attempt, no
//   walk: 0.0161 / 0.0146).  The whole coarse index staged by one CTA
//   (4,096 separate lines from one SM): 0.0167 / 0.0152.  Clusters of 4
//   CTAs ran as fast as 8; of 16 (160 CTAs of 1,024 threads, more than
//   132 SMs) 0.026 against 0.018 at the step, in an earlier version.
//   2,048 windows: 0.0140 / 0.0124.  The first round at ~1.25 k + 8
//   without the floor of 128: 0.0175 at the step (the 3-cell map's spent
//   budget takes a second round).  The round's check by comparisons, 8
//   loads in flight, instead of the table: 0.0155 / 0.0136; a loop that
//   stops at its first match (one load at a time) added 0.0019 / 0.0020
//   to that.  The single map's run ends 0.0074 ms after the launch when
//   cut after the staged index, 0.0100 after the search, 0.0109 after the
//   exchange (an empty launch: 0.0047).
#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;

// ---- cdf_scan_f64
constexpr int SCAN_THREADS = 512;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int CELLS = 16;                           // a thread's cells
constexpr int WARP_CELLS = 32 * CELLS;              // 512
constexpr int CTA_CELLS = SCAN_THREADS * CELLS;     // 8,192
constexpr int MAX_RANKS = 16;                       // CTAs a cluster
constexpr size_t STAGE_BYTES = sizeof(double) * CTA_CELLS;   // 64 KB

// 32-bit words of a thread's cells: 8 of f16, 16 of f32
template <typename T>
constexpr int WORDS = CELLS * (int)sizeof(T) / 4;

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t bits(__half h) { return __half_as_ushort(h); }
__device__ __forceinline__ uint32_t bits(float f) { return __float_as_uint(f); }

// cells [i, i + CELLS) of a map row, 0 past its end
template <typename T>
__device__ __forceinline__ void load_cells(const T* __restrict__ src, int64_t i,
                                           int64_t size, bool vec,
                                           uint32_t (&w)[WORDS<T>]) {
  constexpr int PER = 16 / (int)sizeof(T);          // cells in 16 bytes
  if (vec) {
#pragma unroll
    for (int q = 0; q < CELLS / PER; ++q) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (i + q * PER < size)
        v = __ldg(reinterpret_cast<const uint4*>(src + i + q * PER));
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      const uint32_t b = i + j < size ? bits(src[i + j]) : 0u;
      if constexpr (sizeof(T) == 2) {
        if (j & 1) w[j >> 1] |= b << 16;
        else w[j >> 1] = b;
      } else {
        w[j] = b;
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ double cell(const uint32_t (&w)[WORDS<T>], int j) {
  if constexpr (sizeof(T) == 2)
    return (double)__half2float(
        __ushort_as_half((unsigned short)(w[j >> 1] >> (16 * (j & 1)))));
  else
    return (double)__uint_as_float(w[j]);
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS, 2)
cdf_scan_kernel(const T* __restrict__ maps, const int64_t* __restrict__ ids,
                int64_t size, double* __restrict__ cdf, bool vec) {
  extern __shared__ double stage[];                 // WARP_CELLS a warp
  __shared__ double lane_sum[SCAN_WARPS][32];
  __shared__ double warp_sum[SCAN_WARPS];
  __shared__ double cta_sum[2][MAX_RANKS];          // by rank, two tiles
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t map = blockIdx.x / ranks;
  const T* src = maps + ids[map] * size;
  double* dst = cdf + map * size;
  double* st = stage + warp * WARP_CELLS;
  const int64_t step = (int64_t)ranks * CTA_CELLS;  // cells a cluster tile
  const int64_t mine = (int64_t)rank * CTA_CELLS + threadIdx.x * CELLS;
  uint32_t w[WORDS<T>], next[WORDS<T>];
  load_cells(src, mine, size, vec, w);
  double carry = 0.0;                               // the CDF before the tile
  int buf = 0;
  for (int64_t tile = 0; tile < size; tile += step, buf ^= 1) {
    load_cells(src, tile + step + mine, size, vec, next);
    double sum = 0.0;                               // the thread's cells
#pragma unroll
    for (int j = 0; j < CELLS; ++j) sum = sum + cell<T>(w, j);
    lane_sum[warp][lane] = sum;
    __syncwarp();
    double lane_c = 0.0;                            // the lower lanes' sums
#pragma unroll
    for (int l = 0; l < 31; ++l) {
      const double s = lane_sum[warp][l];
      if (l < lane) lane_c = lane_c + s;
    }
    if (lane == 31) warp_sum[warp] = lane_c + sum;  // the warp's last value
    __syncthreads();
    double warp_c = 0.0, cta = 0.0;                 // the lower warps'; all
#pragma unroll
    for (int v = 0; v < SCAN_WARPS; ++v) {
      if (v == warp) warp_c = cta;
      cta = cta + warp_sum[v];
    }
    if ((int)threadIdx.x < ranks)
      *cluster.map_shared_rank(&cta_sum[buf][rank], (unsigned)threadIdx.x) = cta;
    cluster.sync();                                 // release / acquire
    double cta_c = carry;                           // the lower ranks'
    for (int r = 0; r < ranks; ++r) {
      if (r == rank) cta_c = carry;
      carry = carry + cta_sum[buf][r];
    }
    double run = 0.0;
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      run = run + cell<T>(w, j);
      st[lane * CELLS + (j ^ (lane & 15))] = cta_c + (warp_c + (lane_c + run));
    }
    __syncwarp();
    const int64_t first = tile + (int64_t)rank * CTA_CELLS + warp * WARP_CELLS;
#pragma unroll
    for (int q = 0; q < CELLS; ++q) {
      const int l = q * 32 + lane;                  // the warp's cell
      const int t = l >> 4;                         // its thread
      if (first + l < size) dst[first + l] = st[t * CELLS + ((l & 15) ^ (t & 15))];
    }
#pragma unroll
    for (int j = 0; j < WORDS<T>; ++j) w[j] = next[j];
  }
}

// CTAs a map's cluster: powers of two up to 16, no more than the map's
// CTA tiles, and no more than keep two CTAs on each SM over the m maps
int scan_ranks(int m, int64_t size, int sms) {
  const int64_t tiles = (size + CTA_CELLS - 1) / CTA_CELLS;
  int ranks = 1;
  while (ranks < MAX_RANKS && 2 * ranks <= tiles &&
         (int64_t)m * 2 * ranks <= 2 * (int64_t)sms)
    ranks *= 2;
  return ranks;
}

template <typename T>
int launch_scan(const T* maps, const int64_t* ids, int m, int64_t size,
                double* cdf, cudaStream_t stream) {
  void (*kernel)(const T*, const int64_t*, int64_t, double*, bool) =
      cdf_scan_kernel<T>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STAGE_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ranks = scan_ranks(m, size, sms);
  const bool vec = reinterpret_cast<uintptr_t>(maps) % 16 == 0 &&
                   size % (16 / (int64_t)sizeof(T)) == 0;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(m * ranks));
  config.blockDim = dim3(SCAN_THREADS);
  config.dynamicSmemBytes = STAGE_BYTES;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, maps, ids, size, cdf, vec);
  if (err != cudaSuccess) {
    cudaGetLastError();                             // the launch's own error
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// ---- cdf_draw
constexpr int DRAW_RANKS = 8;                       // CTAs a map's cluster
constexpr int DRAW_THREADS = 1024;
constexpr int DRAW_WARPS = DRAW_THREADS / 32;
constexpr int ROUND = 1024;                         // attempts a round
constexpr int FIRST_ROUND = 128;                    // at least, 16 a rank
constexpr int PER_RANK = ROUND / DRAW_RANKS;        // a rank's searches
constexpr int WINDOWS = 4096;                       // coarse index entries
constexpr int SEARCHES = 2;                         // windows a warp at once
constexpr int KEPT = 2048;                          // kept indices held here
constexpr int TABLE = 2 * ROUND;                    // a round's indices, hashed
static_assert(TABLE == 1 << 11, "the hash takes the top 11 bits");
constexpr unsigned long long EMPTY = ~0ull;

struct DrawShared {
  double last[WINDOWS];                             // each window's last value
  int64_t cand[2][ROUND];                           // a round's indices, by parity
  int64_t kept[KEPT];
  unsigned long long key[TABLE];                    // open addressing: an index,
  int first[TABLE];                                 // its first attempt of the round
  double u[PER_RANK];                               // this rank's u = r * total,
  int win[PER_RANK];                                // windows
  int64_t found[PER_RANK];                          // and indices
  int news[DRAW_WARPS];                             // new indices a warp
  int64_t stop;                                     // the attempt after the k-th
};

struct Map {
  const double* c;                                  // its CDF
  int64_t size, span;                               // cells; cells a window
  int windows;
  double total;
};

__device__ __forceinline__ bool any(const bool (&live)[SEARCHES]) {
  bool a = false;
#pragma unroll
  for (int s = 0; s < SEARCHES; ++s) a |= live[s];
  return a;
}

// std::lower_bound(c, c + size, r * total), clipped to size - 1, of this
// rank's cnt attempts (thread t's uniform r) into sh.found[0, cnt)
__device__ void search(DrawShared& sh, const Map& mp, double r, int cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < cnt) {
    const double u = r * mp.total;
    int lo = 0, len = mp.windows;                   // the first window whose
    while (len > 0) {                               // last value is not below u
      const int half = len >> 1;
      if (sh.last[lo + half] < u) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    sh.u[tid] = u;
    sh.win[tid] = lo;
  }
  __syncthreads();
  for (int a = warp; a < cnt; a += DRAW_WARPS * SEARCHES) {
    double u[SEARCHES];
    int64_t from[SEARCHES];
    int len[SEARCHES], below[SEARCHES];
    bool live[SEARCHES];
#pragma unroll
    for (int s = 0; s < SEARCHES; ++s) {
      const int j = a + s * DRAW_WARPS;
      const int w = j < cnt ? sh.win[j] : mp.windows;
      u[s] = j < cnt ? sh.u[j] : 0.0;
      from[s] = (int64_t)w * mp.span;
      len[s] = w < mp.windows ? (int)imin(mp.span, mp.size - from[s]) : 0;
      below[s] = 0;
      live[s] = len[s] > 0;
    }
    for (int off = 0; any(live); off += 128) {
      double v[SEARCHES][4];
#pragma unroll
      for (int s = 0; s < SEARCHES; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = off + 32 * q + lane;
          v[s][q] = live[s] && i < len[s] ? mp.c[from[s] + i] : CUDART_INF;
        }
#pragma unroll
      for (int s = 0; s < SEARCHES; ++s) {
        if (!live[s]) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned b = __ballot_sync(FULL, v[s][q] < u[s]);
          below[s] += __popc(b);
          if (b != FULL) {                          // the CDF is non-decreasing
            live[s] = false;
            break;
          }
        }
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < SEARCHES; ++s) {
        const int j = a + s * DRAW_WARPS;
        if (j < cnt) sh.found[j] = imin(from[s] + below[s], mp.size - 1);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(DRAW_THREADS, 1)
cdf_draw_kernel(const double* __restrict__ cdf, int64_t size,
                const double* __restrict__ uniforms,
                const int64_t* __restrict__ plan, int64_t* out) {
  extern __shared__ __align__(16) unsigned char raw[];
  DrawShared& sh = *reinterpret_cast<DrawShared*>(raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t map = blockIdx.x / DRAW_RANKS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Map mp;
  mp.c = cdf + map * size;
  mp.size = size;
  mp.span = (size + WINDOWS - 1) / WINDOWS;
  mp.windows = (int)((size + mp.span - 1) / mp.span);
  const int64_t* p = plan + 4 * map;
  const double* uni = uniforms + p[0];
  const int64_t k = p[1];
  const bool replace = p[2] != 0;
  int64_t* kept = out + p[3];
  // the walk's attempts, then the fill's: k in all with replacement
  const int64_t budget = replace ? k : 8 * k + 64;
  // this rank's share of the coarse index, into every rank's
  const int share = (mp.windows + DRAW_RANKS - 1) / DRAW_RANKS;
  for (int w = rank * share + tid; w < imin((rank + 1) * share, mp.windows);
       w += DRAW_THREADS) {
    const double v = mp.c[imin(size, (w + 1) * mp.span) - 1];
#pragma unroll
    for (int d = 0; d < DRAW_RANKS; ++d)
      *cluster.map_shared_rank(&sh.last[w], d) = v;
  }
  // the first round: ~1.25 times the indices to keep, at least
  // FIRST_ROUND (a round costs about as much up to there: it covers a
  // small k's whole budget and fill), and its uniforms load beside the
  // coarse index
  int64_t produced = 0, attempt = 0;
  int n = (int)imin(imin(imax((k + k / 4 + 8 + 31) / 32 * 32, FIRST_ROUND),
                         ROUND),
                    replace ? k : budget + k);
  int per = (n + DRAW_RANKS - 1) / DRAW_RANKS;
  int cnt = (int)imin(per, imax(n - rank * per, 0));
  double r = tid < cnt ? uni[rank * per + tid] : 0.0;
  cluster.sync();
  mp.total = sh.last[mp.windows - 1];
  for (int round = 0; produced < k; ++round) {
    if (round > 0) {                                // the rest, up to ROUND:
      // the walk's attempts to the budget and the fill's after it
      const int64_t last = replace ? attempt : imax(budget, attempt);
      n = (int)imin(ROUND, last + (k - produced) - attempt);
      per = (n + DRAW_RANKS - 1) / DRAW_RANKS;
      cnt = (int)imin(per, imax(n - rank * per, 0));
      r = tid < cnt ? uni[attempt + rank * per + tid] : 0.0;
    }
    for (int i = tid; i < TABLE; i += DRAW_THREADS) {
      sh.key[i] = EMPTY;
      sh.first[i] = ROUND;
    }
    search(sh, mp, r, cnt);
    int64_t* cand = sh.cand[round & 1];
    for (int i = tid; i < cnt * DRAW_RANKS; i += DRAW_THREADS)
      *cluster.map_shared_rank(&cand[rank * per + i / DRAW_RANKS],
                               i % DRAW_RANKS) = sh.found[i / DRAW_RANKS];
    cluster.sync();
    // the walk, on every rank alike: an attempt within the budget is new
    // unless an earlier attempt of the round (the table's first attempt of
    // its index) or a kept index holds its index; past the budget every
    // attempt is (the fill)
    const int64_t idx = tid < n ? cand[tid] : 0;
    const bool checked = tid < n && !replace && attempt + tid < budget;
    int entry = 0;
    if (checked) {
      entry = (int)(((uint64_t)idx * 0x9e3779b97f4a7c15ull) >> 53);  // of 2,048
      for (;;) {
        const unsigned long long held =
            atomicCAS(&sh.key[entry], EMPTY, (unsigned long long)idx);
        if (held == EMPTY || held == (unsigned long long)idx) break;
        entry = (entry + 1) & (TABLE - 1);
      }
      atomicMin(&sh.first[entry], tid);
    }
    __syncthreads();
    bool is_new = tid < n;
    if (checked) {
      bool held = sh.first[entry] != tid;
      for (int64_t q = 0; q < produced; q += 8)     // 8 loads in flight
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (q + e < produced)
            held |= (q + e < KEPT ? sh.kept[q + e]
                                  : __ldcg(reinterpret_cast<const long long*>(
                                        kept) + q + e)) == idx;
      is_new = !held;
    }
    const unsigned b = __ballot_sync(FULL, is_new);
    if (lane == 0) sh.news[warp] = __popc(b);
    __syncthreads();
    int before = 0, news = 0;
    for (int v = 0; v < DRAW_WARPS; ++v) {
      const int c = sh.news[v];
      before += v < warp ? c : 0;
      news += c;
    }
    const int64_t slot = produced + before + __popc(b & ((1u << lane) - 1));
    if (is_new && slot < k) {
      if (rank == 0) kept[slot] = idx;
      if (slot < KEPT) sh.kept[slot] = idx;
      if (slot == k - 1) sh.stop = attempt + tid + 1;
    }
    __syncthreads();
    if (produced + news >= k) {
      attempt = sh.stop;
      produced = k;
    } else {
      attempt += n;
      produced += news;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// cdf [m, size] f64 from maps [*, size] (f16 when half_weights, else f32)
// at rows ids [m]; returns the launch's CUDA error (0 when it launched)
int snt_cdf_scan_f64(const void* maps, int half_weights, const int64_t* ids,
                     int m, int64_t size, double* cdf, cudaStream_t stream) {
  if (m <= 0 || size <= 0) return 0;
  if (half_weights)
    return launch_scan(static_cast<const __half*>(maps), ids, m, size, cdf,
                       stream);
  return launch_scan(static_cast<const float*>(maps), ids, m, size, cdf,
                     stream);
}

// the draws of m maps from their CDFs cdf [m, size] f64, uniforms in
// [0, 1) and plan [m, 4] int64; writes out [sum of k] int64
int snt_cdf_draw(const double* cdf, int m, int64_t size,
                 const double* uniforms, const int64_t* plan, int64_t* out,
                 cudaStream_t stream) {
  if (m <= 0 || size <= 0) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      cdf_draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(DrawShared));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = DRAW_RANKS;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(m * DRAW_RANKS));
  config.blockDim = dim3(DRAW_THREADS);
  config.dynamicSmemBytes = sizeof(DrawShared);
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, cdf_draw_kernel, cdf, size, uniforms, plan, out);
  if (launched != cudaSuccess) {
    cudaGetLastError();                             // the launch's own error
    return (int)launched;
  }
  return (int)cudaGetLastError();
}

// an empty kernel's launch: the floor under a short kernel's time
int snt_sampler_empty_launch(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
