// Row scatter-add, the table-gradient kernel of the hash-grid encoders,
// written for Hopper (sm_90a), with a plain C interface bound by ctypes
// (soccernerfs_tpu_torch/ops/kernels/scatter_kernels.py).
//
// snt_scatter_add_rows replaces sorted_scatter_add
//   (soccernerfs_tpu/ops/pallas/plane_kernels.py:1342, body _scatter_kernel
//   :1257): out[r, :] = sum over updates i with idx[i] == r of g[i, :], into
//   an f32 [rows, c] table that the caller zero-filled.
// The TPU kernel takes the expanded update stream: the caller forms
// w[k, b] * g[b, :] for every lattice corner k of every point b, sorts it by
// row and hands over [K*B, c].  Here the expansion happens in the kernel:
// it takes the unexpanded upstream gradient g [B, G*c] (G groups, the levels
// of one table, side by side as the encoder's output has them), row indices
// idxs [G, K, B] into the shared table and optional weights ws [G, K, B],
// and adds ws[j, k, b] * g[b, j*c:(j+1)*c] to row idxs[j, k, b].  G = K = 1
// without weights is sorted_scatter_add itself, on indices in any order.
// Each product rounds on its own (__fmul_rn), as the plain version's;
// only the order of the sums differs.
//
// Bound on the card: bytes.  It must read g once (4c B per point and
// group), each index and weight once (8 B per update) and write the table
// once (4c B per row; the wrapper's zero fill is that one write, the
// atomics' read-modify-writes are not counted): 275 MB, 0.082 ms at
// 3.35 TB/s for the nerfacto main grid's launch (16 levels, 25.2 M
// updates).  One multiply per channel and update is far below the
// ~20 flop/B where the f32 rate would bind.
//
// What bounded the kernel's first version (one thread per (level, point)
// walking the 8 corners, one 8-byte float2 reduction per corner, a host
// read of the range flag after every launch): scattered L2 reductions, one
// per update (25.2 M on the main grid's launch, ~0.45 ms), which complete
// at ~55-65 G/s when every lane of a warp hits its own 32-byte sector.
// The TPU kernel sorts and sums each stripe of rows with one-hot MXU
// matmuls in VMEM; blocks on the card run in no order, so atomics stay.
// The design (each part measured on the train step's own launches,
// PERF.md):
//   * A lane serves one item: V = min(c, 4) channels (chunk q of the row)
//     of one group j and one corner k over a strip of 8 consecutive points
//     (4 for float4 lanes).  Items run group by group (the chunk, then the
//     corner, then the strip innermost) and the blocks stride over them
//     together, so the whole card works on one level at a time and the
//     rows it updates stay in L2 (the main grid's 49 MB table does not fit
//     it; a layout with the group innermost took 0.75 ms on the main
//     grid's launch, the first version 0.46).  A lane's index and weight
//     loads walk its own 32-byte sectors along the strip.
//   * Runs merge in registers.  The train path flattens samples ray by ray,
//     so consecutive points often share a cell on the coarse levels: a
//     lane sums its terms while the row stays the same and flushes the sum
//     with one reduction (float2 for c = 2, float4 per 4 channels) when it
//     changes and at the strip's end, as plane_bwd_kernels.cu does.  Points
//     in any order stay correct; a strip of random points flushes at every
//     point.
//     Longer strips (16-64 points) merge more but ran slower: fewer lanes
//     in flight, each waiting on its loads in turn.
//   * Not kept: a lane per z-pair of corners, whose neighbouring rows went
//     as one 16-byte atomicAdd(float4*) where the first row was even.  It
//     issued ~27 % fewer reductions and took 1.2-1.3x as long.
//   * Level 0 in shared memory.  The table's first `shared_rows` rows (the
//     wrapper picks 32 KB: level 0, 16^3 rows, of every nerfacto grid, up
//     to 37,000 updates per row in a proposal_0 launch) are summed per block
//     with shared-memory atomics; at its end the block adds each 16-byte
//     piece of that window that is not zero to the table with one vector
//     reduction.  The grid is persistent (one 1024-thread block per SM), so
//     each window row takes at most one add per SM from L2.  It is not
//     faster (shared-memory float adds cost about what the reductions they
//     save do), but without it the f32 atomics' rounding on those rows
//     strayed from an f64 sum by 1.1-1.7e-6 of a row's sum of |terms|,
//     past the 1e-6 the card checks hold the kernel to; with it, <= 5.4e-7.
//   * No host read of the device: a row outside [0, rows) is not clipped,
//     its update is dropped and a sticky per-device flag set, which the
//     wrapper's raise_if_out_of_range reads when the caller asks.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "atomicAdd(float2*), atomicAdd(float4*) need CUDA 12.1 or later"
#endif

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block can have

// points per lane strip: fewer for float4 lanes, whose gradients take twice
// the registers (a 1024-thread block leaves each thread 64)
__host__ __device__ constexpr int strip_of(int v) { return v == 4 ? 4 : 8; }

struct ScatterArgs {
  const float* g;
  const int32_t* idxs;
  const float* ws;  // null: weights of 1
  float* out;
  int* flag;
  long long points;
  long long strips;  // strips per group
  long long items;   // groups * strips * corners * chunks
  int groups, corners, c, rows, shared_rows;
  int chunks;  // c / V
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = __ldg(p);
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
}

template <int V>
__device__ __forceinline__ void red_global(float* dst, const float (&a)[V]) {
  if constexpr (V == 1) {
    atomicAdd(dst, a[0]);
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a[0], a[1]));
  } else {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(a[0], a[1], a[2], a[3]));
  }
}

// Add a lane's merged sum for table row `row` (channels [qV, qV + V)).
template <int V>
__device__ __forceinline__ void flush(float* out, float* window, int* flag,
                                      int rows, int shared_rows, int c, int q,
                                      int row, const float (&acc)[V]) {
  if (row < 0 || row >= rows) {
    *flag = 1;
  } else if (row < shared_rows) {
    float* dst = window + row * c + q * V;
#pragma unroll
    for (int ch = 0; ch < V; ++ch) atomicAdd(dst + ch, acc[ch]);
  } else {
    red_global<V>(out + (long long)row * c + q * V, acc);
  }
}

// V: channels per lane (c for c <= 2, else 4).
template <int V>
__global__ void __launch_bounds__(kThreads, 1)
scatter_add_rows_kernel(const __grid_constant__ ScatterArgs a) {
  constexpr int S = strip_of(V);
  extern __shared__ float4 window4[];
  float* window = reinterpret_cast<float*>(window4);
  const int window_vecs = a.shared_rows * a.c / 4;
  for (int i = threadIdx.x; i < window_vecs; i += kThreads)
    window4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const long long stride = (long long)a.groups * a.c;
  for (long long it = (long long)blockIdx.x * kThreads + threadIdx.x;
       it < a.items; it += (long long)gridDim.x * kThreads) {
    // item = ((group * strips + strip) * corners + corner) * chunks + chunk
    unsigned t = (unsigned)it;  // items < 2^32 (checked at launch)
    const int q = (int)(t % (unsigned)a.chunks);
    t /= (unsigned)a.chunks;
    const int k = (int)(t % (unsigned)a.corners);
    t /= (unsigned)a.corners;
    const long long s = t % (unsigned)a.strips;
    const int j = (int)(t / (unsigned)a.strips);
    const long long first = s * S;
    const int n = (int)(a.points - first < S ? a.points - first : S);
    const long long u0 = ((long long)j * a.corners + k) * a.points;

    // the strip's operands, every load issued before the first add (a point
    // past the end re-reads the last one and is skipped below)
    int row[S];
    float w[S];
    float gv[S][V];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const long long b = first + (i < n ? i : n - 1);
      row[i] = __ldg(a.idxs + u0 + b);
      w[i] = a.ws != nullptr ? __ldg(a.ws + u0 + b) : 1.0f;
      load_vec<V>(a.g + b * stride + j * a.c + q * V, gv[i]);
    }

    int cur = row[0];
    float acc[V];
#pragma unroll
    for (int ch = 0; ch < V; ++ch) acc[ch] = __fmul_rn(gv[0][ch], w[0]);
#pragma unroll
    for (int i = 1; i < S; ++i) {
      if (i < n) {
        const bool same = row[i] == cur;
        if (!same) {
          flush<V>(a.out, window, a.flag, a.rows, a.shared_rows, a.c, q, cur,
                   acc);
          cur = row[i];
        }
#pragma unroll
        for (int ch = 0; ch < V; ++ch) {
          const float term = __fmul_rn(gv[i][ch], w[i]);
          acc[ch] = same ? __fadd_rn(acc[ch], term) : term;
        }
      }
    }
    flush<V>(a.out, window, a.flag, a.rows, a.shared_rows, a.c, q, cur, acc);
  }

  // the window: one vector reduction per 16-byte piece this block touched
  __syncthreads();
  for (int i = threadIdx.x; i < window_vecs; i += kThreads) {
    const float4 v = window4[i];
    if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(a.out) + i, v);
  }
}

template <int V>
int launch(const ScatterArgs& a, int blocks, int smem, cudaStream_t s) {
  auto kernel = scatter_add_rows_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

int vec_of(int c) { return c >= 4 ? 4 : c; }

}  // namespace

// g: [points, groups * c] f32; idxs: [groups, corners, points] int32 rows of
// `out`; ws: [groups, corners, points] f32, or null for weights of 1; out:
// zero-filled [rows, c] f32; flag: one int32 that the kernel sets to 1 when
// an index lies outside [0, rows) (that update is dropped) and never
// clears.  c is 1, 2 or a multiple of 4.  The first `shared_rows` rows of
// the table are summed in shared memory (shared_rows * c a multiple of 4,
// at most 227 KB).
extern "C" int snt_scatter_add_rows(const void* g, const void* idxs,
                                    const void* ws, void* out, void* flag,
                                    long long points, int groups, int corners,
                                    int c, long long rows, int shared_rows,
                                    void* stream) {
  const long long window = (long long)shared_rows * c;  // floats
  if (points <= 0 || groups < 1 || corners < 1 || rows < 1 ||
      rows > 2147483647LL || !(c == 1 || c == 2 || (c > 0 && c % 4 == 0)) ||
      shared_rows < 0 || shared_rows > rows || window % 4 ||
      window * 4 > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  const int v = vec_of(c);
  const long long strips = (points + strip_of(v) - 1) / strip_of(v);
  const long long items = strips * groups * corners * (c / v);
  if (items > 0xffffffffLL) return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > sms) blocks = sms;

  ScatterArgs a;
  a.g = static_cast<const float*>(g);
  a.idxs = static_cast<const int32_t*>(idxs);
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<float*>(out);
  a.flag = static_cast<int*>(flag);
  a.points = points;
  a.strips = strips;
  a.items = items;
  a.groups = groups;
  a.corners = corners;
  a.c = c;
  a.rows = (int)rows;
  a.shared_rows = shared_rows;
  a.chunks = c / v;
  const int smem = (int)(window * 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)blocks;
  if (v == 1) return launch<1>(a, b, smem, s);
  if (v == 2) return launch<2>(a, b, smem, s);
  return launch<4>(a, b, smem, s);
}

// Points per lane strip for rows of c channels (the run merge's reach).
extern "C" int snt_scatter_add_rows_strip(int c) {
  return strip_of(vec_of(c));
}

// Threads per block; the grid has min(SMs, items / threads) blocks, which
// stride over the items together.
extern "C" int snt_scatter_add_rows_threads(void) { return kThreads; }
