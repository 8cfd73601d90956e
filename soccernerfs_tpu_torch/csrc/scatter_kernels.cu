// Row scatter-add, the table-gradient kernel of the hash-grid encoders,
// written for Hopper (sm_90a), with a plain C interface bound by ctypes
// (soccernerfs_tpu_torch/ops/kernels/scatter_kernels.py).
//
// snt_scatter_add_rows replaces sorted_scatter_add
//   (soccernerfs_tpu/ops/pallas/plane_kernels.py, body _scatter_kernel):
//   out[r, :] = sum over updates i with idx[i] == r of g[i, :], into an f32
//   [rows, c] table that the caller zero-filled.
// The TPU kernel takes the expanded update stream: the caller forms
// w[k, b] * g[b, :] for every lattice corner k of every point b, sorts it by
// row and hands over [K*B, c].  Here the expansion happens in the kernel:
// it takes the unexpanded upstream gradient g [B, G*c] (G groups, the levels
// of one table, side by side as the encoder's output has them), row indices
// idxs [G, K, B] into the shared table and optional weights ws [G, K, B],
// and adds ws[j, k, b] * g[b, j*c:(j+1)*c] to row idxs[j, k, b].  G = K = 1
// without weights is sorted_scatter_add itself, on indices in any order.
//
// Bound on the card: bytes.  It must read g once (4c B per point and
// group), each index and weight once (8 B per update) and write the table
// once (4c B per row; the wrapper's zero fill is that one write, the
// atomics' read-modify-writes are not counted).  One multiply per channel
// and update is far below the ~20 flop/B where the f32 rate would bind.
// The design:
//   * The TPU kernel needs sorted indices: each stripe of table rows
//     accumulates its contiguous run of updates with one-hot MXU matmuls in
//     VMEM, and it rounds g to bf16 for them.  Blocks on the card run in no
//     order, so a thread adds its updates straight into the table with
//     atomics, in f32, and the indices may come in any order: no sort, no
//     expanded [K*B, c] stream in device memory (67 MB per level at the
//     first proposal field's 1,048,576 points).
//   * One thread serves one (group, point): it loads its c gradients once
//     and walks the K corners; consecutive threads take consecutive points
//     of one group, so every index and weight load is a coalesced stream.
//   * c = 2 and c = 4 (the hash grids' widths) add a whole row with one
//     vector atomic (atomicAdd on float2 / float4, sm_90); other widths loop
//     over scalar atomics.
//   * Contention: a dense coarse level (16^3 cells) takes ~400 adds per row
//     per step, which serialise in L2.  This first kernel leaves it at
//     that; warp-level pre-aggregation of equal rows or a sort are for a
//     measured later change.
//   * A row outside [0, rows) is not clipped: the update is dropped and a
//     flag raised, which the wrapper reads and turns into an error.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// atomicAdd(float2*), atomicAdd(float4*): CUDA 12.1 and later, sm_90
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 || \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define SNT_VECTOR_ATOMICS 1
#else
#define SNT_VECTOR_ATOMICS 0
#endif

template <int C>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
#if SNT_VECTOR_ATOMICS
  if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    return;
  } else if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#endif
#pragma unroll
  for (int ch = 0; ch < C; ++ch) atomicAdd(dst + ch, v[ch]);
}

// C > 0: the channel count, held in registers.  C == 0: any channel count
// `c`, re-read per corner (wide rows; the loads hit L1).
template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const float* __restrict__ g,
                        const int32_t* __restrict__ idxs,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int* __restrict__ flag, long long points, int groups,
                        int corners, int c, long long rows) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= points * groups) return;
  const long long grp = t / points;
  const long long b = t - grp * points;
  const int width = C > 0 ? C : c;
  const float* src = g + (b * groups + grp) * width;

  float gv[C > 0 ? C : 1];
  if constexpr (C > 0) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) gv[ch] = __ldg(src + ch);
  }

  for (int k = 0; k < corners; ++k) {
    const long long u = (grp * corners + k) * points + b;
    const long long row = __ldg(idxs + u);
    if (row < 0 || row >= rows) {
      *flag = 1;
      continue;
    }
    const float w = ws != nullptr ? __ldg(ws + u) : 1.0f;
    float* dst = out + row * width;
    if constexpr (C > 0) {
      float v[C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) v[ch] = __fmul_rn(gv[ch], w);
      add_row<C>(dst, v);
    } else {
      for (int ch = 0; ch < c; ++ch)
        atomicAdd(dst + ch, __fmul_rn(__ldg(src + ch), w));
    }
  }
}

}  // namespace

// g: [points, groups * c] f32; idxs: [groups, corners, points] int32 rows of
// `out`; ws: [groups, corners, points] f32, or null for weights of 1; out:
// zero-filled [rows, c] f32; flag: one int32, zero on entry, set to 1 when
// an index lies outside [0, rows) (that update is dropped).
extern "C" int snt_scatter_add_rows(const void* g, const void* idxs,
                                    const void* ws, void* out, void* flag,
                                    long long points, int groups, int corners,
                                    int c, long long rows, void* stream) {
  if (points <= 0 || groups < 1 || corners < 1 || c < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const long long threads = points * groups;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const int32_t* ip = static_cast<const int32_t*>(idxs);
  const float* wp = static_cast<const float*>(ws);
  float* op = static_cast<float*>(out);
  int* fp = static_cast<int*>(flag);
  switch (c) {
    case 1:
      scatter_add_rows_kernel<1><<<grid, kThreads, 0, s>>>(
          gp, ip, wp, op, fp, points, groups, corners, c, rows);
      break;
    case 2:
      scatter_add_rows_kernel<2><<<grid, kThreads, 0, s>>>(
          gp, ip, wp, op, fp, points, groups, corners, c, rows);
      break;
    case 4:
      scatter_add_rows_kernel<4><<<grid, kThreads, 0, s>>>(
          gp, ip, wp, op, fp, points, groups, corners, c, rows);
      break;
    case 8:
      scatter_add_rows_kernel<8><<<grid, kThreads, 0, s>>>(
          gp, ip, wp, op, fp, points, groups, corners, c, rows);
      break;
    default:
      scatter_add_rows_kernel<0><<<grid, kThreads, 0, s>>>(
          gp, ip, wp, op, fp, points, groups, corners, c, rows);
      break;
  }
  return (int)cudaGetLastError();
}
