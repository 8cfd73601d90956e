// Bilinear plane-sampling backward kernels of the K-Planes train path,
// written for Hopper (sm_90a), with a plain C interface bound by ctypes
// (soccernerfs_tpu_torch/ops/kernels/plane_kernels.py).
//
// Both kernels compute the transpose of the forward kernels of
// plane_kernels.cu: for every point i of every plane p in one launch they
// add the upstream gradient g_p[i, :] (f32), weighted by the four bilinear
// corner weights
//   w00 = (1-tx)(1-ty), w01 = tx(1-ty), w10 = (1-tx)ty, w11 = tx*ty,
// into an f32 gradient table that the caller zero-filled.  Each weight and
// each weighted term rounds on its own (__fmul_rn, no FMA contraction), as
// the plain PyTorch versions compute them; only the order of the sums
// differs (register sums, then atomics), so a kernel agrees with its plain
// version to f32 rounding of the sums, not bit for bit.
//
// snt_bilerp_bwd_unpacked replaces bilerp_bwd_group_fold
//   (soccernerfs_tpu/ops/pallas/plane_kernels.py, body _bwd_kernel_fold):
//   the gradient of an unpacked [h*w, F] plane; corners (y0, x0), (y0, x1),
//   (y1, x0), (y1, x1) with x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1).
//   At a right or bottom border two corners are the same row and both adds
//   land there: that is the fold of quad_pack's border replication, which
//   the TPU kernel does with carried halos between sequential grid steps.
// snt_bilerp_bwd_packed replaces packed_bilerp_bwd_group (same file, body
//   _bwd_kernel): the gradient of a quad-packed [R, 4F] table; quarter k of
//   row `rowid` gets w_k * g (quad_pack's transpose folds it afterwards).
//
// Bound on the card: bytes.  Per point the kernel must read 4 B of ty and,
// per point and plane, 8 B (row id, tx) and 4F B of g, and it must write
// the whole f32 table once (268 MB for two 1024x1024x32 planes; the
// wrapper's zero fill is that write): about 8 flop per feature against 4F B
// of g, far below the ~20 flop/B where the H100's f32 rate would bind.
// What sets the time instead is the count of L2 atomic operations.  A
// first version issued 4 x 8 scalar atomicAdds per thread, F/8 threads per
// point; on the card they completed at a flat ~83-94 G/s whether the table
// fit in L2 or not and whatever the contention, so the kernels ran at
// 3-24 % of their byte bound.  The TPU kernels sort points into row
// stripes and scatter with one-hot MXU matmuls into VMEM; blocks on the
// card run in no order, so atomics stay, and the design cuts their number:
//   * One 16-byte vector reduction per lane.  F lanes serve a point, lane =
//     corner * F/4 + quarter: the lane loads g[i, 4 quarter : 4 quarter + 4]
//     as one float4 and adds its corner's weight times that into the
//     corner's row with atomicAdd(float4*) (red.global.add.v4.f32, sm_90,
//     CUDA 12.1 or later).  A point's lanes cover its corner rows whole:
//     for F = 32 a warp instruction writes four whole 128-byte rows (two
//     256-byte runs), where the scalar kernel wrote 32 words in 32 sectors;
//     in a packed F = 8 row quarter k is corner k, so the 8 lanes of a
//     point write its one 128-byte row.  4x fewer atomic operations.  A
//     first layout, F/4 lanes that each walk the four corners, measured
//     level on the unpacked kernel's train-step launches (summed: 1.7 %
//     faster in one run, 3.3 % slower in another) and took 1.21-1.31x as
//     long on the packed kernel's (PERF.md): with 2 lanes per F = 8 point
//     a warp instruction touched 16 rows, here 4.
//   * Runs along a ray merge in registers.  A lane walks a strip of kStrip
//     consecutive points (the train path flattens its samples ray by ray,
//     so a strip is a piece of one ray): it loads the whole strip first,
//     then sums its terms in registers while the row id stays the same and
//     flushes the sum with one vector reduction when it changes and at the
//     strip's end.  No sort and no extra pass; points in any order stay
//     correct, a strip of random points just flushes at every point.
//     Equal row ids mean equal corners, border folds included.  On the
//     train step's operands a flush carries 1.0-1.7 points of the main
//     field and 1.0-2.7 of the proposal fields.
//   * kStrip = 8 (62-64 registers, no spills): on the step's launches
//     (summed, in two runs) strips of 4 and 16 (125 registers) came within
//     5 % of it and 32 (237 registers) took 1.17-1.19x as long (PERF.md).
//     At 8 the main field's 262,144 points make 1,048,576 threads per
//     plane.
//   * Up to 3 planes of one table shape share a launch (blockIdx.y); the
//     parameter struct is __grid_constant__ so indexing it by blockIdx.y
//     reads parameter space instead of a per-thread local copy (losing it
//     cost 2.3x once).
// What bounds it now: on tables that fit in L2, the rate of vector
// reductions (~100-150 G/s); on the 1024x1024 planes (134 MB each) the
// read-modify-write of their rows in HBM after the zero fill.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(__CUDACC_VER_MAJOR__) || __CUDACC_VER_MAJOR__ < 12 || \
    (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ < 1)
#error "atomicAdd(float4*) needs CUDA 12.1 or later"
#endif

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kStrip = 8;  // points per lane

struct PlaneGradArgs {
  const float* g[kMaxPlanes];
  const int32_t* rowid[kMaxPlanes];
  const float* tx[kMaxPlanes];
  float* grad[kMaxPlanes];
  const float* ty;
};

__device__ __forceinline__ float4 scaled(float4 g, float w) {
  return make_float4(__fmul_rn(g.x, w), __fmul_rn(g.y, w), __fmul_rn(g.z, w),
                     __fmul_rn(g.w, w));
}

__device__ __forceinline__ float4 plus(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// Where a lane's sum for table row `row` goes.  F lanes serve a point, lane
// = corner * F/4 + quarter: the lane owns features [4 quarter, 4 quarter +
// 4) of one corner, which in a packed [R, 4F] row is float4 number `lane`.
template <int F, bool kPacked>
__device__ __forceinline__ float* corner_dst(float* grad, int row, int lane,
                                             int h, int w) {
  if constexpr (kPacked) {
    return grad + (long long)row * (4 * F) + lane * 4;
  } else {
    const int corner = lane / (F / 4);
    const int y0 = row / w;
    const int x0 = row - y0 * w;
    const int dx = (corner & 1) && x0 < w - 1 ? 1 : 0;
    const int dy = (corner & 2) && y0 < h - 1 ? w : 0;
    return grad + (long long)(row + dy + dx) * F + (lane % (F / 4)) * 4;
  }
}

template <int F, bool kPacked>
__global__ void __launch_bounds__(kThreads)
bilerp_bwd_kernel(const __grid_constant__ PlaneGradArgs a, long long m, int h,
                  int w, int rows) {
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long first = (t / F) * kStrip;
  const int lane = (int)(t % F);
  const int corner = lane / (F / 4);
  if (first >= m) return;
  const int n = (int)(m - first < kStrip ? m - first : kStrip);

  // the strip's operands, every load issued before the first add (a point
  // past the end re-reads the last one and is skipped below)
  int rowid[kStrip];
  float tx[kStrip], ty[kStrip];
  float4 g[kStrip];
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    const long long i = first + (k < n ? k : n - 1);
    rowid[k] = __ldg(a.rowid[p] + i);
    tx[k] = __ldg(a.tx[p] + i);
    ty[k] = __ldg(a.ty + i);
    g[k] = __ldg(reinterpret_cast<const float4*>(a.g[p] + i * F) +
                 lane % (F / 4));
  }

  int cur = 0;
  float4 acc;
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    if (k < n) {
      int row = rowid[k];
      row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);  // as the forward
      // this corner's weight: (1-tx or tx) * (1-ty or ty)
      const float fx = corner & 1 ? tx[k] : __fsub_rn(1.0f, tx[k]);
      const float fy = corner & 2 ? ty[k] : __fsub_rn(1.0f, ty[k]);
      const float4 term = scaled(g[k], __fmul_rn(fx, fy));
      if (k > 0 && row == cur) {
        acc = plus(acc, term);
      } else {
        if (k > 0)
          atomicAdd(reinterpret_cast<float4*>(
                        corner_dst<F, kPacked>(a.grad[p], cur, lane, h, w)),
                    acc);
        cur = row;
        acc = term;
      }
    }
  }
  atomicAdd(reinterpret_cast<float4*>(
                corner_dst<F, kPacked>(a.grad[p], cur, lane, h, w)),
            acc);
}

template <bool kPacked>
int launch(int planes, const void* const* gs, const void* const* rowids,
           const void* const* txs, const void* ty, void* const* grads,
           long long m, int h, int w, long long rows, int feat, void* stream) {
  if (planes < 1 || planes > kMaxPlanes || m <= 0 || rows < 1 ||
      rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  PlaneGradArgs a;
  for (int p = 0; p < kMaxPlanes; ++p) {
    const int q = p < planes ? p : 0;
    a.g[p] = static_cast<const float*>(gs[q]);
    a.rowid[p] = static_cast<const int32_t*>(rowids[q]);
    a.tx[p] = static_cast<const float*>(txs[q]);
    a.grad[p] = static_cast<float*>(grads[q]);
  }
  a.ty = static_cast<const float*>(ty);
  const long long threads = (m + kStrip - 1) / kStrip * feat;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 8:
      bilerp_bwd_kernel<8, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w,
                                                             (int)rows);
      break;
    case 32:
      bilerp_bwd_kernel<32, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w,
                                                              (int)rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// gs: P x [m, feat] f32; rowids: P x [m] int32 (y0*w + x0); txs: P x [m]
// f32; ty: [m] f32, shared by the P planes; grads: P zero-filled
// [h*w, feat] f32.  feat in {8, 32}, 1 <= P <= 3.
extern "C" int snt_bilerp_bwd_unpacked(
    int planes, const void* const* gs, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* grads,
    long long m, int h, int w, int feat, void* stream) {
  return launch<false>(planes, gs, rowids, txs, ty, grads, m, h, w,
                       (long long)h * w, feat, stream);
}

// grads: P zero-filled [rows, 4*feat] f32 quad-packed tables; the rest as
// snt_bilerp_bwd_unpacked.
extern "C" int snt_bilerp_bwd_packed(
    int planes, const void* const* gs, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* grads,
    long long m, long long rows, int feat, void* stream) {
  return launch<true>(planes, gs, rowids, txs, ty, grads, m, 1, 1, rows,
                      feat, stream);
}

// Points per lane strip of the run merge (kStrip).
extern "C" int snt_bilerp_bwd_strip(void) { return kStrip; }
