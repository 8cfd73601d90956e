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
// differs (atomics), so a kernel agrees with its plain version to f32
// rounding of the sums, not bit for bit.
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
// the whole f32 table once (268 MB for two 1024x1024x32 planes): about
// 8 flop per feature against 4F B of g, far below the ~20 flop/B where the
// H100's f32 rate would bind.  The design:
//   * The TPU kernels need points sorted into row stripes: they scatter with
//     one-hot MXU matmuls into VMEM accumulators and carry fold halos from
//     one sequential grid step to the next.  Blocks on the card run in no
//     order, so every thread adds its point's terms straight into the
//     table with atomicAdd (RED.ADD.F32, the return value unused) and the
//     points may come in any order; no sort, stripe or halo exists here.
//   * F/8 threads serve one point; each owns 8 features, loads its g as
//     two 16-byte vectors (the threads of a warp read 8 or 32 consecutive
//     g rows, a coalesced stream) and issues 4 x 8 scalar atomics.
//   * Contention: at the coarsest scale 262,144 points land on 4096 rows,
//     and consecutive samples of a ray often share a corner, so atomics to
//     one address serialise in L2.  This first kernel leaves it at that;
//     warp-level pre-aggregation, vector atomics (red.global.add.v4.f32)
//     or a sort by row are for a measured later change.
//   * Up to 3 planes of one table shape share a launch (blockIdx.y); the
//     parameter struct is __grid_constant__ so indexing it by blockIdx.y
//     reads parameter space instead of a per-thread local copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;

struct PlaneGradArgs {
  const float* g[kMaxPlanes];
  const int32_t* rowid[kMaxPlanes];
  const float* tx[kMaxPlanes];
  float* grad[kMaxPlanes];
  const float* ty;
};

template <int F, bool kPacked>
__global__ void __launch_bounds__(kThreads)
bilerp_bwd_kernel(const __grid_constant__ PlaneGradArgs a, long long m, int h,
                  int w, long long rows) {
  constexpr int kLanes = F / 8;  // threads per point, 8 features each
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / kLanes;
  const int lane = (int)(t - i * kLanes);
  if (i >= m) return;

  long long row = __ldg(a.rowid[p] + i);
  row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);  // as the forward
  const float tx = __ldg(a.tx[p] + i);
  const float ty = __ldg(a.ty + i);
  const float4* src = reinterpret_cast<const float4*>(a.g[p] + i * F + lane * 8);
  const float4 ga = __ldg(src);
  const float4 gb = __ldg(src + 1);
  const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};

  const float omtx = __fsub_rn(1.0f, tx);
  const float omty = __fsub_rn(1.0f, ty);
  const float wk[4] = {__fmul_rn(omtx, omty), __fmul_rn(tx, omty),
                       __fmul_rn(omtx, ty), __fmul_rn(tx, ty)};

  float* dst[4];
  if constexpr (kPacked) {
    float* r = a.grad[p] + row * (4 * F) + lane * 8;
    dst[0] = r;
    dst[1] = r + F;
    dst[2] = r + 2 * F;
    dst[3] = r + 3 * F;
  } else {
    const int y0 = (int)(row / w);
    const int x0 = (int)(row - (long long)y0 * w);
    const long long dx = x0 < w - 1 ? 1 : 0;
    const long long dy = y0 < h - 1 ? w : 0;
    float* r = a.grad[p] + row * F + lane * 8;
    dst[0] = r;
    dst[1] = r + dx * F;
    dst[2] = r + dy * F;
    dst[3] = r + (dy + dx) * F;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(dst[c] + k, __fmul_rn(g[k], wk[c]));
  }
}

template <bool kPacked>
int launch(int planes, const void* const* gs, const void* const* rowids,
           const void* const* txs, const void* ty, void* const* grads,
           long long m, int h, int w, long long rows, int feat, void* stream) {
  if (planes < 1 || planes > kMaxPlanes || m <= 0)
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
  const long long threads = m * (feat / 8);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 8:
      bilerp_bwd_kernel<8, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w, rows);
      break;
    case 32:
      bilerp_bwd_kernel<32, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w, rows);
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
