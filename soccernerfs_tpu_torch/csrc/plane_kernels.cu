// Bilinear plane-sampling forward kernels of the K-Planes render path,
// written for Hopper (sm_90a), with a plain C interface bound by ctypes
// (soccernerfs_tpu_torch/ops/kernels/plane_kernels.py).
//
// Both kernels compute, for every point i of every plane p in one launch,
//   out_p[i, :] = lerp_y(lerp_x(P[y0, x0], P[y0, x1]),
//                        lerp_x(P[y1, x0], P[y1, x1]))
// with (y0, x0) from the row id y0*w + x0, x1 = min(x0 + 1, w - 1) and
// y1 = min(y0 + 1, h - 1) (the border replicates), fractions tx_p[i] and
// ty[i], a bf16 table and f32 arithmetic in the order
//   top = p00*(1-tx) + p01*tx,  bot = p10*(1-tx) + p11*tx,
//   out = top*(1-ty) + bot*ty.
// Every multiply and add rounds on its own (__fmul_rn/__fadd_rn, no FMA
// contraction), so a kernel equals its plain PyTorch version bit for bit.
//
// The render path (no gradient) takes snt_kplanes_fwd_fused instead: one
// launch per K-Planes scale computes every plane's cell and fractions
// from the normalised points, gathers and lerps each plane, multiplies
// the planes and stores the scale's features once (see its comment
// below).  The two kernels here stay for the train forward, whose
// autograd graph keeps every plane's factor.
//
// snt_bilerp_fwd_unpacked replaces unpacked_bilerp_fwd_group
//   (soccernerfs_tpu/ops/pallas/plane_kernels.py, body _fwd_kernel_unpacked):
//   the table is the plane itself, [h*w, F] bf16; the four corners are
//   four rows.
// snt_bilerp_fwd_packed replaces packed_bilerp_fwd_group (same file, body
//   _fwd_kernel): the table is quad-packed, [R, 4F] bf16, each row holding
//   the 2x2 corner block, so a point reads one contiguous 8F-byte row.
//
// The planes of one launch share their y axis (the caller groups planes by
// it, as the TPU kernels' stripe groups do), so they share ty: one ty array
// per launch, read once per point whatever the plane count.
//
// Bound on the card: bytes.  Per point the kernel must read 4 B of ty, and
// per point and plane 8 B (row id, tx) and write 4F B of f32 (136 B at
// F = 32), against 9 flops per feature, about 2 flop/B, far under the ~20 flop/B where H100's f32
// rate (67 TFLOP/s over 3.35 TB/s) would bind.  The table is read once at least (64 MiB for a
// 1024x1024x32 bf16 plane) but gathered at random rows, so the kernel
// lives on L2 hits and 32-byte sector efficiency.  The design:
//   * The TPU kernels sort points into row stripes and gather with one-hot
//     MXU matmuls because Mosaic cannot lower a vector gather.  Here every
//     thread gathers directly, so no sort, no one-hot and no stripe
//     bookkeeping exist and the points may come in any order.
//   * F/8 threads serve one point; each owns 8 features and loads them as
//     one 16-byte vector per corner, so the threads of a point read whole
//     32-byte sectors of a corner row (F = 32) and a warp keeps 4 x 32
//     independent 16-byte loads in flight.
//   * Each thread writes its 8 f32 outputs as two 16-byte stores; the
//     threads of a warp cover 8 (F = 32) or 32 (F = 8) consecutive output
//     rows, a fully coalesced stream.
//   * Up to 3 planes of one table shape share a launch (blockIdx.y), so a
//     plane group costs one launch.  The parameter struct is
//     __grid_constant__, so indexing it by blockIdx.y reads parameter
//     space: without it nvcc may copy the struct to a local stack frame in
//     every thread, which cost 2.3x in time on the H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;

struct PlaneArgs {
  const uint4* table[kMaxPlanes];
  const int32_t* rowid[kMaxPlanes];
  const float* tx[kMaxPlanes];
  float* out[kMaxPlanes];
  const float* ty;
};

// 8 bf16 values in one 16-byte vector -> 8 floats (exact: bf16 is the top
// half of an f32).
__device__ __forceinline__ void bf16x8_to_f32(const uint4 v, float (&f)[8]) {
  const unsigned int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

template <int F, bool kPacked>
__global__ void __launch_bounds__(kThreads)
bilerp_fwd_kernel(const __grid_constant__ PlaneArgs a, long long m, int h,
                  int w, long long rows) {
  constexpr int kLanes = F / 8;  // threads per point, 8 features each
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / kLanes;
  const int lane = (int)(t - i * kLanes);
  if (i >= m) return;

  long long row = __ldg(a.rowid[p] + i);
  row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);  // gather "clip" mode
  const float tx = __ldg(a.tx[p] + i);
  const uint4* table = a.table[p];
  const float ty = __ldg(a.ty + i);

  uint4 q00, q01, q10, q11;
  if constexpr (kPacked) {
    const uint4* r = table + row * (4 * kLanes) + lane;
    q00 = __ldg(r);
    q01 = __ldg(r + kLanes);
    q10 = __ldg(r + 2 * kLanes);
    q11 = __ldg(r + 3 * kLanes);
  } else {
    const int y0 = (int)(row / w);
    const int x0 = (int)(row - (long long)y0 * w);
    const long long dx = x0 < w - 1 ? 1 : 0;
    const long long dy = y0 < h - 1 ? w : 0;
    const uint4* r = table + row * kLanes + lane;
    q00 = __ldg(r);
    q01 = __ldg(r + dx * kLanes);
    q10 = __ldg(r + dy * kLanes);
    q11 = __ldg(r + (dy + dx) * kLanes);
  }

  float f00[8], f01[8], f10[8], f11[8], o[8];
  bf16x8_to_f32(q00, f00);
  bf16x8_to_f32(q01, f01);
  bf16x8_to_f32(q10, f10);
  bf16x8_to_f32(q11, f11);
  const float omtx = __fsub_rn(1.0f, tx);
  const float omty = __fsub_rn(1.0f, ty);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float top = __fadd_rn(__fmul_rn(f00[k], omtx), __fmul_rn(f01[k], tx));
    const float bot = __fadd_rn(__fmul_rn(f10[k], omtx), __fmul_rn(f11[k], tx));
    o[k] = __fadd_rn(__fmul_rn(top, omty), __fmul_rn(bot, ty));
  }
  float4* dst = reinterpret_cast<float4*>(a.out[p] + i * F + lane * 8);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

int fill_args(PlaneArgs* a, int planes, const void* const* tables,
              const void* const* rowids, const void* const* txs,
              const void* ty, void* const* outs) {
  if (planes < 1 || planes > kMaxPlanes) return (int)cudaErrorInvalidValue;
  for (int p = 0; p < kMaxPlanes; ++p) {
    const int q = p < planes ? p : 0;
    a->table[p] = static_cast<const uint4*>(tables[q]);
    a->rowid[p] = static_cast<const int32_t*>(rowids[q]);
    a->tx[p] = static_cast<const float*>(txs[q]);
    a->out[p] = static_cast<float*>(outs[q]);
  }
  a->ty = static_cast<const float*>(ty);
  return 0;
}

template <bool kPacked>
int launch(int planes, const void* const* tables, const void* const* rowids,
           const void* const* txs, const void* ty, void* const* outs,
           long long m, int h, int w, long long rows, int feat, void* stream) {
  PlaneArgs a;
  const int err = fill_args(&a, planes, tables, rowids, txs, ty, outs);
  if (err != 0) return err;
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const long long threads = m * (feat / 8);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
    case 8:
      bilerp_fwd_kernel<8, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w, rows);
      break;
    case 32:
      bilerp_fwd_kernel<32, kPacked><<<grid, kThreads, 0, s>>>(a, m, h, w, rows);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The fused render-path forward of one K-Planes scale
// ---------------------------------------------------------------------------
//
// snt_kplanes_fwd_fused computes, for every point i of pts [M, D] (D in
// {3, 4}, normalised to [-1, 1]) and the P <= 6 planes of one scale,
//   out[i, :] = prod_p bilerp(table_p, x = pts[i, c1_p], y = pts[i, c2_p])
// in the planes' order (the JAX package's _sampled_planes order), the
// product of f32 factors left to right.  A plane's cell and fraction per
// axis are grid_coords' (ops/grid_sample.py):
//   v = clamp(((c + 1) * 0.5) * (size - 1), 0, size - 1),
//   cell = floor(v), frac = v - cell,
// each operation rounded on its own, and the lerp is the one above.  A
// plane's table is its staged bf16 copy, unpacked [h*w, F] or quad-packed
// [h*w, 4F] (ops/grid_sample.stage_table), so one launch mixes layouts.
// The F features land at out + i * out_stride: the caller hands the
// scale's column slice of the [M, S*F] concatenated features.  It
// replaces, on the render path, both TPU kernels above and the passes
// around them (grid_coords per axis, a row id and tx array per plane, a
// per-plane f32 output, the in-place product and the column copy).
//
// Bound on the card: bytes.  Per point it must read D * 4 B of
// coordinates and write 4F B of features; the tables' touched rows are
// read once at least.  The design:
//   * F/8 threads serve one point, each owning 8 features, loaded as one
//     16-byte vector per corner (as the kernels above).
//   * Cells and fractions live in registers: no row id, fraction or
//     per-plane feature array reaches device memory.
//   * All planes' addresses are formed first and every corner load issued
//     before any lerp, so a thread keeps 4P independent 16-byte loads in
//     flight.  The layouts differ only in the corner offsets (packed:
//     the next three vectors of the row; unpacked: the next column and
//     row, 0 on the border), picked without a branch.
//   * The planes' descriptors ride a __grid_constant__ struct (a copy on
//     the stack cost 2.3x once).
//   * One coalesced stream of two 16-byte stores per thread.

constexpr int kMaxFusedPlanes = 6;

struct FusedPlane {
  const uint4* table;
  int packed;  // 1: [h*w, 4F] quad-packed rows; 0: [h*w, F]
  int h, w;
  int c1, c2;  // the coordinates indexing the plane's x (width) and y
};

struct FusedArgs {
  FusedPlane plane[kMaxFusedPlanes];
  const float* pts;
  float* out;
  long long out_stride;  // floats from one output row to the next
  int dim;
};

__device__ __forceinline__ float pick(const float (&c)[4], int k) {
  return k == 0 ? c[0] : (k == 1 ? c[1] : (k == 2 ? c[2] : c[3]));
}

// grid_coords of one coordinate for an axis of ``size`` cells.
__device__ __forceinline__ int grid_cell(float x, int size, float* frac) {
  const float top = (float)(size - 1);
  const float v = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f),
                                        top), 0.0f), top);
  const float c = floorf(v);
  *frac = __fsub_rn(v, c);
  return (int)c;
}

template <int F, int NP>
__global__ void __launch_bounds__(kThreads)
kplanes_fwd_fused_kernel(const __grid_constant__ FusedArgs a, long long m) {
  constexpr int kLanes = F / 8;  // threads per point, 8 features each
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / kLanes;
  const int lane = (int)(t - i * kLanes);
  if (i >= m) return;

  const float* p = a.pts + i * a.dim;
  float c[4];
  c[0] = __ldg(p);
  c[1] = __ldg(p + 1);
  c[2] = __ldg(p + 2);
  c[3] = a.dim == 4 ? __ldg(p + 3) : 0.0f;

  uint4 q[NP][4];
  float tx[NP], ty[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const FusedPlane& pl = a.plane[k];
    const int xc = grid_cell(pick(c, pl.c1), pl.w, &tx[k]);
    const int yc = grid_cell(pick(c, pl.c2), pl.h, &ty[k]);
    const int rows = pl.h * pl.w;
    int row = yc * pl.w + xc;
    row = row < 0 ? 0 : (row >= rows ? rows - 1 : row);  // gather "clip" mode
    const int dx = xc < pl.w - 1 ? kLanes : 0;
    const int dy = yc < pl.h - 1 ? pl.w * kLanes : 0;
    const int o1 = pl.packed ? kLanes : dx;
    const int o2 = pl.packed ? 2 * kLanes : dy;
    const uint4* r = pl.table + (long long)row * (pl.packed ? 4 * kLanes : kLanes)
                     + lane;
    q[k][0] = __ldg(r);
    q[k][1] = __ldg(r + o1);
    q[k][2] = __ldg(r + o2);
    q[k][3] = __ldg(r + o1 + o2);
  }

  float acc[8];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float f00[8], f01[8], f10[8], f11[8];
    bf16x8_to_f32(q[k][0], f00);
    bf16x8_to_f32(q[k][1], f01);
    bf16x8_to_f32(q[k][2], f10);
    bf16x8_to_f32(q[k][3], f11);
    const float omtx = __fsub_rn(1.0f, tx[k]);
    const float omty = __fsub_rn(1.0f, ty[k]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float top = __fadd_rn(__fmul_rn(f00[j], omtx), __fmul_rn(f01[j], tx[k]));
      const float bot = __fadd_rn(__fmul_rn(f10[j], omtx), __fmul_rn(f11[j], tx[k]));
      const float o = __fadd_rn(__fmul_rn(top, omty), __fmul_rn(bot, ty[k]));
      acc[j] = k == 0 ? o : __fmul_rn(acc[j], o);
    }
  }
  float4* dst = reinterpret_cast<float4*>(a.out + i * a.out_stride + lane * 8);
  dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <int F>
int launch_fused(int planes, const FusedArgs& a, long long m, cudaStream_t s) {
  const long long threads = m * (F / 8);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  switch (planes) {
#define SNT_FUSED_CASE(NP) \
    case NP: kplanes_fwd_fused_kernel<F, NP><<<grid, kThreads, 0, s>>>(a, m); break;
    SNT_FUSED_CASE(1) SNT_FUSED_CASE(2) SNT_FUSED_CASE(3)
    SNT_FUSED_CASE(4) SNT_FUSED_CASE(5) SNT_FUSED_CASE(6)
#undef SNT_FUSED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// tables: P pointers to [h*w, feat] bf16; rowids: P x [m] int32;
// txs: P x [m] f32; ty: [m] f32, shared by the P planes;
// outs: P x [m, feat] f32.  feat in {8, 32}, 1 <= P <= 3.
extern "C" int snt_bilerp_fwd_unpacked(
    int planes, const void* const* tables, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* outs,
    long long m, int h, int w, int feat, void* stream) {
  return launch<false>(planes, tables, rowids, txs, ty, outs, m, h, w,
                       (long long)h * w, feat, stream);
}

// tables: P pointers to [rows, 4*feat] bf16 quad-packed rows; the rest as
// snt_bilerp_fwd_unpacked.
extern "C" int snt_bilerp_fwd_packed(
    int planes, const void* const* tables, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* outs,
    long long m, long long rows, int feat, void* stream) {
  return launch<true>(planes, tables, rowids, txs, ty, outs, m, 1, 1, rows,
                      feat, stream);
}

// One K-Planes scale, fused.  tables: P pointers to staged bf16 tables,
// [h*w, feat] (packed[p] = 0) or [h*w, 4*feat] (packed[p] = 1); hs, ws,
// c1s, c2s: each plane's shape and the coordinates of its x and y;
// pts: [m, dim] f32, dim in {3, 4}; out: the first of m rows of feat f32,
// out_stride floats apart (16-byte aligned).  feat in {8, 32},
// 1 <= P <= 6.
extern "C" int snt_kplanes_fwd_fused(
    int planes, const void* const* tables, const int* packed, const int* hs,
    const int* ws, const int* c1s, const int* c2s, const void* pts, int dim,
    void* out, long long out_stride, long long m, int feat, void* stream) {
  if (planes < 1 || planes > kMaxFusedPlanes || m <= 0 ||
      (dim != 3 && dim != 4))
    return (int)cudaErrorInvalidValue;
  FusedArgs a;
  for (int p = 0; p < kMaxFusedPlanes; ++p) {
    const int q = p < planes ? p : 0;
    if (c1s[q] < 0 || c1s[q] >= dim || c2s[q] < 0 || c2s[q] >= dim ||
        hs[q] < 1 || ws[q] < 1)
      return (int)cudaErrorInvalidValue;
    a.plane[p] = {static_cast<const uint4*>(tables[q]), packed[q] ? 1 : 0,
                  hs[q], ws[q], c1s[q], c2s[q]};
  }
  a.pts = static_cast<const float*>(pts);
  a.out = static_cast<float*>(out);
  a.out_stride = out_stride;
  a.dim = dim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (feat) {
    case 8: err = launch_fused<8>(planes, a, m, s); break;
    case 32: err = launch_fused<32>(planes, a, m, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
