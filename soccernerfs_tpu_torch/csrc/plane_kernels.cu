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
// below).  The two kernels here serve the train forward, whose autograd
// graph keeps every plane's factor: at the registry's 4096 rays, 15
// unpacked launches a step of 262,144 points (the field) and 6 packed ones
// of 524,288 or 1,048,576 points (the two F = 8 proposal fields).
//
// snt_bilerp_fwd_unpacked replaces unpacked_bilerp_fwd_group
//   (soccernerfs_tpu/ops/pallas/plane_kernels.py, body _fwd_kernel_unpacked):
//   the table is the plane itself, [h*w, F] bf16; the four corners are
//   four rows.  The train forward stages every field plane so, each step
//   (ops/grid_sample.stage_table: a cast, where quad-packing would also
//   write 4x the plane's bytes): 64x64 up to kp_res_study's 2048x2048.
// snt_bilerp_fwd_packed replaces packed_bilerp_fwd_group (same file, body
//   _fwd_kernel): the table is quad-packed, [R, 4F] bf16, each row holding
//   the 2x2 corner block, so a point reads one contiguous 8F-byte row.  The
//   F = 8 proposal fields' route quad-packs its planes (as the JAX
//   proposal path does), whose transpose folds the packed backward's
//   gradient into the planes.
//
// The planes of one launch share their y axis (the caller groups planes by
// it, as the TPU kernels' stripe groups do), so they share ty: one ty array
// per launch, read once per point whatever the plane count.
//
// Bound on the card: bytes.  Per point the kernel must read 4 B of ty, and
// per point and plane 8 B (row id, tx) and write 4F B of f32 (136 B at
// F = 32), against 9 flops per feature, about 2 flop/B, far under the ~20
// flop/B where H100's f32 rate (67 TFLOP/s over 3.35 TB/s) would bind.  The
// output is ~94 % of those bytes.  The table is read once at least (64 MiB
// for a 1024x1024x32 bf16 plane) but gathered at random rows, so the
// kernel lives on L2 hits and 32-byte sector efficiency; a plane larger
// than L2 pays its random corner rows from DRAM, which the bound (each
// table byte once) leaves out.  The TPU kernels sort points into row
// stripes and gather with one-hot MXU matmuls because Mosaic cannot lower
// a vector gather; here every thread gathers directly, so no sort, no
// one-hot and no stripe bookkeeping exist and the points may come in any
// order.  Both kernels: F/8 threads (lanes) serve one point, each owning 8
// features, loaded as one 16-byte vector per corner, so the lanes of a
// point read whole 32-byte sectors of a corner row (F = 32); each lane
// writes its 8 f32 outputs as two 16-byte stores, a coalesced stream.
//
// Both kernels take one plane per blockIdx.y, up to 3 planes of one table
// shape in a launch; the parameter struct is __grid_constant__, so
// indexing it by blockIdx.y reads parameter space (a per-thread stack copy
// cost 2.3x in time on the H100).
//
// The unpacked kernel, redesigned from its port (PERF.md has each step's
// times, in turns against the form it replaced):
//   * One plane per blockIdx.y, and two points a thread (g and g + n, n =
//     ceil(m/2), so each load and store instruction of a warp still covers
//     consecutive points): 8 independent corner loads in flight a thread.
//     A thread serving its point across every plane of the launch (4P
//     loads in flight, ty read once) measured slower on every case.
//   * 32-bit cells.  The corners need x0 = row mod w (x1 at the right
//     border); it was a 64-bit division in every lane.  Now row < 2^31
//     (the wrappers refuse bigger tables) and row / w is one 32x32->64-bit
//     multiply and a shift by constants the host computes once a launch
//     (RowDiv, exact below 2^31); the bottom border is row >= (h-1)*w.
//   * Cache hints chosen per launch by the tables' size.  When the
//     launch's tables outgrow L2 (the 1024x1024 planes), the once-read row
//     ids, fractions and ty come in with streaming loads and the output
//     goes out with streaming stores (evict-first in L2), so ~33 MB a plane
//     of f32 output does not push the gathered rows out; on tables that
//     fit, the same hints measured slower, and the kernel reads through the
//     read-only path and stores plainly.  An L2::evict_last policy on the
//     table loads slowed the 1024x1024 planes and is gone.  Nothing
//     device-wide changes: no persisting-L2 window, no cudaDeviceSetLimit.
//   * ptxas gives the F = 32 instance 36 registers, so 6 blocks of 256
//     threads share an SM; the same code held to 32 registers (8 blocks)
//     took 1.24x as long on the L2-resident time group.
//   * The plain version's arithmetic in its order: bit-equal to it.
// What bounds it now: on tables that fit in L2, the L2 reads of the
// gathers (four corner rows, 8F B a point and plane, twice its 4F B of
// output); on the 1024x1024 planes, DRAM: the corner rows of random points
// miss L2, and the bound, which counts each table byte once, leaves those
// reads out.
//
// The packed kernel, redesigned from its port in the same way, one lever
// at a time against it (PERF.md has the times, in turns):
//   * Two points a thread below F = 48 (g and g + n, as above): 8
//     independent 16-byte loads in flight a thread.  It cut 8-10 % on
//     random points of an F = 32 table in L2, 8-13 % on the [100, 2048]
//     tables past L2 at F = 16 / 24, and 3 % over a train step's six
//     F = 8 launches (two of them 3-5 % slower).  From F = 48 on, one point
//     a thread (packed_points): at F = 48 the second point cost 2 %, its
//     registers (40, not 32) leaving 6 blocks an SM, not 8.
//   * Rows in 32 bits: a row id is clipped and scaled to its offset as a
//     32-bit value (the wrapper refuses tables of 2^31 rows or more).  The
//     point index stays 64-bit: a 32-bit one (a 32-bit t / (F/8)) was 4 %
//     slower on the F = 20 / 24 tables past L2 and 5 % over the step's
//     F = 8 launches, though faster on an F = 32 table in L2.
//   * No cache hints: the read-only path for every load, plain stores.
//     Its one main path, the F = 8 proposal fields, reads 1-2 MB tables
//     that stay in L2.  Streaming the points' operands and output when
//     the tables outgrow L2 (an instance of its own) won 1-4 % on the
//     [100, 2048] tables, which no path sends this kernel since the train
//     forward stages them unpacked; chosen at run time in one instance it
//     was 9 % slower at F = 20 / 24.
//   * Lost and gone: one lane per 16-byte vector of the row at F = 8 (four
//     lanes a point lerping across two shuffles, so a load instruction
//     reads whole rows), up to 1.7x on the step's [100, 128] proposal
//     launch; the same at F = 24 (16 lanes, 4 idle), no gain; a 32-register
//     cap (8 blocks an SM), 1.19x on F = 48 and up to 1.21x on the step's
//     F = 8 launches; at F = 8 one point a thread (3-9 % slower than the
//     port's form on four of the six step launches) or two adjacent points
//     (2 points a thread reading neighbouring rows: up to 1.45x).
//   * The plain version's arithmetic in its order: bit-equal to it.
// What bounds it: every main path's launch (the proposal fields' 1-2 MB
// packed tables) lives in L2, read 8F B a point and plane, twice its
// output, at 0.5-1 M points a launch, 20-55 us each; on tables past L2
// (the sweep widths' [100, 2048] planes, 79-236 MB packed, at random
// points), DRAM: the same launch with its rows folded into 1/16 of the
// table runs 13-30 % faster.
#include <cuda_runtime.h>
#include <stdint.h>

// The feature widths with a compiled instance of every kernel: the widths
// of the registry, the paper's sweeps and TensoRF's planes, then 64, 96
// and 128.  Every instance is the same code, F/8 lanes of 8 features per
// point; the wrappers zero-pad the feature axis of any other width up to
// 128 to the next of these and drop the padded output columns.
#define SNT_FOR_EACH_FEAT(X) X(8) X(16) X(24) X(32) X(48) X(64) X(96) X(128)

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kThreads = 256;
constexpr int kPoints = 2;  // points a thread of the per-plane forward kernels

// row / w for 0 <= row < 2^31 as (row * magic) >> shift: with l =
// ceil(log2 w) and magic = ceil(2^(31+l) / w) < 2^32 the product's error
// stays under 1/w, so the quotient is exact (ops/kernels/plane_kernels.py
// row_divisor computes the same constants; the tests hold them exact).
struct RowDiv {
  unsigned magic;
  unsigned shift;
};

RowDiv row_div(int w) {
  unsigned l = 0;
  while ((1u << l) < (unsigned)w) ++l;
  const unsigned shift = 31 + l;
  return {(unsigned)(((1ull << shift) + (unsigned)w - 1) / (unsigned)w), shift};
}

__device__ __forceinline__ unsigned div_row(unsigned row, RowDiv d) {
  return (unsigned)(((unsigned long long)row * d.magic) >> d.shift);
}

struct PlaneArgs {
  const uint4* table[kMaxPlanes];
  const int32_t* rowid[kMaxPlanes];
  const float* tx[kMaxPlanes];
  float* out[kMaxPlanes];
  const float* ty;
};

struct UnpackedArgs {
  PlaneArgs p;
  int rows;      // h * w < 2^31
  int last_row;  // (h - 1) * w: the first row id of the bottom row
  int w;
  RowDiv div;    // row / w
  int streaming;  // 1: the tables outgrow L2; loads and stores of the points
                  // evict first
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

// The lerp of one lane's 8 features of four corners, in the plain order.
__device__ __forceinline__ void lerp8(const uint4 (&q)[4], float tx, float ty,
                                      float (&o)[8]) {
  float f00[8], f01[8], f10[8], f11[8];
  bf16x8_to_f32(q[0], f00);
  bf16x8_to_f32(q[1], f01);
  bf16x8_to_f32(q[2], f10);
  bf16x8_to_f32(q[3], f11);
  const float omtx = __fsub_rn(1.0f, tx);
  const float omty = __fsub_rn(1.0f, ty);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float top = __fadd_rn(__fmul_rn(f00[k], omtx), __fmul_rn(f01[k], tx));
    const float bot = __fadd_rn(__fmul_rn(f10[k], omtx), __fmul_rn(f11[k], tx));
    o[k] = __fadd_rn(__fmul_rn(top, omty), __fmul_rn(bot, ty));
  }
}

struct PackedArgs {
  PlaneArgs p;
  int rows;  // R < 2^31
};

// Points a thread of the packed kernel at width F: one from F = 48 on,
// where a point's F/8 lanes already have F/2 row loads in flight and a
// second point's registers would cut the blocks an SM from 8 to 6.
__host__ __device__ constexpr int packed_points(int feat) {
  return feat >= 48 ? 1 : kPoints;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
bilerp_fwd_packed_kernel(const __grid_constant__ PackedArgs a, long long m) {
  constexpr int kLanes = F / 8;  // threads per point, 8 features each
  constexpr int P = packed_points(F);
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g = t / kLanes;
  const int lane = (int)(t - g * kLanes);
  // the thread's points: g, g + n, ... (P of them, n apart)
  const long long n = (m + P - 1) / P;
  if (g >= n) return;

  long long idx[P];
  unsigned row[P];
  float tx[P], ty[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    idx[j] = g + j * n < m ? g + j * n : g;  // past the end: redo point g
    const int r = __ldg(a.p.rowid[p] + idx[j]);
    row[j] = (unsigned)(r < 0 ? 0 : (r >= a.rows ? a.rows - 1 : r));  // "clip"
    tx[j] = __ldg(a.p.tx[p] + idx[j]);
    ty[j] = __ldg(a.p.ty + idx[j]);
  }
  uint4 q[P][4];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const uint4* r = a.p.table[p] + (size_t)row[j] * (4 * kLanes) + lane;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[j][k] = __ldg(r + k * kLanes);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j > 0 && idx[j] == g) break;
    float o[8];
    lerp8(q[j], tx[j], ty[j], o);
    float4* dst = reinterpret_cast<float4*>(a.p.out[p] + idx[j] * F + lane * 8);
    dst[0] = make_float4(o[0], o[1], o[2], o[3]);
    dst[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
bilerp_fwd_unpacked_kernel(const __grid_constant__ UnpackedArgs a, long long m) {
  constexpr int kLanes = F / 8;  // threads per point, 8 features each
  const int p = blockIdx.y;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long g = t / kLanes;
  const int lane = (int)(t - g * kLanes);
  // the thread's points: g, g + n, ... (kPoints of them, n apart), so each
  // load and store instruction of a warp still covers consecutive points
  const long long n = (m + kPoints - 1) / kPoints;
  if (g >= n) return;

  long long idx[kPoints];
  unsigned row[kPoints];
  float tx[kPoints], ty[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    idx[j] = g + j * n < m ? g + j * n : g;  // past the end: redo point g
    const int* rp = a.p.rowid[p] + idx[j];
    const float* xp = a.p.tx[p] + idx[j];
    const float* yp = a.p.ty + idx[j];
    const int r = a.streaming ? __ldcs(rp) : __ldg(rp);
    row[j] = (unsigned)(r < 0 ? 0 : (r >= a.rows ? a.rows - 1 : r));  // "clip"
    tx[j] = a.streaming ? __ldcs(xp) : __ldg(xp);
    ty[j] = a.streaming ? __ldcs(yp) : __ldg(yp);
  }
  uint4 q[kPoints][4];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const unsigned x0 = row[j] - div_row(row[j], a.div) * (unsigned)a.w;
    const size_t dx = x0 + 1 < (unsigned)a.w ? kLanes : 0;
    const size_t dy = row[j] < (unsigned)a.last_row ? (size_t)a.w * kLanes : 0;
    const uint4* r = a.p.table[p] + (size_t)row[j] * kLanes + lane;
    q[j][0] = __ldg(r);
    q[j][1] = __ldg(r + dx);
    q[j][2] = __ldg(r + dy);
    q[j][3] = __ldg(r + dy + dx);
  }
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    if (j > 0 && idx[j] == g) break;
    float o[8];
    lerp8(q[j], tx[j], ty[j], o);
    float4* dst = reinterpret_cast<float4*>(a.p.out[p] + idx[j] * F + lane * 8);
    const float4 lo = make_float4(o[0], o[1], o[2], o[3]);
    const float4 hi = make_float4(o[4], o[5], o[6], o[7]);
    if (a.streaming) {
      __stcs(dst, lo);
      __stcs(dst + 1, hi);
    } else {
      dst[0] = lo;
      dst[1] = hi;
    }
  }
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

}  // namespace

// tables: P pointers to [h*w, feat] bf16, h*w < 2^31; rowids: P x [m]
// int32; txs: P x [m] f32; ty: [m] f32, shared by the P planes;
// outs: P x [m, feat] f32.  feat one of SNT_FOR_EACH_FEAT's, 1 <= P <= 3.
extern "C" int snt_bilerp_fwd_unpacked(
    int planes, const void* const* tables, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* outs,
    long long m, int h, int w, int feat, void* stream) {
  UnpackedArgs a;
  const int err = fill_args(&a.p, planes, tables, rowids, txs, ty, outs);
  if (err != 0) return err;
  if (m <= 0 || h < 1 || w < 1 || (long long)h * w > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.rows = h * w;
  a.last_row = (h - 1) * w;
  a.w = w;
  a.div = row_div(w);
  int device = 0, l2 = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device) != cudaSuccess)
    return (int)cudaGetLastError();
  a.streaming = 2LL * feat * a.rows * planes > l2;
  const long long threads = (m + kPoints - 1) / kPoints * (feat / 8);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
#define SNT_FWD_CASE(F) \
    case F: bilerp_fwd_unpacked_kernel<F><<<grid, kThreads, 0, s>>>(a, m); break;
    SNT_FOR_EACH_FEAT(SNT_FWD_CASE)
#undef SNT_FWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// tables: P pointers to [rows, 4*feat] bf16 quad-packed rows, rows < 2^31;
// the rest as snt_bilerp_fwd_unpacked.
extern "C" int snt_bilerp_fwd_packed(
    int planes, const void* const* tables, const void* const* rowids,
    const void* const* txs, const void* ty, void* const* outs,
    long long m, long long rows, int feat, void* stream) {
  PackedArgs a;
  const int err = fill_args(&a.p, planes, tables, rowids, txs, ty, outs);
  if (err != 0) return err;
  if (m <= 0 || rows < 1 || rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.rows = (int)rows;
  const int points = packed_points(feat);
  const long long threads = (m + points - 1) / points * (feat / 8);
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads), planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (feat) {
#define SNT_PACKED_CASE(F) \
    case F: bilerp_fwd_packed_kernel<F><<<grid, kThreads, 0, s>>>(a, m); break;
    SNT_FOR_EACH_FEAT(SNT_PACKED_CASE)
#undef SNT_PACKED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The constants snt_bilerp_fwd_unpacked divides a row id by w with.
extern "C" void snt_row_divisor(int w, unsigned* magic, unsigned* shift) {
  const RowDiv d = row_div(w);
  *magic = d.magic;
  *shift = d.shift;
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
namespace {

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

// One K-Planes scale, fused.  tables: P pointers to staged bf16 tables,
// [h*w, feat] (packed[p] = 0) or [h*w, 4*feat] (packed[p] = 1); hs, ws,
// c1s, c2s: each plane's shape and the coordinates of its x and y;
// pts: [m, dim] f32, dim in {3, 4}; out: the first of m rows of feat f32,
// out_stride floats apart (16-byte aligned).  feat one of
// SNT_FOR_EACH_FEAT's, 1 <= P <= 6.
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
#define SNT_FUSED_FEAT(F) case F: err = launch_fused<F>(planes, a, m, s); break;
    SNT_FOR_EACH_FEAT(SNT_FUSED_FEAT)
#undef SNT_FUSED_FEAT
    default: return (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}
