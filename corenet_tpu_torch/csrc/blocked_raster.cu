// Blocked triangle rasterization into bit-packed occupancy grids, for
// Hopper (sm_90a): triangles in, OR-ed z-words out, in one kernel.
//
// Replaces corenet_tpu/ops/block_scatter.py::block_scatter_or (the Pallas
// kernel `_kernel`) together with the XLA-side phase A that feeds it,
// corenet_tpu/voxel/raster_fast.py::_phase_a. Contract, for a cubic grid
// of extent m (a multiple of 32, NW = m / 32 words per z-column) and an
// integer image resolution multiplier irm (window WP = 4 * irm pixels):
// every valid triangle t of scene b is moved into voxel space by its
// scene's view -> voxel matrix (slot 0's), sampled on its dominant plane
// over a cell-aligned WP x WP window, and the 4 x 4 x 8-cell block of its
// covered samples is oriented into grid (y, x, z), shifted to its origin
// and ORed into out[b, slot, y, x * NW + w] of a zeroed int32[B, M, m,
// m * NW]. The result is what corenet_tpu_torch/voxel/raster_fast.py::
// _phase_a followed by ops/block_scatter.py::block_scatter_or gives, bit
// for bit, without their [B, T, 8, 8 * NW] block tensor and their
// [B, T, WP, WP] float32 sample temporaries.
//
// Bit-exactness with eager PyTorch: every float32 operation of the
// geometry is one rounded IEEE operation in the order the tensor code
// writes it (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc would
// otherwise contract a * b + c into an FMA, which eager PyTorch's
// elementwise operations never do), divisions are IEEE divisions, and
// float -> int conversions truncate and saturate as PyTorch's CUDA casts
// do. The one compound operation, torch.linalg.cross, is contracted by
// its compilers, and the normal here is too, the same way.
//
// What bounds it: float32 arithmetic. At h7 (4 scenes of 16,384 triangles,
// irm 8) there are 4 * 16,384 * 32^2 = 67 M samples of about 50 float32
// operations each (three edge functions, the coverage test, a division,
// the interpolated depth), against about 5 MB of triangles in and grid
// out.
//
// Design: one warp per triangle. Every lane computes the triangle's
// projection as scalars (the 3 x 4 transform, the normal, the dominant
// axis, the window start, the block origin): the same few dozen
// operations in every lane, which costs less than sharing them. Lane
// l = 16 h + c takes cell c = 4 cu + cv of the 4 x 4 in-plane cells and
// the sample rows su = h, h + 2, ... of that cell's irm x irm samples, so
// any irm works. One pass over the samples: each lane keeps the smallest
// depth cell it has covered and the bit mask of the covered depth cells
// within 8 of it; every cell that can land in the block (dz < 8 from the
// warp's minimum) is within 8 of the lane's own minimum, so nothing is
// lost. A warp min gives the block's depth origin, a shuffle ORs the two
// halves of each cell, and each lane then builds two of the block's 8 x 8
// (y, x) entries from the cells by shuffles (the orientation per dominant
// axis, the row and column shifts), splits each into its lo and hi
// z-words and ORs the nonzero ones into the grid with atomicOr. OR is
// order-independent, so the result is exact and the same on every run.
// A triangle that is not valid, covers nothing, or whose origin falls
// outside the grid (as the scatter decodes it) writes nothing. All index
// arithmetic is 32-bit (the entry point bounds the sizes).
//
// The entry point has a plain C interface and returns cudaGetLastError()
// right after the launch; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDepthCells = 8;
constexpr int kNone = 1 << 20;  // "no covered sample", as the tensor code

// torch.floor(x / s).to(torch.int32) - 2, floored to a multiple of irm,
// clamped to [0, hi]: the cell-aligned window start.
__device__ __forceinline__ int window_start(float vmin, float s, int irm,
                                            int hi) {
  int i0 = __float2int_rz(floorf(__fdiv_rn(vmin, s))) - 2;
  int q = i0 / irm;
  if (i0 % irm != 0 && i0 < 0) --q;
  i0 = q * irm;
  return min(max(i0, 0), hi);
}

// _edge(pu, pv, a, b) = (bu - au) * (pv - av) - (bv - av) * (pu - au),
// with eu = bu - au and ev = bv - av.
__device__ __forceinline__ float edge(float eu, float ev, float dv,
                                      float du) {
  return __fsub_rn(__fmul_rn(eu, dv), __fmul_rn(ev, du));
}

__global__ void __launch_bounds__(kThreads)
    blocked_raster_kernel(const float* __restrict__ triangles,
                          const int* __restrict__ tri_mesh_slot,
                          const float* __restrict__ mats,
                          const uint8_t* __restrict__ tri_valid,
                          uint32_t* __restrict__ out, int n, int t,
                          int meshes, int m, int irm, float s,
                          int conservative) {
  const int tri = blockIdx.x * kWarps + threadIdx.x / 32;  // b * T + t
  if (tri >= n || !tri_valid[tri]) return;
  const int lane = threadIdx.x % 32;
  const int b = tri / t;
  const int nw = m / 32;

  // Vertices to voxel space: ((t0 M[c][0] + t1 M[c][1]) + t2 M[c][2]) +
  // M[c][3], the scene's slot-0 matrix.
  const float* mat = mats + b * 16;
  const float* tv = triangles + tri * 9;
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* row = mat + 4 * c;
      v[i][c] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(tv[3 * i], row[0]),
                              __fmul_rn(tv[3 * i + 1], row[1])),
                    __fmul_rn(tv[3 * i + 2], row[2])),
          row[3]);
    }
  }
  float e1[3], e2[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e1[c] = __fsub_rn(v[1][c], v[0][c]);
    e2[c] = __fsub_rn(v[2][c], v[0][c]);
  }
  // The normal as torch.linalg.cross computes it: its kernel's a * b -
  // c * d is contracted to fma(a, b, -(c * d)), on the CPU and the card.
  const float ax = fabsf(__fmaf_rn(e1[1], e2[2], -__fmul_rn(e1[2], e2[1])));
  const float ay = fabsf(__fmaf_rn(e1[2], e2[0], -__fmul_rn(e1[0], e2[2])));
  const float az = fabsf(__fmaf_rn(e1[0], e2[1], -__fmul_rn(e1[1], e2[0])));
  // The dominant axis with GLSL's strict comparisons (ties go to z, then
  // y), and the plane axes (u, v) = (y, z), (z, x), (x, y).
  const int k = (ax > ay && ax > az) ? 0 : (ay > ax && ay > az) ? 1 : 2;
  const int u_ax = k == 0 ? 1 : k == 1 ? 2 : 0;
  const int v_ax = k == 0 ? 2 : k == 1 ? 0 : 1;
  const float u0 = v[0][u_ax], u1 = v[1][u_ax], u2 = v[2][u_ax];
  const float v0 = v[0][v_ax], v1 = v[1][v_ax], v2 = v[2][v_ax];
  const float d0 = v[0][k], d1 = v[1][k], d2 = v[2][k];

  const int hi_start = (m - 4) * irm;  // image_res - wp
  const int iu0 = window_start(fminf(fminf(u0, u1), u2), s, irm, hi_start);
  const int iv0 = window_start(fminf(fminf(v0, v1), v2), s, irm, hi_start);
  const int ou = iu0 / irm, ov = iv0 / irm;  // first cells, in [0, m - 4]
  const int bu = min(ou / 4 * 4, m - 8), bv = min(ov / 4 * 4, m - 8);

  const float hs = __fmul_rn(s, 0.5f);
  const float e0u = __fsub_rn(u2, u1), e0v = __fsub_rn(v2, v1);
  const float e1u = __fsub_rn(u0, u2), e1v = __fsub_rn(v0, v2);
  const float e2u = __fsub_rn(u1, u0), e2v = __fsub_rn(v1, v0);
  const float slack0 = __fmul_rn(__fadd_rn(fabsf(e0v), fabsf(e0u)), hs);
  const float slack1 = __fmul_rn(__fadd_rn(fabsf(e1v), fabsf(e1u)), hs);
  const float slack2 = __fmul_rn(__fadd_rn(fabsf(e2v), fabsf(e2u)), hs);
  const float umin = fminf(fminf(u0, u1), u2);
  const float umax = fmaxf(fmaxf(u0, u1), u2);
  const float vmin = fminf(fminf(v0, v1), v2);
  const float vmax = fmaxf(fmaxf(v0, v1), v2);
  const float mf = static_cast<float>(m);
  const float eps_scale = static_cast<float>(1e-4);

  // The lane's samples: cell (cu, cv), rows su = half, half + 2, ...
  const int cell = lane & 15;
  const int cu = cell >> 2, cv = cell & 3;
  int lmin = kNone;   // the lane's smallest covered depth cell
  uint32_t mask = 0;  // bit i: depth cell lmin + i covered, i < 8
  for (int su = lane >> 4; su < irm; su += 2) {
    const float pu = __fadd_rn(
        __fmul_rn(static_cast<float>(iu0 + cu * irm + su), s), hs);
    const float du0 = __fsub_rn(pu, u0), du1 = __fsub_rn(pu, u1),
                du2 = __fsub_rn(pu, u2);
    const bool u_in = __fadd_rn(pu, hs) >= umin &&
                      __fsub_rn(pu, hs) <= umax;
    for (int sv = 0; sv < irm; ++sv) {
      const float pv = __fadd_rn(
          __fmul_rn(static_cast<float>(iv0 + cv * irm + sv), s), hs);
      const float w0 = edge(e0u, e0v, __fsub_rn(pv, v1), du1);
      const float w1 = edge(e1u, e1v, __fsub_rn(pv, v2), du2);
      const float w2 = edge(e2u, e2v, __fsub_rn(pv, v0), du0);
      const float area2 = __fadd_rn(__fadd_rn(w0, w1), w2);
      bool cov;
      if (conservative) {
        const float sgn = area2 > 0.f ? 1.f : (area2 < 0.f ? -1.f : 0.f);
        cov = __fadd_rn(__fmul_rn(sgn, w0), slack0) >= 0.f &&
              __fadd_rn(__fmul_rn(sgn, w1), slack1) >= 0.f &&
              __fadd_rn(__fmul_rn(sgn, w2), slack2) >= 0.f && u_in &&
              __fadd_rn(pv, hs) >= vmin && __fsub_rn(pv, hs) <= vmax;
      } else {
        const float eps = __fmul_rn(eps_scale, fabsf(area2));
        cov = (w0 >= -eps && w1 >= -eps && w2 >= -eps) ||
              (w0 <= eps && w1 <= eps && w2 <= eps);
      }
      if (!cov || !(fabsf(area2) > 0.f)) continue;
      const float inv = __fdiv_rn(1.0f, area2);
      const float depth = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(w0, inv), d0),
                    __fmul_rn(__fmul_rn(w1, inv), d1)),
          __fmul_rn(__fmul_rn(w2, inv), d2));
      if (!(depth >= 0.f && depth < mf)) continue;
      const int cd = __float2int_rz(floorf(depth));
      if (cd < lmin) {
        const int up = lmin - cd;
        mask = up >= kDepthCells ? 0u : (mask << up) & 0xffu;
        lmin = cd;
      }
      if (cd - lmin < kDepthCells) mask |= 1u << (cd - lmin);
    }
  }

  // The block's depth origin od = clamp(min covered cell, 0, m - 8); each
  // cell's bits 1 << (cd - od) for cd - od < 8.
  const int dmin = __reduce_min_sync(kFull, lmin);
  if (dmin == kNone) return;  // covers nothing: writes nothing
  const int od = min(max(dmin, 0), m - kDepthCells);
  const int delta = lmin - od;  // >= 0 where mask != 0
  uint32_t bits = (mask != 0u && delta < kDepthCells)
                      ? (mask << delta) & 0xffu : 0u;
  bits |= __shfl_xor_sync(kFull, bits, 16);  // lane c < 16: cell c's b3
  if (!__any_sync(kFull, bits != 0u)) return;

  // The origin as the scatter reads it: o = (slot m + by) m + bx in
  // int32, skipped when negative or when its block leaves the grid.
  const int su_ = ou - bu, sv_ = ov - bv;  // in [0, 4]
  const int bx = u_ax == 0 ? bu : v_ax == 0 ? bv : od;
  const int by = u_ax == 1 ? bu : v_ax == 1 ? bv : od;
  const int bz = u_ax == 2 ? bu : v_ax == 2 ? bv : od;
  const int sx = u_ax == 0 ? su_ : v_ax == 0 ? sv_ : 0;
  const int sy = u_ax == 1 ? su_ : v_ax == 1 ? sv_ : 0;
  const int sz = u_ax == 2 ? su_ : v_ax == 2 ? sv_ : 0;
  const int o = static_cast<int>(
      (static_cast<uint32_t>(tri_mesh_slot[tri]) * m + by) * m + bx);
  if (o < 0) return;
  const int ox = o % m, oy = (o / m) % m, slot = o / (m * m);
  if (slot >= meshes || oy > m - 8 || ox > m - 8) return;

  const int shift = bz & 31, wd = bz >> 5;
  uint32_t* grid = out + ((b * meshes + slot) * m + oy) * (m * nw) + ox * nw;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = lane + 32 * half;  // block entry (y, x) = (p / 8, p % 8)
    const int y = p >> 3, x = p & 7;
    const int y0 = y - sy, x0 = x - sx;  // before the row/column shifts
    // The cells the entry reads (k 2: one; k 0 and 1: a row or column of
    // four), clamped to lanes 0-15 where the entry is out of range.
    const int yc = min(max(y0, 0), 3), xc = min(max(x0, 0), 3);
    uint32_t val = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int src = k == 0 ? 4 * yc + j : k == 1 ? 4 * j + xc
                                                   : 4 * xc + yc;
      const uint32_t c = __shfl_sync(kFull, bits, src);
      if (k == 0) {         // cube[y = cu][x = d], bits z = cv
        val |= ((c >> (x0 & 7)) & 1u) << j;
      } else if (k == 1) {  // cube[y = d][x = cv], bits z = cu
        val |= ((c >> (y0 & 7)) & 1u) << j;
      } else if (j == 0) {  // cube[y = cv][x = cu], bits z = d
        val = c;
      }
    }
    const bool in = y0 >= 0 && x0 >= 0 &&
                    (k == 0 ? y0 < 4 : k == 1 ? x0 < 4 : y0 < 4 && x0 < 4);
    if (!in) continue;
    val <<= sz;
    const uint32_t lo = val << shift;
    const uint32_t hi = (val >> 1) >> (31 - shift);
    uint32_t* dst = grid + y * (m * nw) + x * nw;
    if (lo != 0u) atomicOr(dst + wd, lo);
    if (hi != 0u && wd + 1 < nw) atomicOr(dst + wd + 1, hi);
  }
}

}  // namespace

extern "C" {

// triangles: float32[b * t * 9]; tri_mesh_slot: int32[b * t]; mats:
// float32[b * 16], each scene's view -> voxel matrix; tri_valid: bool[b * t];
// out: uint32[b * meshes * m * m * (m / 32)], zeroed by the caller.
// m is a multiple of 32, irm >= 1, s the sample spacing m / (m irm) as
// float32. Returns a cudaError_t as int: 0 when the launch succeeded.
int blocked_raster_fwd(const void* triangles, const void* tri_mesh_slot,
                       const void* mats, const void* tri_valid, void* out,
                       int b, int t, int meshes, int m, int irm, float s,
                       int conservative, void* stream) {
  if (b <= 0 || t <= 0 || meshes <= 0 || m < 32 || m % 32 != 0 ||
      irm <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 32-bit indices: triangles, grids and pixel indices must fit an int.
  const long long n = static_cast<long long>(b) * t;
  if (n * 9 > 0x7fffffffLL ||
      static_cast<long long>(b) * meshes * m * m * (m / 32) > 0x7fffffffLL ||
      static_cast<long long>(m) * m > 0x7fffffffLL ||
      static_cast<long long>(m) * irm > (1LL << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  blocked_raster_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(triangles),
      static_cast<const int*>(tri_mesh_slot),
      static_cast<const float*>(mats),
      static_cast<const uint8_t*>(tri_valid), static_cast<uint32_t*>(out),
      static_cast<int>(n), t, meshes, m, irm, s, conservative);
  return static_cast<int>(cudaGetLastError());
}

const char* blocked_raster_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
