// OR-scatter of per-triangle packed voxel blocks into bit-packed occupancy
// grids, for Hopper (sm_90a).
//
// Replaces corenet_tpu/ops/block_scatter.py::block_scatter_or (the Pallas
// kernel `_kernel`). Contract: each triangle t of scene b whose origin
//   origins[b, t] = (slot * H + oy) * W + ox
// is >= 0 ORs its 8 x (8 * NW) block of 32-bit z-words pw[b, t] (row dy,
// lane dx * NW + w) into out[b, slot, oy + dy, (ox + dx) * NW + w]. An
// origin of -1 is skipped, and so is one whose block would leave the grid
// (oy > H - 8, ox > W - 8 or slot >= M), so no origin can write outside
// `out`. The caller zeroes `out`.
//
// What bounds it: bytes. Each valid triangle's block is 8 * 8 * NW words
// (1 KiB at NW = 4) read once, and the grid (4 * M * H * W * NW bytes) is
// written; the OR itself is one atomic per nonzero word, and most words of
// a block are zero (a triangle's content spans at most 8 z-bits of one or
// two of its NW words).
//
// Design: one warp per triangle. Its lanes read the triangle's origin
// together (one broadcast load); a warp whose origin is -1 or leaves the grid
// exits before reading its block. The warp walks the block as 16-byte
// groups of 4 words (a row of 8 * NW words is 2 * NW groups), so each
// load instruction reads 512 contiguous bytes; a group of 4 zero words
// ends there, and each nonzero word is one 32-bit atomicOr. All index
// arithmetic is 32-bit (the wrapper bounds the sizes), with NW a
// compile-time constant for NW = 1, 2, 4. OR is order-independent, so the
// result is exact and the same on every run. What the TPU kernel needed
// for its serial loop over triangles (the GROUP/UNIFORM run sentinels,
// padding to 1024-triangle chunks, merging runs of equal origins in VMEM)
// has no counterpart here.
//
// The entry point has a plain C interface and returns cudaGetLastError()
// right after the launch; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;

// NW > 0: the words per z-column as a compile-time constant; 0: nw_rt.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    block_scatter_or_kernel(const int* __restrict__ origins,
                            const uint4* __restrict__ pw,
                            uint32_t* __restrict__ out, int triangles,
                            int t, int m, int h, int w, int nw_rt) {
  const int nw = NW > 0 ? NW : nw_rt;
  const int tri = blockIdx.x * kWarps + threadIdx.x / 32;  // b * T + t
  if (tri >= triangles) return;
  const int o = __ldg(origins + tri);
  if (o < 0) return;
  const int ox = o % w;
  const int oy = (o / w) % h;
  const int slot = o / (w * h);
  if (slot >= m || oy > h - kRows || ox > w - kRows) return;
  const int groups_per_row = 2 * nw;  // 16-byte groups in a block row
  const int groups = kRows * groups_per_row;
  const uint4* block = pw + tri * groups;
  // out's word offset of the block's (row 0, lane 0).
  const int corner = (((tri / t) * m + slot) * h + oy) * (w * nw) + ox * nw;
  for (int g = threadIdx.x % 32; g < groups; g += 32) {
    const uint4 v = __ldg(block + g);
    if ((v.x | v.y | v.z | v.w) == 0u) continue;
    const int row = g / groups_per_row;
    uint32_t* dst = out + corner + row * (w * nw) + 4 * (g % groups_per_row);
    if (v.x) atomicOr(dst, v.x);
    if (v.y) atomicOr(dst + 1, v.y);
    if (v.z) atomicOr(dst + 2, v.z);
    if (v.w) atomicOr(dst + 3, v.w);
  }
}

}  // namespace

extern "C" {

// origins: int32[b * t]; pw: uint32[b * t * 8 * 8 * nw], 16-byte aligned;
// out: uint32[b * m * h * w * nw], zeroed by the caller. Returns a
// cudaError_t as int: 0 when the launch succeeded.
int block_scatter_or_fwd(const void* origins, const void* pw, void* out,
                         int b, int t, int m, int h, int w, int nw,
                         void* stream) {
  if (b <= 0 || t <= 0 || m <= 0 || h < kRows || w < kRows || nw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 32-bit indices: the blocks' and the grids' words must fit an int.
  const long long triangles = static_cast<long long>(b) * t;
  if (triangles * kRows * kRows * nw > 0x7fffffffLL ||
      static_cast<long long>(b) * m * h * w * nw > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = static_cast<int>(triangles);
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int*>(origins);
  const auto* p = static_cast<const uint4*>(pw);
  auto* g = static_cast<uint32_t*>(out);
  switch (nw) {
    case 1:
      block_scatter_or_kernel<1><<<blocks, kThreads, 0, st>>>(o, p, g, n, t,
                                                             m, h, w, nw);
      break;
    case 2:
      block_scatter_or_kernel<2><<<blocks, kThreads, 0, st>>>(o, p, g, n, t,
                                                             m, h, w, nw);
      break;
    case 4:
      block_scatter_or_kernel<4><<<blocks, kThreads, 0, st>>>(o, p, g, n, t,
                                                             m, h, w, nw);
      break;
    default:
      block_scatter_or_kernel<0><<<blocks, kThreads, 0, st>>>(o, p, g, n, t,
                                                             m, h, w, nw);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* block_scatter_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
