// Bit-packed occupancy -> phase-major ground truth, for Hopper (sm_90a).
//
// Replaces corenet_tpu/ops/phased_gt.py::phased_gt (the Pallas kernel
// `_kernel` and its one-hot matrix `_pfat`). Contract, for a factor s in
// {2, 4} per axis: packed int32[B, H, W, NW] (bit z % 32 of word z / 32 at
// (y, x) is the occupancy of voxel (z, y, x); D = 32 * NW) becomes
// out uint8[B, D/s, H/s, (W/s) * s^3] of exact 0/1, where lane
//   jx * s^3 + zpart[zc] + ypart[yc] + xpart[xc]
// of row (jz, jy) holds voxel (z, y, x) = (s*jz + zc, s*jy + yc, s*jx + xc).
// The in-cell digits take the channel order (z1, y1, x1, z2, y2, x2) of the
// training step's permutation: for s = 2 the weights are z 4, y 2, x 1;
// for s = 4 each in-cell index c = 2*c1 + c2 has weights z (32, 4),
// y (16, 2), x (8, 1).
//
// The TPU kernel stored float32 because sub-32-bit stores wedged its
// compiler; the values are the same 0/1, and here they are uint8, which is
// what the loss reads.
//
// What bounds it: bytes. At h7 (B = 4, 128^3, s = 2) it reads 1 MiB of
// words and writes 8 MiB of labels; the shuffle is a few integer
// operations per byte.
//
// Design: for s = 2 one block per (b, jy); for s = 4 one block per (b,
// jy, 16-voxel z chunk), so that the launch fills the card even on a
// space rank's 2 scenes (512 blocks on 132 SMs; one block per (b, jy)
// gave 64 and sat at its launch floor, 0.0049 ms). At s = 2 the chunks
// measured slower than whole columns (0.0062-0.0064 against 0.0053 ms on
// h7's 4 scenes on an H100), so s = 2 keeps one block per column. A block copies the words it needs of the s rows y = s*jy + yc
// into shared memory (one coalesced read; a 16-voxel chunk lies in one
// word), stored [yc][word][x] so that neighbouring cells read
// neighbouring banks. Then each thread writes whole output pieces of the
// block's rows (b, jz, jy): for s = 2 one cell of 8 lanes (an 8-byte
// store), for s = 4 a quarter cell of 16 lanes (a 16-byte store);
// neighbouring threads write neighbouring pieces of a row. Inside a cell
// the z-bits of a voxel column share one word (s divides 32), so a piece
// reads each (y, x) word it needs once and takes two bits from it. All
// index arithmetic is 32-bit (the wrapper bounds the sizes and the shared
// memory). The TPU kernel's row pre-permutation and its one-hot MXU
// matmul worked around what Mosaic could lower; they have no counterpart
// here.
//
// The entry point has a plain C interface and returns cudaGetLastError()
// right after the launch; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 48 * 1024;  // without opting in to more

constexpr int kChunkZ = 16;  // s = 4: voxels of z per block, in one word

// A block's output row (b, jz, jy) starts at ((b * dq + jz) * hq + jy)
// * row_lanes bytes; the shared words of the block's rows are
// sm[(yc * words + word) * w + x], word counted from the block's first.
template <int S>
__global__ void __launch_bounds__(kThreads)
    phased_gt_kernel(const uint32_t* __restrict__ packed,
                     uint8_t* __restrict__ out, int h, int w, int nw) {
  extern __shared__ uint32_t sm[];
  constexpr bool kChunked = S == 4;
  const int hq = h / S;
  const int dq = 32 * nw / S;
  const int chunks = kChunked ? 32 * nw / kChunkZ : 1;
  const int chunk = blockIdx.x % chunks;
  const int b = blockIdx.x / chunks / hq;
  const int jy = (blockIdx.x / chunks) % hq;
  const int words = kChunked ? 1 : nw;  // staged words per (yc, x)
  const int z0 = kChunked ? chunk * kChunkZ : 0;
  const int rows_here = kChunked ? kChunkZ / S : dq;
  const uint32_t* rows = packed + (b * h + S * jy) * w * nw + (z0 >> 5);
  for (int i = threadIdx.x; i < S * w * words; i += kThreads) {
    const int word = i % words;
    const int x = (i / words) % w;
    const int yc = i / (words * w);
    sm[(yc * words + word) * w + x] = __ldg(rows + (yc * w + x) * nw + word);
  }
  __syncthreads();
  const int row_lanes = (w / S) * S * S * S;
  uint8_t* row0 = out + ((b * dq + z0 / S) * hq + jy) * row_lanes;
  if constexpr (S == 2) {
    // Piece = one cell jx; lane p = 4 zc + 2 yc + xc.
    const int cells = w / 2;
    for (int u = threadIdx.x; u < rows_here * cells; u += kThreads) {
      const int r = u / cells;
      const int jx = u % cells;
      const int word = (2 * r) >> 5;
      const int bit = (2 * r) & 31;
      uint32_t lo = 0u, hi = 0u;  // lanes 0-3 (zc = 0) and 4-7 (zc = 1)
#pragma unroll
      for (int yc = 0; yc < 2; ++yc) {
#pragma unroll
        for (int xc = 0; xc < 2; ++xc) {
          const uint32_t v = sm[(yc * words + word) * w + 2 * jx + xc] >> bit;
          const int shift = 8 * (2 * yc + xc);
          lo |= (v & 1u) << shift;
          hi |= ((v >> 1) & 1u) << shift;
        }
      }
      reinterpret_cast<uint2*>(row0 + r * hq * row_lanes)[jx] =
          make_uint2(lo, hi);
    }
  } else {
    // Piece = 16 lanes k * 16 .. k * 16 + 15 of cell jx, which fix
    // z1 = k >> 1 and y1 = k & 1; lane j of the piece is
    // 8 x1 + 4 z2 + 2 y2 + x2.
    const int pieces = w;  // (w / 4) cells * 4
    for (int u = threadIdx.x; u < rows_here * pieces; u += kThreads) {
      const int r = u / pieces;
      const int jx = (u % pieces) / 4;
      const int k = u % 4;
      const int z1 = k >> 1, y1 = k & 1;
      const int bit = ((z0 + 4 * r) & 31) + 2 * z1;
      uint32_t lanes[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int x1 = 0; x1 < 2; ++x1) {
#pragma unroll
        for (int y2 = 0; y2 < 2; ++y2) {
#pragma unroll
          for (int x2 = 0; x2 < 2; ++x2) {
            const int yc = 2 * y1 + y2;
            const int xc = 2 * x1 + x2;
            const uint32_t v = sm[yc * w + 4 * jx + xc] >> bit;
            // z2 = 0 at lane 8 x1 + 2 y2 + x2, z2 = 1 four lanes on.
            const int j = 8 * x1 + 2 * y2 + x2;
            lanes[j / 4] |= (v & 1u) << (8 * (j % 4));
            lanes[j / 4 + 1] |= ((v >> 1) & 1u) << (8 * (j % 4));
          }
        }
      }
      reinterpret_cast<uint4*>(row0 + r * hq * row_lanes)[u % pieces] =
          make_uint4(lanes[0], lanes[1], lanes[2], lanes[3]);
    }
  }
}

}  // namespace

extern "C" {

// packed: int32[b * h * w * nw]; out: uint8[b * (32 nw / s) * (h / s) *
// (w / s) * s^3], 16-byte aligned. s is 2 or 4 and divides h and w, and
// a block's staged words, 4 * s * w * nw bytes for s = 2 and 4 * s * w for
// s = 4, fit 48 KiB of shared memory. Returns a cudaError_t
// as int: 0 when the launch succeeded.
int phased_gt_fwd(const void* packed, void* out, int b, int h, int w, int nw,
                  int s, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || nw <= 0 || (s != 2 && s != 4) ||
      h % s != 0 || w % s != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Output bytes = voxels = b * 32 nw * h * w; 32-bit indices need it to
  // fit an int, and a block's staged words must fit shared memory.
  const long long bytes = static_cast<long long>(b) * 32 * nw * h * w;
  const long long shared = 4LL * s * w * (s == 2 ? nw : 1);
  if (bytes > 0x7fffffffLL || shared > kMaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint32_t*>(packed);
  auto* o = static_cast<uint8_t*>(out);
  const unsigned blocks = static_cast<unsigned>(
      b * (h / s) * (s == 2 ? 1 : 32 * nw / kChunkZ));
  if (s == 2) {
    phased_gt_kernel<2><<<blocks, kThreads, shared, st>>>(in, o, h, w, nw);
  } else {
    phased_gt_kernel<4><<<blocks, kThreads, shared, st>>>(in, o, h, w, nw);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* phased_gt_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
