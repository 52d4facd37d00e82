// The ray-traced skip connection's pixel gather, forward, for Hopper (sm_90a).
//
// Replaces corenet_tpu/ops/skip_gather.py::skip_gather (the Pallas forward
// kernel `_fwd_kernel`):
//
//   out[b, n, :] = fmap[b, py[b, n], px[b, n], :]
//
// fmap is the 1-px padded, channel-last skip map [B, H2, W2, C] (f32 or
// bf16), px/py are int32 [B, N], out is [B, N, C] in fmap's type. The TPU
// kernel computed this as one-hot MXU matmuls over a column-blocked map,
// because Mosaic has no fast dynamic gather; none of that carries over.
//
// What bounds it: bytes. The gather does no arithmetic; it reads two int32
// indices and writes C elements per voxel, and reads the map (at most
// 0.9 MB per launch at h7) from L2. At h7 (256^2 images, 128^3 output,
// batch 4) the four skips move ~78 MB, ~60 MB of it in the 64^3 skip
// (N = 262144, C = 12): ~23 us at the H100's 3.35 TB/s.
//
// Design: in the channel-last map each gathered pixel is one contiguous
// run of C * sizeof(T) bytes, so the gather is a row copy that never looks
// at the element type. One thread moves one vector of V bytes, the widest
// of 16/8/4/2 that divides the row and both base pointers; consecutive
// threads take consecutive vectors of a row, then of the next row, so the
// output is written fully coalesced and each row is read as one
// contiguous burst. The threads of a row read the same index pair, which
// the L1 serves once. The copy is bit-exact by construction.
//
// Indices are clamped into the map, which keeps a bad index from reading
// outside the allocation; the caller's contract is px in [0, W2) and
// py in [0, H2) (models/skip.py builds them so), where the clamp is a
// no-op.
//
// Entry points have a plain C interface and return cudaGetLastError()
// right after the launch; the Python wrapper raises when it is not 0.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
    gather_rows(const V* __restrict__ fmap, const int* __restrict__ px,
                const int* __restrict__ py, V* __restrict__ out, int total,
                int n, int h2, int w2, int vecs_per_row) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int row = i / vecs_per_row;  // b * n + voxel
  const int v = i - row * vecs_per_row;
  const int b = row / n;
  const int x = min(max(__ldg(px + row), 0), w2 - 1);
  const int y = min(max(__ldg(py + row), 0), h2 - 1);
  const long long pixel = (static_cast<long long>(b) * h2 + y) * w2 + x;
  out[i] = __ldg(fmap + pixel * vecs_per_row + v);
}

template <typename V>
cudaError_t launch(const void* fmap, const int* px, const int* py, void* out,
                   int total, int n, int h2, int w2, int vecs_per_row,
                   cudaStream_t stream) {
  const int blocks = (total + kThreads - 1) / kThreads;
  gather_rows<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(fmap), px, py, static_cast<V*>(out), total, n,
      h2, w2, vecs_per_row);
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// Gathers b * n rows of row_bytes bytes each (row_bytes = C * elem_bytes).
// Returns a cudaError_t as int: 0 on a successful launch.
int skip_gather_fwd(const void* fmap, const int* px, const int* py,
                    void* out, int b, int n, int h2, int w2, int row_bytes,
                    int elem_bytes, void* stream) {
  if (b <= 0 || n <= 0 || h2 <= 0 || w2 <= 0 || elem_bytes <= 0 ||
      row_bytes <= 0 || row_bytes % elem_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int vec = 16;
  while (vec > elem_bytes &&
         (row_bytes % vec != 0 || !aligned(fmap, vec) || !aligned(out, vec))) {
    vec /= 2;
  }
  const int vecs_per_row = row_bytes / vec;
  const long long total = static_cast<long long>(b) * n * vecs_per_row;
  if (total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int t = static_cast<int>(total);
  switch (vec) {
    case 16:
      return static_cast<int>(
          launch<uint4>(fmap, px, py, out, t, n, h2, w2, vecs_per_row, s));
    case 8:
      return static_cast<int>(
          launch<uint2>(fmap, px, py, out, t, n, h2, w2, vecs_per_row, s));
    case 4:
      return static_cast<int>(launch<unsigned int>(fmap, px, py, out, t, n,
                                                   h2, w2, vecs_per_row, s));
    case 2:
      return static_cast<int>(launch<unsigned short>(fmap, px, py, out, t, n,
                                                     h2, w2, vecs_per_row, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* skip_gather_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
