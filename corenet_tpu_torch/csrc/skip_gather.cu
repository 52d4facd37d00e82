// The ray-traced skip connection's pixel gather and its gradient, for
// Hopper (sm_90a).
//
// Replaces corenet_tpu/ops/skip_gather.py::skip_gather, both Pallas
// kernels:
//
//   forward  (`_fwd_kernel`)  out[b, n, :] = fmap[b, py[b, n], px[b, n], :]
//   backward (`_bwd_kernel`)  dfmap[b, py[b, n], px[b, n], :] += dout[b, n, :]
//
// fmap is the 1-px padded, channel-last skip map [B, H2, W2, C] (f32 or
// bf16), px/py are int32 [B, N], out and dout are [B, N, C] in fmap's
// type. The TPU kernels computed both as one-hot MXU matmuls over a
// column-blocked map, because Mosaic has no fast dynamic gather or
// scatter; none of that carries over.
//
// Forward. What bounds it: bytes. The gather does no arithmetic; it reads
// two int32 indices and writes C elements per voxel, and reads the map (at
// most 0.9 MB per launch at h7) from L2. At h7 (256^2 images, 128^3
// output, batch 4) the four skips move ~78 MB, ~60 MB of it in the 64^3
// skip (N = 262144, C = 12): ~23 us at the H100's 3.35 TB/s.
//
// Forward design: in the channel-last map each gathered pixel is one
// contiguous run of C * sizeof(T) bytes, so the gather is a row copy that
// never looks at the element type. One thread moves one vector of V bytes,
// the widest of 16/8/4/2 that divides the row and both base pointers;
// consecutive threads take consecutive vectors of a row, then of the next
// row, so the output is written fully coalesced and each row is read as
// one contiguous burst. The threads of a row read the same index pair,
// which the L1 serves once. The copy is bit-exact by construction.
//
// Backward. By bytes it is the forward reversed (dout read once, the map
// written once: ~80 MB at h7 in f32), but every element of dout is one
// f32 atomic add into the map (16.7 M at h7), and voxels that project to
// the same pixel add into the same addresses. Voxels off the image land on
// the 1-px ring and voxels behind the camera on pixel (0, 0), so those
// cells are the hot ones. What bounds it on the card is measured
// (chip_smoke.py) rather than assumed.
//
// Backward design: the wrapper hands in an f32 accumulator [B, H2, W2, C]
// (the output itself for f32 dout); it is zeroed on the stream, then one
// thread per (voxel, vector of V <= 4 channels) loads its vector of dout
// with one coalesced load and adds it into the pixel's channels with one
// vector f32 atomicAdd (RED.V4/V2, the result is unused), so a warp's
// adds cover the same contiguous span its load did. V scalar atomics per
// thread would make each warp instruction touch a V-times wider span of
// addresses, V times as many instructions; measured 3.3x slower at the
// 64^3 skip (PERF.md). bf16 dout accumulates in the f32
// buffer and is rounded to bf16 (nearest even) once, in a second pass, as
// the TPU kernel accumulated in f32 and cast at the end. The order of the
// atomic adds varies from run to run, so the result is deterministic only
// up to f32 summation order: |err| <= ~1e-5 * sum |dout| per cell.
//
// Indices are clamped into the map, which keeps a bad index from reading
// or writing outside the allocation; the caller's contract is px in
// [0, W2) and py in [0, H2) (models/skip.py builds them so), where the
// clamp is a no-op.
//
// Entry points have a plain C interface and return cudaGetLastError()
// right after the launches; the Python wrapper raises when it is not 0.

#include <cuda_bf16.h>
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

// V consecutive elements of T, loaded as one vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    scatter_add_rows(const T* __restrict__ dout, const int* __restrict__ px,
                     const int* __restrict__ py, float* __restrict__ acc,
                     int total, int n, int h2, int w2, int c,
                     int vecs_per_row) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int row = i / vecs_per_row;  // b * n + voxel
  const int v = i - row * vecs_per_row;
  const int b = row / n;
  const int x = min(max(__ldg(px + row), 0), w2 - 1);
  const int y = min(max(__ldg(py + row), 0), h2 - 1);
  const long long pixel = (static_cast<long long>(b) * h2 + y) * w2 + x;
  const Pack<T, V> in = reinterpret_cast<const Pack<T, V>*>(dout)[i];
  float* dst = acc + pixel * c + static_cast<long long>(v) * V;
  // One vector atomic per thread (sm_90's float2/float4 atomicAdd on
  // global memory): a warp's 32 adds then cover one contiguous run of
  // 32 * V floats, as its load did.
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(to_float(in.v[0]), to_float(in.v[1]),
                          to_float(in.v[2]), to_float(in.v[3])));
  } else if constexpr (V == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst),
              make_float2(to_float(in.v[0]), to_float(in.v[1])));
  } else {
    atomicAdd(dst, to_float(in.v[0]));
  }
}

__global__ void __launch_bounds__(kThreads)
    round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                  long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < count) dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T, int V>
cudaError_t launch_scatter(const void* dout, const int* px, const int* py,
                           float* acc, int total, int n, int h2, int w2, int c,
                           cudaStream_t stream) {
  const int blocks = (total + kThreads - 1) / kThreads;
  scatter_add_rows<T, V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), px, py, acc, total, n, h2, w2, c, c / V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t scatter(const void* dout, const int* px, const int* py,
                    float* acc, long long rows, int n, int h2, int w2, int c,
                    cudaStream_t stream) {
  int vec = 4;
  while (vec > 1 && (c % vec != 0 || !aligned(dout, vec * sizeof(T)) ||
                     !aligned(acc, vec * sizeof(float)))) {
    vec /= 2;
  }
  const long long total = rows * (c / vec);
  if (total > INT_MAX) return cudaErrorInvalidValue;
  const int t = static_cast<int>(total);
  switch (vec) {
    case 4:
      return launch_scatter<T, 4>(dout, px, py, acc, t, n, h2, w2, c, stream);
    case 2:
      return launch_scatter<T, 2>(dout, px, py, acc, t, n, h2, w2, c, stream);
    default:
      return launch_scatter<T, 1>(dout, px, py, acc, t, n, h2, w2, c, stream);
  }
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

// Scatter-adds b * n rows of c elements of dout (f32 when elem_bytes is 4,
// bf16 when 2) into dfmap [b, h2, w2, c] of dout's type, through the f32
// accumulator acc of the same shape, which may be dfmap itself for f32.
// Returns a cudaError_t as int: 0 when every launch succeeded.
int skip_gather_bwd(const void* dout, const int* px, const int* py,
                    float* acc, void* dfmap, int b, int n, int h2, int w2,
                    int c, int elem_bytes, void* stream) {
  if (b <= 0 || n <= 0 || h2 <= 0 || w2 <= 0 || c <= 0 ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (elem_bytes == 4 && dfmap != acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(b) * h2 * w2 * c;
  cudaError_t err = cudaMemsetAsync(acc, 0, cells * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * n;
  err = elem_bytes == 4
            ? scatter<float>(dout, px, py, acc, rows, n, h2, w2, c, s)
            : scatter<__nv_bfloat16>(dout, px, py, acc, rows, n, h2, w2, c, s);
  if (err != cudaSuccess || elem_bytes == 4) return static_cast<int>(err);
  const long long blocks = (cells + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  round_to_bf16<<<static_cast<int>(blocks), kThreads, 0, s>>>(
      acc, static_cast<__nv_bfloat16*>(dfmap), cells);
  return static_cast<int>(cudaGetLastError());
}

const char* skip_gather_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
