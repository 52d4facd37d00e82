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
// Backward. By bytes it is the forward reversed: dout read once, the
// indices once, the map written once (~80 MB at h7 in f32, ~60 MB of it
// in the 64^3 skip). What held the first version back was atomics: one
// vector f32 atomicAdd per (voxel, 4 channels), 3.1 M at the 64^3 skip,
// piling onto few addresses (a pixel there takes 64 voxels on average and
// up to 205). The voxels come in (z, y, x) order and the decoder's camera
// looks along z, so consecutive voxels of one depth column (y, x) often
// project to the same pixel.
//
// Backward design: one thread per (scene, column (y, x), set of up to 12
// channels, chunk of z). It walks z through its chunk, reads each voxel's
// pixel, and adds the voxel's channels into f32 sums in registers for as
// long as the pixel stays the same; when the pixel changes, and at the end
// of the chunk, it flushes the sums into the pixel's channels with one
// vector f32 atomicAdd per 4 channels (RED.V4/V2, the result unused). That
// is one atomic per run of equal pixels instead of one per voxel.
// Consecutive threads take consecutive columns, and a thread loads its
// channels one by one at dout's element strides: where dout is
// channel-major, as autograd hands it over from the decoder's
// concatenation (element strides (C_tot * N, 1, N)), each channel load of
// a warp reads 32 consecutive elements. dout may have any strides, so the
// gradient is never copied before the launch. Voxels without column
// structure are columns of depth 1: one thread and one atomic per (voxel,
// 4 channels), still correct.
//
// Packed (space-to-depth) execution. The packed decoder's skip takes its
// voxels phase by phase: 8 grids of D/2 x H/2 x W/2, phase (pz, py, px)
// holding fine voxels (2Z + pz, 2Y + py, 2X + px). Its concatenation puts
// channel c of phase p at p * C_tot + c, so the gradient arrives as
// dout [B, 8, N/8, C] with element strides (8 * C_tot * N/8, C_tot * N/8,
// 1, N/8): not a [B, N, C] view, since the phase's stride is not N/8
// times the voxel's. The walk takes the phase as a fourth index: each
// (scene, phase) is walked like a fine skip at half the resolution, into
// the scene's map. A run of equal pixels along z then steps two fine
// voxels at a time.
//
// What bounds it at the 64^3 skip (PERF.md): the runs are short (4.2
// voxels on average: perspective moves a column's pixel every few steps
// in z), so it still issues 0.85 M vector atomics, 3.7x fewer than one
// per voxel. In trial kernels on the H100 that are not kept (PERF.md
// names their runs), plain stores in place of the atomics took as long,
// while reading the indices again for every channel group cost time: the
// reads set the pace. Hence up to 12 channels per thread (each voxel's
// pixel read once), two voxels in flight per thread (more costs registers
// and so warps), and a chunk of a quarter of the column, chosen by the
// wrapper (tools/skip_backward_sweep.py times the other chunks).
//
// The accumulator is [B, H2, W2, C] f32 (the output itself for f32 dout),
// zeroed on the stream first. bf16 dout accumulates in it and is rounded
// to bf16 (nearest even) once, in a second pass, as the TPU kernel
// accumulated in f32 and cast at the end. The order of the atomic adds
// varies from run to run, so the result is deterministic only up to f32
// summation order: |err| <= ~1e-5 * sum |dout| per cell.
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// How a launch walks dout [B, P, N, C] (element strides sb, sp, sn, sc):
// per scene P phases of N = depth * cols voxels each in (z, column) order,
// all scattering into the scene's map; `sets` sets of NG groups of V
// channels, chunks of z_chunk voxels along z.
struct Walk {
  long long sb, sp, sn, sc;
  int n, phases, depth, cols, sets, z_chunk, chunks, h2, w2, c;
};

// Voxels loaded into registers before any is summed. More keeps more
// loads in flight per thread but costs registers, and so warps per SM,
// which was slower in trials on the H100.
constexpr int kUnroll = 2;

// Adds the sums into the pixel's NG * V channels at dst: one vector atomic
// per V channels (sm_90's float2/float4 atomicAdd on global memory).
template <int V, int NG>
__device__ __forceinline__ void flush(float* dst, const float (&sum)[NG * V]) {
#pragma unroll
  for (int q = 0; q < NG; ++q) {
    const float* s = sum + q * V;
    if constexpr (V == 4) {
      atomicAdd(reinterpret_cast<float4*>(dst) + q,
                make_float4(s[0], s[1], s[2], s[3]));
    } else if constexpr (V == 2) {
      atomicAdd(reinterpret_cast<float2*>(dst) + q, make_float2(s[0], s[1]));
    } else {
      atomicAdd(dst + q, s[0]);
    }
  }
}

template <typename T, int V, int NG>
__global__ void __launch_bounds__(kThreads)
    scatter_add_columns(const T* __restrict__ dout, const int* __restrict__ px,
                        const int* __restrict__ py, float* __restrict__ acc,
                        int total, Walk w) {
  constexpr int kChannels = NG * V;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // i = (((b * P + p) * chunks + chunk) * sets + set) * cols + column.
  const int column = i % w.cols;
  int rest = i / w.cols;
  const int set = rest % w.sets;
  rest /= w.sets;
  const int chunk = rest % w.chunks;
  const int bp = rest / w.chunks;  // scene * P + phase
  const int b = bp / w.phases;
  const int p = bp - b * w.phases;
  const int z_begin = chunk * w.z_chunk;
  const int steps = min(w.z_chunk, w.depth - z_begin);
  const int first = z_begin * w.cols + column;  // voxel within the phase
  const long long z_stride = static_cast<long long>(w.cols) * w.sn;
  const T* src = dout + b * w.sb + p * w.sp + first * w.sn +
                 set * kChannels * w.sc;
  // The indices are [B, P * N]: phase p's voxels follow phase p - 1's.
  const long long scene = static_cast<long long>(bp) * w.n + first;
  const int* ix = px + scene;
  const int* iy = py + scene;
  float* dst = acc + static_cast<long long>(b) * w.h2 * w.w2 * w.c +
               set * kChannels;

  float sum[kChannels];
#pragma unroll
  for (int j = 0; j < kChannels; ++j) sum[j] = 0.0f;
  int current = -1;  // the pixel (y * W2 + x) the sums belong to
  for (int s = 0; s < steps; s += kUnroll) {
    int pixel[kUnroll];
    float v[kUnroll][kChannels];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      pixel[k] = -1;
      if (s + k < steps) {
        const int x = min(max(__ldg(ix + k * w.cols), 0), w.w2 - 1);
        const int y = min(max(__ldg(iy + k * w.cols), 0), w.h2 - 1);
        pixel[k] = y * w.w2 + x;
        const T* p = src + k * z_stride;
#pragma unroll
        for (int j = 0; j < kChannels; ++j) v[k][j] = to_float(p[j * w.sc]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (pixel[k] < 0) continue;
      if (pixel[k] != current) {
        if (current >= 0) flush<V, NG>(dst + current * w.c, sum);
        current = pixel[k];
#pragma unroll
        for (int j = 0; j < kChannels; ++j) sum[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kChannels; ++j) sum[j] += v[k][j];
    }
    ix += kUnroll * w.cols;
    iy += kUnroll * w.cols;
    src += kUnroll * z_stride;
  }
  if (current >= 0) flush<V, NG>(dst + current * w.c, sum);
}

__global__ void __launch_bounds__(kThreads)
    round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                  long long count) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i < count) dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T, int V, int NG>
cudaError_t launch_scatter(const void* dout, const int* px, const int* py,
                           float* acc, int b, Walk w, cudaStream_t stream) {
  w.sets = w.c / (NG * V);
  const long long total =
      static_cast<long long>(b) * w.phases * w.chunks * w.sets * w.cols;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  const int t = static_cast<int>(total);
  const int blocks = (t + kThreads - 1) / kThreads;
  scatter_add_columns<T, V, NG><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dout), px, py, acc, t, w);
  return cudaGetLastError();
}

// V channels per vector atomic: the widest of 4, 2, 1 that divides C. A
// thread takes 3 groups of 4 channels where C allows, so that it reads
// each voxel's pixel once for 12 channels (the h7 skips have 12 to 96).
template <typename T>
cudaError_t scatter(const void* dout, const int* px, const int* py,
                    float* acc, int b, const Walk& w, cudaStream_t stream) {
  if (w.c % 12 == 0 && aligned(acc, 4 * sizeof(float))) {
    return launch_scatter<T, 4, 3>(dout, px, py, acc, b, w, stream);
  }
  if (w.c % 4 == 0 && aligned(acc, 4 * sizeof(float))) {
    return launch_scatter<T, 4, 1>(dout, px, py, acc, b, w, stream);
  }
  if (w.c % 2 == 0 && aligned(acc, 2 * sizeof(float))) {
    return launch_scatter<T, 2, 1>(dout, px, py, acc, b, w, stream);
  }
  return launch_scatter<T, 1, 1>(dout, px, py, acc, b, w, stream);
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

// Scatter-adds dout [b, phases, n, c] (f32 when elem_bytes is 4, bf16
// when 2; element strides stride_b, stride_p, stride_n, stride_c) into
// dfmap [b, h2, w2, c] of dout's type, through the f32 accumulator acc of
// the same shape, which may be dfmap itself for f32. px and py are
// [b, phases * n]. Each phase's n voxels are `depth` slices of n / depth
// columns, (z, column) order; each thread walks z_chunk of them along z.
// The fine decoder's skips have one phase; the packed decoder's have 8,
// one grid of D/2 x H/2 x W/2 voxels each (models/skip.py).
// Returns a cudaError_t as int: 0 when every launch succeeded.
int skip_gather_bwd(const void* dout, const int* px, const int* py,
                    float* acc, void* dfmap, int b, int phases, int n,
                    int h2, int w2, int c, long long stride_b,
                    long long stride_p, long long stride_n,
                    long long stride_c, int depth, int z_chunk,
                    int elem_bytes, void* stream) {
  if (b <= 0 || phases <= 0 || n <= 0 || h2 <= 0 || w2 <= 0 || c <= 0 ||
      depth <= 0 || n % depth != 0 || z_chunk <= 0 || stride_b < 0 ||
      stride_p < 0 || stride_n < 0 || stride_c < 0 ||
      static_cast<long long>(h2) * w2 * c > INT_MAX ||
      static_cast<long long>(b) * phases * n > INT_MAX ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (elem_bytes == 4 && dfmap != acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Walk w{stride_b, stride_p, stride_n, stride_c, n, phases, depth,
               n / depth, 0, z_chunk, (depth + z_chunk - 1) / z_chunk, h2,
               w2, c};
  const auto s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(b) * h2 * w2 * c;
  cudaError_t err = cudaMemsetAsync(acc, 0, cells * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = elem_bytes == 4
            ? scatter<float>(dout, px, py, acc, b, w, s)
            : scatter<__nv_bfloat16>(dout, px, py, acc, b, w, s);
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
