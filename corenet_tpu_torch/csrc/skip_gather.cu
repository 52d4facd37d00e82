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
// times the voxel's. Walked phase by phase, like a fine skip at half the
// resolution, a run of equal pixels along z would step two fine voxels
// at a time: runs of 2.3 voxels instead of 4.2, 1.8x the flushes.
//
// Packed design: a thread takes a column (Y, X) of one lane (py, px) and
// walks it through both z phases, phase pz * 4 + lane holding fine depth
// 2Z + pz: the fine column (2Y + py, 2X + px) in fine z order, reading
// the two phases' rows at their stride apart. That gives back the fine
// order's runs, flushes and thread count for the same voxels, and the
// gradient is still read in place. ops/skip_gather.py::backward_walk and
// walk_voxels give the same walk thread by thread; walk_flushes counts its
// runs and flushes.
//
// What bounds it at the 64^3 skip, in both orders (chip_smoke.py's phase
// 12 and tools/skip_backward_sweep.py measure it; PERF.md): the runs are
// short (4.2 voxels on average: perspective moves a column's pixel every few
// steps in z), so it still issues 0.85 M vector atomics, 3.7x fewer than one
// per voxel. In trial kernels on the H100 that are not kept, plain stores in
// place of the atomics took nearly as long, and reading the indices again for
// every channel group cost time: the reads set the pace. Built without its
// atomics the launch still takes most of its time. Summing a block's runs in
// a shared-memory tile first was slower (float atomics on shared memory are
// compare-and-swap loops on sm_90), and keeping four voxels in flight per
// thread was no faster. Hence up to 12 channels per thread (each voxel's
// pixel read once), two voxels in flight per thread (more costs registers and
// so warps), and a chunk of a quarter of the fine column, chosen by the
// wrapper (tools/skip_backward_sweep.py times the other chunks, both walks in
// packed order and the build without atomics).
//
// The accumulator is [B, H2, W2, C] f32 (the output itself for f32 dout),
// zeroed on the stream first. bf16 dout accumulates in it and is rounded to
// bf16 (nearest even) once, in a last pass, as the TPU kernel accumulated in
// f32 and cast at the end. The three launches are chained with Hopper's
// programmatic dependent launch: the scatter's first loads overlap the
// zeroing, and each launch's start overlaps the end of the one before. With
// the rounding pass taking four elements a thread, that made the small skips'
// bf16 launches faster in a trial on the H100 (they sit on the launch floor)
// and left the 64^3 skip's as it was. The order of the atomic adds varies
// from run to run, so the result is deterministic only up to f32 summation
// order: |err| <= ~1e-5 * sum |dout| per cell.
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

#include <algorithm>
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

// How a launch walks dout [B, P, N, C] (element strides sb, sp, sn, sc).
// Per scene, P phases of N = slices * cols voxels each in (slice, column)
// order, all scattering into the scene's map. The phases are ZP z phases
// of `lanes` phases each: phase pz * lanes + lane holds slice Z of its
// columns at fine depth ZP * Z + pz, and one thread walks a column of one
// lane through all ZP z phases, `depth` = ZP * slices voxels in fine
// depth order. `sets` sets of NG groups of V channels; chunks of z_chunk
// voxels along the fine depth.
struct Walk {
  long long sb, sp, sn, sc;
  int n, phases, lanes, depth, cols, sets, z_chunk, chunks, h2, w2, c;
};

// Voxels loaded into registers before any is summed. More keeps more
// loads in flight per thread but costs registers, and so warps per SM,
// which was slower in trials on the H100.
constexpr int kUnroll = 2;

// Programmatic dependent launch (Hopper): the zeroing, the scatter and
// the rounding are launched so that each may start while the one before
// it still runs. start_dependents lets the next launch begin;
// wait_for_prerequisite waits until the launch before has finished and
// its writes are visible (at once in a launch without that dependency).
__device__ __forceinline__ void start_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Adds the sums into the pixel's NG * V channels at dst: one vector atomic
// per V channels (sm_90's float2/float4 atomicAdd on global memory).
// Built with SKIP_GATHER_BWD_NO_ATOMICS, it stores only where the sums
// add up to one NaN bit pattern, which finite gradients never do, so that
// the walk still loads and adds every voxel: a build that gives wrong
// results, for timing the walk without its atomics
// (tools/skip_backward_sweep.py).
template <int V, int NG>
__device__ __forceinline__ void flush(float* dst, const float (&sum)[NG * V]) {
#ifdef SKIP_GATHER_BWD_NO_ATOMICS
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < NG * V; ++j) total += sum[j];
  if (__float_as_uint(total) == 0x7fffffffu) *dst = total;
#else
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
#endif
}

template <typename T, int V, int NG, int ZP>
__global__ void __launch_bounds__(kThreads)
    scatter_add_columns(const T* __restrict__ dout, const int* __restrict__ px,
                        const int* __restrict__ py, float* __restrict__ acc,
                        int total, Walk w) {
  constexpr int kChannels = NG * V;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // i = (((b * lanes + lane) * chunks + chunk) * sets + set) * cols + column.
  const int column = i % w.cols;
  int rest = i / w.cols;
  const int set = rest % w.sets;
  rest /= w.sets;
  const int chunk = rest % w.chunks;
  const int bl = rest / w.chunks;  // scene * lanes + lane
  const int b = bl / w.lanes;
  const int lane = bl - b * w.lanes;
  const int z_begin = chunk * w.z_chunk;
  const int steps = min(w.z_chunk, w.depth - z_begin);
  const T* src = dout + b * w.sb + lane * w.sp + column * w.sn +
                 set * kChannels * w.sc;
  // The indices are [B, P * N]: phase p's voxels follow phase p - 1's.
  const long long scene =
      static_cast<long long>(b * w.phases + lane) * w.n + column;
  const int* ix = px + scene;
  const int* iy = py + scene;
  float* dst = acc + static_cast<long long>(b) * w.h2 * w.w2 * w.c +
               set * kChannels;
  // Fine step t of the column is slice t / ZP of z phase t % ZP, which is
  // phase (t % ZP) * lanes + lane.
  const long long slice_src = static_cast<long long>(w.cols) * w.sn;
  const long long phase_src = static_cast<long long>(w.lanes) * w.sp;
  const long long phase_idx = static_cast<long long>(w.lanes) * w.n;

  start_dependents();
  float sum[kChannels];
#pragma unroll
  for (int j = 0; j < kChannels; ++j) sum[j] = 0.0f;
  int current = -1;  // the pixel (y * W2 + x) the sums belong to
  // The first loads overlap the zeroing; the first flush waits for it.
  bool zeroed = false;
  for (int s = 0; s < steps; s += kUnroll) {
    int pixel[kUnroll];
    float v[kUnroll][kChannels];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      pixel[k] = -1;
      if (s + k < steps) {
        const int t = z_begin + s + k;
        const int pz = t % ZP;
        const int z = t / ZP;
        const long long at =
            pz * phase_idx + static_cast<long long>(z) * w.cols;
        const int x = min(max(__ldg(ix + at), 0), w.w2 - 1);
        const int y = min(max(__ldg(iy + at), 0), w.h2 - 1);
        pixel[k] = y * w.w2 + x;
        const T* p = src + pz * phase_src + z * slice_src;
#pragma unroll
        for (int j = 0; j < kChannels; ++j) v[k][j] = to_float(p[j * w.sc]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (pixel[k] < 0) continue;
      if (pixel[k] != current) {
        if (current >= 0) {
          if (!zeroed) {
            wait_for_prerequisite();
            zeroed = true;
          }
          flush<V, NG>(dst + current * w.c, sum);
        }
        current = pixel[k];
#pragma unroll
        for (int j = 0; j < kChannels; ++j) sum[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kChannels; ++j) sum[j] += v[k][j];
    }
  }
  if (current >= 0) {
    if (!zeroed) wait_for_prerequisite();
    flush<V, NG>(dst + current * w.c, sum);
  }
}

__global__ void __launch_bounds__(kThreads)
    zero_floats(float* __restrict__ dst, long long count) {
  start_dependents();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < count; i += stride) {
    dst[i] = 0.0f;
  }
}

// Four elements per thread, as one float4 load and two bf16x2 stores
// where `vector` says both pointers allow it.
__global__ void __launch_bounds__(kThreads)
    round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                  long long count, bool vector) {
  wait_for_prerequisite();
  const long long i =
      4 * (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x);
  if (vector && i + 4 <= count) {
    const float4 v = *reinterpret_cast<const float4*>(src + i);
    auto* out = reinterpret_cast<__nv_bfloat162*>(dst + i);
    out[0] = __floats2bfloat162_rn(v.x, v.y);
    out[1] = __floats2bfloat162_rn(v.z, v.w);
    return;
  }
  for (long long j = i; j < min(i + 4, count); ++j) {
    dst[j] = __float2bfloat16_rn(src[j]);
  }
}

// Launches kernel<<<blocks, kThreads>>>(args...) on the stream with a
// programmatic dependency on the stream's launch before it.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), long long blocks,
                             cudaStream_t stream, Args... args) {
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<Params>(args)...);
}

template <typename T, int V, int NG>
cudaError_t launch_scatter(const void* dout, const int* px, const int* py,
                           float* acc, int b, int z_phases, Walk w,
                           cudaStream_t stream) {
  w.sets = w.c / (NG * V);
  const long long total =
      static_cast<long long>(b) * w.lanes * w.chunks * w.sets * w.cols;
  if (total > INT_MAX) return cudaErrorInvalidValue;
  const int t = static_cast<int>(total);
  const int blocks = (t + kThreads - 1) / kThreads;
  const T* d = static_cast<const T*>(dout);
  return z_phases == 2
             ? launch_dependent(scatter_add_columns<T, V, NG, 2>, blocks,
                                stream, d, px, py, acc, t, w)
             : launch_dependent(scatter_add_columns<T, V, NG, 1>, blocks,
                                stream, d, px, py, acc, t, w);
}

// V channels per vector atomic: the widest of 4, 2, 1 that divides C. A
// thread takes 3 groups of 4 channels where C allows, so that it reads
// each voxel's pixel once for 12 channels (the h7 skips have 12 to 96).
template <typename T>
cudaError_t scatter(const void* dout, const int* px, const int* py,
                    float* acc, int b, int z_phases, const Walk& w,
                    cudaStream_t stream) {
  if (w.c % 12 == 0 && aligned(acc, 4 * sizeof(float))) {
    return launch_scatter<T, 4, 3>(dout, px, py, acc, b, z_phases, w, stream);
  }
  if (w.c % 4 == 0 && aligned(acc, 4 * sizeof(float))) {
    return launch_scatter<T, 4, 1>(dout, px, py, acc, b, z_phases, w, stream);
  }
  if (w.c % 2 == 0 && aligned(acc, 2 * sizeof(float))) {
    return launch_scatter<T, 2, 1>(dout, px, py, acc, b, z_phases, w, stream);
  }
  return launch_scatter<T, 1, 1>(dout, px, py, acc, b, z_phases, w, stream);
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
// columns, (slice, column) order. The phases are z_phases (1 or 2) z
// phases of q = phases / z_phases each: phase pz * q + lane holds slice Z
// of its columns at fine depth z_phases * Z + pz. A thread walks z_chunk
// voxels of a column of one lane in fine depth order, through its z
// phases. The fine decoder's skips have one phase; the packed decoder's 8,
// (pz, py, px), grids of D/2 x H/2 x W/2 voxels (models/skip.py), walked
// with z_phases 2: a thread walks a fine column.
// Returns a cudaError_t as int: 0 when every launch succeeded.
int skip_gather_bwd(const void* dout, const int* px, const int* py,
                    float* acc, void* dfmap, int b, int phases, int n,
                    int h2, int w2, int c, long long stride_b,
                    long long stride_p, long long stride_n,
                    long long stride_c, int depth, int z_phases, int z_chunk,
                    int elem_bytes, void* stream) {
  if (b <= 0 || phases <= 0 || n <= 0 || h2 <= 0 || w2 <= 0 || c <= 0 ||
      depth <= 0 || n % depth != 0 || z_chunk <= 0 ||
      (z_phases != 1 && z_phases != 2) || phases % z_phases != 0 ||
      stride_b < 0 || stride_p < 0 || stride_n < 0 || stride_c < 0 ||
      static_cast<long long>(h2) * w2 * c > INT_MAX ||
      static_cast<long long>(b) * phases * n > INT_MAX ||
      (elem_bytes != 4 && elem_bytes != 2) ||
      (elem_bytes == 4 && dfmap != acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int walk_depth = depth * z_phases;
  const Walk w{stride_b, stride_p, stride_n, stride_c, n, phases,
               phases / z_phases, walk_depth, n / depth, 0, z_chunk,
               (walk_depth + z_chunk - 1) / z_chunk, h2, w2, c};
  const auto s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(b) * h2 * w2 * c;
  // A grid-stride loop over at most 1024 blocks.
  const long long zero_blocks =
      std::min((cells + kThreads - 1) / kThreads, 1024LL);
  zero_floats<<<static_cast<int>(zero_blocks), kThreads, 0, s>>>(acc, cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = elem_bytes == 4
            ? scatter<float>(dout, px, py, acc, b, z_phases, w, s)
            : scatter<__nv_bfloat16>(dout, px, py, acc, b, z_phases, w, s);
  if (err != cudaSuccess || elem_bytes == 4) return static_cast<int>(err);
  const long long quads = (cells + 3) / 4;
  return static_cast<int>(launch_dependent(
      round_to_bf16, (quads + kThreads - 1) / kThreads, s,
      static_cast<const float*>(acc), static_cast<__nv_bfloat16*>(dfmap),
      cells, aligned(acc, 16) && aligned(dfmap, 8)));
}

const char* skip_gather_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
