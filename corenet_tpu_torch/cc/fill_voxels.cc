// Interior flood fill — native host implementation.
//
// The port's own copy of corenet_tpu/cc/fill_voxels.cc, with the same
// code, entry points and semantics, built by corenet_tpu_torch/cc/native.py.
// Semantics identical to corenet_tpu_torch/voxel/fill.py: empty regions
// (<= 0) not connected to the grid boundary are filled; output is binary
// — 1 for occupied-or-enclosed, 0 for boundary-connected empty.
//
// Design: a breadth-first flood from boundary empty cells (an explicit
// frontier queue), O(voxels), no union-find. Batch elements fan out over
// a thread pool. Serves as the host-side GT path of the data loader
// (data/batching.py::host_voxelize) and as an oracle for the tensor fill.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename T>
void FillOne(T* grid, int64_t d, int64_t h, int64_t w) {
  const int64_t size = d * h * w;
  std::vector<uint8_t> outside(size, 0);
  std::vector<int64_t> frontier;
  frontier.reserve(static_cast<size_t>(d * h + h * w + d * w) * 2);

  auto idx = [h, w](int64_t z, int64_t y, int64_t x) {
    return (z * h + y) * w + x;
  };
  auto try_push = [&](int64_t i) {
    if (!outside[i] && !(grid[i] > T(0))) {
      outside[i] = 1;
      frontier.push_back(i);
    }
  };

  for (int64_t z = 0; z < d; ++z)
    for (int64_t y = 0; y < h; ++y)
      for (int64_t x = 0; x < w; ++x)
        if (z == 0 || z == d - 1 || y == 0 || y == h - 1 || x == 0 ||
            x == w - 1)
          try_push(idx(z, y, x));

  while (!frontier.empty()) {
    int64_t i = frontier.back();
    frontier.pop_back();
    int64_t x = i % w;
    int64_t y = (i / w) % h;
    int64_t z = i / (w * h);
    if (x > 0) try_push(i - 1);
    if (x < w - 1) try_push(i + 1);
    if (y > 0) try_push(i - w);
    if (y < h - 1) try_push(i + w);
    if (z > 0) try_push(i - w * h);
    if (z < d - 1) try_push(i + w * h);
  }

  for (int64_t i = 0; i < size; ++i) grid[i] = outside[i] ? T(0) : T(1);
}

template <typename T>
void FillBatch(T* grid, int64_t n, int64_t d, int64_t h, int64_t w) {
  const int64_t per = d * h * w;
  unsigned workers = std::thread::hardware_concurrency();
  if (workers == 0) workers = 4;
  if (static_cast<int64_t>(workers) > n) workers = static_cast<unsigned>(n);
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  for (unsigned t = 0; t < workers; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= n) return;
        FillOne(grid + i * per, d, h, w);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

void corenet_fill_inside_voxels_f32(float* grid, int64_t n, int64_t d,
                                    int64_t h, int64_t w) {
  FillBatch(grid, n, d, h, w);
}

void corenet_fill_inside_voxels_u8(uint8_t* grid, int64_t n, int64_t d,
                                   int64_t h, int64_t w) {
  FillBatch(grid, n, d, h, w);
}

void corenet_fill_inside_voxels_i32(int32_t* grid, int64_t n, int64_t d,
                                    int64_t h, int64_t w) {
  FillBatch(grid, n, d, h, w);
}

}  // extern "C"
