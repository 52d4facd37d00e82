// Native host triangle voxelizer.
//
// The port's own copy of corenet_tpu/cc/voxelize.cc, with the same code,
// entry point and semantics, built by corenet_tpu_torch/cc/native.py.
// Same sampling semantics as corenet_tpu_torch/voxel/voxelize.py:
// dominant-normal-axis orthographic projection, pixel-center samples on an
// R×R target (R = round(max(w, h, d·pdm)·irm)), barycentric position
// interpolation, optional exact-SAT conservative coverage, optional 2R+1
// sub-grid accumulation. Triangles arrive already transformed to voxel
// space.
//
// This is the host-side GT path (it runs in the data loader's producer
// thread, overlapping device compute) and an oracle for the tensor
// voxelizer. Meshes fan out over a thread pool; within a mesh, triangles
// rasterize serially into a private grid (no atomics needed: writes are
// the constant 1).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Params {
  int64_t d, h, w;
  int image_res;
  double pdm;             // projection depth multiplier
  bool conservative;
  int sub_grid;           // <=0: off; otherwise the (odd) multiplier
};

inline int DominantAxis(const float n[3]) {
  float ax = std::fabs(n[0]), ay = std::fabs(n[1]), az = std::fabs(n[2]);
  if (ax > ay && ax > az) return 0;
  if (ay > ax && ay > az) return 1;
  return 2;
}

// Plane (u, v) coordinate axes per dominant axis — matches the GLSL
// swizzles (voxelize.geom:52-55).
constexpr int kPlaneU[3] = {1, 2, 0};
constexpr int kPlaneV[3] = {2, 0, 1};

void RasterizeTriangle(const float* v /*3x3 xyz*/, float* grid,
                       const Params& p) {
  float e1[3], e2[3], n[3];
  for (int i = 0; i < 3; ++i) {
    e1[i] = v[3 + i] - v[i];
    e2[i] = v[6 + i] - v[i];
  }
  n[0] = e1[1] * e2[2] - e1[2] * e2[1];
  n[1] = e1[2] * e2[0] - e1[0] * e2[2];
  n[2] = e1[0] * e2[1] - e1[1] * e2[0];
  const int k = DominantAxis(n);
  const int ua = kPlaneU[k], va = kPlaneV[k];

  const double full[3] = {static_cast<double>(p.w),
                          static_cast<double>(p.h),
                          static_cast<double>(p.d) * p.pdm};
  const double su = full[ua] / p.image_res;
  const double sv = full[va] / p.image_res;

  const double u0 = v[ua], u1 = v[3 + ua], u2 = v[6 + ua];
  const double v0 = v[va], v1 = v[3 + va], v2 = v[6 + va];
  const double area2 = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0);
  if (area2 == 0.0) return;
  const double sgn = area2 > 0 ? 1.0 : -1.0;

  const double umin = std::min({u0, u1, u2}), umax = std::max({u0, u1, u2});
  const double vmin = std::min({v0, v1, v2}), vmax = std::max({v0, v1, v2});
  int iu0 = std::max<int>(0, static_cast<int>(std::floor(umin / su)) - 1);
  int iu1 = std::min<int>(p.image_res - 1,
                          static_cast<int>(std::ceil(umax / su)) + 1);
  int iv0 = std::max<int>(0, static_cast<int>(std::floor(vmin / sv)) - 1);
  int iv1 = std::min<int>(p.image_res - 1,
                          static_cast<int>(std::ceil(vmax / sv)) + 1);

  const int64_t gd = p.sub_grid > 0 ? 2 * p.d + 1 : p.d;
  const int64_t gh = p.sub_grid > 0 ? 2 * p.h + 1 : p.h;
  const int64_t gw = p.sub_grid > 0 ? 2 * p.w + 1 : p.w;

  for (int iu = iu0; iu <= iu1; ++iu) {
    const double pu = (iu + 0.5) * su;
    for (int iv = iv0; iv <= iv1; ++iv) {
      const double pv = (iv + 0.5) * sv;
      // Edge functions (opposite-vertex order).
      const double w0 = (u2 - u1) * (pv - v1) - (v2 - v1) * (pu - u1);
      const double w1 = (u0 - u2) * (pv - v2) - (v0 - v2) * (pu - u2);
      const double w2 = (u1 - u0) * (pv - v0) - (v1 - v0) * (pu - u0);
      bool covered;
      if (p.conservative) {
        const double hu = su * 0.5, hv = sv * 0.5;
        auto edge_ok = [&](double wv, double au, double av, double bu,
                           double bv) {
          const double slack =
              std::fabs(-(bv - av)) * hu + std::fabs(bu - au) * hv;
          return sgn * wv + slack >= 0;
        };
        covered = edge_ok(w0, u1, v1, u2, v2) && edge_ok(w1, u2, v2, u0, v0)
                  && edge_ok(w2, u0, v0, u1, v1);
        covered = covered && (pu + hu >= umin) && (pu - hu <= umax) &&
                  (pv + hv >= vmin) && (pv - hv <= vmax);
      } else {
        // Area-relative epsilon closes f32 cracks on shared edges (keeps
        // interior flood fills watertight on subdivided meshes); matches
        // the XLA voxelizer's rule.
        const double eps = 1e-4 * std::fabs(area2);
        covered = (w0 >= -eps && w1 >= -eps && w2 >= -eps) ||
                  (w0 <= eps && w1 <= eps && w2 <= eps);
      }
      if (!covered) continue;

      const double b0 = w0 / area2, b1 = w1 / area2, b2 = w2 / area2;
      double pos[3];
      for (int c = 0; c < 3; ++c)
        pos[c] = b0 * v[c] + b1 * v[3 + c] + b2 * v[6 + c];
      if (pos[0] < 0 || pos[1] < 0 || pos[2] < 0 || pos[0] >= p.w ||
          pos[1] >= p.h || pos[2] >= p.d)
        continue;

      int64_t cx, cy, cz;
      if (p.sub_grid > 0) {
        const int s = p.sub_grid;
        auto cell = [s](double x) {
          int64_t vi = static_cast<int64_t>(std::floor(x * s)) + s / 2;
          int64_t ci = vi / s;
          int ri = (vi % s == s - 1) ? 1 : 0;
          return 2 * ci + ri;
        };
        cx = cell(pos[0]);
        cy = cell(pos[1]);
        cz = cell(pos[2]);
      } else {
        cx = static_cast<int64_t>(std::floor(pos[0]));
        cy = static_cast<int64_t>(std::floor(pos[1]));
        cz = static_cast<int64_t>(std::floor(pos[2]));
      }
      if (cx < 0 || cy < 0 || cz < 0 || cx >= gw || cy >= gh || cz >= gd)
        continue;
      grid[(cz * gh + cy) * gw + cx] = 1.0f;
    }
  }
}

}  // namespace

extern "C" {

// triangles: float32[total_tri * 9], voxel-space vertices.
// tri_mesh_index: int32[total_tri], ascending mesh ids in [0, num_meshes).
// out_grid: float32[num_meshes * D' * H' * W'], zero-initialized by caller.
void corenet_voxelize_triangles(const float* triangles,
                                const int32_t* tri_mesh_index,
                                int64_t total_tri, int64_t num_meshes,
                                int64_t d, int64_t h, int64_t w,
                                int image_res, double pdm, int conservative,
                                int sub_grid, float* out_grid) {
  Params p;
  p.d = d;
  p.h = h;
  p.w = w;
  p.image_res = image_res;
  p.pdm = pdm;
  p.conservative = conservative != 0;
  p.sub_grid = sub_grid;
  const int64_t per = (sub_grid > 0)
                          ? (2 * d + 1) * (2 * h + 1) * (2 * w + 1)
                          : d * h * w;

  // Per-mesh triangle ranges (indices are ascending).
  std::vector<int64_t> start(num_meshes + 1, 0);
  for (int64_t i = 0; i < total_tri; ++i) start[tri_mesh_index[i] + 1]++;
  for (int64_t m = 0; m < num_meshes; ++m) start[m + 1] += start[m];

  unsigned workers = std::thread::hardware_concurrency();
  if (workers == 0) workers = 4;
  if (static_cast<int64_t>(workers) > num_meshes)
    workers = static_cast<unsigned>(num_meshes);
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < workers; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t m = next.fetch_add(1);
        if (m >= num_meshes) return;
        float* grid = out_grid + m * per;
        for (int64_t i = start[m]; i < start[m + 1]; ++i)
          RasterizeTriangle(triangles + i * 9, grid, p);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
