// Native host-side preprocessing for coarse3d_tpu_torch (the port's copy of
// the JAX package's native/preprocess.cpp; only comments differ).
//
// Behavioral models:
//   - spherical range projection with nearest-point-wins scatter
//     (the reference's pc_processor/dataset/preprocess/projection.py:43-115);
//     the reference sorts by depth descending so the smallest depth lands
//     last — here a single O(N) pass keeps the minimum per pixel with
//     lowest-point-index tie-break (same convention as the device path).
//   - voxel-grid point->voxel assignment (open3d VoxelGrid coordinates:
//     floor((p - min_bound) / voxel_size)), replacing the per-point Python
//     loop at gen_sem_weak_label_rand_grid.py:192-194.
//
// Pure C ABI for ctypes; no Python.h dependency. All buffers are allocated
// by the caller (NumPy). Thread-safe (no globals).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Project an (n, stride) float32 cloud (xyz in the first 3 channels) to an
// (h, w) range image. Outputs:
//   proj_feat  (h*w*stride) -1-filled, winning point's channels per pixel
//   proj_range (h*w)        -1-filled
//   proj_idx   (h*w) int32  -1-filled, winning point index
//   px, py     (n) int32    per-point pixel coords
//   depth      (n) float32  per-point range
// depth_override: optional (n) float32 used for ordering only (the weak-label
// fallback re-projection trick, wss_sem_kitti_loader.py:134-147); pass null
// to order by true depth.
void c3d_range_project(
    const float* points, int64_t n, int32_t stride,
    int32_t h, int32_t w,
    float fov_up_deg, float fov_down_deg,
    float fov_left_deg, float fov_right_deg,
    float max_depth,
    const float* depth_override,
    float* proj_feat, float* proj_range, int32_t* proj_idx,
    int32_t* px, int32_t* py, float* depth_out) {
  const double kPi = 3.14159265358979323846;
  const double fov_down = fov_down_deg / 180.0 * kPi;
  const double fov_vert = std::fabs(fov_up_deg / 180.0 * kPi) +
                          std::fabs(fov_down);
  const double fov_left = fov_left_deg / 180.0 * kPi;
  const double fov_hori = std::fabs(fov_left) +
                          std::fabs(fov_right_deg / 180.0 * kPi);

  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int64_t p = 0; p < hw; ++p) {
    proj_range[p] = -1.0f;
    proj_idx[p] = -1;
  }
  for (int64_t p = 0; p < hw * stride; ++p) proj_feat[p] = -1.0f;

  // pass 1: coordinates + depth (no cross-iteration deps -> vectorizable)
  for (int64_t i = 0; i < n; ++i) {
    const float* pt = points + i * stride;
    const double x = pt[0], y = pt[1], z = pt[2];
    double d = std::sqrt(x * x + y * y + z * z);
    if (max_depth > 0 && d > max_depth) d = max_depth;
    depth_out[i] = static_cast<float>(d);

    const double yaw = -std::atan2(y, x);
    double sin_pitch = d > 1e-12 ? z / d : 0.0;
    if (sin_pitch > 1.0) sin_pitch = 1.0;
    if (sin_pitch < -1.0) sin_pitch = -1.0;
    const double pitch = std::asin(sin_pitch);

    double fx = (yaw + std::fabs(fov_left)) / fov_hori * w;
    double fy = (1.0 - (pitch + std::fabs(fov_down)) / fov_vert) * h;
    int32_t ix = static_cast<int32_t>(std::floor(fx));
    int32_t iy = static_cast<int32_t>(std::floor(fy));
    if (ix < 0) ix = 0;
    if (ix > w - 1) ix = w - 1;
    if (iy < 0) iy = 0;
    if (iy > h - 1) iy = h - 1;
    px[i] = ix;
    py[i] = iy;
  }

  // pass 2: nearest-wins scatter (exact ties -> lowest point index)
  for (int64_t i = 0; i < n; ++i) {
    const float order_d = depth_override ? depth_override[i] : depth_out[i];
    const int64_t pix = static_cast<int64_t>(py[i]) * w + px[i];
    const int32_t cur_idx = proj_idx[pix];
    const float cur_order =
        cur_idx < 0
            ? 3.0e38f
            : (depth_override ? depth_override[cur_idx] : proj_range[pix]);
    if (cur_idx < 0 || order_d < cur_order) {
      proj_range[pix] = depth_out[i];
      proj_idx[pix] = static_cast<int32_t>(i);
    }
  }

  // pass 3: winner channel gather (contiguous writes per pixel)
  for (int64_t p = 0; p < hw; ++p) {
    const int32_t idx = proj_idx[p];
    if (idx >= 0) {
      std::memcpy(proj_feat + p * stride, points + idx * stride,
                  sizeof(float) * stride);
    }
  }
}

// Scatter per-point labels through a projection index map: empty pixels -> 0.
void c3d_scatter_labels(const int32_t* proj_idx, int64_t hw,
                        const int32_t* labels, int32_t* out) {
  for (int64_t p = 0; p < hw; ++p) {
    out[p] = proj_idx[p] >= 0 ? labels[proj_idx[p]] : 0;
  }
}

// Voxel-grid assignment. Returns the number of voxels; fills point2voxel (n)
// with dense voxel ids (in order of first appearance) and first_point
// (capacity n, first n_voxels valid) with each voxel's first point index.
int64_t c3d_voxelize(const float* points, int64_t n, int32_t stride,
                     float voxel_size,
                     int32_t* point2voxel, int32_t* first_point) {
  if (n == 0) return 0;
  float minb[3] = {points[0], points[1], points[2]};
  for (int64_t i = 1; i < n; ++i) {
    const float* pt = points + i * stride;
    for (int k = 0; k < 3; ++k)
      if (pt[k] < minb[k]) minb[k] = pt[k];
  }
  std::unordered_map<uint64_t, int32_t> voxel_ids;
  voxel_ids.reserve(static_cast<size_t>(n));
  int32_t next_id = 0;
  // float32 subtract + float32 divide, exactly like the NumPy path
  // (np.floor((xyz - xyz.min(0)) / voxel_size) on float32 input) — the
  // two implementations must produce byte-identical voxel assignments so
  // fixed-seed weak-label generation is environment-independent.
  const float vsf = static_cast<float>(voxel_size);
  for (int64_t i = 0; i < n; ++i) {
    const float* pt = points + i * stride;
    const uint64_t cx = static_cast<uint64_t>(
        static_cast<int64_t>(std::floor((pt[0] - minb[0]) / vsf)));
    const uint64_t cy = static_cast<uint64_t>(
        static_cast<int64_t>(std::floor((pt[1] - minb[1]) / vsf)));
    const uint64_t cz = static_cast<uint64_t>(
        static_cast<int64_t>(std::floor((pt[2] - minb[2]) / vsf)));
    // 21 bits per axis: fine for (2^21 * 0.06m) ~ 125 km extents
    const uint64_t key = (cx & 0x1FFFFF) | ((cy & 0x1FFFFF) << 21) |
                         ((cz & 0x1FFFFF) << 42);
    auto it = voxel_ids.find(key);
    if (it == voxel_ids.end()) {
      voxel_ids.emplace(key, next_id);
      first_point[next_id] = static_cast<int32_t>(i);
      point2voxel[i] = next_id;
      ++next_id;
    } else {
      point2voxel[i] = it->second;
    }
  }
  return next_id;
}

}  // extern "C"
