// Projection scatter-min (kernel K1 of the port), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel ops/pallas/proj_scatter.py:_kernel of the JAX
// package (driven by _scatter_min_pallas, wrapped by
// range_project_batch_pallas). It computes, for every image b and pixel q,
// the lexicographic minimum of (depth, point index) over the points i with
// flat[b, i] == q: the minimum depth (3e38 where no point lands) and the
// winning point index (P where no point lands). Points with flat outside
// [0, hw) are dropped (padding).
//
// Design. A non-negative float orders like its uint32 bit pattern, so the
// 64-bit key (float_as_uint(depth) << 32) | i orders exactly like
// (depth, i), and one 64-bit atomicMin per point (a reduction at the L2,
// where the 16.8 MB of KITTI-size keys stay resident) replaces the TPU
// kernel's per-pixel accumulator pair. Two launches after the key memset:
//
//   scatter_keys  grid (ceil(P / 256), B): the image is blockIdx.y, so no
//                 thread divides. One point a thread: two coalesced 4-byte
//                 loads and one atomic. The pass is held by the L2's rate of
//                 64-bit atomics (about 75 G/s on scattered pixels), so four
//                 points a thread by 16-byte loads measured 2 us slower, not
//                 faster, and a read of the key before the atomic did not
//                 pay either (PERF.md has the numbers).
//   emit_pixels   grid (ceil(hw / 256), B): a thread reads its pixel's key
//                 once and writes everything the caller asked for from it:
//                 (min_depth, winner), the scatter-min's own outputs, and/or
//                 what the projection returns for that pixel: proj_idx and
//                 proj_range (-1 fill), proj_mask (either convention), and
//                 the winner's row of `points` into proj_points (-1 fill;
//                 one 16-byte load and store when C == 4). Integer decode
//                 and copies only, so it equals the plain version exactly.
//
// Bound on an H100 (3.35 TB/s): bytes. At KITTI size (B=16, P=150000,
// hw=131072, C=4) the scatter-min reads 19.2 MB of point stream and writes
// 16.8 MB of images; the fused projection reads 19.2 MB + the 38.4 MB of
// points and writes 58.7 MB of images. The keys are scratch; the winner
// rows are 2.1 M scattered 16-byte reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_keys(const int32_t* __restrict__ flat, const float* __restrict__ depth,
             unsigned long long* __restrict__ keys, int p, int hw) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= p) return;
  const int64_t at = static_cast<int64_t>(blockIdx.y) * p + i;
  const int32_t pix = flat[at];
  const float d = depth[at];
  // one unsigned compare drops pix < 0 and pix >= hw
  if (static_cast<unsigned>(pix) >= static_cast<unsigned>(hw)) return;
  const unsigned long long key =
      (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
      static_cast<unsigned long long>(static_cast<unsigned>(i));
  atomicMin(keys + static_cast<int64_t>(blockIdx.y) * hw + pix, key);
}

template <bool kC4>
__global__ void __launch_bounds__(kThreads)
emit_pixels(const unsigned long long* __restrict__ keys,
            const float* __restrict__ points, int p, int c, int hw,
            float* __restrict__ min_depth, int32_t* __restrict__ winner,
            int32_t* __restrict__ proj_idx, float* __restrict__ proj_range,
            int32_t* __restrict__ proj_mask, float* __restrict__ proj_points,
            int excludes_point0) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= hw) return;
  const int64_t i = static_cast<int64_t>(blockIdx.y) * hw + q;
  const unsigned long long key = keys[i];
  const bool hit = key != kEmpty;
  const int32_t win = static_cast<int32_t>(key & 0xffffffffull);
  const float d = __uint_as_float(static_cast<unsigned int>(key >> 32));
  if (min_depth != nullptr) {
    min_depth[i] = hit ? d : kBig;
    winner[i] = hit ? win : p;
  }
  if (proj_idx == nullptr) return;
  const int32_t idx = hit ? win : -1;
  proj_idx[i] = idx;
  proj_range[i] = hit ? d : -1.0f;
  proj_mask[i] = excludes_point0 ? (idx > 0) : (idx >= 0);
  const int64_t src = static_cast<int64_t>(blockIdx.y) * p + win;
  if (kC4) {
    float4 v = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
    if (hit) v = reinterpret_cast<const float4*>(points)[src];
    reinterpret_cast<float4*>(proj_points)[i] = v;
  } else {
    for (int k = 0; k < c; ++k)
      proj_points[i * c + k] = hit ? points[src * c + k] : -1.0f;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

// flat (B, P) int32, depth (B, P) float32, points (B, P, C) float32 or null
// -> keys (B * hw) uint64 scratch, and whichever outputs are not null:
// min_depth (B, hw) float32 + winner (B, hw) int32 (both or neither);
// proj_idx (B, hw) int32 + proj_range (B, hw) float32 + proj_mask (B, hw)
// int32 + proj_points (B, hw, C) float32 (all four or none; they need
// points). All device pointers, contiguous; launched on `stream`. Returns the
// CUDA error code (0 = ok).
extern "C" int c3d_proj_scatter(const void* flat, const void* depth,
                                const void* points, void* keys,
                                void* min_depth, void* winner, void* proj_idx,
                                void* proj_range, void* proj_mask,
                                void* proj_points, int64_t b, int64_t p,
                                int64_t c, int64_t hw, int excludes_point0,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || hw == 0) return 0;
  cudaError_t err =
      cudaMemsetAsync(keys, 0xff, b * hw * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pi = static_cast<int>(p), hwi = static_cast<int>(hw);
  if (p > 0) {
    const dim3 grid(static_cast<unsigned>((p + kThreads - 1) / kThreads),
                    static_cast<unsigned>(b));
    scatter_keys<<<grid, kThreads, 0, s>>>(
        static_cast<const int32_t*>(flat), static_cast<const float*>(depth),
        static_cast<unsigned long long*>(keys), pi, hwi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  const bool c4 = c == 4 && aligned16(points) && aligned16(proj_points);
  auto emit = c4 ? emit_pixels<true> : emit_pixels<false>;
  emit<<<grid, kThreads, 0, s>>>(
      static_cast<const unsigned long long*>(keys),
      static_cast<const float*>(points), pi, static_cast<int>(c), hwi,
      static_cast<float*>(min_depth), static_cast<int32_t*>(winner),
      static_cast<int32_t*>(proj_idx), static_cast<float*>(proj_range),
      static_cast<int32_t*>(proj_mask), static_cast<float*>(proj_points),
      excludes_point0);
  return static_cast<int>(cudaGetLastError());
}
