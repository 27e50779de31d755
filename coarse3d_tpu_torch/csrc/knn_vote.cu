// KNN range vote (kernel K2 of the port), CUDA C++ for sm_90a.
// Build with --fmad=false (see below); never with -use_fast_math.
//
// Replaces the TPU kernel coarse3d_tpu/ops/pallas/knn_vote.py:_kernel
// (wrapped by knn_vote_pallas), and with it the window gather that feeds
// it (coarse3d_tpu/ops/knn.py:114-130). Per point i of image b at pixel
// (y, x), over the S x S window of the label-packed range image around it:
//   - each tap's packed float carries the neighbour's range in its high bits
//     and its argmax label (< 32) in the 5 low mantissa bits; taps outside the
//     image read 0 (range 0, label 0: the reference's zero padding);
//   - the centre tap's range is replaced by the point's own range;
//   - dist = |r - r_i| * inv_gauss[t] + 1, with the tap's label packed back
//     into the low bits (the +1 keeps a zero distance out of the denormals);
//   - k rounds take the smallest packed distance (the value carries its
//     label, so ties in value are ties in label) and knock it out;
//   - a pick with dist - 1 > cutoff votes for the invalid class C;
//   - the label is 1 + argmax of the votes for classes 1..C-1, ties to the
//     lowest class.
//
// Design. One thread per point. The TPU kernel takes windows gathered
// beforehand, a (B, P, S*S) tensor that is 240 MB at KITTI size (B=16,
// P=150000, S=5); here each thread fetches its own window from the packed
// (B, H, W) image (8.4 MB, resident in the 50 MB L2) and keeps the window,
// the k extractions and the per-class counters in registers: every index
// into them is a compile-time constant after unrolling. The arithmetic
// repeats the plain PyTorch twin's (ops/knn_vote.py) operation for
// operation, and --fmad=false keeps |dr| * g + 1 as two roundings, so the
// two agree exactly.
//
// Bound on an H100 (3.35 TB/s): bytes. It reads 28.8 MB of per-point input
// (range, px, py) and 8.4 MB of image, and writes 9.6 MB of labels.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClasses = 32;  // labels live in 5 mantissa bits
constexpr unsigned int kLabelMask = 31u;
constexpr float kKnockedOut = 3.0e38f;

struct InvGauss {
  float v[49];  // up to 7 x 7
};

template <int S>
__global__ void knn_vote_kernel(const unsigned int* __restrict__ packed,
                                const float* __restrict__ point_range,
                                const int32_t* __restrict__ px,
                                const int32_t* __restrict__ py,
                                const InvGauss gauss,
                                int32_t* __restrict__ out, int64_t n_points,
                                int64_t p, int32_t h, int32_t w,
                                int32_t n_classes, int32_t knn, float cutoff) {
  constexpr int S2 = S * S;
  constexpr int kPad = S / 2;
  constexpr int kCenter = S2 / 2;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n_points) return;

  // flat pixel row, clipped like the JAX take(mode="clip")
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t n_pixels = (n_points / p) * hw;
  int64_t flat = (i / p) * hw + static_cast<int64_t>(py[i]) * w + px[i];
  flat = flat < 0 ? 0 : (flat >= n_pixels ? n_pixels - 1 : flat);
  const int64_t img = flat / hw;
  const int rem = static_cast<int>(flat - img * hw);
  const int y = rem / w;
  const int x = rem - y * w;
  const unsigned int* image = packed + img * hw;
  const float r0 = point_range[i];

  float work[S2];
#pragma unroll
  for (int t = 0; t < S2; ++t) {
    const int yy = y + t / S - kPad;
    const int xx = x + t % S - kPad;
    const bool inside = yy >= 0 && yy < h && xx >= 0 && xx < w;
    const unsigned int bits = inside ? __ldg(image + yy * w + xx) : 0u;
    const float r = (t == kCenter) ? r0 : __uint_as_float(bits & ~kLabelMask);
    const float d = fabsf(r - r0) * gauss.v[t] + 1.0f;
    work[t] = __uint_as_float((__float_as_uint(d) & ~kLabelMask) |
                              (bits & kLabelMask));
  }

  int votes[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) votes[c] = 0;

  for (int k = 0; k < knn; ++k) {
    float m = work[0];
    int j = 0;
#pragma unroll
    for (int t = 1; t < S2; ++t) {
      if (work[t] < m) {  // strict: the first column among equal values
        m = work[t];
        j = t;
      }
    }
    const unsigned int mbits = __float_as_uint(m);
    int label = static_cast<int>(mbits & kLabelMask);
    if (cutoff > 0.0f && __uint_as_float(mbits & ~kLabelMask) - 1.0f > cutoff) {
      label = n_classes;
    }
#pragma unroll
    for (int c = 1; c < kMaxClasses; ++c) votes[c] += (label == c);
#pragma unroll
    for (int t = 0; t < S2; ++t) {
      if (t == j) work[t] = kKnockedOut;
    }
  }

  int best = 1;
  int best_votes = votes[1];
#pragma unroll
  for (int c = 2; c < kMaxClasses; ++c) {
    if (c < n_classes && votes[c] > best_votes) {
      best = c;
      best_votes = votes[c];
    }
  }
  out[i] = best;
}

template <int S>
cudaError_t launch(const void* packed, const void* point_range, const void* px,
                   const void* py, const InvGauss& gauss, void* out,
                   int64_t n_points, int64_t p, int32_t h, int32_t w,
                   int32_t n_classes, int32_t knn, float cutoff,
                   cudaStream_t s) {
  const int blocks = static_cast<int>((n_points + kThreads - 1) / kThreads);
  knn_vote_kernel<S><<<blocks, kThreads, 0, s>>>(
      static_cast<const unsigned int*>(packed),
      static_cast<const float*>(point_range), static_cast<const int32_t*>(px),
      static_cast<const int32_t*>(py), gauss, static_cast<int32_t*>(out),
      n_points, p, h, w, n_classes, knn, cutoff);
  return cudaGetLastError();
}

}  // namespace

// packed (B, H, W) float32 bits, point_range (B, P) float32, px/py (B, P)
// int32, out (B, P) int32: device pointers, contiguous. inv_gauss is a HOST
// pointer to search*search floats, passed to the kernel by value. Launched on
// `stream`; returns the CUDA error code (0 = ok).
extern "C" int c3d_knn_vote(const void* packed, const void* point_range,
                            const void* px, const void* py,
                            const void* inv_gauss, void* out, int64_t b,
                            int64_t p, int32_t h, int32_t w, int32_t search,
                            int32_t n_classes, int32_t knn, float cutoff,
                            void* stream) {
  if (search != 3 && search != 5 && search != 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_classes < 2 || n_classes >= kMaxClasses || knn < 1 ||
      knn > search * search) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_points = b * p;
  if (n_points == 0) return 0;
  InvGauss gauss;
  std::memset(&gauss, 0, sizeof(gauss));
  std::memcpy(gauss.v, inv_gauss, sizeof(float) * search * search);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (search) {
    case 3:
      err = launch<3>(packed, point_range, px, py, gauss, out, n_points, p, h,
                      w, n_classes, knn, cutoff, s);
      break;
    case 5:
      err = launch<5>(packed, point_range, px, py, gauss, out, n_points, p, h,
                      w, n_classes, knn, cutoff, s);
      break;
    default:
      err = launch<7>(packed, point_range, px, py, gauss, out, n_points, p, h,
                      w, n_classes, knn, cutoff, s);
      break;
  }
  return static_cast<int>(err);
}
