// Kernel K3: the prototype Sinkhorn/EMA tail, hand-written for Hopper
// (sm_90a), plain C interface (ctypes).
//
// Replaces the TPU kernel ops/pallas/proto_update.py:_kernel of the JAX
// package (called from fused_proto_tail). Per class c over its M gathered
// rows: row LayerNorm + l2; similarity to the whole (C*K, D) memory; max
// within each class; LayerNorm over the C maxima; argmax (first wins);
// agreement = (pred == c) & valid; own-class (M, K) similarity / eps;
// masked max-shift, exp, `iters` masked Sinkhorn rounds; hard =
// argmax(Q + gumbel); one-hot^T @ feat over the agreeing valid rows -> (K, D);
// l2; EMA with `momentum` on occupied rows of non-ignore classes; l2 renorm.
//
// The TPU kernel keeps one class's whole tail in ~100 MB of VMEM. An H100
// block has 227 KB of shared memory and the (C*K, D) memory alone is 410 KB
// at KITTI size, so the work is split in two launches:
//   row_pass   (one block per 16 rows, 128 threads): LayerNorm + l2 of the
//              rows into `featn`, the (16, C*K) similarity with the memory
//              staged through shared memory 32 prototypes at a time (each
//              thread: 1 row x 4 prototypes), then per row the class maxima,
//              their LayerNorm, the argmax, `agree`, and the K own-class
//              similarities into `simc`. A tile holding no valid row exits
//              at once: valid rows are a prefix of each class's M slots, so
//              the work follows the valid counts.
//   class_pass (one block per class, 1024 threads): Q (M, K) in dynamic
//              shared memory (160 KB at M=2048, K=20), the Sinkhorn rounds
//              in the JAX package's order, the hard assignment, and the
//              (K, D) contraction in the same shared memory (one slice of
//              accumulators per group of D threads), then l2, EMA, renorm.
// A class with no valid row (always the ignore class) writes l2(memory[c])
// without touching Q, which is what the JAX path gives after its masks drop
// the NaN of max(-inf).
//
// What bounds it on this card: float32 operations (TF32 off). At KITTI size
// with every row valid: similarity 2*C*M*C*K*D = 8.39 G, own-class block and
// contraction 0.42 G each, 9.23 GFLOP = 0.138 ms at 67 TFLOP/s; bytes ~46.6
// MB = 0.014 ms at 3.35 TB/s. This first version stages operands through
// shared memory (5 loads per 4 FMAs) and is not tuned.
//
// Numerics: IEEE division, sqrtf and expf (never -use_fast_math). Sums run
// in another order than the PyTorch twin's, so the two agree by tolerance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;            // rows per row_pass block
constexpr int kChunk = 32;           // prototypes staged per chunk
constexpr int kRowThreads = 128;     // 16 rows x 8 prototype lanes
constexpr int kClassThreads = 1024;
constexpr int kRed = 96;             // floats of reduction scratch
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result. red[0..32] scratch.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nwarps ? red[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nwarps ? red[lane] : -INFINITY;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  return red[32];
}

__global__ void __launch_bounds__(kRowThreads)
row_pass(const float* __restrict__ feat, const uint8_t* __restrict__ valid,
         const float* __restrict__ protos, float* __restrict__ featn,
         float* __restrict__ simc, uint8_t* __restrict__ agree,
         int C, int M, int K, int D) {
  extern __shared__ float smem[];
  const int ld = D + 1;              // padded rows: conflict-free columns
  const int ck = C * K;
  float* rowS = smem;                          // [kRows][ld]
  float* protoS = rowS + kRows * ld;           // [kChunk][ld]
  float* simS = protoS + kChunk * ld;          // [kRows][ck]
  const long long total = (long long)C * M;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kRowThreads / 32;

  int any = 0;
  if (tid < kRows && row0 + tid < total) any = valid[row0 + tid];
  if (!__syncthreads_or(any)) return;

  // 1. LayerNorm (biased variance) + l2, one warp per row
  for (int r = warp; r < kRows; r += kWarps) {
    const long long g = row0 + r;
    float* x = rowS + r * ld;
    if (g >= total) {
      for (int i = lane; i < D; i += 32) x[i] = 0.f;
      continue;
    }
    const float* src = feat + g * D;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = src[i];
      x[i] = v;
      s += v;
    }
    const float mu = warp_sum(s) / (float)D;
    float s2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = x[i] - mu;
      s2 += v * v;
    }
    const float inv = 1.0f / sqrtf(warp_sum(s2) / (float)D + kLnEps);
    float n2 = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float v = (x[i] - mu) * inv;
      x[i] = v;
      n2 += v * v;
    }
    const float nrm = fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
    float* dst = featn + g * D;
    for (int i = lane; i < D; i += 32) {
      const float v = x[i] / nrm;
      x[i] = v;
      dst[i] = v;
    }
  }
  __syncthreads();

  // 2. (kRows, C*K) similarity, prototypes staged kChunk at a time
  const int tr = tid >> 3;           // row of this thread
  const int tp = tid & 7;            // prototypes tp, tp+8, tp+16, tp+24
  const float* xr = rowS + tr * ld;
  for (int p0 = 0; p0 < ck; p0 += kChunk) {
    const int np = min(kChunk, ck - p0);
    for (int i = tid; i < np * D; i += kRowThreads) {
      const int pp = i / D;
      protoS[pp * ld + (i - pp * D)] = protos[(long long)p0 * D + i];
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < D; ++i) {
      const float xv = xr[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += xv * protoS[(tp + 8 * j) * ld + i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = tp + 8 * j;
      if (pp < np) simS[tr * ck + p0 + pp] = acc[j];
    }
    __syncthreads();
  }

  // 3. class maxima, their LayerNorm, argmax, agreement, own-class block
  for (int r = warp; r < kRows; r += kWarps) {
    const long long g = row0 + r;
    if (g >= total) continue;
    const int c = (int)(g / M);
    const float* s = simS + r * ck;
    float near = -INFINITY;
    if (lane < C)
      for (int kk = 0; kk < K; ++kk) near = fmaxf(near, s[lane * K + kk]);
    const float mu = warp_sum(lane < C ? near : 0.f) / (float)C;
    const float dv = lane < C ? near - mu : 0.f;
    const float inv = 1.0f / sqrtf(warp_sum(dv * dv) / (float)C + kLnEps);
    float best_v = lane < C ? dv * inv : -INFINITY;
    int best = lane;
    for (int o = 16; o > 0; o >>= 1) {     // argmax, lowest class wins ties
      const float ov = __shfl_xor_sync(kFull, best_v, o);
      const int oi = __shfl_xor_sync(kFull, best, o);
      if (ov > best_v || (ov == best_v && oi < best)) {
        best_v = ov;
        best = oi;
      }
    }
    if (lane == 0) agree[g] = (uint8_t)(valid[g] && best == c);
    for (int kk = lane; kk < K; kk += 32) simc[g * K + kk] = s[c * K + kk];
  }
}

__global__ void __launch_bounds__(kClassThreads)
class_pass(const float* __restrict__ featn, const float* __restrict__ simc,
           const uint8_t* __restrict__ valid, const uint8_t* __restrict__ agree,
           const float* __restrict__ protos, const float* __restrict__ gumbel,
           float* __restrict__ out, int M, int K, int D, float momentum,
           float one_minus, float eps, int ignore_cls, int iters) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int slices = max(1, kClassThreads / D);
  const int mk = M * K;
  const int qn = max(mk, slices * K * D);
  float* q = smem;                             // [M][K], then [slices][K][D]
  float* red = q + qn;                         // [kRed]
  float* colS = red + 64;                      // [K] column sums / counts
  int* hard = (int*)(red + kRed);              // [M]
  uint8_t* v = (uint8_t*)(hard + M);           // [M] valid
  uint8_t* w = v + M;                          // [M] valid & agree

  const long long base = (long long)c * M;
  float nv_local = 0.f;
  for (int m = tid; m < M; m += nthreads) {
    const uint8_t vv = valid[base + m];
    v[m] = vv;
    w[m] = vv && agree[base + m];
    nv_local += vv;
  }
  const float n_valid_rows = block_sum(nv_local, red);

  const float* prow = protos + (long long)c * K * D;
  float* orow = out + (long long)c * K * D;
  if (n_valid_rows == 0.f || c == ignore_cls) {
    // no valid row, or the ignore class: the memory rows, renormalized
    for (int kk = warp; kk < K; kk += nwarps) {
      float s2 = 0.f;
      for (int d = lane; d < D; d += 32) s2 += prow[kk * D + d] * prow[kk * D + d];
      const float nrm = fmaxf(sqrtf(warp_sum(s2)), 1e-12f);
      for (int d = lane; d < D; d += 32) orow[kk * D + d] = prow[kk * D + d] / nrm;
    }
    return;
  }

  // masked max-shift and exp
  const float* sc = simc + base * K;
  const float* gc = gumbel + base * K;
  float lm = -INFINITY;
  for (int i = tid; i < mk; i += nthreads) {
    if (v[i / K]) {
      const float l = sc[i] / eps;
      q[i] = l;
      lm = fmaxf(lm, l);
    }
  }
  const float lmax = block_max(lm, red);
  float tot = 0.f;
  for (int i = tid; i < mk; i += nthreads) {
    const float e = v[i / K] ? expf(q[i] - lmax) : 0.f;
    q[i] = e;
    tot += e;
  }
  const float total = block_sum(tot, red);
  const float tden = total > 0.f ? total : 1.f;
  for (int i = tid; i < mk; i += nthreads) q[i] = q[i] / tden;
  __syncthreads();

  // Sinkhorn rounds: columns to 1/K, rows to 1/n_valid, invalid rows 0
  const float nv = fmaxf(n_valid_rows, 1.f);
  const float kf = (float)K;
  for (int it = 0; it < iters; ++it) {
    for (int kk = warp; kk < K; kk += nwarps) {
      float s = 0.f;
      for (int m = lane; m < M; m += 32) s += q[m * K + kk];
      s = warp_sum(s);
      if (lane == 0) colS[kk] = s;
    }
    __syncthreads();
    for (int i = tid; i < mk; i += nthreads) {
      const float cs = colS[i % K];
      q[i] = (q[i] / (cs > 0.f ? cs : 1.f)) / kf;
    }
    __syncthreads();
    for (int m = tid; m < M; m += nthreads) {
      float* qr = q + m * K;
      float rs = 0.f;
      for (int kk = 0; kk < K; ++kk) rs += qr[kk];
      const float den = rs > 0.f ? rs : 1.f;
      for (int kk = 0; kk < K; ++kk)
        qr[kk] = v[m] ? (qr[kk] / den) / nv : 0.f;
    }
    __syncthreads();
  }

  // hard assignment argmax(Q * n_valid + gumbel), first index wins; only
  // the rows that enter the contraction need it
  for (int m = tid; m < M; m += nthreads) {
    int best = 0;
    if (w[m]) {
      float bv = -INFINITY;
      for (int kk = 0; kk < K; ++kk) {
        const float val = __fadd_rn(__fmul_rn(q[m * K + kk], nv),
                                    gc[m * K + kk]);
        if (val > bv) {
          bv = val;
          best = kk;
        }
      }
    }
    hard[m] = best;
  }
  __syncthreads();

  // (K, D) contraction over the agreeing valid rows; Q's space now holds
  // one accumulator slice per group of D threads
  float* acc = q;
  for (int i = tid; i < slices * K * D; i += nthreads) acc[i] = 0.f;
  __syncthreads();
  const float* fc = featn + base * D;
  const int sl = tid / D, dd = tid - sl * D;
  if (sl < slices) {
    float* a = acc + (long long)sl * K * D + dd;
    for (int m = sl; m < M; m += slices)
      if (w[m]) a[hard[m] * D] += fc[(long long)m * D + dd];
  }
  for (int kk = warp; kk < K; kk += nwarps) {
    float cnt = 0.f;
    for (int m = lane; m < M; m += 32) cnt += (w[m] && hard[m] == kk);
    cnt = warp_sum(cnt);
    if (lane == 0) colS[kk] = cnt;
  }
  __syncthreads();

  // sum the slices; l2; EMA on occupied rows; renorm
  for (int kk = warp; kk < K; kk += nwarps) {
    float s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      float f = 0.f;
      for (int s = 0; s < slices; ++s) f += acc[(s * K + kk) * D + d];
      acc[kk * D + d] = f;
      s2 += f * f;
    }
    const float fn = fmaxf(sqrtf(warp_sum(s2)), 1e-12f);
    const bool occupied = colS[kk] > 0.f;
    float n2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float p = prow[kk * D + d];
      const float nw = occupied
          ? __fadd_rn(__fmul_rn(momentum, p),
                      __fmul_rn(one_minus, acc[kk * D + d] / fn))
          : p;
      acc[kk * D + d] = nw;
      n2 += nw * nw;
    }
    const float nn = fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
    for (int d = lane; d < D; d += 32) orow[kk * D + d] = acc[kk * D + d] / nn;
  }
}

}  // namespace

extern "C" int c3d_proto_tail(
    const float* feat, const uint8_t* valid, const float* protos,
    const float* gumbel, float* featn, float* simc, uint8_t* agree,
    float* out, int C, int M, int K, int D, float momentum, float one_minus,
    float eps, int ignore_cls, int iters, cudaStream_t stream) {
  const size_t row_smem =
      sizeof(float) * ((size_t)(kRows + kChunk) * (D + 1) + (size_t)kRows * C * K);
  const int slices = max(1, kClassThreads / D);
  const size_t qn = (size_t)max(M * K, slices * K * D);
  const size_t cls_smem =
      sizeof(float) * (qn + kRed) + sizeof(int) * (size_t)M + 2 * (size_t)M;
  cudaError_t err = cudaFuncSetAttribute(
      row_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      class_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cls_smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * M;
  const int grid = (int)((total + kRows - 1) / kRows);
  row_pass<<<grid, kRowThreads, row_smem, stream>>>(
      feat, valid, protos, featn, simc, agree, C, M, K, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  class_pass<<<C, kClassThreads, cls_smem, stream>>>(
      featn, simc, valid, agree, protos, gumbel, out, M, K, D, momentum,
      one_minus, eps, ignore_cls, iters);
  return (int)cudaGetLastError();
}
