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
// The TPU kernel keeps one class's whole tail in ~100 MB of VMEM; an H100
// block has 227 KB and the (C*K, D) memory alone is 410 KB at KITTI size.
// Three launches behind one C entry point:
//
// live_tiles, one block: the (class, 64-row tile) pairs that hold a valid
//   row, so the row pass works only where the valid rows are (a training
//   batch has a few hundred of the C*M slots).
//
// row_pass, persistent, two 256-thread blocks per SM walking the work units
//   (live pair, chunk): 64 rows of one class against one chunk of whole
//   classes of the memory (as even as 128 columns allow: four chunks of
//   five classes at C=20, K=20). The raw rows come into shared memory by
//   cp.async, all at once, and get LayerNorm + l2 there (chunk 0 also
//   writes `featn`). The chunk streams through shared memory in depth
//   slices of 32, double-buffered with 16-byte cp.async. Each thread owns a
//   4-row x 8-prototype register tile: a depth step of 4 is 12 128-bit
//   shared loads for 128 FMAs, conflict-free (prototype rows padded to 36
//   floats, the thread's prototypes 16 apart). The tile then goes through
//   shared memory once to fold each class's maximum (`near`, C per row) and
//   to write the own-class similarities (`simc`), so the (rows, C*K)
//   similarity never sits whole anywhere.
//
// class_pass, one cluster of 8 CTAs (256 threads each) per class. Every
//   loop stops at the class's last valid slot + 1 (later slots are invalid
//   and add nothing). Per valid row the LayerNorm of its C class maxima,
//   the argmax (lowest class wins ties) and the agreement. Each CTA holds
//   a slice of those rows of Q (row stride K+1: no bank conflicts in the
//   row or column loops). The global max, the total and each Sinkhorn
//   round's column sums combine through distributed shared memory, rank by
//   rank in a fixed order. The hard assignment groups the CTA's agreeing
//   rows by sub-prototype (a stable counting sort by warp ballots); a warp
//   then sums each group's featn rows in registers with coalesced 16-byte
//   loads, four rows in flight. The (K, D) partial sums of the 8 CTAs are
//   added in rank order by the CTA that owns the sub-prototype row, which
//   then applies l2, the EMA and the renorm.
//   A class with no valid row, and the ignore class, write l2(memory[c])
//   without touching Q: what the JAX path gives after its masks drop the
//   NaN of max(-inf).
//
// What bounds it on this card: float32 operations (TF32 off, since the /0.05
// logits turn 1e-3 errors into flipped assignments). At KITTI size with
// every row valid: similarity 2*C*M*C*K*D = 8.39 G, own-class block and
// contraction 0.42 G each, 9.23 GFLOP = 0.138 ms at 67 TFLOP/s; bytes ~46.6
// MB = 0.014 ms at 3.35 TB/s.
//
// Numerics: IEEE division, sqrtf and expf (never -use_fast_math); the
// assignment argmax and the EMA use __fmul_rn / __fadd_rn where the twin
// rounds twice. No float atomics: every sum runs in a fixed order, so the
// output is the same from run to run. Sums run in another order than the
// PyTorch twin's, so the two agree by tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;            // rows per row_pass block
constexpr int kProtos = 128;         // prototype columns of a chunk
constexpr int kSlice = 32;           // depth of one staged slice
constexpr int kSliceLd = kSlice + 4; // padded slice row (floats)
constexpr int kSimLd = kProtos + 1;  // padded similarity tile row
constexpr int kRowThreads = 256;     // 16 prototype lanes x 16 row lanes
constexpr int kCluster = 8;          // CTAs per class in class_pass
constexpr int kClassThreads = 256;
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

__device__ __forceinline__ int warp_isum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_imax(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
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

// (sum, max) of one int per thread over the block
__device__ int2 block_isum_imax(int s, int m, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  s = warp_isum(s);
  m = warp_imax(m);
  __syncthreads();
  if (lane == 0) {
    red[warp] = s;
    red[32 + warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int a = lane < nwarps ? red[lane] : 0;
    int b = lane < nwarps ? red[32 + lane] : -1;
    a = warp_isum(a);
    b = warp_imax(b);
    if (lane == 0) {
      red[64] = a;
      red[65] = b;
    }
  }
  __syncthreads();
  return make_int2(red[64], red[65]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc += a.x * b.x;
  acc += a.y * b.y;
  acc += a.z * b.z;
  acc += a.w * b.w;
  return acc;
}

// One block: the (class, 64-row tile) pairs that hold a valid row, in
// order, as live[1..live[0]]. The mask is read coalesced, a byte a thread,
// every load in flight; flags[pair] (dynamic shared memory) marks the pairs.
__global__ void __launch_bounds__(1024)
live_tiles(const uint8_t* __restrict__ valid, int C, int M,
           int* __restrict__ live) {
  extern __shared__ int flags[];
  __shared__ int warp_n[32];
  const int n_tiles = (M + kRows - 1) / kRows;
  const int n_pairs = C * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n_pairs; i += 1024) flags[i] = 0;
  __syncthreads();
  const int total = C * M;
#pragma unroll 8
  for (int i = tid; i < total; i += 1024) {
    if (valid[i]) {
      const int c = i / M;
      flags[c * n_tiles + (i - c * M) / kRows] = 1;
    }
  }
  __syncthreads();
  int done = 0;                                // live pairs of earlier rounds
  for (int p0 = 0; p0 < n_pairs; p0 += 1024) {
    const int pair = p0 + tid;
    const bool hit = pair < n_pairs && flags[pair];
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    int before = done;
    for (int w = 0; w < warp; ++w) before += warp_n[w];
    if (hit) live[1 + before + __popc(mask & ((1u << lane) - 1u))] = pair;
    for (int w = 0; w < 32; ++w) done += warp_n[w];
    __syncthreads();
  }
  if (tid == 0) live[0] = done;
}

// Persistent: each block walks the work units (live pair, chunk) with the
// grid's stride.
__global__ void __launch_bounds__(kRowThreads, 2)
row_pass(const float* __restrict__ feat, const int* __restrict__ live,
         const float* __restrict__ protos, float* __restrict__ featn,
         float* __restrict__ simc, float* __restrict__ near,
         int C, int M, int K, int D, int per_chunk) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = D + 4;
  float* xs = smem;                            // [kRows][ldx]
  float* ps = xs + kRows * ldx;                // [2][kProtos][kSliceLd]
  float* simT = ps;                            // [kRows][kSimLd], aliases ps
  const int n_chunks = (C + per_chunk - 1) / per_chunk;
  const int n_tiles = (M + kRows - 1) / kRows;
  const int n_units = live[0] * n_chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kRowThreads / 32;
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int pair = live[1 + unit / n_chunks];
    const int chunk = unit % n_chunks;
    const int c = pair / n_tiles;
    const int row0 = (pair - c * n_tiles) * kRows;
    const int q0 = chunk * per_chunk;            // this unit's classes
    const int nq = min(per_chunk, C - q0);
    const int np = nq * K;
    const long long base = (long long)c * M;
    const bool write_featn = chunk == 0;
    __syncthreads();                             // the last unit is done

    // 1. the raw rows into shared memory (all copies in flight at once), then
    //    LayerNorm (biased variance) + l2 there, one warp per row
    const int d4 = D >> 2;
    for (int i = tid; i < kRows * d4; i += kRowThreads) {
      const int r = i / d4, f = i - r * d4;
      float* dst = xs + r * ldx + 4 * f;
      if (row0 + r < M)
        cp_async16(dst, feat + (base + row0 + r) * D + 4 * f);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      float4* x = reinterpret_cast<float4*>(xs + r * ldx);
      const int m = row0 + r;
      if (m >= M) continue;
      float s = 0.f;
      for (int i = lane; i < d4; i += 32) {
        const float4 v = x[i];
        s += v.x + v.y + v.z + v.w;
      }
      const float mu = warp_sum(s) / (float)D;
      float s2 = 0.f;
      for (int i = lane; i < d4; i += 32) {
        const float4 v = x[i];
        const float a = v.x - mu, b = v.y - mu, e = v.z - mu, f = v.w - mu;
        s2 += a * a + b * b + e * e + f * f;
      }
      const float inv = 1.0f / sqrtf(warp_sum(s2) / (float)D + kLnEps);
      float n2 = 0.f;
      for (int i = lane; i < d4; i += 32) {
        float4 v = x[i];
        v.x = (v.x - mu) * inv;
        v.y = (v.y - mu) * inv;
        v.z = (v.z - mu) * inv;
        v.w = (v.w - mu) * inv;
        x[i] = v;
        n2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
      const float nrm = fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
      float4* dst = reinterpret_cast<float4*>(featn + (base + m) * D);
      for (int i = lane; i < d4; i += 32) {
        float4 v = x[i];
        v.x /= nrm;
        v.y /= nrm;
        v.z /= nrm;
        v.w /= nrm;
        x[i] = v;
        if (write_featn) dst[i] = v;
      }
    }

    // 2. similarity to this block's chunk of whole classes
    const int tx = tid & 15;           // prototypes tx + 16 j, j < 8
    const int ty = tid >> 4;           // rows ty + 16 i, i < 4
    const int n_slices = D / kSlice;
    const float* pbase = protos + (long long)q0 * K * D;
    auto load_slice = [&](int s) {
      float* dstb = ps + (s & 1) * kProtos * kSliceLd;
      const int k0 = s * kSlice;
      for (int i = tid; i < kProtos * (kSlice / 4); i += kRowThreads) {
        const int pr = i >> 3, f = i & 7;
        if (pr < np)
          cp_async16(dstb + pr * kSliceLd + f * 4,
                     pbase + (long long)pr * D + k0 + f * 4);
      }
      cp_async_commit();
    };
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    __syncthreads();                 // the rows are in xs
    load_slice(0);
    for (int s = 0; s < n_slices; ++s) {
      if (s + 1 < n_slices) {
        load_slice(s + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* pb = ps + (s & 1) * kProtos * kSliceLd;
      const int k0 = s * kSlice;
#pragma unroll 4
      for (int dd = 0; dd < kSlice; dd += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              xs + (ty + 16 * i) * ldx + k0 + dd);
#pragma unroll
        for (int h = 0; h < 8; h += 4) {   // half the prototypes at a time:
          float4 b[4];                     // 64 live floats, no spill
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                pb + (tx + 16 * (h + j)) * kSliceLd + dd);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][h + j] = dot4(acc[i][h + j], a[i], b[j]);
        }
      }
      __syncthreads();               // the buffer is refilled next round
    }
    // fold: the tile once through shared memory, class maxima per row
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        simT[(ty + 16 * i) * kSimLd + tx + 16 * j] = acc[i][j];
    __syncthreads();
    for (int i = tid; i < kRows * nq; i += kRowThreads) {
      const int r = i / nq, q = i - r * nq;
      const float* sr = simT + r * kSimLd + q * K;
      float mx = -INFINITY;
      for (int kk = 0; kk < K; ++kk) mx = fmaxf(mx, sr[kk]);
      if (row0 + r < M) near[(base + row0 + r) * C + q0 + q] = mx;
    }
    if (c >= q0 && c < q0 + nq) {
      for (int i = tid; i < kRows * K; i += kRowThreads) {
        const int r = i / K, kk = i - r * K;
        if (row0 + r < M)
          simc[(base + row0 + r) * K + kk] =
              simT[r * kSimLd + (c - q0) * K + kk];
      }
    }
  }
}

__global__ void __launch_bounds__(kClassThreads)
class_pass(const float* __restrict__ featn, const float* __restrict__ simc,
           const uint8_t* __restrict__ valid, const float* __restrict__ near,
           const float* __restrict__ protos, const float* __restrict__ gumbel,
           float* __restrict__ out, int C, int M, int K, int D, float momentum,
           float one_minus, float eps, int ignore_cls, int iters) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int R = (M + kCluster - 1) / kCluster;     // most rows of one CTA
  const int ldq = K + 1;
  float* partial = smem;                           // [K][D] this CTA's sums
  float* q = partial + K * D;                      // [R][ldq]
  float* fin = q + R * ldq;                        // [ceil(K/8)][D]
  float* xch = fin + ((K + kCluster - 1) / kCluster) * D;  // [2 + 2K]
  float* colS = xch + 2 + 2 * K;                   // [K]
  float* red = colS + K;                           // [66]
  int* bcount = (int*)(red + 66);                  // [K]
  int* boff = bcount + K;                          // [K + 1]
  int* hard = boff + K + 1;                        // [R]
  int* order = hard + R;                           // [R]
  uint8_t* v = (uint8_t*)(order + R);              // [R] valid
  uint8_t* w = v + R;                              // [R] valid & agree

  const long long base = (long long)c * M;
  const float* prow = protos + (long long)c * K * D;
  float* orow = out + (long long)c * K * D;

  // the whole class's valid count and last valid slot (every CTA)
  int cnt = 0, last = -1;
  for (int m = tid; m < M; m += nthreads)
    if (valid[base + m]) {
      ++cnt;
      last = m;
    }
  const int2 cl = block_isum_imax(cnt, last, (int*)red);
  if (cl.x == 0 || c == ignore_cls) {
    // no valid row, or the ignore class: the memory rows, renormalized
    for (int kk = rank * nwarps + warp; kk < K; kk += kCluster * nwarps) {
      float s2 = 0.f;
      for (int d = lane; d < D; d += 32)
        s2 += prow[kk * D + d] * prow[kk * D + d];
      const float nrm = fmaxf(sqrtf(warp_sum(s2)), 1e-12f);
      for (int d = lane; d < D; d += 32)
        orow[kk * D + d] = prow[kk * D + d] / nrm;
    }
    return;                          // the whole cluster takes this branch
  }
  const float nv = (float)cl.x;      // n_valid >= 1
  const int n_act = cl.y + 1;        // slots past the last valid add nothing
  const int rows = (n_act + kCluster - 1) / kCluster;
  const int r0 = min(rank * rows, n_act);
  const int nr = min(rows, n_act - r0);
  const int nq = nr * K;

  // agreement: LayerNorm of the row's C class maxima, argmax (the lowest
  // class wins ties) == c, one thread per row
  for (int m = tid; m < nr; m += nthreads) {
    const bool vv = valid[base + r0 + m];
    bool agree = false;
    if (vv) {
      const float* row = near + (base + r0 + m) * C;
      float x[32];                     // C <= 32; every load in flight
#pragma unroll
      for (int q = 0; q < 32; ++q) x[q] = q < C ? row[q] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 32; ++q) s += x[q];
      const float mu = s / (float)C;
      float s2 = 0.f;
#pragma unroll
      for (int q = 0; q < 32; ++q)
        if (q < C) s2 += (x[q] - mu) * (x[q] - mu);
      const float inv = 1.0f / sqrtf(s2 / (float)C + kLnEps);
      float best_v = -INFINITY;
      int best = 0;
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const float z = (x[q] - mu) * inv;
        if (q < C && z > best_v) {
          best_v = z;
          best = q;
        }
      }
      agree = best == c;
    }
    v[m] = vv;
    w[m] = agree;
  }
  __syncthreads();

  // masked max-shift and exp; max and total over the cluster, rank order
  const float* sc = simc + (base + r0) * K;
  const float* gc = gumbel + (base + r0) * K;
  float lm = -INFINITY;
  for (int i = tid; i < nq; i += nthreads) {
    const int m = i / K, kk = i - m * K;
    if (v[m]) {
      const float l = sc[i] / eps;
      q[m * ldq + kk] = l;
      lm = fmaxf(lm, l);
    }
  }
  lm = block_max(lm, red);
  if (tid == 0) xch[0] = lm;
  cluster.sync();
  float lmax = -INFINITY;
  for (int s = 0; s < kCluster; ++s)
    lmax = fmaxf(lmax, cluster.map_shared_rank(xch, s)[0]);
  float tot = 0.f;
  for (int i = tid; i < nq; i += nthreads) {
    const int m = i / K, kk = i - m * K;
    const float e = v[m] ? expf(q[m * ldq + kk] - lmax) : 0.f;
    q[m * ldq + kk] = e;
    tot += e;
  }
  tot = block_sum(tot, red);
  if (tid == 0) xch[1] = tot;
  cluster.sync();
  float total = 0.f;
  for (int s = 0; s < kCluster; ++s) total += cluster.map_shared_rank(xch, s)[1];
  const float tden = total > 0.f ? total : 1.f;
  for (int i = tid; i < nq; i += nthreads) {
    const int m = i / K, kk = i - m * K;
    q[m * ldq + kk] = q[m * ldq + kk] / tden;
  }
  __syncthreads();

  // Sinkhorn rounds: columns to 1/K, rows to 1/n_valid, invalid rows 0
  const float kf = (float)K;
  for (int it = 0; it < iters; ++it) {
    float* part = xch + 2 + (it & 1) * K;   // parity: a slow CTA may still
    for (int kk = warp; kk < K; kk += nwarps) {   // read the last round's
      float s = 0.f;
      for (int m = lane; m < nr; m += 32) s += q[m * ldq + kk];
      s = warp_sum(s);
      if (lane == 0) part[kk] = s;
    }
    cluster.sync();
    for (int kk = tid; kk < K; kk += nthreads) {
      float s = 0.f;
      for (int r = 0; r < kCluster; ++r)
        s += cluster.map_shared_rank(part, r)[kk];
      colS[kk] = s;
    }
    __syncthreads();
    for (int i = tid; i < nq; i += nthreads) {
      const int m = i / K, kk = i - m * K;
      const float cs = colS[kk];
      q[m * ldq + kk] = (q[m * ldq + kk] / (cs > 0.f ? cs : 1.f)) / kf;
    }
    __syncthreads();
    for (int m = tid; m < nr; m += nthreads) {
      float* qr = q + m * ldq;
      float rs = 0.f;
      for (int kk = 0; kk < K; ++kk) rs += qr[kk];
      const float den = rs > 0.f ? rs : 1.f;
      for (int kk = 0; kk < K; ++kk) qr[kk] = v[m] ? (qr[kk] / den) / nv : 0.f;
    }
    __syncthreads();
  }

  // hard assignment argmax(Q * n_valid + gumbel), first index wins; -1 for
  // the rows that do not enter the contraction
  for (int m = tid; m < nr; m += nthreads) {
    int best = -1;
    if (w[m]) {
      float g[32];                     // K <= 32; every load in flight
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) g[kk] = kk < K ? gc[m * K + kk] : 0.f;
      float bv = -INFINITY;
      best = 0;
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        if (kk < K) {
          const float val = __fadd_rn(__fmul_rn(q[m * ldq + kk], nv), g[kk]);
          if (val > bv) {
            bv = val;
            best = kk;
          }
        }
      }
    }
    hard[m] = best;
  }
  __syncthreads();

  // stable counting sort of the agreeing rows by assignment (warp ballots)
  const unsigned lt = (1u << lane) - 1u;
  for (int kk = warp; kk < K; kk += nwarps) {
    int n = 0;
    for (int mb = 0; mb < nr; mb += 32) {
      const int m = mb + lane;
      n += __popc(__ballot_sync(kFull, m < nr && hard[m] == kk));
    }
    if (lane == 0) bcount[kk] = n;
  }
  __syncthreads();
  if (tid == 0) {
    boff[0] = 0;
    for (int kk = 0; kk < K; ++kk) boff[kk + 1] = boff[kk] + bcount[kk];
  }
  __syncthreads();
  for (int kk = warp; kk < K; kk += nwarps) {
    int pos = boff[kk];
    for (int mb = 0; mb < nr; mb += 32) {
      const int m = mb + lane;
      const bool hit = m < nr && hard[m] == kk;
      const unsigned mask = __ballot_sync(kFull, hit);
      if (hit) order[pos + __popc(mask & lt)] = m;
      pos += __popc(mask);
    }
  }
  __syncthreads();

  // (K, D) partial sums of this CTA: one warp per (group, 128 features),
  // registers, rows in slot order, 16-byte loads across the lanes, four
  // rows in flight
  const float* fc = featn + (base + r0) * D;
  const int n_dc = (D + 127) / 128;
  for (int item = warp; item < K * n_dc; item += nwarps) {
    const int kk = item / n_dc;
    const int d0 = (item - kk * n_dc) * 128 + lane * 4;
    if (d0 >= D) continue;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    int t = boff[kk];
    const int t1 = boff[kk + 1];
    for (; t + 4 <= t1; t += 4) {
      float4 f[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        f[u] = __ldg(reinterpret_cast<const float4*>(
            fc + (long long)order[t + u] * D + d0));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a.x += f[u].x;
        a.y += f[u].y;
        a.z += f[u].z;
        a.w += f[u].w;
      }
    }
    for (; t < t1; ++t) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(
          fc + (long long)order[t] * D + d0));
      a.x += f.x;
      a.y += f.y;
      a.z += f.z;
      a.w += f.w;
    }
    *reinterpret_cast<float4*>(partial + kk * D + d0) = a;
  }
  cluster.sync();

  // the CTA of rank kk % 8 owns sub-prototype kk: the 8 partials in rank
  // order, l2, EMA on occupied rows, renorm
  for (int j = warp; rank + kCluster * j < K; j += nwarps) {
    const int kk = rank + kCluster * j;
    float* f = fin + j * D;
    int n_assigned = 0;
    for (int s = 0; s < kCluster; ++s)
      n_assigned += cluster.map_shared_rank(bcount, s)[kk];
    float s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      float x = 0.f;
#pragma unroll
      for (int s = 0; s < kCluster; ++s)
        x += cluster.map_shared_rank(partial, s)[kk * D + d];
      f[d] = x;
      s2 += x * x;
    }
    const float fn = fmaxf(sqrtf(warp_sum(s2)), 1e-12f);
    float n2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float p = prow[kk * D + d];
      const float nw = n_assigned > 0
          ? __fadd_rn(__fmul_rn(momentum, p), __fmul_rn(one_minus, f[d] / fn))
          : p;
      f[d] = nw;
      n2 += nw * nw;
    }
    const float nn = fmaxf(sqrtf(warp_sum(n2)), 1e-12f);
    for (int d = lane; d < D; d += 32) orow[kk * D + d] = f[d] / nn;
  }
  cluster.sync();                    // no CTA leaves while others read it
}

size_t row_smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * (D + 4) +
                          (size_t)2 * kProtos * kSliceLd);
}

size_t class_smem_bytes(int M, int K, int D) {
  const size_t R = (size_t)(M + kCluster - 1) / kCluster;
  const size_t floats = (size_t)K * D + R * (K + 1) +
                        (size_t)((K + kCluster - 1) / kCluster) * D +
                        (2 + 2 * (size_t)K) + K + 66;
  const size_t ints = (size_t)K + (K + 1) + 2 * R;
  return sizeof(float) * floats + sizeof(int) * ints + 2 * R;
}

// The 4-byte words of scratch one call uses: featn (C, M, D), simc
// (C, M, K), near (C, M, C), then the live list (1 + C * ceil(M / 64)).
struct Scratch {
  float* featn;
  float* simc;
  float* near;
  int* live;
};

// (class, 64-row tile) pairs
size_t n_pairs(int C, int M) { return (size_t)C * ((M + kRows - 1) / kRows); }

size_t scratch_words(int C, int M, int K, int D) {
  return (size_t)C * M * (D + K + C) + 1 + n_pairs(C, M);
}

Scratch carve(void* scratch, int C, int M, int K, int D) {
  Scratch s;
  s.featn = static_cast<float*>(scratch);
  s.simc = s.featn + (size_t)C * M * D;
  s.near = s.simc + (size_t)C * M * K;
  s.live = reinterpret_cast<int*>(s.near + (size_t)C * M * C);
  return s;
}

// Once per device: the passes may use up to a block's shared memory (the
// attribute call costs host time on every launch otherwise), and the SM
// count the persistent row pass sizes its grid by.
cudaError_t configure(int* sms) {
  constexpr int kMaxDevices = 64;
  constexpr int kMaxSmem = 232448;
  static int sm_count[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && sm_count[device] > 0) {
    *sms = sm_count[device];
    return cudaSuccess;
  }
  for (const void* f : {(const void*)live_tiles, (const void*)row_pass,
                        (const void*)class_pass}) {
    cudaFuncAttributes attr;              // the limit counts static smem too
    if ((err = cudaFuncGetAttributes(&attr, f)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices) sm_count[device] = *sms;
  return cudaSuccess;
}

cudaError_t launch_row_pass(const float* feat, const uint8_t* valid,
                            const float* protos, const Scratch& sc, int C,
                            int M, int K, int D, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return err;
  live_tiles<<<1, 1024, sizeof(int) * n_pairs(C, M), stream>>>(valid, C, M,
                                                               sc.live);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // chunks of whole classes, as even as kProtos columns allow (20 classes
  // of 20: four chunks of five); two resident blocks per SM walk the live
  // (pair, chunk) units
  const int most = max(1, min(C, kProtos / K));
  const int n_chunks = (C + most - 1) / most;
  const int per_chunk = (C + n_chunks - 1) / n_chunks;
  const int units = C * ((M + kRows - 1) / kRows) * n_chunks;
  row_pass<<<min(units, 2 * sms), kRowThreads, row_smem_bytes(D), stream>>>(
      feat, sc.live, protos, sc.featn, sc.simc, sc.near, C, M, K, D,
      per_chunk);
  return cudaGetLastError();
}

cudaError_t launch_class_pass(const uint8_t* valid, const float* protos,
                              const float* gumbel, const Scratch& sc,
                              float* out, int C, int M, int K, int D,
                              float momentum, float one_minus, float eps,
                              int ignore_cls, int iters, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = configure(&sms);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * kCluster);
  cfg.blockDim = dim3(kClassThreads);
  cfg.dynamicSmemBytes = class_smem_bytes(M, K, D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, class_pass, (const float*)sc.featn,
                           (const float*)sc.simc, valid,
                           (const float*)sc.near, protos, gumbel, out, C, M,
                           K, D, momentum, one_minus, eps, ignore_cls, iters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// 4-byte words of device scratch c3d_proto_tail needs at this shape
extern "C" int64_t c3d_proto_tail_scratch(int C, int M, int K, int D) {
  return (int64_t)scratch_words(C, M, K, D);
}

// Runs the row pass (pass 0: the live list, then the row pass), the class
// pass (pass 1, reading what the row pass left in scratch) or both (pass
// -1); each alone is for timing. scratch: c3d_proto_tail_scratch(C, M, K,
// D) words of device memory, 16-byte aligned. Shapes the kernel takes:
// C <= 32, K <= 32, D a multiple of 32, each pass's shared memory within
// the block limit (the wrapper checks all of them first).
extern "C" int c3d_proto_tail(
    int pass, const float* feat, const uint8_t* valid, const float* protos,
    const float* gumbel, void* scratch, float* out, int C, int M, int K,
    int D, float momentum, float one_minus, float eps, int ignore_cls,
    int iters, cudaStream_t stream) {
  if (C < 1 || C > 32 || K < 1 || K > 32 || M < 1 || D < kSlice ||
      D % kSlice != 0 || pass < -1 || pass > 1)
    return (int)cudaErrorInvalidValue;
  const Scratch sc = carve(scratch, C, M, K, D);
  if (pass != 1) {
    const cudaError_t err =
        launch_row_pass(feat, valid, protos, sc, C, M, K, D, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (pass != 0)
    return (int)launch_class_pass(valid, protos, gumbel, sc, out, C, M, K, D,
                                  momentum, one_minus, eps, ignore_cls, iters,
                                  stream);
  return 0;
}
