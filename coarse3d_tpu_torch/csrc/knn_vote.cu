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
//   - the label is the most frequent pick in 1..C-1, ties to the lowest
//     class, and 1 when no pick counts.
//
// Design. A point's window lies in its image tile (8 rows x 128 columns)
// plus a halo of (S-1)/2, so the points are bucketed by tile and each block
// reads one tile's window from shared memory, whatever order the points
// come in (the scans of a batch arrive in random or ring order). Four
// launches behind one C entry point, integer atomics only:
//   tile_count   per point the pixel (clipped like the JAX take), its tile;
//                a shared-memory histogram of 8192 points, 1024 threads
//                with all their loads in flight at once (one atomic per
//                tile per warp), then one global atomicAdd per tile it
//                touched, which reserves the block's range of that tile;
//   tile_scan    one block: exclusive scans of the tile counts and of their
//                chunks (at most kChunk points each, never across a tile:
//                the padding slots of a scan all sit on one pixel, and one
//                tile may hold 30k points), and the chunk table;
//   tile_scatter the same blocks: per point a slot in its block's range of
//                its tile (warp-aggregated shared atomics, no global ones:
//                those on 2048 tile cursors cost 263 us in random order) and
//                a 16-byte record {i, range, y, x}; the order within a tile
//                may vary from run to run, and no label depends on it;
//   tile_vote    one block per chunk: the tile and its halo from the packed
//                image with coalesced loads (zeros outside the image), then
//                one thread per record: S*S taps from shared memory, the
//                same distance arithmetic as the twin, the k smallest packed
//                distances (a min/max insertion list for k <= 8, k rounds
//                of min-extraction beyond), and a vote counted in bit-sliced
//                32-bit planes (one bit per class): the counts' argmax is a
//                scan of the planes from the top, ties to the lowest class.
// Index arithmetic is 32-bit; the wrapper refuses B*P or B*H*W beyond int32.
// The arithmetic repeats the plain PyTorch twin's (ops/knn_vote.py)
// operation for operation, and --fmad=false keeps |dr| * g + 1 as two
// roundings, so the two agree exactly.
//
// Bound on an H100 (3.35 TB/s): bytes. It must read 28.8 MB of per-point
// input (range, px, py) and 8.4 MB of image, and write 9.6 MB of labels.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kChunk = 1024;         // most records one vote block takes
constexpr int kBinThreads = 1024;    // threads of tile_count / tile_scatter
constexpr int kCountPer = 8;         // points per thread there
constexpr int kScanThreads = 1024;
constexpr size_t kMaxHistBytes = 232448;  // tile_count's histogram
constexpr unsigned int kLabelMask = 31u;
constexpr float kKnockedOut = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

struct InvGauss {
  float v[49];  // up to 7 x 7
};

struct Geometry {
  int p, h, w;
  int tiles_x, tiles_per_img;        // ceil(W/128), ceil(H/8) * tiles_x
  int n_pixels;                      // B * H * W
};

// The pixel of point (b, j) after the clip of the JAX take(mode="clip") on
// the flat (B*H*W) row index, and its tile.
__device__ __forceinline__ void locate(const Geometry& g, int b, int py,
                                       int px, int* img, int* y, int* x,
                                       int* tile) {
  if (py >= 0 && py < g.h && px >= 0 && px < g.w) {
    *img = b;
    *y = py;
    *x = px;
  } else {
    const long long hw = (long long)g.h * g.w;
    long long flat = b * hw + (long long)py * g.w + px;
    flat = flat < 0 ? 0 : (flat >= g.n_pixels ? g.n_pixels - 1 : flat);
    *img = (int)(flat / hw);
    const int rem = (int)(flat - *img * hw);
    *y = rem / g.w;
    *x = rem - *y * g.w;
  }
  *tile = *img * g.tiles_per_img + (*y / kTileH) * g.tiles_x + *x / kTileW;
}

// grid (ceil(P / (kBinThreads * kCountPer)), B); dynamic smem: n_tiles
// ints. Each block reserves a range of every tile it touches:
// block_base[block][tile].
__global__ void __launch_bounds__(kBinThreads)
tile_count(const int32_t* __restrict__ px, const int32_t* __restrict__ py,
           Geometry g, int n_tiles, int32_t* __restrict__ counts,
           int32_t* __restrict__ block_base) {
  extern __shared__ int hist[];
  for (int t = threadIdx.x; t < n_tiles; t += kBinThreads) hist[t] = 0;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kBinThreads * kCountPer + threadIdx.x;
  int qx[kCountPer], qy[kCountPer];
#pragma unroll
  for (int u = 0; u < kCountPer; ++u) {      // every load in flight at once
    const int j = j0 + u * kBinThreads;
    qx[u] = j < g.p ? __ldg(px + b * g.p + j) : 0;
    qy[u] = j < g.p ? __ldg(py + b * g.p + j) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kCountPer; ++u) {
    int img, y, x, tile = -1;
    if (j0 + u * kBinThreads < g.p)
      locate(g, b, qy[u], qx[u], &img, &y, &x, &tile);
    // one shared atomic per tile per warp: the padding slots of a scan all
    // sit on one pixel
    const unsigned group = __match_any_sync(kFull, tile);
    if (tile >= 0 && lane == __ffs(group) - 1)
      atomicAdd(hist + tile, __popc(group));
  }
  __syncthreads();
  int32_t* base = block_base + (size_t)(b * gridDim.x + blockIdx.x) * n_tiles;
  for (int t = threadIdx.x; t < n_tiles; t += kBinThreads)
    if (hist[t]) base[t] = atomicAdd(counts + t, hist[t]);
}

// one block of kScanThreads: tile offsets and the chunk table
__global__ void __launch_bounds__(kScanThreads)
tile_scan(const int32_t* __restrict__ counts, int n_tiles,
          int32_t* __restrict__ offsets, int4* __restrict__ chunks,
          int32_t* __restrict__ n_chunks) {
  __shared__ int warp_pts[32], warp_chk[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(tid * per, n_tiles), t1 = min(t0 + per, n_tiles);
  int pts = 0, chk = 0;
  for (int t = t0; t < t1; ++t) {
    pts += counts[t];
    chk += (counts[t] + kChunk - 1) / kChunk;
  }
  // inclusive warp scans, then the warps' totals
  int ip = pts, ic = chk;
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFull, ip, o), c = __shfl_up_sync(kFull, ic, o);
    if (lane >= o) {
      ip += a;
      ic += c;
    }
  }
  if (lane == 31) {
    warp_pts[warp] = ip;
    warp_chk[warp] = ic;
  }
  __syncthreads();
  if (warp == 0) {
    int a = warp_pts[lane], c = warp_chk[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, a, o), y = __shfl_up_sync(kFull, c, o);
      if (lane >= o) {
        a += x;
        c += y;
      }
    }
    warp_pts[lane] = a;              // inclusive over warps
    warp_chk[lane] = c;
  }
  __syncthreads();
  int off = ip - pts + (warp ? warp_pts[warp - 1] : 0);
  int ch = ic - chk + (warp ? warp_chk[warp - 1] : 0);
  for (int t = t0; t < t1; ++t) {
    const int n = counts[t];
    offsets[t] = off;
    for (int s = 0; s < n; s += kChunk)
      chunks[ch++] = make_int4(t, off + s, min(kChunk, n - s), 0);
    off += n;
  }
  if (tid == kScanThreads - 1) *n_chunks = ch;
}

// the blocks of tile_count; dynamic smem: n_tiles ints
__global__ void __launch_bounds__(kBinThreads)
tile_scatter(const float* __restrict__ point_range,
             const int32_t* __restrict__ px, const int32_t* __restrict__ py,
             Geometry g, int n_tiles, const int32_t* __restrict__ offsets,
             const int32_t* __restrict__ block_base,
             int4* __restrict__ records) {
  extern __shared__ unsigned int next[];   // next free slot of each tile
  const int b = blockIdx.y;
  const int32_t* base =
      block_base + (size_t)(b * gridDim.x + blockIdx.x) * n_tiles;
  // unsigned: a tile this block does not touch holds a stale base, unused
  for (int t = threadIdx.x; t < n_tiles; t += kBinThreads)
    next[t] = (unsigned int)offsets[t] + (unsigned int)base[t];
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kBinThreads * kCountPer + threadIdx.x;
  int qx[kCountPer], qy[kCountPer];
  float qr[kCountPer];
#pragma unroll
  for (int u = 0; u < kCountPer; ++u) {      // every load in flight at once
    const int j = j0 + u * kBinThreads;
    const bool live = j < g.p;
    qx[u] = live ? __ldg(px + b * g.p + j) : 0;
    qy[u] = live ? __ldg(py + b * g.p + j) : 0;
    qr[u] = live ? __ldg(point_range + b * g.p + j) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kCountPer; ++u) {
    const int j = j0 + u * kBinThreads;
    const bool live = j < g.p;
    int img = 0, y = 0, x = 0, tile = -1;
    if (live) locate(g, b, qy[u], qx[u], &img, &y, &x, &tile);
    const unsigned group = __match_any_sync(kFull, tile);
    const int leader = __ffs(group) - 1;
    unsigned int slot = 0;
    if (live && lane == leader) slot = atomicAdd(next + tile, __popc(group));
    slot = __shfl_sync(kFull, slot, leader) + __popc(group & ((1u << lane) - 1u));
    if (live) records[slot] = make_int4(b * g.p + j, __float_as_int(qr[u]), y, x);
  }
}

// bits of a count up to n: the bit-sliced vote planes
__host__ __device__ constexpr int count_bits(int n) {
  return n < 2 ? 1 : 1 + count_bits(n / 2);
}

// One block per chunk. L > 0: knn == L, and the L smallest packed distances
// are kept by a min/max insertion list (2 L operations a tap, no selects);
// L == 0: any knn, by knn rounds of first-minimum extraction. Both give the
// multiset of the knn smallest values, which is what the twin's topk gives.
template <int S, int L>
__global__ void __launch_bounds__(kThreads)
tile_vote(const unsigned int* __restrict__ packed,
          const int4* __restrict__ chunks, const int32_t* __restrict__ n_chunks,
          const int4* __restrict__ records, const InvGauss gauss, Geometry g,
          int32_t* __restrict__ out, int n_classes, int knn, float cutoff) {
  constexpr int S2 = S * S;
  constexpr int kPad = S / 2;
  constexpr int kCenter = S2 / 2;
  constexpr int kWinH = kTileH + 2 * kPad;
  constexpr int kWinW = kTileW + 2 * kPad;
  constexpr int kLd = kWinW + 1;
  constexpr int kPlanes = L > 0 ? count_bits(L) : count_bits(S2);
  __shared__ unsigned int win[kWinH * kLd];
  if ((int)blockIdx.x >= *n_chunks) return;
  const int4 chunk = chunks[blockIdx.x];
  const int tile = chunk.x;
  const int img = tile / g.tiles_per_img;
  const int rt = tile - img * g.tiles_per_img;
  const int ty = rt / g.tiles_x;
  const int y0 = ty * kTileH - kPad;
  const int x0 = (rt - ty * g.tiles_x) * kTileW - kPad;
  const unsigned int* image = packed + img * (g.h * g.w);
  for (int e = threadIdx.x; e < kWinH * kWinW; e += kThreads) {
    const int r = e / kWinW, c = e - r * kWinW;
    const int yy = y0 + r, xx = x0 + c;
    const bool inside = yy >= 0 && yy < g.h && xx >= 0 && xx < g.w;
    win[r * kLd + c] = inside ? __ldg(image + yy * g.w + xx) : 0u;
  }
  __syncthreads();

  const unsigned int valid_labels = ((1u << n_classes) - 1u) & ~1u;
  for (int e = threadIdx.x; e < chunk.z; e += kThreads) {
    const int4 rec = records[chunk.y + e];
    const float r0 = __int_as_float(rec.y);
    const unsigned int* wp =
        win + (rec.z - y0 - kPad) * kLd + (rec.w - x0 - kPad);
    float work[S2];
#pragma unroll
    for (int t = 0; t < S2; ++t) {
      const unsigned int bits = wp[(t / S) * kLd + t % S];
      const float r = (t == kCenter) ? r0 : __uint_as_float(bits & ~kLabelMask);
      const float d = fabsf(r - r0) * gauss.v[t] + 1.0f;
      work[t] = __uint_as_float((__float_as_uint(d) & ~kLabelMask) |
                                (bits & kLabelMask));
    }
    unsigned int plane[kPlanes];
#pragma unroll
    for (int q = 0; q < kPlanes; ++q) plane[q] = 0u;
    // one pick: its label (the invalid class C past the cutoff) counted in
    // the bit-sliced planes
    auto vote = [&](float m) {
      const unsigned int mbits = __float_as_uint(m);
      unsigned int label = mbits & kLabelMask;
      if (cutoff > 0.0f && __uint_as_float(mbits & ~kLabelMask) - 1.0f > cutoff)
        label = (unsigned int)n_classes;
      unsigned int carry = 1u << label;
#pragma unroll
      for (int q = 0; q < kPlanes; ++q) {
        const unsigned int c = plane[q] & carry;
        plane[q] ^= carry;
        carry = c;
      }
    };
    if constexpr (L > 0) {
      float best[L];
#pragma unroll
      for (int q = 0; q < L; ++q) best[q] = kKnockedOut;
#pragma unroll
      for (int t = 0; t < S2; ++t) {
        float v = work[t];
#pragma unroll
        for (int q = 0; q < L; ++q) {
          const float lo = fminf(best[q], v);
          v = fmaxf(best[q], v);
          best[q] = lo;
        }
      }
#pragma unroll
      for (int q = 0; q < L; ++q) vote(best[q]);
    } else {
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
        vote(m);
#pragma unroll
        for (int t = 0; t < S2; ++t) {
          if (t == j) work[t] = kKnockedOut;
        }
      }
    }
    // the classes 1..C-1 with the most votes; the lowest of them (all of
    // them, so class 1, when no pick counts)
    unsigned int cand = valid_labels;
#pragma unroll
    for (int q = kPlanes - 1; q >= 0; --q) {
      const unsigned int t = cand & plane[q];
      if (t) cand = t;
    }
    out[rec.x] = __ffs(cand) - 1;
  }
}

struct VoteArgs {
  int grid;
  const unsigned int* packed;
  const int4* chunks;
  const int32_t* n_chunks;
  const int4* records;
  InvGauss gauss;
  Geometry g;
  int32_t* out;
  int n_classes, knn;
  float cutoff;
  cudaStream_t stream;
};

template <int S, int L>
cudaError_t launch_vote(const VoteArgs& a) {
  tile_vote<S, L><<<a.grid, kThreads, 0, a.stream>>>(
      a.packed, a.chunks, a.n_chunks, a.records, a.gauss, a.g, a.out,
      a.n_classes, a.knn, a.cutoff);
  return cudaGetLastError();
}

// the insertion list for knn <= 8, the extraction rounds above
template <int S>
cudaError_t launch_vote_k(const VoteArgs& a) {
  switch (a.knn) {
    case 1: return launch_vote<S, 1>(a);
    case 2: return launch_vote<S, 2>(a);
    case 3: return launch_vote<S, 3>(a);
    case 4: return launch_vote<S, 4>(a);
    case 5: return launch_vote<S, 5>(a);
    case 6: return launch_vote<S, 6>(a);
    case 7: return launch_vote<S, 7>(a);
    case 8: return launch_vote<S, 8>(a);
    default: return launch_vote<S, 0>(a);
  }
}

// Layout of the int32 scratch of one call, in int32 words: records (B*P
// int4, first, so 16-byte aligned), chunks (n_tiles + ceil(B*P / 1024)
// int4), counts and offsets (n_tiles each), block_base (B * ceil(P / 8192)
// * n_tiles), n_chunks (1); n_tiles = B * ceil(H/8) * ceil(W/128).
struct Scratch {
  int64_t n_tiles, max_chunks, records, chunks, counts, offsets, block_base,
      n_chunks, total;
};

Scratch scratch_layout(int64_t b, int64_t p, int64_t h, int64_t w) {
  Scratch s;
  s.n_tiles = b * ((h + kTileH - 1) / kTileH) * ((w + kTileW - 1) / kTileW);
  s.max_chunks = s.n_tiles + (b * p + kChunk - 1) / kChunk;
  const int64_t n_blocks_x =
      (p + kBinThreads * kCountPer - 1) / (kBinThreads * kCountPer);
  s.records = 0;
  s.chunks = s.records + 4 * b * p;
  s.counts = s.chunks + 4 * s.max_chunks;
  s.offsets = s.counts + s.n_tiles;
  s.block_base = s.offsets + s.n_tiles;
  s.n_chunks = s.block_base + b * n_blocks_x * s.n_tiles;
  s.total = s.n_chunks + 1;
  return s;
}

// The binning kernels may use up to kMaxHistBytes of dynamic shared memory:
// set once per device (the attribute call costs host time on every launch
// otherwise).
cudaError_t allow_histograms() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && done[device])) return err;
  for (const void* f : {(const void*)tile_count, (const void*)tile_scatter}) {
    cudaFuncAttributes attr;              // the limit counts static smem too
    if ((err = cudaFuncGetAttributes(&attr, f)) != cudaSuccess) return err;
    err = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxHistBytes) -
                                   static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
  }
  if (device < kMaxDevices) done[device] = true;
  return cudaSuccess;
}

}  // namespace

// int32 words of device scratch that c3d_knn_vote needs at this shape
extern "C" int64_t c3d_knn_vote_scratch(int64_t b, int64_t p, int32_t h,
                                        int32_t w) {
  return scratch_layout(b, p, h, w).total;
}

// packed (B, H, W) float32 bits, point_range (B, P) float32, px/py (B, P)
// int32, out (B, P) int32: device pointers, contiguous. inv_gauss is a HOST
// pointer to search*search floats, passed to the kernel by value. scratch:
// c3d_knn_vote_scratch(b, p, h, w) int32 words of device memory, 16-byte
// aligned, carved (and its tile counts zeroed) here. Launched on `stream`;
// returns the CUDA error code (0 = ok).
extern "C" int c3d_knn_vote(const void* packed, const void* point_range,
                            const void* px, const void* py,
                            const void* inv_gauss, void* out, void* scratch,
                            int64_t b, int64_t p, int32_t h, int32_t w,
                            int32_t search, int32_t n_classes, int32_t knn,
                            float cutoff, void* stream) {
  if (search != 3 && search != 5 && search != 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_classes < 2 || n_classes > 31 || knn < 1 || knn > search * search)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * p > INT32_MAX || b * h * (int64_t)w > INT32_MAX || h < 1 ||
      w < 1 || h > 65535 || w > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b * p == 0) return 0;
  const Scratch lay = scratch_layout(b, p, h, w);
  if (static_cast<size_t>(lay.n_tiles) * sizeof(int) > kMaxHistBytes ||
      lay.max_chunks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>(lay.n_tiles);
  Geometry g;
  g.p = static_cast<int>(p);
  g.h = h;
  g.w = w;
  g.tiles_x = (w + kTileW - 1) / kTileW;
  g.tiles_per_img = ((h + kTileH - 1) / kTileH) * g.tiles_x;
  g.n_pixels = static_cast<int>(b * h * w);
  InvGauss gauss;
  std::memset(&gauss, 0, sizeof(gauss));
  std::memcpy(gauss.v, inv_gauss, sizeof(float) * search * search);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* base = static_cast<int32_t*>(scratch);
  auto* rec = reinterpret_cast<int4*>(base + lay.records);
  auto* chk = reinterpret_cast<int4*>(base + lay.chunks);
  int32_t* cnt = base + lay.counts;
  int32_t* off = base + lay.offsets;
  int32_t* bb = base + lay.block_base;
  int32_t* nch = base + lay.n_chunks;
  const auto* pxi = static_cast<const int32_t*>(px);
  const auto* pyi = static_cast<const int32_t*>(py);

  const size_t hist_bytes = sizeof(int) * static_cast<size_t>(n_tiles);
  cudaError_t err = allow_histograms();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(cnt, 0, hist_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kBinThreads * kCountPer;
  const dim3 point_grid((g.p + per_block - 1) / per_block, (unsigned)b);
  tile_count<<<point_grid, kBinThreads, hist_bytes, s>>>(pxi, pyi, g, n_tiles,
                                                         cnt, bb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_scan<<<1, kScanThreads, 0, s>>>(cnt, n_tiles, off, chk, nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  tile_scatter<<<point_grid, kBinThreads, hist_bytes, s>>>(
      static_cast<const float*>(point_range), pxi, pyi, g, n_tiles, off, bb,
      rec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const VoteArgs va{static_cast<int>(lay.max_chunks),
                    static_cast<const unsigned int*>(packed), chk, nch, rec,
                    gauss, g, static_cast<int32_t*>(out), n_classes, knn,
                    cutoff, s};
  switch (search) {
    case 3: err = launch_vote_k<3>(va); break;
    case 5: err = launch_vote_k<5>(va); break;
    default: err = launch_vote_k<7>(va); break;
  }
  return static_cast<int>(err);
}
