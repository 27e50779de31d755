// Kernel K4: one SqueezeSegV3 SAC block's attention and 1x1 mix, fused,
// hand-written for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces no TPU kernel: the JAX package's SAC block is plain XLA. It was
// added because the serving forward spent most of its time writing and
// reading the block's 9c-channel maps. Per pixel it computes
//
//   y = ReLU(W2' . (unfold3x3(feature) * sigmoid(W1' . patch7x7(xyz) + b1'))
//            + b2')
//
// where W1', b1' are the 7x7 attention conv with its BatchNorm folded in and
// W2', b2' the 1x1 conv with its BatchNorm folded in (ops/sac_fused.py folds
// them on the host in float32 and rounds to bf16), and writes only the
// c-channel output, bf16, NCHW. Neither the 9c-channel attention map nor the
// unfold is ever written: at B=8 on a 64x2048 image each is 604 MB.
//
// The 9c dimension is tap-major (index tap * c + channel; the host permutes
// W1's rows and W2's columns the same way), so one 32-channel step of the
// second product's depth is one tap (dy, dx) of a 32-channel chunk of the
// features, and its feature operand is a shifted read of a staged tile.
//
// One block of two warpgroups owns a row segment of 128 pixels, 64 a
// warpgroup (the M of wgmma), 16 a warp:
//   - the xyz rows y-3..y+3 and, per 32-channel chunk, the feature rows
//     y-1..y+1 (columns x0-8 .. x0+135) come in by cp.async with the
//     weights; each warp builds its [16 x 160] patch (147 taps padded to
//     160) once, as ten register A fragments;
//   - each step streams [32 x 160] of W1' and [c x 32] of W2', stored as
//     8x8 core matrices (the no-swizzle wgmma layout, packed so on the
//     host), through a ring of 3 or 4 stages. Product 1 is ten wgmma
//     m64n32k16 with A from registers and B from shared memory; the float32
//     logits it leaves in registers take the bias, the sigmoid (float32) and
//     the product with the shifted features, and, rounded to bf16, are
//     already the register A fragments of product 2 (the accumulator layout
//     of two n8 columns is the A layout of one k16 slice): two wgmma
//     m64nck16 add them into the warpgroup's float32 [64 x c] accumulator;
//   - the epilogue adds b2', applies ReLU and goes through shared memory
//     for coalesced 16-byte stores.
// A stage is refilled two steps after it was read, when every warpgroup has
// waited for the products that read it. Blocks of c <= 64 run two an SM.
//
// What bounds it on this card: bf16 tensor-core operations. At B=8 every
// block of SqueezeSegV3-21 does 2 * B*H*W * 9c * (147 + c) useful flops
// (108 GFLOP at c = 32, 0.11 ms at 989 TFLOP/s; 243 GFLOP at c = 256),
// against about 140 MB in and out (0.04 ms at 3.35 TB/s). The taps are
// padded from 147 to 160 (8 % more work in product 1). The sigmoid is two
// special-function operations (ex2, rcp): 8192 a step of a block, 512 clocks
// of an SM's 16 units, run between the two products while this block's
// tensor work waits (a second block on the SM, at c <= 64, fills the gap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPix = kWarps * 16;    // pixels of one block: a row segment
constexpr int kStepC = 32;           // channels of one step
constexpr int kTaps1 = 147;          // 3 channels x 7 x 7
constexpr int kK1 = 160;             // padded to ten k16 slices
// staged image rows: columns x0-8 .. x0+135, 18 16-byte chunks
constexpr int kTileChunks = kPix / 8 + 2;
constexpr int kTileCols = kTileChunks * 8;
constexpr int kTileLd = kTileCols + 8;    // 76 words: conflict-free feature reads
constexpr int kFeatRowsLd = 3 * kTileLd;  // one channel's three rows
constexpr int kFeatHalves = kStepC * kFeatRowsLd;
constexpr int kXyzHalves = 3 * 7 * kTileLd;
constexpr int kOutLd = kPix + 8;

template <int C>
struct Shape {
  static constexpr int kSteps = 9 * C / kStepC;  // (chunk of 32 channels, tap)
  // the weight ring: a stage is refilled two steps after the step that read
  // it, kAhead steps before it is read. Three stages at c = 64 fit two
  // blocks an SM (as at c = 32, whose 4 stages fit): 0.63 -> 0.49 ms at
  // B=8, 64x1024 (H100, 700 W)
  static constexpr int kStages = C == 64 ? 3 : 4;
  static constexpr int kAhead = kStages - 2;
  static constexpr int kW1Halves = kStepC * kK1;
  static constexpr int kStepHalves = kW1Halves + C * kStepC;
};

template <int C>
constexpr int smem_bytes() {
  const int body =
      Shape<C>::kStages * Shape<C>::kStepHalves + 2 * kFeatHalves + kXyzHalves + 2 * kK1;
  const int out = C * kOutLd;
  return 2 * (body > out ? body : out);
}

__device__ __forceinline__ float bf(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src));
}

// 16 bytes, or 16 zero bytes where src_bytes is 0 (nothing is read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// what cp.async wrote is read next by wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers an asynchronous wgmma reads or writes stay where they are, and
// live, until this point
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// a K-major B operand of 8x8 core matrices, no swizzle: `lbo` bytes between
// core matrices along K, `sbo` bytes between groups of 8 rows along N; the
// start address is the low field, in 16-byte units, so adding n to the
// descriptor moves its start 16 n bytes on
__device__ __forceinline__ uint64_t desc_b(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// float32 sigmoid; exp of a large argument is +inf and 1 / inf is 0
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// d (+)= a . B for a warpgroup: wgmma m64nNk16, bf16 A from registers (the
// mma.m16n8k16 A fragment of the warp's 16 rows), B from shared memory;
// d is the warp's 16 x N float32 tile as N/8 mma.m16n8 accumulators
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int C>
__global__ void __launch_bounds__(kThreads, C <= 64 ? 2 : 1)
    sac_fused_kernel(const uint16_t* __restrict__ xyz,   // (B, 3, H, W) bf16
                     const uint16_t* __restrict__ feat,  // (B, C, H, W) bf16
                     const uint16_t* __restrict__ wsteps,
                     const float* __restrict__ b1,  // (steps, 32)
                     const float* __restrict__ b2,  // (C)
                     uint16_t* __restrict__ out, int H, int W) {
  using S = Shape<C>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* const stages = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* const feat_s = stages + S::kStages * S::kStepHalves;
  uint16_t* const xyz_s = feat_s + 2 * kFeatHalves;
  int* const off_s = reinterpret_cast<int*>(xyz_s + kXyzHalves);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int p0 = warp * 16;
  const int x0 = blockIdx.x * kPix, y = blockIdx.y, b = blockIdx.z;
  const size_t plane = static_cast<size_t>(H) * W;
  const bool vec = (W & 7) == 0;  // 16-byte rows: x0 - 8 is 16-byte aligned

  // rows [y0, y0 + n) of `planes` image planes from `src`, columns x0-8 ..
  // x0+135, into [plane][row][kTileLd], zero outside the image: cp.async
  // where rows are 16-byte aligned, plain loads where they are not
  auto stage_rows = [&](uint16_t* dst, const uint16_t* src, int planes, int y0, int n) {
    if (vec) {
#pragma unroll 1
      for (int i = tid; i < planes * n * kTileChunks; i += kThreads) {
        const int v = i % kTileChunks, pr = i / kTileChunks;
        const int yy = y0 + pr % n, xg = x0 - 8 + v * 8;
        const bool in = yy >= 0 && yy < H && xg >= 0 && xg < W;
        const uint16_t* s = in ? src + (pr / n) * plane + static_cast<size_t>(yy) * W + xg : src;
        cp_async16_zfill(dst + pr * kTileLd + v * 8, s, in ? 16 : 0);
      }
    } else {
#pragma unroll 1
      for (int i = tid; i < planes * n * kTileCols; i += kThreads) {
        const int q = i % kTileCols, pr = i / kTileCols;
        const int yy = y0 + pr % n, xx = x0 - 8 + q;
        dst[pr * kTileLd + q] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                                    ? src[(pr / n) * plane + static_cast<size_t>(yy) * W + xx]
                                    : uint16_t(0);
      }
    }
  };

  // step s's weights (one contiguous copy: the host packed them as the
  // stage holds them) and, at a new 32-channel chunk, its feature rows
  // y-1..y+1 into the chunk's half of the double buffer
  auto load_step = [&](int s) {
    const uint16_t* src = wsteps + static_cast<size_t>(s) * S::kStepHalves;
    uint16_t* dst = stages + (s % S::kStages) * S::kStepHalves;
#pragma unroll 1
    for (int i = tid; i < S::kStepHalves / 8; i += kThreads) cp_async16(dst + i * 8, src + i * 8);
    if (s % 9 == 0) {
      const int fc = s / 9;
      stage_rows(feat_s + (fc & 1) * kFeatHalves,
                 feat + (static_cast<size_t>(b) * C + fc * kStepC) * plane, kStepC, y - 1, 3);
    }
  };

  // group 0: step 0, its features and the xyz rows y-3..y+3; then one group
  // a step, kAhead steps ahead
  stage_rows(xyz_s, xyz + static_cast<size_t>(b) * 3 * plane, 3, y - 3, 7);
#pragma unroll 1
  for (int s = 0; s < S::kAhead; ++s) {
    load_step(s);
    cp_async_commit();
  }
  // patch column k = channel * 49 + ky * 7 + kx (the conv weight's layout)
  // reads xyz_s at off_s[k] + pixel; the padding taps read 0
  if (tid < kK1) {
    const int ci = tid / 49, r = tid % 49;
    off_s[tid] = tid < kTaps1 ? (ci * 7 + r / 7) * kTileLd + r % 7 + 5 : -1;
  }
  cp_async_wait<S::kAhead - 1>();
  __syncthreads();

  auto patch = [&](int p, int k) -> uint16_t {
    const int o = off_s[k];
    return o < 0 ? uint16_t(0) : xyz_s[o + p];
  };
  uint32_t a1[10][4];
#pragma unroll
  for (int ks = 0; ks < 10; ++ks) {
    const int k = ks * 16 + 2 * t;
    a1[ks][0] = pack_bits(patch(p0 + g, k), patch(p0 + g, k + 1));
    a1[ks][1] = pack_bits(patch(p0 + g + 8, k), patch(p0 + g + 8, k + 1));
    a1[ks][2] = pack_bits(patch(p0 + g, k + 8), patch(p0 + g, k + 9));
    a1[ks][3] = pack_bits(patch(p0 + g + 8, k + 8), patch(p0 + g + 8, k + 9));
    asm volatile("" ::: "memory");  // one slice's loads at a time
  }

  float acc1[16];     // the warp's 16 pixels x 32 attention logits
  float acc2[C / 2];  // the warp's 16 pixels x C outputs
  uint32_t a2[2][4];  // product 2's A: two k16 slices of 16 x 32

  for (int s = 0; s < S::kSteps; ++s) {
    cp_async_wait<S::kAhead - 1>();
    fence_proxy_async();
    __syncthreads();
    if (s + S::kAhead < S::kSteps) load_step(s + S::kAhead);  // the stage step s-2 used
    cp_async_commit();

    const uint16_t* w1s = stages + (s % S::kStages) * S::kStepHalves;
    const uint16_t* w2s = w1s + S::kW1Halves;
    const int tap = s % 9, dy = tap / 3 - 1, dx = tap % 3 - 1;

    // product 1: [64 x 160] patch x [160 x 32]: W1' is 4 x 20 core
    // matrices, row groups 20 * 128 bytes apart
    const uint64_t d1 = desc_b(w1s, 128, 20 * 128);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 10; ++ks) wgmma_rs<32>(acc1, a1[ks], d1 + ks * 16, ks > 0);
    wgmma_commit();
    wgmma_wait<0>();  // and product 2 of the step before
    hold(acc1);
    hold(a2[0]);
    hold(a2[1]);

    // bias, sigmoid, times the features at this tap -> A of product 2
    const float* bias = b1 + s * kStepC;
    const uint16_t* frow =
        feat_s + ((s / 9) & 1) * kFeatHalves + (dy + 1) * kTileLd + p0 + g + dx + 8;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
      const uint16_t* f0 = frow + col * kFeatRowsLd;  // channel col
      const uint16_t* f1 = f0 + kFeatRowsLd;          // channel col + 1
      a2[nt >> 1][(nt & 1) * 2] = pack_bf16(sigmoid(acc1[4 * nt] + bb.x) * bf(f0[0]),
                                            sigmoid(acc1[4 * nt + 1] + bb.y) * bf(f1[0]));
      a2[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(sigmoid(acc1[4 * nt + 2] + bb.x) * bf(f0[8]),
                                                sigmoid(acc1[4 * nt + 3] + bb.y) * bf(f1[8]));
    }

    // product 2: [64 x 32] x [32 x C] into the accumulator: W2' is C/8 x 4
    // core matrices, row groups 4 * 128 bytes apart
    const uint64_t d2 = desc_b(w2s, 128, 4 * 128);
    wgmma_fence();
    wgmma_rs<C>(acc2, a2[0], d2, s > 0);
    wgmma_rs<C>(acc2, a2[1], d2 + 16, 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  hold(acc2);
  hold(a2[0]);
  hold(a2[1]);

  // epilogue: bias, ReLU, bf16 through shared memory ([C][128 + 8])
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* const out_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int o = nt * 8 + 2 * t, p = p0 + g;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + o));
    out_s[o * kOutLd + p] = __float2bfloat16(fmaxf(acc2[4 * nt] + bb.x, 0.0f));
    out_s[(o + 1) * kOutLd + p] = __float2bfloat16(fmaxf(acc2[4 * nt + 1] + bb.y, 0.0f));
    out_s[o * kOutLd + p + 8] = __float2bfloat16(fmaxf(acc2[4 * nt + 2] + bb.x, 0.0f));
    out_s[(o + 1) * kOutLd + p + 8] = __float2bfloat16(fmaxf(acc2[4 * nt + 3] + bb.y, 0.0f));
  }
  __syncthreads();
  uint16_t* const obase =
      out + static_cast<size_t>(b) * C * plane + static_cast<size_t>(y) * W + x0;
  const uint16_t* const out_u = reinterpret_cast<const uint16_t*>(out_s);
  if (vec) {
    for (int i = tid; i < C * kPix / 8; i += kThreads) {
      const int o = i / (kPix / 8), v = i % (kPix / 8);
      if (x0 + v * 8 < W)
        *reinterpret_cast<uint4*>(obase + o * plane + v * 8) =
            *reinterpret_cast<const uint4*>(out_u + o * kOutLd + v * 8);
    }
  } else {
    for (int i = tid; i < C * kPix; i += kThreads) {
      const int o = i / kPix, p = i % kPix;
      if (x0 + p < W) obase[o * plane + p] = out_u[o * kOutLd + p];
    }
  }
}

template <int C>
cudaError_t launch(const uint16_t* xyz, const uint16_t* feat, const uint16_t* wsteps,
                   const float* b1, const float* b2, uint16_t* out, int B, int H, int W,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<C>();
  auto kernel = sac_fused_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kPix - 1) / kPix, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(xyz, feat, wsteps, b1, b2, out, H, W);
  return cudaGetLastError();
}

}  // namespace

// One SAC block's fused attention and 1x1 mix. xyz (B, 3, H, W) and feat
// (B, C, H, W) bf16, contiguous, 16-byte aligned; wsteps: the folded,
// tap-major weights in step order and core-matrix layout
// (ops/sac_fused.py:pack_steps), 9*C/32 steps of 32*160 + C*32 bf16; b1
// (9*C/32, 32) and b2 (C) float32; out (B, C, H, W) bf16. Takes C in
// {32, 64, 128, 256}.
extern "C" int c3d_sac_fused(const void* xyz, const void* feat, const void* wsteps,
                             const float* b1, const float* b2, void* out, int B,
                             int C, int H, int W, cudaStream_t stream) {
  if (B < 1 || H < 1 || W < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const uint16_t*>(xyz);
  const auto* f = static_cast<const uint16_t*>(feat);
  const auto* w = static_cast<const uint16_t*>(wsteps);
  auto* o = static_cast<uint16_t*>(out);
  switch (C) {
    case 32:
      return static_cast<int>(launch<32>(x, f, w, b1, b2, o, B, H, W, stream));
    case 64:
      return static_cast<int>(launch<64>(x, f, w, b1, b2, o, B, H, W, stream));
    case 128:
      return static_cast<int>(launch<128>(x, f, w, b1, b2, o, B, H, W, stream));
    case 256:
      return static_cast<int>(launch<256>(x, f, w, b1, b2, o, B, H, W, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
