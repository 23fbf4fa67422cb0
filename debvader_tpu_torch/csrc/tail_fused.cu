// Fused decoder-tail conv pair on the tensor cores, two instances of one
// core:
//
// * dvt_tail_fused, at fidelity precision:
//     out = relu(conv2(prelu(conv1(x) + b1, alpha1)) + b2),
//   both convs SAME 3x3 stride 1, each as the 3-term round-to-nearest
//   bf16-limb product  xh*wh + xh*wm + xm*wh  with float32 accumulation (the
//   'bf16x3' scheme of models/precision.py), conv1's outputs off the image
//   zeroed before conv2 (its SAME padding must see zeros there, not conv1's
//   values).  Replaces the Pallas TPU kernel
//   debvader_tpu/kernels/tail_fused.py fused_tail_pair (_kernel, _limb3,
//   _split2, _rne).
// * dvt_decoder_tail_bf16, the one-limb instance: the bfloat16 decoder tail
//   of debvader_tpu/kernels/decoder_tail.py fused_decoder_tail (_tail_kernel
//   with a bfloat16 x): bf16 x and bf16 weights, one product of bf16 values
//   with float32 accumulation, h rounded to bf16 after the PReLU (the high
//   limb of the same split), the output rounded to bf16 after the ReLU.
//
// What is kept of the Pallas kernel is its arithmetic: hi = rne(v) (here by
// cvt.rn.bf16x2.f32, which rounds as the integer form, add 0x7FFF + the
// round bit and clear the low 16 bits, does for finite values), mid =
// bf16(v - hi) rounded to nearest even; the activations are split in the
// kernel (x at load, h1 after bias, PReLU and the off-image zeroing), the
// weights once by the wrapper; the three limb products are summed as
// (hh + hm) + mh.  Its flat (rows, W*C) layout, its over-read rows and its
// lane-packed weight concat are TPU workarounds and are not carried over.
//
// Bound on the H100: operations.  The function's products are bf16 x bf16
// into float32, P limb terms (3 or 1) x 2*9*C*(C1 + C2) a pixel, against x
// read once and out written once.  Design, for Hopper:
// * a persistent grid: one block of three warpgroups a multiprocessor (two
//   blocks for the one-limb instance), each walking the (image, 16x16 tile)
//   list (tile t at image t / tiles, row and column from t % tiles; block b
//   takes b, b + grid, ...).  Both convs' weight limbs are copied into
//   shared memory once a block, in the layout wgmma's B descriptor reads
//   without swizzling (8x8 core matrices of 128 contiguous bytes), the two
//   limbs stacked along N (the wrapper packs them:
//   kernels/tail_fused.pack_b_operand);
// * the x window: the third warpgroup is the loader.  While the other two
//   run a tile's conv2, it splits the next tile's 20x20 window, staged in
//   shared memory, into bf16 limb planes (two values a cvt.rn.bf16x2), then
//   starts the window after it on its way by 16-byte cp.async with zero
//   fill (the zero fill is conv1's SAME padding).  cp.async and not TMA:
//   the window is split in registers anyway, and the staging buffer is its
//   only other home;
// * the products run on wgmma.m64nNk16, one warpgroup a 64-pixel m-tile
//   (conv1: 6 m-tiles on the three warpgroups; conv2: 4 on the first two):
//   xh times both weight limbs in one wgmma of N = 64 (conv1; 32 for conv2,
//   C2 zero-padded to 16), xm times the high limb in one of N = 32 (16).
//   A comes from registers, filled by ldmatrix.x4 from the limb planes:
//   each lane hands ldmatrix the address of its own pixel row, which is how
//   the implicit im2col's shifted tap windows (which no shared-memory A
//   descriptor can describe) reach the tensor core.  Limb planes keep 40
//   values a pixel (80 bytes), so the eight rows of an ldmatrix fall on
//   separate banks;
// * a tap's two k-steps accumulate in the tensor core and the nine taps add
//   with IEEE adds (__fadd_rn) into one accumulator a limb product: the
//   tensor core's float32 accumulation truncates where it aligns addends,
//   and a chain of 18 k-steps would carry that bias all the way.  These adds
//   wait for their tap's products; the next tap's A fragments load while
//   the products run, and the three warpgroups keep the tensor cores fed
//   from one another's taps.  The PReLU alphas of a thread's pixels load
//   before the products;
// * conv1 computes 6 m-tiles for the 324 pixels of the 18x18 h1 tile with
//   its ring, conv2 4 for the 256 outputs; h1 never touches device memory.
// The kernel is held to its plain version by a tolerance, never bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                  // channels of x and of h1
constexpr int kN2 = 16;                 // conv2's output channels, zero-padded
constexpr int kTile = 16;
constexpr int kIn = kTile + 4;          // 20: x window
constexpr int kMid = kTile + 2;         // 18: h1 tile with its ring
constexpr int kPix = kC + 8;            // 40 bf16 a pixel in a limb plane
constexpr int kK = 9 * kC;              // 288
constexpr int kWG = 3;                  // warpgroups a block: 3 on conv1, 2 on conv2 + the loader
constexpr int kThreads = kWG * 128;
constexpr int kM1 = kMid * kMid;        // 324 h1 pixels
constexpr int kM1Tiles = (kM1 + 63) / 64;          // 6
constexpr int kM2Tiles = kTile * kTile / 64;       // 4

constexpr int kXPlane = kIn * kIn * kPix * 2;      // bytes of one limb plane of x
constexpr int kHPlane = kM1 * kPix * 2;            // bytes of one limb plane of h1
constexpr int kW1Limb = kK * kC * 2;               // bytes of one limb of conv1's weights
constexpr int kW2Limb = kK * kN2 * 2;

// Shared memory of an instance with `planes` limb planes and x elements of
// `xbytes` bytes: staging window, x planes, h1 planes, weight limbs, biases.
__host__ __device__ constexpr int shared_bytes(int planes, int xbytes) {
  return kIn * kIn * kC * xbytes + planes * (kXPlane + kHPlane + kW1Limb + kW2Limb) + 4 * (kC + kN2);
}

// (lo, hi) rounded to bf16, nearest even, packed lo first: one
// cvt.rn.bf16x2.f32, the same rounding as the integer form for finite values.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two limbs of (v0, v1), each a packed pair: hi = rne(v), mid = bf16(v - hi).
__device__ __forceinline__ void split2x2(float v0, float v1, uint32_t& hi, uint32_t& mid) {
  hi = bf16x2(v0, v1);
  mid = bf16x2(__fsub_rn(v0, __uint_as_float(hi << 16)), __fsub_rn(v1, __uint_as_float(hi & 0xFFFF0000u)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma shared-memory descriptor of a K-major B operand without swizzle:
// start address, leading byte offset (between the two 8-value halves of a
// k-step: 128 bytes), stride byte offset (between groups of 8 rows n: 256).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 32 f32, this thread's 16) (+)= a (64 x 16 bf16, registers) * B.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// d (64 x 16 f32, this thread's 8) (+)= a (64 x 16 bf16, registers) * B.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// d (64 x 64 f32, this thread's 32) (+)= a (64 x 16 bf16, registers) * B.
template <int SCALE_D>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(SCALE_D));
}

// d (64 x 8 NT f32) (+)= a * B, N = 8 NT columns of B.
template <int NT, int SCALE_D>
__device__ __forceinline__ void wgmma(float (&d)[NT * 4], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NT == 8)
    wgmma_n64<SCALE_D>(d, a, desc);
  else if constexpr (NT == 4)
    wgmma_n32<SCALE_D>(d, a, desc);
  else
    wgmma_n16<SCALE_D>(d, a, desc);
}

// One 64-row m-tile of an implicit-im2col product over the nine taps.
// a_hi / a_mid: shared addresses, in the two limb planes, of this lane's
// ldmatrix row at tap (0, 0) and channel (lane / 16) * 8; width: the
// source's row width in pixels; b: the B operand, P == 3: the weight limbs
// stacked along N (columns 0..8 NT - 1 the high limb, 8 NT..16 NT - 1 the
// middle one), so that one wgmma of N = 16 NT gives hh and hm and one of
// N = 8 NT (the high limb alone) gives mh; P == 1: one limb.
// S[0..P): the limb products hh (and hm, mh), tap sums added in order.
template <int NT, int P>
__device__ __forceinline__ void mtile_products(uint32_t a_hi, uint32_t a_mid, int width, uint32_t b,
                                               float (&S)[P][NT * 4]) {
  constexpr int L = P == 3 ? 2 : 1;
  constexpr int kStepBytes = L * NT * 8 * 16 * 2;  // one k-step of B
  float t[L * NT * 4];                              // this tap's hh (| hm, stacked)
  float mh[NT * 4];                                 // and mh (P == 3)
  uint32_t A[2][L][2][4];                           // a tap's A: [buffer][limb][k-step]
  auto load_a = [&](int tap, uint32_t (&a)[L][2][4]) {
    const uint32_t toff = ((tap / 3) * width + tap % 3) * kPix * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      ldmatrix_x4(a[0][half], a_hi + toff + half * 32);
      if constexpr (P == 3) ldmatrix_x4(a[1][half], a_mid + toff + half * 32);
    }
  };
  load_a(0, A[0]);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    uint32_t (&ah)[2][4] = A[tap & 1][0];
    uint32_t (&am)[2][4] = A[tap & 1][L - 1];
    fence_operand(t);
    if constexpr (P == 3) fence_operand(mh);
    wgmma_fence();
    const uint64_t d0 = b_desc(b + (2 * tap) * kStepBytes), d1 = b_desc(b + (2 * tap + 1) * kStepBytes);
    wgmma<L * NT, 0>(t, ah[0], d0);
    wgmma<L * NT, 1>(t, ah[1], d1);
    if constexpr (P == 3) {
      wgmma<NT, 0>(mh, am[0], d0);
      wgmma<NT, 1>(mh, am[1], d1);
    }
    wgmma_commit();
    // tap - 1's products are done: its A registers take tap + 1's
    // fragments, which load while this tap's products run
    if (tap < 8) load_a(tap + 1, A[(tap + 1) & 1]);
    wgmma_wait<0>();
    fence_operand(t);
    if constexpr (P == 3) fence_operand(mh);
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      S[0][i] = tap == 0 ? t[i] : __fadd_rn(S[0][i], t[i]);
      if constexpr (P == 3) {
        S[1][i] = tap == 0 ? t[NT * 4 + i] : __fadd_rn(S[1][i], t[NT * 4 + i]);
        S[2][i] = tap == 0 ? mh[i] : __fadd_rn(S[2][i], mh[i]);
      }
    }
  }
}

// (hh + hm) + mh, or the one product
template <int P, int R>
__device__ __forceinline__ float limb_sum(const float (&S)[P][R], int i) {
  if constexpr (P == 3) return __fadd_rn(__fadd_rn(S[0][i], S[1][i]), S[2][i]);
  return S[0][i];
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// P = 3: float32 x, two limb planes, the bf16x3 products, float32 out.
// P = 1: bfloat16 x, one plane, one product, bfloat16 out.
template <int P, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, P == 3 ? 1 : 2)
tail_pair_kernel(const XT* __restrict__ x, const uint16_t* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ a1, const uint16_t* __restrict__ w2, const float* __restrict__ b2,
                 OT* __restrict__ out, int n, int height, int width, int c2) {
  constexpr int L = P == 3 ? 2 : 1;                 // limb planes
  constexpr int kChunk = 16 / sizeof(XT);           // x values a 16-byte copy
  constexpr int kChunks = kC / kChunk;              // copies a pixel
  extern __shared__ __align__(128) unsigned char smem[];
  XT* stage = reinterpret_cast<XT*>(smem);                                  // [kIn * kIn][kC]
  unsigned char* xl = smem + kIn * kIn * kC * sizeof(XT);                   // L planes [400][kPix]
  unsigned char* hl = xl + L * kXPlane;                                     // L planes [324][kPix]
  unsigned char* w1s = hl + L * kHPlane;                                    // B operands, limbs stacked
  unsigned char* w2s = w1s + L * kW1Limb;
  float* b1s = reinterpret_cast<float*>(w2s + L * kW2Limb);
  float* b2s = b1s + kC;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;          // warpgroup, warp within it
  const int group = lane >> 2, tig = lane & 3;
  const int tiles_r = (height + kTile - 1) / kTile, tiles_c = (width + kTile - 1) / kTile;
  const int per_image = tiles_r * tiles_c;
  const int total = n * per_image;

  // ---- the weight limbs and biases, once a block
  for (int i = tid; i < L * kW1Limb / 16; i += kThreads)
    reinterpret_cast<uint4*>(w1s)[i] = reinterpret_cast<const uint4*>(w1)[i];
  for (int i = tid; i < L * kW2Limb / 16; i += kThreads)
    reinterpret_cast<uint4*>(w2s)[i] = reinterpret_cast<const uint4*>(w2)[i];
  if (tid < kC) b1s[tid] = b1[tid];
  if (tid < kN2) b2s[tid] = tid < c2 ? b2[tid] : 0.f;
  // the tensor cores read B through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // The last warpgroup is the loader: it brings tile t's window into the
  // staging buffer and splits it into the limb planes while the others run
  // the previous tile's conv2 (4 m-tiles, two a warpgroup).
  const bool loader = wg == kWG - 1;
  const int ltid = tid - (kWG - 1) * 128;
  auto loader_sync = [] { asm volatile("bar.sync 1, 128;\n" ::: "memory"); };
  auto load_window = [&](int t) {
    const int image = t / per_image, rem = t % per_image;
    const int r0 = (rem / tiles_c) * kTile, c0 = (rem % tiles_c) * kTile;
    const XT* xi = x + static_cast<size_t>(image) * height * width * kC;
    const uint32_t base = smem_addr(stage);
    for (int i = ltid; i < kIn * kIn * kChunks; i += 128) {
      const int pix = i / kChunks, q = i % kChunks;
      const int gr = r0 - 2 + pix / kIn, gc = c0 - 2 + pix % kIn;
      const bool in = gr >= 0 && gr < height && gc >= 0 && gc < width;
      const XT* src = in ? xi + (static_cast<size_t>(gr) * width + gc) * kC + q * kChunk : x;
      cp_async16(base + i * 16, src, in ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the staged window into the limb planes, then the window of tile `next`
  // into the staging buffer
  auto split_window = [&](int next) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    loader_sync();
    if constexpr (P == 3) {
      for (int i = ltid; i < kIn * kIn * (kC / 4); i += 128) {
        const int pix = i / (kC / 4), q = i % (kC / 4);
        const float4 v = reinterpret_cast<const float4*>(stage)[i];
        uint32_t h01, h23, m01, m23;
        split2x2(v.x, v.y, h01, m01);
        split2x2(v.z, v.w, h23, m23);
        const int at = (pix * kPix + q * 4) * 2;
        *reinterpret_cast<uint2*>(xl + at) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(xl + kXPlane + at) = make_uint2(m01, m23);
      }
    } else {
      for (int i = ltid; i < kIn * kIn * (kC / 8); i += 128) {
        const int pix = i / (kC / 8), q = i % (kC / 8);
        *reinterpret_cast<uint4*>(xl + (pix * kPix + q * 8) * 2) = reinterpret_cast<const uint4*>(stage)[i];
      }
    }
    loader_sync();
    if (next < total) load_window(next);
  };

  const int grid = static_cast<int>(gridDim.x);
  if (loader && static_cast<int>(blockIdx.x) < total) {
    load_window(blockIdx.x);
    split_window(blockIdx.x + grid);
  }
  for (int t = blockIdx.x; t < total; t += grid) {
    const int image = t / per_image, rem = t % per_image;
    const int r0 = (rem / tiles_c) * kTile, c0 = (rem % tiles_c) * kTile;
    __syncthreads();  // the limb planes hold tile t's window; h1 is free

    // ---- conv1: h1 on the 18x18 ring tile, 6 m-tiles of 64 pixels, all warpgroups
    for (int mt = wg; mt < kM1Tiles; mt += kWG) {
      // this lane's ldmatrix row; rows past the tile read its last pixel
      const int m = min(mt * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, kM1 - 1);
      const uint32_t aoff = (((m / kMid) * kIn + m % kMid) * kPix + (lane >> 4) * 8) * 2;
      // this thread's PReLU alphas (2 pixels x 4 channel pairs), loaded
      // before the products so that their latency hides behind them
      bool on_image[2];
      float2 alpha[2][4];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int p = mt * 64 + wq * 16 + group + row * 8;
        const int gr = r0 - 1 + p / kMid, gc = c0 - 1 + p % kMid;
        on_image[row] = p < kM1 && gr >= 0 && gr < height && gc >= 0 && gc < width;
        const float* ap = a1 + (on_image[row] ? (static_cast<size_t>(gr) * width + gc) * kC : 0) + tig * 2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) alpha[row][nt] = __ldg(reinterpret_cast<const float2*>(ap + nt * 8));
      }
      float S[P][16];
      mtile_products<4, P>(smem_addr(xl) + aoff, smem_addr(xl + kXPlane) + aoff, kIn, smem_addr(w1s), S);
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int p = mt * 64 + wq * 16 + group + row * 8;
        if (p >= kM1) continue;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int ch = nt * 8 + tig * 2;
          uint32_t hi = 0, mid = 0;
          if (on_image[row]) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[e] = __fadd_rn(limb_sum<P>(S, nt * 4 + row * 2 + e), b1s[ch + e]);
              v[e] = __fadd_rn(fmaxf(v[e], 0.f), __fmul_rn(e ? alpha[row][nt].y : alpha[row][nt].x, fminf(v[e], 0.f)));
            }
            if constexpr (P == 3)
              split2x2(v[0], v[1], hi, mid);
            else
              hi = bf16x2(v[0], v[1]);
          }
          *reinterpret_cast<uint32_t*>(hl + (p * kPix + ch) * 2) = hi;
          if constexpr (P == 3) *reinterpret_cast<uint32_t*>(hl + kHPlane + (p * kPix + ch) * 2) = mid;
        }
      }
    }
    __syncthreads();

    // ---- conv2: the 16x16 output tile, 4 m-tiles of 4 tile rows, all
    // warpgroups but the loader, which splits the next tile's window
    if (loader) {
      if (t + grid < total) split_window(t + 2 * grid);
      continue;
    }
    OT* oimg = out + static_cast<size_t>(image) * height * width * c2;
    for (int mt = wg; mt < kM2Tiles; mt += kWG - 1) {
      const int m = mt * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const uint32_t aoff = (((m / kTile) * kMid + m % kTile) * kPix + (lane >> 4) * 8) * 2;
      float S[P][8];
      mtile_products<2, P>(smem_addr(hl) + aoff, smem_addr(hl + kHPlane) + aoff, kMid, smem_addr(w2s), S);
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const int p = mt * 64 + wq * 16 + group + row * 8;
        const int gr = r0 + p / kTile, gc = c0 + p % kTile;
        if (gr >= height || gc >= width) continue;
        OT* dst = oimg + (static_cast<size_t>(gr) * width + gc) * c2;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = nt * 8 + tig * 2 + e;
            if (ch < c2) store_out(dst + ch, fmaxf(__fadd_rn(limb_sum<P>(S, nt * 4 + row * 2 + e), b2s[ch]), 0.f));
          }
      }
    }
  }
}

template <int P, typename XT, typename OT>
int launch(const XT* x, const void* w1, const float* b1, const float* a1, const void* w2, const float* b2, OT* out,
           int n, int height, int width, int c2, void* stream) {
  auto kernel = tail_pair_kernel<P, XT, OT>;
  constexpr int bytes = shared_bytes(P == 3 ? 2 : 1, sizeof(XT));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles = static_cast<long long>(n) * ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < static_cast<long long>(sms) * per_sm ? tiles : sms * per_sm);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint16_t*>(w1), b1, a1, static_cast<const uint16_t*>(w2), b2, out, n, height, width, c2);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x (n, height, width, 32) and out (n, height, width, c2) float32
// channels-last, contiguous, x 16-byte aligned.  w1 / w2: the two bf16
// limbs of conv1's / conv2's weights stacked into one B operand by
// kernels/tail_fused.pack_b_operand (n_pad 32 and 16), 16-byte aligned.
// b1 (32,), a1 (height, width, 32), b2 (c2,) float32.  cin and c1 must be
// 32 and c2 at most 16.  Returns the cudaError_t of the launch.
extern "C" int dvt_tail_fused(const float* x, const void* w1, const float* b1, const float* a1, const void* w2,
                              const float* b2, float* out, int n, int height, int width, int cin, int c1, int c2,
                              void* stream) {
  if (n <= 0 || height <= 0 || width <= 0) return 0;
  if (cin != kC || c1 != kC || c2 < 1 || c2 > kN2 || !aligned16(x) || !aligned16(w1) || !aligned16(w2))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<3>(x, w1, b1, a1, w2, b2, out, n, height, width, c2, stream);
}

// The bfloat16 decoder tail: x (n, height, width, 32) and out (n, height,
// width, c2) bfloat16 channels-last, contiguous, x 16-byte aligned; w1: the
// transposed conv as a conv (flipped taps, HWIO) rounded to bf16, w2 the
// head's HWIO kernel rounded to bf16, each packed by pack_b_operand with one
// limb (n_pad 32 and 16); b1 (32,), a1 (height, width, 32), b2 (c2,)
// float32.  c must be 32 and c2 at most 16.  Returns the cudaError_t of the
// launch.
extern "C" int dvt_decoder_tail_bf16(const void* x, const void* w1, const float* b1, const float* a1,
                                     const void* w2, const float* b2, void* out, int n, int height, int width,
                                     int c, int c2, void* stream) {
  if (n <= 0 || height <= 0 || width <= 0) return 0;
  if (c != kC || c2 < 1 || c2 > kN2 || !aligned16(x) || !aligned16(w1) || !aligned16(w2))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<1>(static_cast<const __nv_bfloat16*>(x), w1, b1, a1, w2, b2,
                   static_cast<__nv_bfloat16*>(out), n, height, width, c2, stream);
}
