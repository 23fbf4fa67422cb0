// Fused decoder-tail conv pair at fidelity precision:
//   out = relu(conv2(prelu(conv1(x) + b1, alpha1)) + b2),
// both convs SAME 3x3 stride 1, each as the 3-term round-to-nearest bf16-limb
// product  xh*wh + xh*wm + xm*wh  with float32 accumulation (the 'bf16x3'
// scheme of models/precision.py), conv1's outputs off the image zeroed
// before conv2 (its SAME padding must see zeros there, not conv1's values).
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/tail_fused.py
// fused_tail_pair (_kernel, _limb3, _split2, _rne).  What is kept is its
// arithmetic: hi = rne(v) by the integer form (add 0x7FFF + the round bit,
// clear the low 16 bits), mid = bf16(v - hi) rounded to nearest even; the
// activations are split in the kernel (x at load, h1 after bias, PReLU and
// the off-image zeroing), the weights once by the wrapper; the three limb
// products are summed as (hh + hm) + mh.  Its flat (rows, W*C) layout, its
// over-read rows and its lane-packed weight concat are TPU workarounds and
// are not carried over.
//
// Bound on the H100: operations.  The function's products are bf16 x bf16
// into float32, 3 limb terms x 2*9*C*(C1 + C2) a pixel, against x read once
// and out written once.  Design: the products run on the tensor cores
// through mma.sync.m16n8k16 (bf16 in, float32 out), as an implicit im2col:
// M = the pixels of a tile, K = 9 taps x 32 channels = 18 k-steps,
// N = 32 (conv1) or 16 (conv2, C2 zero-padded).  One block of 8 warps per
// (image, 16x16 output tile).  Shared memory holds the tile's 20x20 window of
// x and the 18x18 tile of h1 with its ring, each as two bf16 limb planes
// with a pixel stride of 40 values (80 bytes: the eight rows a fragment load
// touches fall on separate banks), and both weight sets as [n][k] rows of
// 296 values (the same padding), about 173 KB, so one block a
// multiprocessor; h1 never touches device memory.  A warp owns m-tiles of 16
// pixels and keeps the three limb products in separate float32 accumulators;
// a tap's two k-steps accumulate in the tensor core and the nine taps are
// added with IEEE adds (the tensor core's float32 accumulation truncates:
// on normal random inputs all 18 k-steps chained were off by 3.4e-6 of the
// output scale from the plain version, this way by 2.5e-6, most of which is
// h1 values that split into other limbs where the two sums differ in the
// last bit).  The kernel is held to the plain version by a tolerance, never
// bit for bit.
// wgmma, TMA and a persistent grid are left to the change that tunes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                  // channels of x and of h1
constexpr int kN2 = 16;                 // conv2's output channels, zero-padded
constexpr int kTile = 16;
constexpr int kIn = kTile + 4;          // 20: x window
constexpr int kMid = kTile + 2;         // 18: h1 tile with its ring
constexpr int kPix = kC + 8;            // 40 bf16 a pixel in shared memory
constexpr int kK = 9 * kC;              // 288
constexpr int kKs = kK + 8;             // 296 bf16 a weight row in shared memory
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kM1 = kMid * kMid;        // 324 h1 pixels
constexpr int kM1Tiles = (kM1 + 15) / 16;          // 21
constexpr int kM2Tiles = kTile * kTile / 16;       // 16

constexpr int kXElems = kIn * kIn * kPix;          // one limb plane of x
constexpr int kHElems = kM1 * kPix;                // one limb plane of h1
constexpr int kW1Elems = kC * kKs;
constexpr int kW2Elems = kN2 * kKs;
constexpr int kSharedBytes =
    2 * (2 * kXElems + 2 * kHElems + 2 * kW1Elems + 2 * kW2Elems) + 4 * (kC + kN2);

// Round-to-nearest-even bf16 value of v, in float32 (finite v).
__device__ __forceinline__ uint32_t rne_bits(float v) {
  const uint32_t bits = __float_as_uint(v);
  return (bits + 0x7FFFu + ((bits >> 16) & 1u)) & 0xFFFF0000u;
}

// The two limbs of v as bf16 bit patterns: hi = rne(v), mid = bf16(v - hi).
__device__ __forceinline__ void split2(float v, uint16_t& hi, uint16_t& mid) {
  const uint32_t h = rne_bits(v);
  hi = static_cast<uint16_t>(h >> 16);
  mid = __bfloat16_as_ushort(__float2bfloat16_rn(__fsub_rn(v, __uint_as_float(h))));
}

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16x16, row major) * b (16x8, column major), bf16 in, float32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One m-tile of an implicit-im2col limb product over all 18 k-steps.
// src_hi / src_mid: limb planes with pixel stride kPix and row width
// `src_width` pixels; off0 / off1: the plane offsets (in values) of the
// fragment's two pixel rows at tap (0, 0); wh / wm: [n][kKs] weight limbs.
// hh, hm, mh: the three limb products, [n-tile][4] each.
template <int NT>
__device__ __forceinline__ void limb3_mtile(const uint16_t* __restrict__ src_hi,
                                            const uint16_t* __restrict__ src_mid, int src_width,
                                            int off0, int off1, const uint16_t* __restrict__ wh,
                                            const uint16_t* __restrict__ wm, int group, int tig,
                                            float (&hh)[NT][4], float (&hm)[NT][4],
                                            float (&mh)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) hh[nt][i] = hm[nt][i] = mh[nt][i] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int toff = ((tap / 3) * src_width + tap % 3) * kPix;
    // a tap's two k-steps accumulate in the tensor core, the nine taps with
    // IEEE adds: the tensor core truncates where it aligns its addends, and
    // a chain of 18 k-steps would carry that bias all the way
    float t_hh[NT][4], t_hm[NT][4], t_mh[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) t_hh[nt][i] = t_hm[nt][i] = t_mh[nt][i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = half * 16 + tig * 2;      // this thread's channel pair
      const int k = tap * kC + c;             // and its place along K
      uint32_t ah[4], am[4];
      ah[0] = lds32(src_hi + off0 + toff + c);
      ah[1] = lds32(src_hi + off1 + toff + c);
      ah[2] = lds32(src_hi + off0 + toff + c + 8);
      ah[3] = lds32(src_hi + off1 + toff + c + 8);
      am[0] = lds32(src_mid + off0 + toff + c);
      am[1] = lds32(src_mid + off1 + toff + c);
      am[2] = lds32(src_mid + off0 + toff + c + 8);
      am[3] = lds32(src_mid + off1 + toff + c + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int wrow = (nt * 8 + group) * kKs + k;
        const uint32_t bh0 = lds32(wh + wrow), bh1 = lds32(wh + wrow + 8);
        const uint32_t bm0 = lds32(wm + wrow), bm1 = lds32(wm + wrow + 8);
        mma_bf16(t_hh[nt], ah, bh0, bh1);
        mma_bf16(t_hm[nt], ah, bm0, bm1);
        mma_bf16(t_mh[nt], am, bh0, bh1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hh[nt][i] = __fadd_rn(hh[nt][i], t_hh[nt][i]);
        hm[nt][i] = __fadd_rn(hm[nt][i], t_hm[nt][i]);
        mh[nt][i] = __fadd_rn(mh[nt][i], t_mh[nt][i]);
      }
  }
}

__global__ void __launch_bounds__(kThreads)
tail_fused_kernel(const float* __restrict__ x, const uint16_t* __restrict__ w1h,
                  const uint16_t* __restrict__ w1m, const float* __restrict__ b1,
                  const float* __restrict__ a1, const uint16_t* __restrict__ w2h,
                  const uint16_t* __restrict__ w2m, const float* __restrict__ b2,
                  float* __restrict__ out, int height, int width, int c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* xh = reinterpret_cast<uint16_t*>(smem_raw);   // [kIn * kIn][kPix]
  uint16_t* xm = xh + kXElems;
  uint16_t* hh_s = xm + kXElems;                           // [kM1][kPix]
  uint16_t* hm_s = hh_s + kHElems;
  uint16_t* w1h_s = hm_s + kHElems;                        // [kC][kKs]
  uint16_t* w1m_s = w1h_s + kW1Elems;
  uint16_t* w2h_s = w1m_s + kW1Elems;                      // [kN2][kKs]
  uint16_t* w2m_s = w2h_s + kW2Elems;
  float* b1s = reinterpret_cast<float*>(w2m_s + kW2Elems); // [kC]
  float* b2s = b1s + kC;                                   // [kN2]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int group = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const size_t image = static_cast<size_t>(blockIdx.z) * height * width;
  x += image * kC;
  out += image * c2;

  // ---- stage in: the x window split into its limbs, the weights, the biases
  for (int i = tid; i < kIn * kIn * (kC / 4); i += kThreads) {
    const int pix = i / (kC / 4), q = i % (kC / 4);
    const int gr = r0 - 2 + pix / kIn, gc = c0 - 2 + pix % kIn;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr >= 0 && gr < height && gc >= 0 && gc < width)
      v = reinterpret_cast<const float4*>(x + (static_cast<size_t>(gr) * width + gc) * kC)[q];
    uint16_t h0, h1, h2, h3, m0, m1, m2, m3;
    split2(v.x, h0, m0);
    split2(v.y, h1, m1);
    split2(v.z, h2, m2);
    split2(v.w, h3, m3);
    const int at = pix * kPix + q * 4;
    *reinterpret_cast<uint2*>(xh + at) = make_uint2(pack2(h0, h1), pack2(h2, h3));
    *reinterpret_cast<uint2*>(xm + at) = make_uint2(pack2(m0, m1), pack2(m2, m3));
  }
  {
    // the wrapper hands the weights over in the shared layout: straight copies
    const uint4* src[4] = {reinterpret_cast<const uint4*>(w1h), reinterpret_cast<const uint4*>(w1m),
                           reinterpret_cast<const uint4*>(w2h), reinterpret_cast<const uint4*>(w2m)};
    uint4* dst[4] = {reinterpret_cast<uint4*>(w1h_s), reinterpret_cast<uint4*>(w1m_s),
                     reinterpret_cast<uint4*>(w2h_s), reinterpret_cast<uint4*>(w2m_s)};
    const int count[4] = {kW1Elems / 8, kW1Elems / 8, kW2Elems / 8, kW2Elems / 8};
#pragma unroll
    for (int s = 0; s < 4; ++s)
      for (int i = tid; i < count[s]; i += kThreads) dst[s][i] = src[s][i];
  }
  if (tid < kC) b1s[tid] = b1[tid];
  if (tid < kN2) b2s[tid] = tid < c2 ? b2[tid] : 0.f;
  __syncthreads();

  // ---- stage 1: h1 on the 18x18 ring tile, 21 m-tiles of 16 pixels
  for (int mt = warp; mt < kM1Tiles; mt += kWarps) {
    // the fragment's two pixel rows; rows past the tile read its last pixel
    // and are not stored
    const int p0 = mt * 16 + group, p1 = p0 + 8;
    const int q0 = min(p0, kM1 - 1), q1 = min(p1, kM1 - 1);
    const int off0 = ((q0 / kMid) * kIn + q0 % kMid) * kPix;
    const int off1 = ((q1 / kMid) * kIn + q1 % kMid) * kPix;
    float hh[4][4], hm[4][4], mh[4][4];
    limb3_mtile<4>(xh, xm, kIn, off0, off1, w1h_s, w1m_s, group, tig, hh, hm, mh);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int p = row ? p1 : p0;
      if (p >= kM1) continue;
      const int gr = r0 - 1 + p / kMid, gc = c0 - 1 + p % kMid;
      const bool on_image = gr >= 0 && gr < height && gc >= 0 && gc < width;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int ch = nt * 8 + tig * 2;
        uint16_t hi[2] = {0, 0}, mid[2] = {0, 0};
        if (on_image) {
          const float* alpha = a1 + (static_cast<size_t>(gr) * width + gc) * kC + ch;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = row * 2 + e;
            float v = __fadd_rn(__fadd_rn(hh[nt][i], hm[nt][i]), mh[nt][i]);
            v = __fadd_rn(v, b1s[ch + e]);
            v = __fadd_rn(fmaxf(v, 0.f), __fmul_rn(alpha[e], fminf(v, 0.f)));
            split2(v, hi[e], mid[e]);
          }
        }
        *reinterpret_cast<uint32_t*>(hh_s + p * kPix + ch) = pack2(hi[0], hi[1]);
        *reinterpret_cast<uint32_t*>(hm_s + p * kPix + ch) = pack2(mid[0], mid[1]);
      }
    }
  }
  __syncthreads();

  // ---- stage 2: the 16x16 output tile, 16 m-tiles (one tile row each)
  for (int mt = warp; mt < kM2Tiles; mt += kWarps) {
    const int p0 = mt * 16 + group, p1 = p0 + 8;
    const int off0 = ((p0 / kTile) * kMid + p0 % kTile) * kPix;
    const int off1 = ((p1 / kTile) * kMid + p1 % kTile) * kPix;
    float hh[2][4], hm[2][4], mh[2][4];
    limb3_mtile<2>(hh_s, hm_s, kMid, off0, off1, w2h_s, w2m_s, group, tig, hh, hm, mh);
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const int p = row ? p1 : p0;
      const int gr = r0 + p / kTile, gc = c0 + p % kTile;
      if (gr >= height || gc >= width) continue;
      float* dst = out + (static_cast<size_t>(gr) * width + gc) * c2;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = nt * 8 + tig * 2 + e;
          if (ch >= c2) continue;
          const int i = row * 2 + e;
          const float v = __fadd_rn(__fadd_rn(hh[nt][i], hm[nt][i]), mh[nt][i]);
          dst[ch] = fmaxf(__fadd_rn(v, b2s[ch]), 0.f);
        }
    }
  }
}

}  // namespace

// x (n, height, width, 32) and out (n, height, width, c2) float32
// channels-last, contiguous, x 16-byte aligned.  w1h / w1m: the two bf16
// limbs of conv1's weights as (32, 296) rows [co][tap * 32 + ci], the last 8
// values of a row zero; w2h / w2m: conv2's as (16, 296) rows [o][tap * 32 + c],
// rows from c2 on zero; all four 16-byte aligned.  b1 (32,), a1 (height,
// width, 32), b2 (c2,) float32.  cin and c1 must be 32, c2 at most 16 and n
// at most 65535.  Returns the cudaError_t of the launch.
extern "C" int dvt_tail_fused(const float* x, const void* w1h, const void* w1m, const float* b1,
                              const float* a1, const void* w2h, const void* w2m, const float* b2,
                              float* out, int n, int height, int width, int cin, int c1, int c2,
                              void* stream) {
  if (n <= 0 || height <= 0 || width <= 0) return 0;
  if (cin != kC || c1 != kC || c2 < 1 || c2 > kN2 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(tail_fused_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, n);
  tail_fused_kernel<<<grid, kThreads, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const uint16_t*>(w1h), static_cast<const uint16_t*>(w1m), b1, a1,
      static_cast<const uint16_t*>(w2h), static_cast<const uint16_t*>(w2m), b2, out, height, width,
      c2);
  return static_cast<int>(cudaGetLastError());
}
