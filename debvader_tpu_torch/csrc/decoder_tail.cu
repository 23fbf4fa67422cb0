// Fused decoder tail, float32: stride-1 transposed conv 3x3 (C -> C) + bias,
// per-element PReLU, SAME 3x3 conv (C -> O) + bias, ReLU.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/decoder_tail.py
// fused_decoder_tail (_tail_kernel) for a float32 x (a bfloat16 x runs the
// one-limb instance of csrc/tail_fused.cu).  For x (N, S, S, C) channels-last:
//   h[p, co]  = b2[co] + sum_{sy,sx,ci} x[p + (sy-1, sx-1), ci] * w2[sy, sx, ci, co]
//               (the transposed conv at stride 1 is a conv with the flipped
//               kernel: w2[sy, sx, ci, co] = k2[2-sy, 2-sx, co, ci]; the
//               wrapper hands w2 over in that layout), x = 0 outside the image;
//   h         = max(h, 0) + a2[p, co] * min(h, 0);
//   out[p, o] = relu(b3[o] + sum_{ty,tx,c} h[p + (ty-1, tx-1), c] * k3[ty, tx, c, o]),
//               h = 0 outside the image (SAME padding of the second conv: the
//               ring is zero, not the first conv's value there).
//
// Bound on the H100: operations (2 * 9 * C * (C + O) a pixel on the float32
// CUDA cores; the bytes are x once and out once).  Design, for Hopper:
// * a persistent grid, one block of 8 warps a multiprocessor, each walking
//   the (image, 16x32 output tile) list (tile t at image t / tiles, row and
//   column from t % tiles; block b takes b, b + grid, ...).  Both weight
//   sets are copied into shared memory once a block and stay there;
// * the tile's 20x36 window of x arrives by 16-byte cp.async with zero fill
//   (the zero fill is the transposed conv's zero padding).  One window
//   buffer: two windows, the 18x34 h tile and the weights would take 313 KB
//   of the 227 KB a block may have, so the next tile's window is loaded
//   into the same buffer as soon as stage 1 has read it, and arrives while
//   stage 2 runs;
// * stage 1 is an implicit GEMM, M = the 612 h pixels, N = 32 channels,
//   K = 9 x 32, register-blocked: lanes are 8 pixel groups x 4 channel
//   groups, a thread holds 10 pixels x 8 channels and, for every 4 input
//   channels, reads 10 float4s of x and 8 of weights for 320 FMAs (0.9
//   bytes of shared memory an FMA; 4 x 8 tiles at 1.5 bytes, 20 warps,
//   measured 5% slower).  8 warps of 80 pixels cover the 612, two on each
//   scheduler;
// * stage 2, a thread 2 pixels x all O outputs (O rounded up to a multiple
//   of 4: no arithmetic on padding for O = 12);
// * x and h sit unpadded in shared memory with their 16-byte chunks swizzled
//   (chunk ^ pixel % 8), so 8 consecutive pixels fall on separate banks;
//   the 18x34 tile costs 612 / 512 = 1.195x of stage 1's work for the
//   ring, and h never touches device memory; the PReLU alphas of a thread's
//   10 pixels are loaded together, before any is used.
// Float32 FMAs throughout, no tensor cores, no TF32; built with contraction
// on and held to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                   // channels of x and of h
constexpr int kTR = 16, kTC = 32;        // output tile: rows, columns
constexpr int kInR = kTR + 4, kInC = kTC + 4;      // 20 x 36 window of x
constexpr int kMidR = kTR + 2, kMidC = kTC + 2;    // 18 x 34 h tile with its ring
constexpr int kXPix = kInR * kInC;                 // 720
constexpr int kM1 = kMidR * kMidC;                 // 612
constexpr int kPx = 10;                            // stage 1: pixels a thread
constexpr int kWarps = (kM1 + 8 * kPx - 1) / (8 * kPx);  // 8: a warp covers 8 kPx pixels
constexpr int kThreads = kWarps * 32;              // 256
constexpr int kPx2 = 2;                            // stage 2: pixels a thread
static_assert(kThreads * kPx2 == kTR * kTC, "stage 2: a thread 2 outputs");
static_assert(kWarps % 4 == 0, "the warps spread evenly over the 4 schedulers");

__host__ __device__ constexpr int shared_floats(int opad) {
  return (kXPix + kM1) * kC + 9 * kC * kC + 9 * kC * opad + kC + opad;
}

// float offset of channel chunk c4 (4 floats) of pixel pix: chunks swizzled
__device__ __forceinline__ int sw(int pix, int c4) { return pix * kC + ((c4 ^ (pix & 7)) << 2); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int OPAD>
__global__ void __launch_bounds__(kThreads, 1)
decoder_tail_kernel(const float* __restrict__ x, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ a2,
                    const float* __restrict__ k3, const float* __restrict__ b3,
                    float* __restrict__ out, int n, int size, int o) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [kXPix][kC], swizzled
  float* hs = xs + kXPix * kC;          // [kM1][kC], swizzled
  float* w2s = hs + kM1 * kC;           // [9][ci][co]
  float* w3s = w2s + 9 * kC * kC;       // [9][c][OPAD]
  float* b2s = w3s + 9 * kC * OPAD;     // [kC]
  float* b3s = b2s + kC;                // [OPAD]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tiles_r = (size + kTR - 1) / kTR, tiles_c = (size + kTC - 1) / kTC;
  const int per_image = tiles_r * tiles_c;
  const int total = n * per_image;
  const int grid = static_cast<int>(gridDim.x);

  // ---- both weight sets and the biases, once a block
  for (int i = tid; i < 9 * kC * kC / 4; i += kThreads)
    reinterpret_cast<float4*>(w2s)[i] = reinterpret_cast<const float4*>(w2)[i];
  for (int i = tid; i < 9 * kC * OPAD; i += kThreads) {
    const int oo = i % OPAD;
    w3s[i] = oo < o ? k3[(i / OPAD) * o + oo] : 0.f;
  }
  if (tid < kC) b2s[tid] = b2[tid];
  if (tid < OPAD) b3s[tid] = tid < o ? b3[tid] : 0.f;

  // the window of tile t, zero outside the image
  auto load_window = [&](int t) {
    const int image = t / per_image, rem = t % per_image;
    const int r0 = (rem / tiles_c) * kTR, c0 = (rem % tiles_c) * kTC;
    const float* xi = x + static_cast<size_t>(image) * size * size * kC;
    for (int i = tid; i < kXPix * (kC / 4); i += kThreads) {
      const int pix = i >> 3, q = i & 7;
      const int gr = r0 - 2 + pix / kInC, gc = c0 - 2 + pix % kInC;
      const bool in = gr >= 0 && gr < size && gc >= 0 && gc < size;
      const float* src = in ? xi + (static_cast<size_t>(gr) * size + gc) * kC + q * 4 : x;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(xs + sw(pix, q))),
                   "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (static_cast<int>(blockIdx.x) < total) load_window(blockIdx.x);
  for (int t = blockIdx.x; t < total; t += grid) {
    const int image = t / per_image, rem = t % per_image;
    const int r0 = (rem / tiles_c) * kTR, c0 = (rem % tiles_c) * kTC;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // ---- stage 1: h on the 18x34 ring tile; lane = 8 pixel groups x 4
    // channel groups, a thread 10 pixels (8 apart) x 8 channels
    {
      const int g = lane >> 2, q = lane & 3;
      int wp[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int m = min(warp * 8 * kPx + j * 8 + g, kM1 - 1);  // past the tile: its last pixel, not stored
        wp[j] = (m / kMidC) * kInC + m % kMidC;
      }
      float acc[kPx][8];
#pragma unroll
      for (int j = 0; j < kPx; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * kInC + tap % 3;
        const float* wt = w2s + tap * kC * kC + q * 8;
#pragma unroll
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          float4 xv[kPx];
#pragma unroll
          for (int j = 0; j < kPx; ++j) xv[j] = *reinterpret_cast<const float4*>(xs + sw(wp[j] + toff, c4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 wa = *reinterpret_cast<const float4*>(wt + (c4 * 4 + i) * kC);
            const float4 wb = *reinterpret_cast<const float4*>(wt + (c4 * 4 + i) * kC + 4);
#pragma unroll
            for (int j = 0; j < kPx; ++j) {
              const float xi = comp(xv[j], i);
              acc[j][0] = fmaf(xi, wa.x, acc[j][0]);
              acc[j][1] = fmaf(xi, wa.y, acc[j][1]);
              acc[j][2] = fmaf(xi, wa.z, acc[j][2]);
              acc[j][3] = fmaf(xi, wa.w, acc[j][3]);
              acc[j][4] = fmaf(xi, wb.x, acc[j][4]);
              acc[j][5] = fmaf(xi, wb.y, acc[j][5]);
              acc[j][6] = fmaf(xi, wb.z, acc[j][6]);
              acc[j][7] = fmaf(xi, wb.w, acc[j][7]);
            }
          }
        }
      }
      // the PReLU alphas of all kPx pixels first, so that their loads
      // overlap; a pixel off the image reads the first one and stores 0
      bool on[kPx];
      float4 aa[kPx], ab[kPx];
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int m = warp * 8 * kPx + j * 8 + g;
        const int gr = r0 - 1 + m / kMidC, gc = c0 - 1 + m % kMidC;
        on[j] = m < kM1 && gr >= 0 && gr < size && gc >= 0 && gc < size;
        const float4* al = reinterpret_cast<const float4*>(
            a2 + (on[j] ? (static_cast<size_t>(gr) * size + gc) * kC : 0) + q * 8);
        aa[j] = __ldg(al);
        ab[j] = __ldg(al + 1);
      }
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        const int m = warp * 8 * kPx + j * 8 + g;
        if (m >= kM1) continue;
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float h = acc[j][k] + b2s[q * 8 + k];
          v[k] = on[j] ? fmaxf(h, 0.f) + (k < 4 ? comp(aa[j], k) : comp(ab[j], k - 4)) * fminf(h, 0.f) : 0.f;
        }
        *reinterpret_cast<float4*>(hs + sw(m, 2 * q)) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(hs + sw(m, 2 * q + 1)) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();
    // the window is read: bring the next tile's in while stage 2 runs
    if (t + grid < total) load_window(t + grid);

    // ---- stage 2: the 16x32 output tile, a thread 2 pixels (8 rows
    // apart) x all outputs
    {
      const int hp = (tid / kTC) * kMidC + tid % kTC;    // h pixel of the first at tap (0, 0)
      float acc[kPx2][OPAD];
#pragma unroll
      for (int j = 0; j < kPx2; ++j)
#pragma unroll
        for (int k = 0; k < OPAD; ++k) acc[j][k] = b3s[k];
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * kMidC + tap % 3;
        const float* wt = w3s + tap * kC * OPAD;
#pragma unroll
        for (int c4 = 0; c4 < kC / 4; ++c4) {
          float4 hv[kPx2];
#pragma unroll
          for (int j = 0; j < kPx2; ++j)
            hv[j] = *reinterpret_cast<const float4*>(hs + sw(hp + j * (kTR / kPx2) * kMidC + toff, c4));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k4 = 0; k4 < OPAD / 4; ++k4) {
              const float4 w = *reinterpret_cast<const float4*>(wt + (c4 * 4 + i) * OPAD + k4 * 4);
#pragma unroll
              for (int j = 0; j < kPx2; ++j) {
                const float h = comp(hv[j], i);
                acc[j][4 * k4] = fmaf(h, w.x, acc[j][4 * k4]);
                acc[j][4 * k4 + 1] = fmaf(h, w.y, acc[j][4 * k4 + 1]);
                acc[j][4 * k4 + 2] = fmaf(h, w.z, acc[j][4 * k4 + 2]);
                acc[j][4 * k4 + 3] = fmaf(h, w.w, acc[j][4 * k4 + 3]);
              }
            }
          }
        }
      }
      float* oimg = out + static_cast<size_t>(image) * size * size * o;
#pragma unroll
      for (int j = 0; j < kPx2; ++j) {
        const int p = tid + j * kThreads;
        const int gr = r0 + p / kTC, gc = c0 + p % kTC;
        if (gr >= size || gc >= size) continue;
        float* dst = oimg + (static_cast<size_t>(gr) * size + gc) * o;
        if (o == OPAD) {
#pragma unroll
          for (int k4 = 0; k4 < OPAD / 4; ++k4)
            reinterpret_cast<float4*>(dst)[k4] =
                make_float4(fmaxf(acc[j][4 * k4], 0.f), fmaxf(acc[j][4 * k4 + 1], 0.f),
                            fmaxf(acc[j][4 * k4 + 2], 0.f), fmaxf(acc[j][4 * k4 + 3], 0.f));
        } else {
#pragma unroll
          for (int k = 0; k < OPAD; ++k)
            if (k < o) dst[k] = fmaxf(acc[j][k], 0.f);
        }
      }
    }
  }
}

template <int OPAD>
int launch(const float* x, const float* w2, const float* b2, const float* a2, const float* k3,
           const float* b3, float* out, int n, int size, int o, cudaStream_t stream) {
  const int bytes = shared_floats(OPAD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_kernel<OPAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const long long tiles =
      static_cast<long long>(n) * ((size + kTR - 1) / kTR) * ((size + kTC - 1) / kTC);
  if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  decoder_tail_kernel<OPAD><<<grid, kThreads, bytes, stream>>>(x, w2, b2, a2, k3, b3, out, n, size, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, size, size, 32) and out (n, size, size, o) float32 channels-last,
// contiguous, both 16-byte aligned; w2 (3, 3, 32, 32) as [sy][sx][ci][co],
// 16-byte aligned; b2 (32,); a2 (size, size, 32), 16-byte aligned;
// k3 (3, 3, 32, o); b3 (o,); c must be 32 and o at most 16.  Returns the
// cudaError_t of the launch.
extern "C" int dvt_decoder_tail(const float* x, const float* w2, const float* b2,
                                const float* a2, const float* k3, const float* b3, float* out,
                                int n, int size, int c, int o, void* stream) {
  if (n <= 0 || size <= 0) return 0;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w2) |
                          reinterpret_cast<uintptr_t>(a2) | reinterpret_cast<uintptr_t>(out);
  if (c != kC || o < 1 || o > 16 || (align & 15)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o <= 4) return launch<4>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  if (o <= 8) return launch<8>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  if (o <= 12) return launch<12>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  return launch<16>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
}
