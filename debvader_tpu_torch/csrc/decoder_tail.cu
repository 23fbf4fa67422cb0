// Fused decoder tail: stride-1 transposed conv 3x3 (C -> C) + bias,
// per-element PReLU, SAME 3x3 conv (C -> O) + bias, ReLU.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/decoder_tail.py
// fused_decoder_tail (_tail_kernel).  For x (N, S, S, C) channels-last:
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
// CUDA cores; the bytes are x once and out once).  Design: one block per
// (image, 16x16 tile).  The tile's 20x20 window of x, the 18x18 tile of h
// with its ring, and both weight sets sit in shared memory (about 145 KB at
// C = 32, O = 12, so one block a multiprocessor), and h never touches device
// memory.  Stage 1 runs a warp's lanes along the output channel: a lane
// keeps 6 pixels' sums in registers, reads a weight once for the 6, and
// reads x as broadcast float4s.  Stage 2 runs one thread a pixel with all O
// sums in registers; k3 is read as broadcast float4s and h through a
// pixel stride of C + 1 floats, which keeps the lanes on separate banks.
// Float32 FMAs throughout, no tensor cores, no TF32; built with
// contraction on and held to a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                  // channels of x and of h: a warp's lanes
constexpr int kTile = 16;
constexpr int kIn = kTile + 4;          // 20: x window
constexpr int kMid = kTile + 2;         // 18: h tile with its ring
constexpr int kMidStride = kC + 1;      // 33 floats a pixel of h
constexpr int kWarps = 9;
constexpr int kThreads = kWarps * 32;   // 288
constexpr int kP = 6;                   // pixels a lane carries in stage 1
constexpr int kGroups = kMid * kMid / kP;  // 54
static_assert(kMid * kMid % kP == 0, "stage 1 groups must tile the h tile");
static_assert(kThreads >= kTile * kTile, "stage 2 needs a thread a pixel");

constexpr int kXinFloats = kIn * kIn * kC;
constexpr int kMidFloats = kMid * kMid * kMidStride;
constexpr int kW2Floats = 9 * kC * kC;

__host__ __device__ constexpr int shared_floats(int opad) {
  return kXinFloats + kMidFloats + kW2Floats + 9 * kC * opad + kC + opad;
}

template <int OPAD>
__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const float* __restrict__ x, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ a2,
                    const float* __restrict__ k3, const float* __restrict__ b3,
                    float* __restrict__ out, int size, int o) {
  extern __shared__ __align__(16) float smem[];
  float* xin = smem;                    // [kIn * kIn][kC]
  float* mid = xin + kXinFloats;        // [kMid * kMid][kMidStride]
  float* w2s = mid + kMidFloats;        // [9][ci][co]
  float* w3s = w2s + kW2Floats;         // [9][c][OPAD]
  float* b2s = w3s + 9 * kC * OPAD;     // [kC]
  float* b3s = b2s + kC;                // [OPAD]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const size_t image = static_cast<size_t>(blockIdx.z) * size * size;
  x += image * kC;
  out += image * o;

  // ---- stage in: the x window as float4s, the weights, the biases
  for (int i = tid; i < kIn * kIn * (kC / 4); i += kThreads) {
    const int pix = i / (kC / 4), q = i % (kC / 4);
    const int gr = r0 - 2 + pix / kIn, gc = c0 - 2 + pix % kIn;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr >= 0 && gr < size && gc >= 0 && gc < size)
      v = reinterpret_cast<const float4*>(x + (static_cast<size_t>(gr) * size + gc) * kC)[q];
    reinterpret_cast<float4*>(xin)[i] = v;
  }
  for (int i = tid; i < kW2Floats; i += kThreads) w2s[i] = w2[i];
  for (int i = tid; i < 9 * kC * OPAD; i += kThreads) {
    const int oo = i % OPAD;
    w3s[i] = oo < o ? k3[(i / OPAD) * o + oo] : 0.f;
  }
  if (tid < kC) b2s[tid] = b2[tid];
  if (tid < OPAD) b3s[tid] = tid < o ? b3[tid] : 0.f;
  __syncthreads();

  // ---- stage 1: h on the 18x18 ring tile, lane = output channel
  for (int g = warp; g < kGroups; g += kWarps) {
    int xoff[kP];
    float acc[kP];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int m = g * kP + j;
      xoff[j] = ((m / kMid) * kIn + m % kMid) * kC;
      acc[j] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = ((tap / 3) * kIn + tap % 3) * kC;
      const float* wt = w2s + tap * kC * kC + lane;
#pragma unroll 2
      for (int ci = 0; ci < kC; ci += 4) {
        const float wa = wt[ci * kC], wb = wt[(ci + 1) * kC];
        const float wc = wt[(ci + 2) * kC], wd = wt[(ci + 3) * kC];
#pragma unroll
        for (int j = 0; j < kP; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(xin + xoff[j] + toff + ci);
          acc[j] = fmaf(xv.x, wa, acc[j]);
          acc[j] = fmaf(xv.y, wb, acc[j]);
          acc[j] = fmaf(xv.z, wc, acc[j]);
          acc[j] = fmaf(xv.w, wd, acc[j]);
        }
      }
    }
    const float bias = b2s[lane];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int m = g * kP + j;
      const int gr = r0 - 1 + m / kMid, gc = c0 - 1 + m % kMid;
      float v = 0.f;
      if (gr >= 0 && gr < size && gc >= 0 && gc < size) {
        const float h = acc[j] + bias;
        const float alpha = a2[(static_cast<size_t>(gr) * size + gc) * kC + lane];
        v = fmaxf(h, 0.f) + alpha * fminf(h, 0.f);
      }
      mid[m * kMidStride + lane] = v;
    }
  }
  __syncthreads();

  // ---- stage 2: one thread a pixel, all O sums in registers
  if (tid >= kTile * kTile) return;
  const int pr = tid / kTile, pc = tid % kTile;
  const int gr = r0 + pr, gc = c0 + pc;
  if (gr >= size || gc >= size) return;
  float sum[OPAD];
#pragma unroll
  for (int q = 0; q < OPAD; ++q) sum[q] = b3s[q];
  for (int tap = 0; tap < 9; ++tap) {
    const float* hp = mid + ((pr + tap / 3) * kMid + pc + tap % 3) * kMidStride;
    const float4* wt = reinterpret_cast<const float4*>(w3s + tap * kC * OPAD);
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float h = hp[c];
#pragma unroll
      for (int q = 0; q < OPAD / 4; ++q) {
        const float4 w = wt[c * (OPAD / 4) + q];
        sum[4 * q] = fmaf(h, w.x, sum[4 * q]);
        sum[4 * q + 1] = fmaf(h, w.y, sum[4 * q + 1]);
        sum[4 * q + 2] = fmaf(h, w.z, sum[4 * q + 2]);
        sum[4 * q + 3] = fmaf(h, w.w, sum[4 * q + 3]);
      }
    }
  }
  float* dst = out + (static_cast<size_t>(gr) * size + gc) * o;
#pragma unroll
  for (int q = 0; q < OPAD; ++q)
    if (q < o) dst[q] = fmaxf(sum[q], 0.f);
}

template <int OPAD>
int launch(const float* x, const float* w2, const float* b2, const float* a2, const float* k3,
           const float* b3, float* out, int n, int size, int o, cudaStream_t stream) {
  const int bytes = shared_floats(OPAD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_kernel<OPAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (size + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, n);
  decoder_tail_kernel<OPAD><<<grid, kThreads, bytes, stream>>>(x, w2, b2, a2, k3, b3, out, size, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, size, size, 32) and out (n, size, size, o) float32 channels-last,
// contiguous, x 16-byte aligned; w2 (3, 3, 32, 32) as [sy][sx][ci][co];
// b2 (32,); a2 (size, size, 32); k3 (3, 3, 32, o); b3 (o,); c must be 32,
// o at most 16 and n at most 65535.  Returns the cudaError_t of the launch.
extern "C" int dvt_decoder_tail(const float* x, const float* w2, const float* b2,
                                const float* a2, const float* k3, const float* b3, float* out,
                                int n, int size, int c, int o, void* stream) {
  if (n <= 0 || size <= 0) return 0;
  if (c != kC || o < 1 || o > 16 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (o <= 4) return launch<4>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  if (o <= 8) return launch<8>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  if (o <= 12) return launch<12>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
  return launch<16>(x, w2, b2, a2, k3, b3, out, n, size, o, st);
}
