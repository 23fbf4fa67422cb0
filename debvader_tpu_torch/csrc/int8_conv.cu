// int8 serving layers of the quantized VAE on Hopper's int8 tensor cores.
//
// Replaces the XLA int8 contractions of debvader_tpu/models/quantized.py
// (no Pallas kernel there): the TF-SAME conv (:340-347), the TF transposed
// conv (:399-407) and the dense (:447-452), each an s8 x s8 -> s32 product
// with preferred_element_type=int32, dequantized by y * (dq * wscale) + bias.
//
// Two kernels, each behind a plain C launcher:
//
// - dvt_quant_act: float32 activations, NCHW (a dense input (N, F) is NCHW
//   with H = W = 1), to int8 clip(round_half_even(h / s), -127, 127) with s
//   per tensor or per input channel, written channels innermost (NHWC), the
//   layout the conv reads.  A true division (__fdiv_rn) and rintf, as
//   jnp.round(h / scale) computes it; a NaN gives 0, as XLA's saturating
//   float -> int8 conversion does.
// - dvt_conv_s8: an implicit-GEMM convolution.  M = N * Ho * Wo output
//   pixels, N = Cout, K = kh * kw * Cin ordered (ky, kx, ci) and padded with
//   zeros to a multiple of 32 (Conv_0: K = 54 -> 64).  The weight comes
//   packed as (Cout rounded up to 64, Kp) int8 rows.  A block computes a
//   64 x 64 tile of the output with four warps, 32 x 32 each, through
//   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, the K loop in steps of
//   32 through shared memory.  The A tile is gathered from the NHWC input:
//   a 16-byte load when Cin is a multiple of 16, byte by byte otherwise.
//   The TF-SAME conv reads input (oy * s - pad_top + ky, ox * s - pad_left
//   + kx); the transposed conv is the gather form of its scatter: output oy
//   sums the taps ky whose input index (oy + lo - ky) / s is integral and in
//   range (the crop at lo of ConvTranspose2dTF), with no zero-inserted
//   buffer; the dense is the 1 x 1 case.  The epilogue writes NCHW float32
//   __fadd_rn(__fmul_rn(__int2float_rn(acc), dqw[c]), bias[c]) in JAX's
//   order (y.astype(f32) * (dq * wscale), then + bias), or the raw int32
//   accumulators.
//
// The int32 sums are exact whatever their order (|acc| <= K * 127^2 =
// 66,064,384 < 2^31 at K = 4096), so the output is bit for bit the plain
// version's (float64 convolutions of the int8 values).
//
// Bound on an H100: the convs at a 128-stamp chunk do 2 * M * N * K integer
// operations, up to 1.2 GOP (enc/Conv_2: 445,568 x 64 x 288), against 1,979
// TOP/s dense int8: about 0.6 us; the bytes (int8 input once, float32
// output once) take longer, 57 MB at enc/Conv_0 -> 17 us.  So every layer
// is bound by its bytes, chiefly the float32 output.  This first kernel is
// simple: synchronous loads, no cp.async, TMA or wgmma, and the transposed
// conv multiplies the zero taps of its gather (4x the work at stride 2).
// Built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
// shared-memory row stride in bytes: 48 makes the fragment loads of a warp
// hit 32 distinct banks
constexpr int LDS = 48;
constexpr int THREADS = 128;

__device__ __forceinline__ int8_t quantize(float h, float s) {
  float d = __fdiv_rn(h, s);
  if (d != d) return 0;
  float v = fminf(fmaxf(rintf(d), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(v));
}

// (N, C, HW) float32 -> (N, HW, C) int8 through a 32 x 32 shared tile
__global__ void quant_act_tiled(const float* __restrict__ x, const float* __restrict__ scale,
                                int8_t* __restrict__ q, int c, int hw, int per_channel) {
  __shared__ int8_t tile[32][33];
  const int p0 = blockIdx.x * 32, c0 = blockIdx.y * 32, n = blockIdx.z;
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int ci = c0 + j, p = p0 + threadIdx.x;
    int8_t v = 0;
    if (ci < c && p < hw) {
      v = quantize(x[(static_cast<long long>(n) * c + ci) * hw + p], per_channel ? scale[ci] : scale[0]);
    }
    tile[j][threadIdx.x] = v;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    const int p = p0 + j, ci = c0 + threadIdx.x;
    if (p < hw && ci < c) q[(static_cast<long long>(n) * hw + p) * c + ci] = tile[threadIdx.x][j];
  }
}

// HW = 1 (a dense input): NCHW is NHWC, elementwise
__global__ void quant_act_flat(const float* __restrict__ x, const float* __restrict__ scale,
                               int8_t* __restrict__ q, long long total, int c, int per_channel) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    q[i] = quantize(x[i], per_channel ? scale[i % c] : scale[0]);
  }
}

// the NHWC input row of output pixel (n, oy, ox) at tap (ky, kx), or -1
__device__ __forceinline__ long long tap_row(int n, int oy, int ox, int ky, int kx, int h, int w, int stride,
                                             int pad_top, int pad_left, int transposed) {
  int iy, ix;
  if (transposed) {
    const int ty = oy + pad_top - ky, tx = ox + pad_left - kx;
    if (ty < 0 || tx < 0 || ty % stride != 0 || tx % stride != 0) return -1;
    iy = ty / stride;
    ix = tx / stride;
  } else {
    iy = oy * stride - pad_top + ky;
    ix = ox * stride - pad_left + kx;
    if (iy < 0 || ix < 0) return -1;
  }
  if (iy >= h || ix >= w) return -1;
  return (static_cast<long long>(n) * h + iy) * w + ix;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS) conv_s8(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b, const float* __restrict__ dqw,
    const float* __restrict__ bias, void* __restrict__ out, int n, int h, int w, int cin, int ho, int wo,
    int cout, int ksz, int stride, int pad_top, int pad_left, int transposed, int kp, int raw) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t = lane & 3;
  const long long hwo = static_cast<long long>(ho) * wo;
  const long long m_total = static_cast<long long>(n) * hwo;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int k_total = ksz * ksz * cin;
  const bool vec = (cin % 16) == 0;

  // this thread's loads: row lrow of each tile, bytes [lk, lk + 16)
  const int lrow = tid >> 1, lk = (tid & 1) * 16;
  const long long m = m0 + lrow;
  const bool m_ok = m < m_total;
  int pn = 0, oy = 0, ox = 0;
  if (m_ok) {
    pn = static_cast<int>(m / hwo);
    const int r = static_cast<int>(m - pn * hwo);
    oy = r / wo;
    ox = r - oy * wo;
  }

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < kp; k0 += BK) {
    const int kb = k0 + lk;
    int4 va = make_int4(0, 0, 0, 0);
    if (m_ok && kb < k_total) {
      if (vec) {
        const int tap = kb / cin, ci = kb - tap * cin;
        const int ky = tap / ksz, kx = tap - ky * ksz;
        const long long row = tap_row(pn, oy, ox, ky, kx, h, w, stride, pad_top, pad_left, transposed);
        if (row >= 0) va = *reinterpret_cast<const int4*>(a + row * cin + ci);
      } else {
        uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int k = kb + j;
          if (k < k_total) {
            const int tap = k / cin, ci = k - tap * cin;
            const int ky = tap / ksz, kx = tap - ky * ksz;
            const long long row = tap_row(pn, oy, ox, ky, kx, h, w, stride, pad_top, pad_left, transposed);
            if (row >= 0) words[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(a[row * cin + ci])) << (8 * (j & 3));
          }
        }
        va = make_int4(static_cast<int>(words[0]), static_cast<int>(words[1]), static_cast<int>(words[2]),
                       static_cast<int>(words[3]));
      }
    }
    *reinterpret_cast<int4*>(As + lrow * LDS + lk) = va;
    *reinterpret_cast<int4*>(Bs + lrow * LDS + lk) =
        *reinterpret_cast<const int4*>(b + static_cast<long long>(n0 + lrow) * kp + kb);
    __syncthreads();

    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;
      af[i][0] = *reinterpret_cast<const uint32_t*>(As + r * LDS + t * 4);
      af[i][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + t * 4);
      af[i][2] = *reinterpret_cast<const uint32_t*>(As + r * LDS + 16 + t * 4);
      af[i][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + 16 + t * 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = wn * 32 + j * 8 + g;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(Bs + col * LDS + t * 4);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(Bs + col * LDS + 16 + t * 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long mm = m0 + wm * 32 + i * 16 + g + (e >= 2 ? 8 : 0);
      if (mm >= m_total) continue;
      const long long on = mm / hwo, p = mm - on * hwo;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + wn * 32 + j * 8 + t * 2 + (e & 1);
        if (co >= cout) continue;
        const long long idx = (on * cout + co) * hwo + p;
        if (raw) {
          static_cast<int*>(out)[idx] = acc[i][j][e];
        } else {
          static_cast<float*>(out)[idx] = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][e]), dqw[co]), bias[co]);
        }
      }
    }
  }
}

}  // namespace

extern "C" int dvt_quant_act(const void* x, const void* scale, void* q, int n, int c, int hw, int per_channel,
                             cudaStream_t stream) {
  if (hw == 1) {
    const long long total = static_cast<long long>(n) * c;
    const int blocks = static_cast<int>((total + 255) / 256 < 65535 ? (total + 255) / 256 : 65535);
    quant_act_flat<<<blocks, 256, 0, stream>>>(static_cast<const float*>(x), static_cast<const float*>(scale),
                                              static_cast<int8_t*>(q), total, c, per_channel);
  } else {
    dim3 grid((hw + 31) / 32, (c + 31) / 32, n);
    quant_act_tiled<<<grid, dim3(32, 8), 0, stream>>>(static_cast<const float*>(x),
                                                       static_cast<const float*>(scale),
                                                       static_cast<int8_t*>(q), c, hw, per_channel);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dvt_conv_s8(const void* a, const void* b, const void* dqw, const void* bias, void* out, int n, int h,
                           int w, int cin, int ho, int wo, int cout, int ksz, int stride, int pad_top, int pad_left,
                           int transposed, int kp, int raw, cudaStream_t stream) {
  const long long m_total = static_cast<long long>(n) * ho * wo;
  dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), (cout + BN - 1) / BN);
  conv_s8<<<grid, THREADS, 0, stream>>>(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                        static_cast<const float*>(dqw), static_cast<const float*>(bias), out, n, h, w,
                                        cin, ho, wo, cout, ksz, stride, pad_top, pad_left, transposed, kp, raw);
  return static_cast<int>(cudaGetLastError());
}
