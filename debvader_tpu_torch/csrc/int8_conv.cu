// int8 serving layers of the quantized VAE on Hopper's int8 tensor cores.
//
// Replaces the XLA int8 contractions of debvader_tpu/models/quantized.py
// (no Pallas kernel there): the TF-SAME conv (:340-347), the TF transposed
// conv (:399-407) and the dense (:447-452), each an s8 x s8 -> s32 product
// with preferred_element_type=int32, dequantized by y * (dq * wscale) +
// bias, with the _prelu (:115) and the next layer's _quant_act (:172) that
// _forward (:461-530) chains after it.
//
// Three kernels, each behind a plain C launcher:
//
// - dvt_quant_act: float32 activations, NCHW (a dense input (N, F) is NCHW
//   with H = W = 1), to int8 clip(round_half_even(h / s), -127, 127) with s
//   per tensor or per input channel, written channels innermost (NHWC), the
//   layout the conv reads.  A true division (__fdiv_rn) and rintf, as
//   jnp.round(h / scale) computes it; a NaN gives 0, as XLA's saturating
//   float -> int8 conversion does.  The forward runs it only where another
//   float layer comes before an int8 one.
// - dvt_quant_point: the same quantizer fused with the float tail before
//   it at the two points the sim_demo forward has: the BatchNorm before
//   enc/Conv_0 (kBnQuant) and dec/Dense_0's bias and PReLU before
//   dec/Dense_1 (kBiasPreluQuant), channels last in and out.
// - dvt_conv_fused: one int8 layer and its epilogue in one launch, as an
//   implicit GEMM: M output pixels, N = Cout, K = taps x Cin ordered (tap,
//   ci) and padded with zeros to a multiple of 32.
//
// The layer is one or more tap classes (kernels/int8_conv.tap_classes):
// class c computes the outputs (oy0 + ostep qy, ox0 + ostep qx) from the
// input pixels (istride qy + dy_t, istride qx + dx_t) of its taps t.  A
// TF-SAME conv is one class of all k^2 taps (istride = stride); a stride-2
// transposed conv is four stride-1 sub-convolutions, one for each output
// parity, with only the taps whose input index (oy + lo - ky) / 2 is
// integral (1, 2, 2 and 4 of the 9 under the crop at lo of
// ConvTranspose2dTF), so none of its products is a product with a zero;
// a dense layer is one 1 x 1 tap.  The classes are grid.z, each with its
// own packed weights.
//
// The main loop, one warpgroup a 64-row tile:
// - a ring of 4 shared-memory stages, each a 64 x 32-byte A tile and a
//   BN x 32-byte B tile (BN = 32, 64 or 128, fitted to Cout);
// - A gathered by 16-byte cp.async with zero fill (padding taps, rows past
//   M) when Cin % 16 == 0; byte by byte otherwise (enc/Conv_0, Cin = 6);
//   B, packed by the wrapper in the order of the shared layout, by
//   contiguous 16-byte cp.async;
// - both in wgmma's K-major layout without swizzle (8-row x 16-byte core
//   matrices of 128 contiguous bytes; leading offset 128 between the two
//   halves of a k-step, stride offset 256 between groups of 8 rows);
// - wgmma.mma_async m64nNk32 .s32.s8.s8 (N = 32 or 64, two or more
//   products for BN = 128) with A and B from shared-memory descriptors, one
//   group kept in flight while the next stage's loads are issued.
//
// Split K: where the output tiles leave SMs idle (the two dense layers at
// M = 128, the deepest convs), grid.z also splits K into slices of at
// least 8 k-steps; each block adds its int32 partial sums to a zeroed
// workspace (red.add: int32 sums are exact in any order) and the last
// block of a tile to arrive (a counter) reads the tile's sums back and
// runs the epilogue.
//
// The epilogue, per output element in JAX's order under -fmad=false:
//   y = __fadd_rn(__fmul_rn(__int2float_rn(acc), dqw[c]), bias[c]);
//   y = prelu(y, alpha1[c, oy, ox])            // as torch.maximum(y, 0) +
//   y = prelu(y, alpha2[(oy, ox, c) flat])     //  alpha * torch.minimum(y, 0)
//   q = clip(rint(y / scale[(oy, ox, c) flat % L]), -127, 127)
// writing the next layer's int8 NHWC input through a shared-memory tile
// (16-byte rows of channels); or float32 NCHW (the layer before the float
// head conv, enc/Dense_0), or the raw int32 sums.  The float32 activation
// between two int8 layers never reaches memory.  What made it fast:
// - its operands (dqw, bias, the scale by column, the alphas as a tile)
//   are copied into shared memory by cp.async at the start, so their loads
//   overlap the main loop; read from device memory where they are used,
//   each element waited for two round trips in turn;
// - the division is float(double(y) * RN(1 / s)), which is y / s
//   correctly rounded (div_by_reciprocal) and has no branch; __fdiv_rn's
//   checked fast path split every element into its own branch region;
// - an instance a kind of epilogue (launch_epi) and a path without bounds
//   checks for full tiles, so no per-element branch is left.
// On a 128-stamp chunk these took the 18 layers from 1.32 to 0.88 ms of
// device time on an H100 (the main loop alone about 0.6 ms); ring depth
// (3-8 stages), wgmma groups in flight (0-3) and k-steps a stage (1-4)
// changed nothing measurable.
//
// bfloat16 models (ModelConfig.dtype='bfloat16'): JAX's int8 forward
// rounds where its compute dtype says (:349, :409, :454, _prelu :115,
// the cast at the reshape :518).  The epilogue carries two more rounding
// points in its kind (EPI), each a round to nearest even by
// __float2bfloat16_rn and widened back by __bfloat162float:
//   kEpiBf16:    the layer's dtype is bfloat16: y rounds after the bias,
//                and each PReLU runs in bfloat16 arithmetic (prelu_bf16:
//                its alpha rounded, the product rounded, the sum rounded);
//   kEpiOutBf16: the value handed on is bfloat16: y rounds once more
//                before the quantizer (a no-op after kEpiBf16, the one
//                rounding of dec/Dense_1's float32 epilogue under
//                strict_cast) and a float output is written as bfloat16.
// Split K adds the int32 partial sums before the epilogue, so the
// rounding points do not move.  The float32 kinds are the instances they
// were; the bfloat16 kinds have instances of their own where the sim_demo
// forward launches them (launch_epi), the generic instance reads the
// rounding from the parameters.  csrc/int8_conv_bf16.cu compiles this
// file again with DVT_INT8_BF16 set: that translation unit holds the
// bfloat16 instances and its launcher is dvt_conv_fused_bf16, this one the
// float32 instances, dvt_conv_fused, dvt_quant_act and dvt_quant_point, so
// that the two build in parallel.

// The int32 sums are exact whatever their order (|acc| <= K * 127^2 =
// 66,064,384 < 2^31 at K = 4096), so the output is bit for bit the plain
// version's (float64 convolutions of the int8 values, then the same
// float32 epilogue).
//
// Bound on an H100, a 128-stamp chunk of the 18 layers: the bytes (int8
// activations in and out, the weights, the per-element PReLU alphas, the
// two float32 outputs) 0.073 ms at 3.35 TB/s; the products the taps need
// 0.038 ms at 1,979 TOP/s int8 (chip_smoke.py phase 19).  Built with
// -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef DVT_INT8_BF16
#define DVT_INT8_BF16 0
#endif

namespace {

constexpr int BM = 64;
constexpr int BK = 32;
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int MAX_CLASSES = 4;
constexpr int MAX_TAPS = 9;
constexpr int A_BYTES = BM * BK;

enum Mode { kFloat = 0, kInt8 = 1, kRaw = 2 };

struct ClassDesc {
  int oy0, ox0, ntaps, kp, b_off;
  int dy[MAX_TAPS], dx[MAX_TAPS];
};

struct Params {
  const int8_t* a;
  const int8_t* b;
  const float* dqw;
  const float* bias;
  const float* alpha1;
  const float* alpha2;
  const float* scale;
  void* out;
  int* ws;
  int* counters;
  int n, h, w, cin, ho, wo, cout, hq, wq, istride, ostep, np_pad, mode, scale_len, splits, rounding;
  ClassDesc cls[MAX_CLASSES];
};

// x rounded to the nearest bfloat16 (ties to even; NaN stays NaN, a value
// past the largest bfloat16 goes to +-inf), as a float
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// clip(round_half_even(d), -127, 127), a NaN d giving 0
__device__ __forceinline__ int8_t saturate(float d) {
  if (d != d) return 0;
  float v = fminf(fmaxf(rintf(d), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(v));
}

__device__ __forceinline__ int8_t quantize(float h, float s) { return saturate(__fdiv_rn(h, s)); }


// h / s correctly rounded to float, from rs = RN_double(1 / s): the double
// product is within 2^-52 of h / s (relative), and no float rounding
// boundary lies closer than 2^-49 to a quotient of two floats that is not
// itself one (nor is any such quotient a boundary unless s is a power of
// two, where rs and the product are exact), so rounding the product to
// float rounds h / s.  Branch-free, unlike __fdiv_rn's checked fast path.
__device__ __forceinline__ float div_by_reciprocal(float h, double rs) {
  return __double2float_rn(__dmul_rn(static_cast<double>(h), rs));
}

// torch.maximum(x, 0) + alpha * torch.minimum(x, 0) as PyTorch computes it
// on the card: a NaN x propagates, otherwise fmaxf / fminf in that order
__device__ __forceinline__ float prelu(float x, float alpha) {
  const float mx = x != x ? x : fmaxf(x, 0.0f);
  const float mn = x != x ? x : fminf(x, 0.0f);
  return __fadd_rn(mx, __fmul_rn(alpha, mn));
}

// The same PReLU on a bfloat16 x in bfloat16 arithmetic, as PyTorch and
// XLA compute it (each op in float32, its result rounded): the product of
// two bfloat16 values is exact in float32 and one of max(x, 0), a * min(x,
// 0) is zero, so this is one rounding of prelu(x, a) except for the sign
// of a product too small for bfloat16, which the add of +0 then decides
__device__ __forceinline__ float prelu_bf16(float x, float alpha) {
  const float mx = x != x ? x : fmaxf(x, 0.0f);
  const float mn = x != x ? x : fminf(x, 0.0f);
  return bf16r(__fadd_rn(mx, bf16r(__fmul_rn(bf16r(alpha), mn))));
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

// The float -> int8 points where a float layer comes before an int8 one,
// fused with that layer's elementwise tail (one launch each, in place of
// the eager ops, a copy and dvt_quant_act):
// - kBnQuant, enc/Conv_0's input: the inference BatchNorm in flax's
//   order, y = (x - mean[c]) * mul[c] + bias[c], then the quantizer;
// - kBiasPreluQuant, dec/Dense_1's input: dec/Dense_0's bias and the
//   PReLU after it, y = prelu(x + bias[c], alpha[c]), then the quantizer;
// - their bfloat16 kinds (JAX :120-131 and :509-512 under a bfloat16
//   compute dtype): kBnQuantBf16 rounds the stamps to bfloat16, computes
//   the BatchNorm in float32 and rounds its result; kBiasPreluQuantBf16
//   reads the bfloat16 product, adds the bias rounded to bfloat16 and
//   rounds, then the bfloat16 PReLU (prelu_bf16).
// x and q are channels last with C channels innermost ((N, H, W, C) or
// (N, C)), so there is no transpose: each thread takes 4 consecutive
// elements by one 16-byte load (8 bytes for a bfloat16 x) and one 4-byte
// store.  The channel parameters (rounded where the kind says) and RN(1 /
// s) go into shared memory once a block.  Bound by its bytes (4 or 2 in, 1
// out an element).
enum PointKind { kBnQuant = 0, kBiasPreluQuant = 1, kBnQuantBf16 = 2, kBiasPreluQuantBf16 = 3 };

template <int KIND>
__global__ void __launch_bounds__(256)
quant_point(const void* __restrict__ xv, const float* __restrict__ p0, const float* __restrict__ p1,
            const float* __restrict__ p2, const float* __restrict__ scale, int8_t* __restrict__ q,
            long long total, int c, int per_channel) {
  constexpr bool BN = KIND == kBnQuant || KIND == kBnQuantBf16;
  constexpr bool BF16 = KIND == kBnQuantBf16 || KIND == kBiasPreluQuantBf16;
  constexpr bool BF16_IN = KIND == kBiasPreluQuantBf16;
  extern __shared__ double point_shared[];
  double* rs = point_shared;                     // c
  float* a = reinterpret_cast<float*>(rs + c);   // mean / bias
  float* m = a + c;                              // mul / alpha
  float* d = m + c;                              // bias (BatchNorm)
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    rs[k] = 1.0 / static_cast<double>(per_channel ? scale[k] : scale[0]);
    a[k] = KIND == kBiasPreluQuantBf16 ? bf16r(p0[k]) : p0[k];
    m[k] = p1[k];
    if (BN) d[k] = p2[k];
  }
  __syncthreads();
  auto one = [&](float v, int ch) -> int8_t {
    float y;
    if constexpr (BN) {
      y = __fadd_rn(__fmul_rn(__fsub_rn(BF16 ? bf16r(v) : v, a[ch]), m[ch]), d[ch]);
      if (BF16) y = bf16r(y);
    } else if constexpr (BF16) {
      y = prelu_bf16(bf16r(__fadd_rn(v, a[ch])), m[ch]);
    } else {
      y = prelu(__fadd_rn(v, a[ch]), m[ch]);
    }
    return saturate(div_by_reciprocal(y, rs[ch]));
  };
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long groups = total / 4;
  for (long long g = first; g < groups; g += stride) {
    float v[4];
    if constexpr (BF16_IN) {
      // bfloat16 is the high half of a float: widening is a shift
      const uint2 raw = reinterpret_cast<const uint2*>(xv)[g];
      v[0] = __uint_as_float(raw.x << 16);
      v[1] = __uint_as_float(raw.x & 0xFFFF0000u);
      v[2] = __uint_as_float(raw.y << 16);
      v[3] = __uint_as_float(raw.y & 0xFFFF0000u);
    } else {
      const float4 f = reinterpret_cast<const float4*>(xv)[g];
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
    int ch = static_cast<int>((g * 4) % c);
    char4 o;
    o.x = one(v[0], ch);
    ch = ch + 1 == c ? 0 : ch + 1;
    o.y = one(v[1], ch);
    ch = ch + 1 == c ? 0 : ch + 1;
    o.z = one(v[2], ch);
    ch = ch + 1 == c ? 0 : ch + 1;
    o.w = one(v[3], ch);
    reinterpret_cast<char4*>(q)[g] = o;
  }
  for (long long i = groups * 4 + first; i < total; i += stride) {
    const float v = BF16_IN ? __bfloat162float(static_cast<const __nv_bfloat16*>(xv)[i])
                            : static_cast<const float*>(xv)[i];
    q[i] = one(v, static_cast<int>(i % c));
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand without swizzle:
// start address, leading byte offset 128 (between the two 16-byte halves
// of a k-step), stride byte offset 256 (between groups of 8 rows)
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 32 s32, this thread's 16) += A (64 x 32 s8) * B (32 x 32 s8)
__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 s32, this thread's 32) += A (64 x 32 s8) * B (32 x 64 s8)
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int NW>
__device__ __forceinline__ void wgmma(int (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 64)
    wgmma_n64(d, da, db);
  else
    wgmma_n32(d, da, db);
}

// 4 bytes global -> shared; src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// The epilogue's operands of a tile, staged in shared memory after the
// ring: dqw, bias and (per column) the next scale for the BN columns, then
// [BN][TP] tiles of the per-element ones (alpha1, alpha2, a per-element
// next scale), a column's 64 rows contiguous (TP = 68: a warp's reads of 8
// rows x 4 columns land on distinct banks).
constexpr int TP = 68;

// how the next layer's scale of output (pix, co) is indexed: none, by
// column ((pix cout + co) % L = co % L where L divides cout), or by element
enum ScaleMode { kNoScale = 0, kColumnScale = 1, kElementScale = 2 };

__host__ __device__ constexpr int ring_bytes(int bn) { return STAGES * (A_BYTES + bn * BK); }

__host__ __device__ inline int smem_bytes(int bn, bool alpha1, bool alpha2, int scale_mode) {
  const int tiles = int(alpha1) + int(alpha2) + int(scale_mode == kElementScale);
  // then the next scale's reciprocals, one double a column
  return ring_bytes(bn) + 3 * bn * 4 + tiles * bn * TP * 4 + 8 * bn;
}

// The epilogue a kernel instance is built for: the output mode, whether
// it applies alpha1 and alpha2, whether the next scale goes by element,
// its bfloat16 rounding points (kEpiBf16, kEpiOutBf16: the header); or
// GENERIC, which reads all of them from the parameters (the rounding from
// Params::rounding, the same two bits).
constexpr int kEpiA1 = 4, kEpiA2 = 8, kEpiElemScale = 16, kEpiGeneric = 32, kEpiBf16 = 64, kEpiOutBf16 = 128;

template <int BN, bool VEC, int EPI>
__global__ void __launch_bounds__(THREADS) conv_fused(const __grid_constant__ Params p, int scale_mode_arg) {
  constexpr bool GENERIC = (EPI & kEpiGeneric) != 0;
  const int mode = GENERIC ? p.mode : (EPI & 3);
  const bool has_a1 = GENERIC ? p.alpha1 != nullptr : (EPI & kEpiA1) != 0;
  const bool has_a2 = GENERIC ? p.alpha2 != nullptr : (EPI & kEpiA2) != 0;
  const int scale_mode = GENERIC ? scale_mode_arg
                                 : (EPI & 3) != kInt8 ? kNoScale : (EPI & kEpiElemScale) ? kElementScale : kColumnScale;
  const int rounding = GENERIC ? p.rounding : EPI & (kEpiBf16 | kEpiOutBf16);
  const bool round_each = (rounding & kEpiBf16) != 0;
  const bool round_out = (rounding & (kEpiBf16 | kEpiOutBf16)) != 0;
  constexpr int NW = BN < 64 ? BN : 64;  // one wgmma's width
  constexpr int NSUB = BN / NW;
  constexpr int STAGE = A_BYTES + BN * BK;  // one k-step's A and B
  extern __shared__ __align__(128) int8_t smem[];
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int ci_class = blockIdx.z / p.splits, split = blockIdx.z - ci_class * p.splits;
  const ClassDesc& cd = p.cls[ci_class];
  const long long hwq = static_cast<long long>(p.hq) * p.wq;
  const long long m_total = static_cast<long long>(p.n) * hwq;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int hwo = p.ho * p.wo;
  const int steps = cd.kp / BK;
  const int k_begin = static_cast<int>(static_cast<long long>(steps) * split / p.splits);
  const int nk = static_cast<int>(static_cast<long long>(steps) * (split + 1) / p.splits) - k_begin;
  const int k_total = cd.ntaps * p.cin;
  const uint32_t s_base = smem_addr(smem);

  // output pixel of tile row m (outputs < 2^31: the wrapper checks)
  auto pixel_of = [&](long long m, int& n) {
    n = static_cast<int>(m / hwq);
    const int r = static_cast<int>(m - n * hwq);
    const int qy = r / p.wq, qx = r - qy * p.wq;
    return (qy * p.ostep + cd.oy0) * p.wo + qx * p.ostep + cd.ox0;
  };

  // the epilogue's operands start on their way first: they land while the
  // main loop runs (one cp.async group, older than the ring's)
  float* col_dq = reinterpret_cast<float*>(smem + ring_bytes(BN));
  float* col_b = col_dq + BN;
  float* col_s = col_b + BN;
  float* t_alpha1 = col_s + BN;
  float* t_alpha2 = t_alpha1 + (has_a1 ? BN * TP : 0);
  float* t_scale = t_alpha2 + (has_a2 ? BN * TP : 0);
  if (mode != kRaw) {
    for (int c = tid; c < BN; c += THREADS) {
      const int co = n0 + c, ok = co < p.cout ? 4 : 0;
      cp_async4(smem_addr(col_dq + c), ok ? p.dqw + co : p.dqw, ok);
      cp_async4(smem_addr(col_b + c), ok ? p.bias + co : p.bias, ok);
      if (scale_mode == kColumnScale) cp_async4(smem_addr(col_s + c), ok ? p.scale + co % p.scale_len : p.scale, ok);
    }
    if (has_a1 || has_a2 || scale_mode == kElementScale) {
      const int r = tid & (BM - 1);
      const long long m = m0 + r;
      int n = 0;
      const int pix = m < m_total ? pixel_of(m, n) : 0;
      for (int c = tid / BM; c < BN; c += THREADS / BM) {
        const int co = n0 + c, ok = m < m_total && co < p.cout ? 4 : 0;
        const int flat = pix * p.cout + co;
        if (has_a1)
          cp_async4(smem_addr(t_alpha1 + c * TP + r), ok ? p.alpha1 + co * hwo + pix : p.alpha1, ok);
        if (has_a2) cp_async4(smem_addr(t_alpha2 + c * TP + r), ok ? p.alpha2 + flat : p.alpha2, ok);
        if (scale_mode == kElementScale)
          cp_async4(smem_addr(t_scale + c * TP + r), ok ? p.scale + flat % p.scale_len : p.scale, ok);
      }
    }
  }
  cp_async_commit();

  // this thread's A row and 16-byte half, and where they go in a stage
  const int arow = tid >> 1, ahalf = tid & 1;
  const long long am = m0 + arow;
  const bool a_ok = am < m_total;
  long long an = 0;
  int aiy = 0, aix = 0;
  if (a_ok) {
    an = am / hwq;
    const int r = static_cast<int>(am - an * hwq);
    const int qy = r / p.wq;
    aiy = qy * p.istride;
    aix = (r - qy * p.wq) * p.istride;
  }
  const uint32_t a_dst = (arow >> 3) * 256 + ahalf * 128 + (arow & 7) * 16;
  const int8_t* b_src = p.b + cd.b_off + static_cast<long long>(n0) * BK;

  // k-step kstep into ring stage `stage`
  auto load_stage = [&](int kstep, int stage) {
    const int off = stage * STAGE;
    const uint32_t sa = s_base + off;
    const int k = kstep * BK + ahalf * 16;
    if constexpr (VEC) {
      const void* src = p.a;
      int bytes = 0;
      if (a_ok && k < k_total) {
        const int t = k / p.cin, ci = k - t * p.cin;
        const int iy = aiy + cd.dy[t], ix = aix + cd.dx[t];
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w) {
          src = p.a + ((an * p.h + iy) * p.w + ix) * p.cin + ci;
          bytes = 16;
        }
      }
      cp_async16(sa + a_dst, src, bytes);
    } else {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
      if (a_ok && k < k_total) {
        // walk the 16 bytes tap by tap: one division for the first
        int t = k / p.cin, ci = k - t * p.cin;
        auto pixel = [&](int tap) -> const int8_t* {
          const int iy = aiy + cd.dy[tap], ix = aix + cd.dx[tap];
          return iy >= 0 && iy < p.h && ix >= 0 && ix < p.w ? p.a + ((an * p.h + iy) * p.w + ix) * p.cin : nullptr;
        };
        const int8_t* src = pixel(t);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (t < cd.ntaps && src != nullptr) {
            words[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(src[ci])) << (8 * (j & 3));
          }
          if (++ci == p.cin) {
            ci = 0;
            ++t;
            src = t < cd.ntaps ? pixel(t) : nullptr;
          }
        }
      }
      *reinterpret_cast<uint4*>(smem + off + a_dst) = make_uint4(words[0], words[1], words[2], words[3]);
    }
    const int8_t* bs = b_src + static_cast<long long>(kstep) * p.np_pad * BK;
    for (int i = tid; i < BN * 2; i += THREADS) cp_async16(sa + A_BYTES + i * 16, bs + i * 16, 16);
  };

  int acc[NSUB][NW / 2];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[j][i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(k_begin + s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    // the stage's bytes, written through the generic proxy, are read by
    // the tensor cores through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t sa = s_base + (kt % STAGES) * STAGE;
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_operand(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) wgmma<NW>(acc[j], desc(sa), desc(sa + A_BYTES + j * NW * BK));
    wgmma_commit();
    // the products of step kt - 1 are done: their stage takes step kt + 3
    wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_operand(acc[j]);
    if (kt + STAGES - 1 < nk) load_stage(k_begin + kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < NSUB; ++j) fence_operand(acc[j]);
  // every copy has landed (the epilogue's operands too); the ring is free
  cp_async_wait<0>();
  __syncthreads();

  // accumulator (j, nb * 4 + e): row warp * 16 + g + 8 (e >> 1), column
  // j * NW + nb * 8 + 2 t + (e & 1)
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if (p.splits > 1) {
    int* ws = p.ws + static_cast<long long>(ci_class) * m_total * p.np_pad;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const long long m = m0 + warp * 16 + g + 8 * e2;
      if (m >= m_total) continue;
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
#pragma unroll
        for (int nb = 0; nb < NW / 8; ++nb)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int co = n0 + j * NW + nb * 8 + t4 * 2 + e1;
            if (co < p.cout) atomicAdd(ws + m * p.np_pad + co, acc[j][nb * 4 + e2 * 2 + e1]);
          }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = (ci_class * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      last_block = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    }
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    // the tile's sums, read back without branches (rows past M read the
    // last row; the workspace is np_pad columns wide) so that the loads
    // overlap
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const long long m = min(m0 + warp * 16 + g + 8 * e2, m_total - 1);
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
#pragma unroll
        for (int nb = 0; nb < NW / 8; ++nb) {
          const int2 v = __ldcg(reinterpret_cast<const int2*>(ws + m * p.np_pad + n0 + j * NW + nb * 8 + t4 * 2));
          acc[j][nb * 4 + e2 * 2] = v.x;
          acc[j][nb * 4 + e2 * 2 + 1] = v.y;
        }
    }
  }

  // this thread's two rows: image and output pixel
  int row_n[2], row_pix[2];
  bool row_ok[2];
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const long long m = m0 + warp * 16 + g + 8 * e2;
    row_ok[e2] = m < m_total;
    row_n[e2] = 0;
    row_pix[e2] = row_ok[e2] ? pixel_of(m, row_n[e2]) : 0;
  }
  if (mode == kRaw) {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int nb = 0; nb < NW / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = n0 + j * NW + nb * 8 + t4 * 2 + (e & 1), e2 = e >> 1;
          if (co < p.cout && row_ok[e2])
            static_cast<int*>(p.out)[(row_n[e2] * p.cout + co) * hwo + row_pix[e2]] = acc[j][nb * 4 + e];
        }
    return;
  }
  // the next scale's reciprocals, in double, by column
  double* col_rs = reinterpret_cast<double*>(t_scale + (scale_mode == kElementScale ? BN * TP : 0));
  if (scale_mode == kColumnScale) {
    for (int c = tid; c < BN; c += THREADS) col_rs[c] = 1.0 / static_cast<double>(col_s[c]);
    __syncthreads();
  }
  // The int8 outputs go through shared memory (the ring, [64][BN + 16]:
  // the 8 rows of a store land on distinct banks) and leave as 16-byte
  // rows of channels, an output pixel's channels being contiguous.
  constexpr int PITCH = BN + 16;
  static_assert(BM * PITCH <= STAGES * STAGE, "the staging tile fits the ring");
  const bool staged = mode == kInt8 && p.cout % 16 == 0;
  // a full tile (every row and column inside) skips the bounds checks
  const bool full = m0 + BM <= m_total && n0 + BN <= p.cout;
  auto elements = [&](auto checked) {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int nb = 0; nb < NW / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int e1 = e & 1, e2 = e >> 1;
          const int col = j * NW + nb * 8 + t4 * 2 + e1, co = n0 + col, row = warp * 16 + g + 8 * e2;
          if constexpr (decltype(checked)::value) {
            if (!row_ok[e2] || co >= p.cout) continue;
          }
          float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[j][nb * 4 + e]), col_dq[col]), col_b[col]);
          if (round_each) {
            y = bf16r(y);
            if (has_a1) y = prelu_bf16(y, t_alpha1[col * TP + row]);
            if (has_a2) y = prelu_bf16(y, t_alpha2[col * TP + row]);
          } else {
            if (has_a1) y = prelu(y, t_alpha1[col * TP + row]);
            if (has_a2) y = prelu(y, t_alpha2[col * TP + row]);
            if (round_out) y = bf16r(y);
          }
          if (mode == kFloat) {
            const long long at = (row_n[e2] * p.cout + co) * hwo + row_pix[e2];
            if (round_out)
              static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16_rn(y);
            else
              static_cast<float*>(p.out)[at] = y;
            continue;
          }
          const double rs = scale_mode == kColumnScale ? col_rs[col]
                                                       : 1.0 / static_cast<double>(t_scale[col * TP + row]);
          const int8_t q = saturate(div_by_reciprocal(y, rs));
          if (staged)
            smem[row * PITCH + col] = q;
          else
            static_cast<int8_t*>(p.out)[(row_n[e2] * hwo + row_pix[e2]) * p.cout + co] = q;
        }
  };
  if (full)
    elements(std::false_type{});
  else
    elements(std::true_type{});
  if (!staged) return;
  __syncthreads();
  constexpr int CHUNKS = BN / 16;
  for (int i = tid; i < BM * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, c16 = (i - row * CHUNKS) * 16;
    const long long m = m0 + row;
    if (m >= m_total || n0 + c16 >= p.cout) continue;
    int n;
    const int pix = pixel_of(m, n);
    *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + (n * hwo + pix) * p.cout + n0 + c16) =
        *reinterpret_cast<const uint4*>(smem + row * PITCH + c16);
  }
}

template <int BN, bool VEC, int EPI>
cudaError_t launch_one(const Params& p, int scale_mode, dim3 grid, cudaStream_t stream) {
  // the most shared memory any layer asks for, allowed once
  static const cudaError_t allowed = cudaFuncSetAttribute(
      conv_fused<BN, VEC, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(BN, true, true, kElementScale));
  if (allowed != cudaSuccess) return allowed;
  const int bytes = smem_bytes(BN, p.alpha1 != nullptr, p.alpha2 != nullptr, scale_mode);
  conv_fused<BN, VEC, EPI><<<grid, THREADS, bytes, stream>>>(p, scale_mode);
  return cudaGetLastError();
}

// The epilogues of the int8 forward have instances of their own: a
// layer into the next int8 layer (PReLU, per-column scale), enc/Conv_7
// into enc/Dense_0 (two PReLUs, per-element scale), the float32 outputs
// with and without a PReLU, the raw sums, each at every channel tile; and
// the bfloat16 kinds of the sim_demo forward at the tiles where it
// launches them: a layer into the next (every tile; enc/Conv_0's byte
// gather at 32), enc/Conv_7 into enc/Dense_0 with a per-tensor scale and
// enc/Dense_0's bfloat16 output (128), dec/Dense_1's float32 epilogue
// rounded once under strict_cast (128), dec/ConvTranspose2DTF_7's
// bfloat16 output after its PReLU (32).  Anything else runs the generic
// instance.
constexpr int kB = kEpiBf16 | kEpiOutBf16;

template <int BN, bool VEC, int EPI>
constexpr bool instance() {
  if constexpr ((EPI & (kEpiBf16 | kEpiOutBf16)) != 0 && !DVT_INT8_BF16) return false;
  if constexpr ((EPI & (kEpiBf16 | kEpiOutBf16)) == 0 && DVT_INT8_BF16) return false;
  if constexpr (!VEC) return EPI == (kInt8 | kEpiA1) || (BN == 32 && EPI == (kInt8 | kEpiA1 | kB));
  switch (EPI) {
    case kInt8 | kEpiA1:
    case kInt8 | kEpiA1 | kEpiA2 | kEpiElemScale:
    case kFloat | kEpiA1:
    case kFloat:
    case kRaw:
    case kInt8 | kEpiA1 | kB:
      return true;
    case kInt8 | kEpiA1 | kEpiA2 | kB:
    case kFloat | kB:
    case kInt8 | kEpiA1 | kEpiOutBf16:
      return BN == 128;
    case kFloat | kEpiA1 | kB:
      return BN == 32;
    default:
      return false;
  }
}

template <int BN, bool VEC, int EPI>
cudaError_t launch_kind(const Params& p, int scale_mode, dim3 grid, cudaStream_t stream) {
  if constexpr (instance<BN, VEC, EPI>()) return launch_one<BN, VEC, EPI>(p, scale_mode, grid, stream);
  return launch_one<BN, VEC, kEpiGeneric>(p, scale_mode, grid, stream);
}

template <int BN, bool VEC>
cudaError_t launch_epi(const Params& p, int scale_mode, dim3 grid, cudaStream_t stream) {
  const int epi = p.mode | (p.alpha1 != nullptr ? kEpiA1 : 0) | (p.alpha2 != nullptr ? kEpiA2 : 0) |
                  (scale_mode == kElementScale ? kEpiElemScale : 0) | p.rounding;
  switch (epi) {
    case kInt8 | kEpiA1:
      return launch_kind<BN, VEC, kInt8 | kEpiA1>(p, scale_mode, grid, stream);
    case kInt8 | kEpiA1 | kEpiA2 | kEpiElemScale:
      return launch_kind<BN, VEC, kInt8 | kEpiA1 | kEpiA2 | kEpiElemScale>(p, scale_mode, grid, stream);
    case kFloat | kEpiA1:
      return launch_kind<BN, VEC, kFloat | kEpiA1>(p, scale_mode, grid, stream);
    case kFloat:
      return launch_kind<BN, VEC, kFloat>(p, scale_mode, grid, stream);
    case kRaw:
      return launch_kind<BN, VEC, kRaw>(p, scale_mode, grid, stream);
    case kInt8 | kEpiA1 | kB:
      return launch_kind<BN, VEC, kInt8 | kEpiA1 | kB>(p, scale_mode, grid, stream);
    case kInt8 | kEpiA1 | kEpiA2 | kB:
      return launch_kind<BN, VEC, kInt8 | kEpiA1 | kEpiA2 | kB>(p, scale_mode, grid, stream);
    case kFloat | kB:
      return launch_kind<BN, VEC, kFloat | kB>(p, scale_mode, grid, stream);
    case kInt8 | kEpiA1 | kEpiOutBf16:
      return launch_kind<BN, VEC, kInt8 | kEpiA1 | kEpiOutBf16>(p, scale_mode, grid, stream);
    case kFloat | kEpiA1 | kB:
      return launch_kind<BN, VEC, kFloat | kEpiA1 | kB>(p, scale_mode, grid, stream);
    default:
      return launch_one<BN, VEC, kEpiGeneric>(p, scale_mode, grid, stream);
  }
}

template <int BN>
cudaError_t launch(const Params& p, int scale_mode, dim3 grid, cudaStream_t stream) {
  // enc/Conv_0 (Cin = 6) is the one layer with a byte gather
  if (p.cin % 16 != 0) return launch_epi<BN, false>(p, scale_mode, grid, stream);
  return launch_epi<BN, true>(p, scale_mode, grid, stream);
}

}  // namespace

#if !DVT_INT8_BF16
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

// x (total) float32 (bfloat16 for kind 3) and q (total) int8, channels
// last with c channels innermost, x 16-byte aligned (8 for bfloat16); p0,
// p1, p2 (c) float32: mean, mul, bias (kinds 0 and 2) or bias, alpha,
// unused (kinds 1 and 3); scale (c) or (1).
extern "C" int dvt_quant_point(const void* x, const void* p0, const void* p1, const void* p2, const void* scale,
                               void* q, int kind, int n, int c, int inner, int per_channel, cudaStream_t stream) {
  if (kind < kBnQuant || kind > kBiasPreluQuantBf16) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = kind == kBiasPreluQuantBf16 ? 8 : 16;
  if (reinterpret_cast<uintptr_t>(x) % align != 0 || reinterpret_cast<uintptr_t>(q) % 4 != 0 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(n) * inner * c;
  if (total == 0) return 0;
  const long long groups = (total + 3) / 4;
  const int blocks = static_cast<int>((groups + 255) / 256 < 8192 ? (groups + 255) / 256 : 8192);
  const size_t bytes = static_cast<size_t>(c) * (sizeof(double) + 3 * sizeof(float));
  if (bytes > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float *f0 = static_cast<const float*>(p0), *f1 = static_cast<const float*>(p1);
  const float *f2 = static_cast<const float*>(p2), *fs = static_cast<const float*>(scale);
  int8_t* qq = static_cast<int8_t*>(q);
  switch (kind) {
    case kBnQuant:
      quant_point<kBnQuant><<<blocks, 256, bytes, stream>>>(x, f0, f1, f2, fs, qq, total, c, per_channel);
      break;
    case kBiasPreluQuant:
      quant_point<kBiasPreluQuant><<<blocks, 256, bytes, stream>>>(x, f0, f1, f2, fs, qq, total, c, per_channel);
      break;
    case kBnQuantBf16:
      quant_point<kBnQuantBf16><<<blocks, 256, bytes, stream>>>(x, f0, f1, f2, fs, qq, total, c, per_channel);
      break;
    default:
      quant_point<kBiasPreluQuantBf16><<<blocks, 256, bytes, stream>>>(x, f0, f1, f2, fs, qq, total, c, per_channel);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif

// table: nclass rows of 23 ints (oy0, ox0, taps, kp, operand offset, 9 dy,
// 9 dx), in host memory.  ws: with splits > 1, nclass * M * np_pad int32
// partial sums, then one counter a tile; zeroed here.  rounding: 0 (a
// float32 epilogue) or kEpiBf16 | kEpiOutBf16 (a bfloat16 layer) or
// kEpiOutBf16 (a float32 epilogue rounded once at the end); out is
// bfloat16 in float mode when rounding is not 0.
#if DVT_INT8_BF16
#define DVT_CONV_FUSED dvt_conv_fused_bf16
#else
#define DVT_CONV_FUSED dvt_conv_fused
#endif
extern "C" int DVT_CONV_FUSED(const void* a, const void* b, const void* dqw, const void* bias, const void* alpha1,
                              const void* alpha2, const void* scale, void* out, void* ws, const void* table, int n,
                              int h, int w, int cin, int ho, int wo, int cout, int hq, int wq, int istride, int ostep,
                              int nclass, int np_pad, int mode, int scale_len, int splits, int rounding,
                              cudaStream_t stream) {
  if (nclass < 1 || nclass > MAX_CLASSES || splits < 1 || (rounding & ~(kEpiBf16 | kEpiOutBf16)) != 0 ||
      (mode == kRaw && rounding != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.dqw = static_cast<const float*>(dqw);
  p.bias = static_cast<const float*>(bias);
  p.alpha1 = static_cast<const float*>(alpha1);
  p.alpha2 = static_cast<const float*>(alpha2);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.n = n, p.h = h, p.w = w, p.cin = cin, p.ho = ho, p.wo = wo, p.cout = cout, p.hq = hq, p.wq = wq;
  p.istride = istride, p.ostep = ostep, p.np_pad = np_pad, p.mode = mode;
  p.scale_len = scale_len, p.splits = splits, p.rounding = rounding;
  const int* t = static_cast<const int*>(table);
  for (int c = 0; c < nclass; ++c, t += 5 + 2 * MAX_TAPS) {
    ClassDesc& cd = p.cls[c];
    cd.oy0 = t[0], cd.ox0 = t[1], cd.ntaps = t[2], cd.kp = t[3], cd.b_off = t[4];
    if (cd.ntaps > MAX_TAPS || cd.kp % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < MAX_TAPS; ++i) cd.dy[i] = t[5 + i], cd.dx[i] = t[5 + MAX_TAPS + i];
  }
  const int bn = cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  if (np_pad % bn != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long m_total = static_cast<long long>(n) * hq * wq;
  dim3 grid(static_cast<unsigned>((m_total + BM - 1) / BM), np_pad / bn, nclass * splits);
  p.ws = static_cast<int*>(ws);
  p.counters = splits > 1 ? p.ws + nclass * m_total * np_pad : nullptr;
  if (splits > 1) {
    const size_t ints = nclass * m_total * np_pad + static_cast<size_t>(nclass) * grid.x * grid.y;
    const cudaError_t err = cudaMemsetAsync(ws, 0, ints * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int scale_mode = mode != kInt8 ? kNoScale : cout % scale_len == 0 ? kColumnScale : kElementScale;
  const cudaError_t err = bn == 32   ? launch<32>(p, scale_mode, grid, stream)
                          : bn == 64 ? launch<64>(p, scale_mode, grid, stream)
                                     : launch<128>(p, scale_mode, grid, stream);
  return static_cast<int>(err);
}
