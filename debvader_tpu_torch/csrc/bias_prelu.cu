// Bias and PReLU of the stamp forward in one pass.
//
// It replaces no TPU kernel: on the TPU, XLA fuses the bias add and the
// PReLU into the convolution's output fusion (debvader_tpu/models/vae.py,
// _prelu after each nn.Conv / nn.ConvTranspose / nn.Dense).  In eager
// PyTorch each of their ops is a launch of its own over the whole
// activation: the bias add (after cuDNN's convolution in float32, after the
// bfloat16 contraction with its own cast in bfloat16), the zero fill, the
// maximum, the minimum, the alpha cast, the multiply and the add.  This
// kernel computes, over a conv or dense output y (N, C, H, W) or (N, C),
//
//   out = max(t, 0) + alpha * min(t, 0),  t = y + bias
//
// with bias (C,) and alpha (C, H, W) float32 (the layer's bias and its
// PReLU's per-element alpha), each op rounded as the plain ops round it:
//   float32:  t = y + b, one rounding (ATen adds a conv's bias after the
//             cuDNN convolution); then the maximum, the minimum, the
//             product and the sum, each rounded on its own;
//   bfloat16: t = bf16(y + bf16(b)); alpha rounded to bf16; the product
//             rounded to bf16, the sum rounded to bf16 (ATen computes each
//             bfloat16 op in float32 and rounds its result once).
// The maximum and the minimum are ATen's: a NaN propagates, otherwise
// fmaxf / fminf.  The arithmetic uses __fadd_rn / __fmul_rn, which never
// contract into a fused multiply-add, and the file builds with -fmad=false.
//
// Bound on the H100: bytes.  y is read once and out written once (8 bytes
// an element in float32, 4 in bfloat16); alpha and the bias are read once
// a thread and kept in registers.  Design: a thread owns V consecutive
// elements of one sample of out in memory (V = 16 bytes of the element
// type when the shape allows), works out once which (c, h, w) each is, its
// alpha, its bias and where y holds it, then walks the batch (blockIdx.y,
// then gridDim.y apart), kUnroll samples in flight, with 16-byte stores.
// out is dense in any order of its dims: the convolutions' outputs are
// NCHW in the float32 stamp forward and channels-last in the bfloat16 one
// (models/layers.py conv_input), and the result keeps the layout the plain
// ops would give it, so the next convolution runs the same cuDNN
// algorithm.  A dense y is overwritten in place.  A strided y (the crop
// view of a TF transposed conv) is read where it lies: 16-byte loads where
// a thread's elements are consecutive and aligned there (the channels-last
// crop), else one element at a time (the NCHW crop, whose rows start off
// the 16-byte grid).  Shapes V does not divide take V = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// about two waves of eight 256-thread blocks on each of the H100's 132 SMs
constexpr int kBlocksTarget = 132 * 8 * 2;

// the element type's bits, widened to float and narrowed back
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float widen(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits narrow(float v) { return __float_as_uint(v); }
};

template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float widen(Bits b) { return __bfloat162float(__ushort_as_bfloat16(b)); }
  static __device__ __forceinline__ Bits narrow(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
};

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// torch.maximum(t, 0) and torch.minimum(t, 0) as ATen computes them
__device__ __forceinline__ float max0(float t) { return t != t ? t : fmaxf(t, 0.0f); }
__device__ __forceinline__ float min0(float t) { return t != t ? t : fminf(t, 0.0f); }

// one element; b and a are the bias and alpha as the dtype's ops see them
// (rounded to bf16 for a bfloat16 y)
template <typename T>
__device__ __forceinline__ float bias_prelu1(float y, float b, float a);

template <>
__device__ __forceinline__ float bias_prelu1<float>(float y, float b, float a) {
  const float t = __fadd_rn(y, b);
  return __fadd_rn(max0(t), __fmul_rn(a, min0(t)));
}

template <>
__device__ __forceinline__ float bias_prelu1<__nv_bfloat16>(float y, float b, float a) {
  const float t = round_bf16(__fadd_rn(y, b));
  return __fadd_rn(max0(t), round_bf16(__fmul_rn(a, min0(t))));
}

template <typename T, int V>
union Pack {
  uint4 raw;
  typename Elem<T>::Bits e[V];
};

// y: sample s at in + s * sn, element (c, h, w) at c * sc + h * sh + w * sw.
// out: dense, sample s at out + s * C*H*W, its dims in memory from the
// outermost o0 to the innermost o2 (0 = c, 1 = h, 2 = w).  kVecIn: the V
// elements a thread owns lie consecutive and 16-byte aligned in y.
template <typename T, int V, bool kVecIn>
__global__ void __launch_bounds__(kThreads)
bias_prelu_kernel(const T* in, T* out, const float* __restrict__ bias, const float* __restrict__ alpha, int n,
                  int c, int h, int w, int sn, int sc, int sh, int sw, int o0, int o1, int o2) {
  using E = Elem<T>;
  using Bits = typename E::Bits;
  constexpr bool kLow = sizeof(T) == 2;
  const int chw = c * h * w;
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (j0 >= chw) return;
  const int size[3] = {c, h, w};
  const int inner = size[o2], mid = size[o1];
  float a[V], b[V];
  int off[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int j = j0 + k;
    const int i2 = j % inner, t = j / inner;
    const int i1 = t % mid, i0 = t / mid;
    // the logical index of dim d, from its place in memory
    auto at = [&](int d) { return o0 == d ? i0 : (o1 == d ? i1 : i2); };
    const int ci = at(0), hi = at(1), wi = at(2);
    const float ak = alpha[(ci * h + hi) * w + wi];
    const float bk = bias[ci];
    a[k] = kLow ? round_bf16(ak) : ak;
    b[k] = kLow ? round_bf16(bk) : bk;
    off[k] = ci * sc + hi * sh + wi * sw;
  }
  const int step = gridDim.y;
  for (int s0 = blockIdx.y; s0 < n; s0 += kUnroll * step) {
    Pack<T, V> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * step;
      if (s < n) {
        const T* src = in + static_cast<int64_t>(s) * sn;
        if (kVecIn) {
          v[u].raw = *reinterpret_cast<const uint4*>(src + off[0]);
        } else {
          const Bits* p = reinterpret_cast<const Bits*>(src);
#pragma unroll
          for (int k = 0; k < V; ++k) v[u].e[k] = p[off[k]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * step;
      if (s < n) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[u].e[k] = E::narrow(bias_prelu1<T>(E::widen(v[u].e[k]), b[k], a[k]));
        T* dst = out + static_cast<int64_t>(s) * chw + j0;
        if (V * sizeof(T) == 16) {
          *reinterpret_cast<uint4*>(dst) = v[u].raw;
        } else {
          Bits* p = reinterpret_cast<Bits*>(dst);
#pragma unroll
          for (int k = 0; k < V; ++k) p[k] = v[u].e[k];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* in_p, void* out_p, const float* bias, const float* alpha, int n, int c, int h, int w, int sn,
           int sc, int sh, int sw, int o0, int o1, int o2, bool consecutive, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* in = static_cast<const T*>(in_p);
  T* out = static_cast<T*>(out_p);
  const int64_t chw = static_cast<int64_t>(c) * h * w;
  // V elements a thread: whole vectors of each sample, out aligned; the
  // host says whether they are consecutive in y at offsets V divides
  const bool vec = chw % V == 0 && aligned16(out);
  const bool vec_in = vec && consecutive && aligned16(in);
  const int per = vec ? V : 1;
  const int64_t blocks_x = (chw / per + kThreads - 1) / kThreads;
  if (blocks_x > 2147483647) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks_y = (kBlocksTarget + blocks_x - 1) / blocks_x;
  blocks_y = blocks_y < n ? blocks_y : n;
  blocks_y = blocks_y < 65535 ? blocks_y : 65535;
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  if (vec_in) {
    bias_prelu_kernel<T, V, true><<<grid, kThreads, 0, st>>>(in, out, bias, alpha, n, c, h, w, sn, sc, sh, sw, o0, o1,
                                                             o2);
  } else if (vec) {
    bias_prelu_kernel<T, V, false><<<grid, kThreads, 0, st>>>(in, out, bias, alpha, n, c, h, w, sn, sc, sh, sw, o0, o1,
                                                              o2);
  } else {
    bias_prelu_kernel<T, 1, false><<<grid, kThreads, 0, st>>>(in, out, bias, alpha, n, c, h, w, sn, sc, sh, sw, o0, o1,
                                                              o2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (N, C, H, W) at strides (sn, sc, sh, sw) -> out, dense with its dims
// in memory in the order (o0, o1, o2) (0 = c, 1 = h, 2 = w); out may be y
// when y is dense (then in place).  consecutive != 0: in every sample the
// elements of out's innermost dim lie consecutive in y, and y's offsets of
// any V-th of them are multiples of V.  bf16 != 0: y and out are bfloat16,
// else float32.  A dense layer's (N, C) output passes H = W = 1.
extern "C" int dvt_bias_prelu(const void* y, void* out, const float* bias, const float* alpha, int n, int c,
                              int h, int w, int sn, int sc, int sh, int sw, int o0, int o1, int o2,
                              int consecutive, int bf16, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return 0;
  const bool order_ok = o0 != o1 && o1 != o2 && o0 != o2 && o0 >= 0 && o1 >= 0 && o2 >= 0 && o0 < 3 && o1 < 3 &&
                        o2 < 3;
  if (!order_ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(y, out, bias, alpha, n, c, h, w, sn, sc, sh, sw, o0, o1, o2, consecutive != 0, st);
  return launch<float>(y, out, bias, alpha, n, c, h, w, sn, sc, sh, sw, o0, o1, o2, consecutive != 0, st);
}
