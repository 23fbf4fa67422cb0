// Sigma-clipped background statistics for the detection background mesh.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/clipped_stats.py
// sigma_clipped_stats_pallas (_cs_kernel, _subset_stats).  Per box of P
// pixels (P = 64*64 on the main path): three rounds of clipping to
// median +- (3*std + 1e-12), then (mean, median, std) of the survivors.
// The median is the exact order statistic at (count-1)//2, found by a
// 32-step radix descend over monotonic int32 keys of the float bits (no
// sort); mean and std are sums centred on the box's unclipped mean.
//
// Bound on the H100: the operations.  The box is read once (8 bytes a
// pixel with its valid mask) but every round walks it 35 times (three
// sums and 32 rank counts), all from shared memory.  Design: one thread
// block per box; the box's values, validity and the round's member keys
// (non-members set to INT32_MAX, as the TPU kernel folds them) sit in
// shared memory, 9 bytes a pixel (36 KB at P = 4096); each descend step is
// one block-wide count.  Simple and exact; the G*G = 256 boxes of a
// 1024^2 field fill two blocks per SM.
//
// Built with -fmad=false and explicit _rn intrinsics so the clip
// thresholds round like the plain PyTorch version's separate ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int32_t order_key(float v) {
  const int32_t b = __float_as_int(v);
  return b < 0 ? (b ^ 0x7fffffff) : b;
}

// Block-wide sum, returned to every thread.  The leading barrier keeps a
// previous call's readers of `red` ahead of this call's writers.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) total += red[w];
  return total;
}

__global__ void __launch_bounds__(kThreads)
clipped_stats_kernel(const float* __restrict__ x, const float* __restrict__ valid,
                     float* __restrict__ mean_out, float* __restrict__ med_out,
                     float* __restrict__ std_out, int p, int iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int32_t* mk = reinterpret_cast<int32_t*>(xs + p);
  unsigned char* vs = reinterpret_cast<unsigned char*>(mk + p);
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];

  const size_t off = static_cast<size_t>(blockIdx.x) * p;
  int cnt = 0;
  float s = 0.f;
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const float v = x[off + i];
    const bool ok = valid[off + i] > 0.f;
    xs[i] = v;
    vs[i] = ok;
    if (ok) {
      ++cnt;
      s = __fadd_rn(s, v);
    }
  }
  const int n_all = block_sum(cnt, redi);
  const float c = __fdiv_rn(block_sum(s, redf), static_cast<float>(max(n_all, 1)));

  float lo = 0.f, hi = 0.f;
  bool clipped = false;
  for (int round = 0; round <= iters; ++round) {
    // Members of this round; each thread touches only its own indices, so
    // mk needs no barrier between this loop and the descend below.
    int m = 0;
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < p; i += kThreads) {
      const float v = xs[i];
      const bool member = vs[i] && (!clipped || (v >= lo && v <= hi));
      mk[i] = member ? order_key(v) : INT32_MAX;
      if (member) {
        const float y = __fsub_rn(v, c);
        ++m;
        s1 = __fadd_rn(s1, y);
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
    }
    const int n = block_sum(m, redi);
    const float sum1 = block_sum(s1, redf);
    const float sum2 = block_sum(s2, redf);
    const float nf = static_cast<float>(max(n, 1));
    const float mean_y = __fdiv_rn(sum1, nf);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(sum2, nf), __fmul_rn(mean_y, mean_y)), 0.f);
    const float sd = __fsqrt_rn(var);

    // k-th smallest member key, k = (n-1)//2, most significant bit first:
    // keep bit b when fewer than k+1 members lie below the candidate.
    const int k = max(n - 1, 0) / 2;
    uint32_t base = 0u;
    for (int b = 31; b >= 0; --b) {
      const uint32_t t = base | (1u << b);
      const int32_t tk = static_cast<int32_t>(t ^ 0x80000000u);
      int below = 0;
      for (int i = threadIdx.x; i < p; i += kThreads) below += mk[i] < tk;
      if (block_sum(below, redi) <= k) base = t;
    }
    const int32_t wk = static_cast<int32_t>(base ^ 0x80000000u);
    const float med = n > 0 ? __int_as_float(wk < 0 ? (wk ^ 0x7fffffff) : wk) : 0.f;

    if (round == iters) {
      if (threadIdx.x == 0) {
        mean_out[blockIdx.x] = n > 0 ? __fadd_rn(mean_y, c) : 0.f;
        med_out[blockIdx.x] = med;
        std_out[blockIdx.x] = sd;
      }
    } else {
      const float thr = __fadd_rn(__fmul_rn(3.f, sd), 1e-12f);
      lo = __fsub_rn(med, thr);
      hi = __fadd_rn(med, thr);
      clipped = true;
    }
  }
}

}  // namespace

// boxes and valid: (n_boxes, p) float32, contiguous; outputs (n_boxes,).
// Returns the cudaError_t of the launch.
extern "C" int dvt_clipped_stats(const float* x, const float* valid, float* mean,
                                 float* med, float* std_out, int n_boxes, int p,
                                 int iters, void* stream) {
  if (n_boxes <= 0) return 0;
  const size_t smem = static_cast<size_t>(p) * (sizeof(float) + sizeof(int32_t) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        clipped_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  clipped_stats_kernel<<<n_boxes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, valid, mean, med, std_out, p, iters);
  return static_cast<int>(cudaGetLastError());
}
