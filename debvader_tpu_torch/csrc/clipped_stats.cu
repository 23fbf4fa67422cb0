// Sigma-clipped background statistics for the detection background mesh.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/clipped_stats.py
// sigma_clipped_stats_pallas (_cs_kernel, _subset_stats).  Per box of P
// pixels (P = 64*64 on the main path): three rounds of clipping to
// median +- (3*std + 1e-12), then (mean, median, std) of the survivors.
// The median is the exact order statistic at (count-1)//2 of monotonic
// int32 keys of the float bits (-0.0 orders below +0.0); mean and std are
// sums centred on the box's unclipped mean, over members only.  A round
// whose clip is empty (its std NaN after a mean that overflowed) has no
// members, so median 0 and std 0, and the next round admits |x| <= 1e-12;
// a zero count gives zeros.
//
// Bound on the H100: the bytes, 8 a pixel (value and valid mask), read
// once.  A direct port of the TPU kernel is held far above it by serial
// block-wide steps: three block sums and a 32-step one-bit radix descend
// each round, every step a block-wide count, about 140 reductions a box
// over only 16 shared loads a thread.
//
// Design: one block of kThreads = 512 threads per box (256 and 1,024
// measured slower), two blocks an SM, so the 256 boxes of a 1024^2 field
// run in one wave.
// - A thread keeps its pixels' values in registers, 4, 8, 16 or 32 of
//   them, the fewest that hold the box (P <= 32 * kThreads); a larger box
//   is held in shared memory, 4 bytes a pixel.  An invalid pixel is held
//   as NaN, which no clip admits.  Up to 8 a thread, two blocks share an
//   SM at 64 registers a thread; the 8-pixel kernel spills a few bytes
//   there, which measured faster than one block an SM without the spill.
// - A round's members are the valid pixels with lo <= v <= hi: a
//   contiguous range of keys (+-0.0 always fall on the same side of lo).
//   So the k-th member is the valid key of rank k + #(valid, v < lo), and
//   one set of histograms of the valid keys serves every round: 2,048 bins
//   of key bits 31..21 built once a box; 2,048 bins of bits 20..10 within
//   the chosen top bucket and 1,024 of bits 9..0 within the chosen 22-bit
//   prefix, each rebuilt only when the median leaves the bucket it was
//   built for.  A lookup is one barrier, and none when the rank falls in
//   the bin that level found last round.
// - A round's count, count below lo, sum and sum of squares are one fused
//   reduction (warp shuffles, one barrier).
// - A warp whose lanes all add to one bin (a box of ties) adds once.
// That is 2 to 10 barriers a round in place of about 70.  No TMA: each
// pixel is read once, 4 bytes a thread, coalesced, into registers.
//
// Built with -fmad=false and explicit _rn intrinsics so the clip
// thresholds round like the plain PyTorch version's separate ops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins1 = 2048;  // key bits 31..21
constexpr int kBins2 = 2048;  // key bits 20..10
constexpr int kBins3 = 1024;  // key bits 9..0
constexpr int kRegPixels = 32 * kThreads;  // largest box held in registers
static_assert(kBins3 % kThreads == 0, "every thread owns whole bins");

// the key order as an unsigned integer: signed key ^ 0x80000000
__device__ __forceinline__ uint32_t ukey(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ukey(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

struct Shared {
  int h1[kBins1];
  int h2[kBins2];
  int h3[kBins3];
  int red_i[2][2][kWarps];
  float red_f[2][2][kWarps];
  int warp_total[kWarps];
  int found[2][3];
};

// Add one to h[bin] for every lane with ok.  A warp whose lanes all hold
// the same bin (a box of ties) adds once; otherwise each lane adds, and
// lanes that share a bin serialise only among themselves.  Every lane of
// the warp calls it.
__device__ __forceinline__ void hist_add(int* h, uint32_t bin, bool ok) {
  const unsigned lanes = __ballot_sync(0xffffffffu, ok);
  if (lanes == 0) return;
  const int leader = __ffs(lanes) - 1;
  const uint32_t first = __shfl_sync(0xffffffffu, bin, leader);
  if (__all_sync(0xffffffffu, !ok || bin == first)) {
    if (static_cast<int>(threadIdx.x & 31) == leader) atomicAdd(&h[bin], __popc(lanes));
  } else if (ok) {
    atomicAdd(&h[bin], 1);
  }
}

// One level of the key histogram as this thread sees it: it owns bins
// [tid * K, tid * K + K), holding `own` keys, after `excl` keys of the
// bins before them.  scan() fixes the two after a build (one barrier);
// find() then answers a rank (one barrier), and remembers the bin it
// found (its first rank and count, the same in every thread), so that a
// later rank in the same bin is answered with no barrier.
template <int NB>
struct Level {
  static constexpr int K = NB / kThreads;
  int excl = 0, own = 0;
  int bin = -1, start = 0, count = 0;

  // zero this thread's bins (no other thread reads them) and forget the
  // last bin found
  __device__ __forceinline__ void clear(int* h) {
#pragma unroll
    for (int k = 0; k < K; ++k) h[threadIdx.x * K + k] = 0;
    bin = -1;
  }

  __device__ __forceinline__ void scan(const int* h, Shared& sh) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    own = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) own += h[threadIdx.x * K + k];
    int inc = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) sh.warp_total[warp] = inc;
    __syncthreads();
    int before = lane < warp ? sh.warp_total[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
    excl = before + inc - own;
  }

  // The bin holding rank r (0 <= r < the level's total); returns the rank
  // within it.  `buf` alternates between calls that take a barrier: the
  // slot a call writes was last read before the barrier of the call in
  // between.
  __device__ __forceinline__ int find(const int* h, int r, Shared& sh, int& buf) {
    if (bin >= 0 && r >= start && r < start + count) return r - start;
    if (r >= excl && r < excl + own) {
      int acc = excl;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = h[threadIdx.x * K + k];
        if (r < acc + c) {
          sh.found[buf][0] = threadIdx.x * K + k;
          sh.found[buf][1] = acc;
          sh.found[buf][2] = c;
          break;
        }
        acc += c;
      }
    }
    __syncthreads();
    bin = sh.found[buf][0];
    start = sh.found[buf][1];
    count = sh.found[buf][2];
    buf ^= 1;
    return r - start;
  }
};

// Block-wide sums of (a, b, c, d), the same in every thread; one barrier.
// Alternate `buf` between calls, as for Level::find.
__device__ __forceinline__ void block_sum4(int& a, int& b, float& c, float& d, Shared& sh,
                                           int buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
    c = __fadd_rn(c, __shfl_down_sync(0xffffffffu, c, o));
    d = __fadd_rn(d, __shfl_down_sync(0xffffffffu, d, o));
  }
  if (lane == 0) {
    sh.red_i[buf][0][warp] = a;
    sh.red_i[buf][1][warp] = b;
    sh.red_f[buf][0][warp] = c;
    sh.red_f[buf][1][warp] = d;
  }
  __syncthreads();
  const bool in = lane < kWarps;
  a = in ? sh.red_i[buf][0][lane] : 0;
  b = in ? sh.red_i[buf][1][lane] : 0;
  c = in ? sh.red_f[buf][0][lane] : 0.f;
  d = in ? sh.red_f[buf][1][lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
    c = __fadd_rn(c, __shfl_xor_sync(0xffffffffu, c, o));
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, o));
  }
}

// PER pixels a thread, pixel j * kThreads + tid, in registers; or, with
// kInShared, the whole box in dynamic shared memory (PER is then unused
// and the loops run to P).
template <int PER, bool kInShared>
struct Pixels {
  float v[kInShared ? 1 : PER];
  const float* xs;
  int p;

  template <typename Fn>
  __device__ __forceinline__ void each(Fn fn) const {
    if constexpr (kInShared) {
      for (int i0 = 0; i0 < p; i0 += kThreads) {
        const int i = i0 + threadIdx.x;
        fn(i < p ? xs[i] : __int_as_float(0x7fc00000));
      }
    } else {
#pragma unroll
      for (int j = 0; j < PER; ++j) fn(v[j]);
    }
  }
};

template <int PER, bool kInShared>
__global__ void __launch_bounds__(kThreads, (!kInShared && PER <= 8) ? 2 : 1)
clipped_stats_kernel(const float* __restrict__ x, const float* __restrict__ valid,
                     float* __restrict__ mean_out, float* __restrict__ med_out,
                     float* __restrict__ std_out, int p, int iters) {
  __shared__ Shared sh;
  extern __shared__ float xs[];  // kInShared: the box, invalid pixels NaN
  const float kNaN = __int_as_float(0x7fc00000);

  Pixels<PER, kInShared> px;
  px.xs = xs;
  px.p = p;
  const size_t off = static_cast<size_t>(blockIdx.x) * p;
  int cnt = 0, unused = 0;
  float s = 0.f, unused_f = 0.f;
  auto load = [&](int i) {
    float v = kNaN;
    if (i < p) {
      const float xv = x[off + i];
      if (valid[off + i] > 0.f) {
        v = xv;
        ++cnt;
        s = __fadd_rn(s, xv);
      }
    }
    return v;
  };
  if constexpr (kInShared) {
    for (int i = threadIdx.x; i < p; i += kThreads) xs[i] = load(i);
  } else {
#pragma unroll
    for (int j = 0; j < PER; ++j) px.v[j] = load(j * kThreads + threadIdx.x);
  }
  Level<kBins1> l1;
  Level<kBins2> l2;
  Level<kBins3> l3;
  l1.clear(sh.h1);
  block_sum4(cnt, unused, s, unused_f, sh, 0);  // its barrier orders the clear
  const float c = __fdiv_rn(s, static_cast<float>(max(cnt, 1)));

  // top-level histogram of every valid key, kept for all rounds
  px.each([&](float v) { hist_add(sh.h1, ukey(v) >> 21, v == v); });
  __syncthreads();
  l1.scan(sh.h1, sh);

  int buf = 1, fbuf = 0;
  int pre2 = -1, pre3 = -1;  // the buckets h2 and h3 were built for
  float lo = 0.f, hi = 0.f;
  bool clipped = false;
  for (int round = 0; round <= iters; ++round) {
    int m = 0, below = 0;
    float s1 = 0.f, s2 = 0.f;
    px.each([&](float v) {
      if (v != v) return;
      if (!clipped || (v >= lo && v <= hi)) {
        const float y = __fsub_rn(v, c);
        ++m;
        s1 = __fadd_rn(s1, y);
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      } else {
        below += v < lo;
      }
    });
    block_sum4(m, below, s1, s2, sh, buf);
    buf ^= 1;
    const int n = m;
    const float nf = static_cast<float>(max(n, 1));
    const float mean_y = __fdiv_rn(s1, nf);
    const float d = __fsub_rn(__fdiv_rn(s2, nf), __fmul_rn(mean_y, mean_y));
    const float sd = __fsqrt_rn(d < 0.f ? 0.f : d);  // a NaN stays NaN, as in torch.clamp

    float med = 0.f;
    if (n > 0) {
      // rank of the median among all valid keys
      const int r1 = l1.find(sh.h1, below + (n - 1) / 2, sh, fbuf);
      if (l1.bin != pre2) {
        const int b1 = l1.bin;
        l2.clear(sh.h2);
        __syncthreads();
        px.each([&](float v) {
          const uint32_t u = ukey(v);
          hist_add(sh.h2, (u >> 10) & 0x7ffu, v == v && static_cast<int>(u >> 21) == b1);
        });
        __syncthreads();
        l2.scan(sh.h2, sh);
        pre2 = b1;
      }
      const int r2 = l2.find(sh.h2, r1, sh, fbuf);
      const int p22 = (l1.bin << 11) | l2.bin;
      if (p22 != pre3) {
        l3.clear(sh.h3);
        __syncthreads();
        px.each([&](float v) {
          const uint32_t u = ukey(v);
          hist_add(sh.h3, u & 0x3ffu, v == v && static_cast<int>(u >> 10) == p22);
        });
        __syncthreads();
        l3.scan(sh.h3, sh);
        pre3 = p22;
      }
      l3.find(sh.h3, r2, sh, fbuf);
      med = from_ukey((static_cast<uint32_t>(p22) << 10) | static_cast<uint32_t>(l3.bin));
    }

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

template <int PER, bool kInShared>
int launch(const float* x, const float* valid, float* mean, float* med, float* std_out,
           int n_boxes, int p, int iters, cudaStream_t stream) {
  const size_t dyn = kInShared ? static_cast<size_t>(p) * sizeof(float) : 0;
  if (kInShared) {
    const cudaError_t e = cudaFuncSetAttribute(
        clipped_stats_kernel<PER, kInShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  clipped_stats_kernel<PER, kInShared><<<n_boxes, kThreads, dyn, stream>>>(
      x, valid, mean, med, std_out, p, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes and valid: (n_boxes, p) float32, contiguous; outputs (n_boxes,).
// Returns the cudaError_t of the launch.
extern "C" int dvt_clipped_stats(const float* x, const float* valid, float* mean,
                                 float* med, float* std_out, int n_boxes, int p,
                                 int iters, void* stream) {
  if (n_boxes <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 4 * kThreads) return launch<4, false>(x, valid, mean, med, std_out, n_boxes, p, iters, st);
  if (p <= 8 * kThreads) return launch<8, false>(x, valid, mean, med, std_out, n_boxes, p, iters, st);
  if (p <= 16 * kThreads) return launch<16, false>(x, valid, mean, med, std_out, n_boxes, p, iters, st);
  if (p <= kRegPixels) return launch<32, false>(x, valid, mean, med, std_out, n_boxes, p, iters, st);
  return launch<1, true>(x, valid, mean, med, std_out, n_boxes, p, iters, st);
}
