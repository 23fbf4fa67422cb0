// Position registration: a bounded Gauss-Newton fit of each source's
// (dy, dx) shift, one thread block a source.
//
// The port's kernel for XLA code of the JAX package (no Pallas kernel):
// debvader_tpu/ops/registration.py position_optimization_batch_windowed
// (dvt_register_windowed) and its full-field branch
// position_optimization_batch (dvt_register_full).  For source i with
// predicted r-band stamp P_i (S x S) and detected offset o_i:
//   base = P_i placed at field centre + o_i (bilinear for the fraction),
//   x = 0; iterations times:
//     r = field - shift(base, x), J = -d shift(base, x) / dx,
//     A = J^T J + 1e-6 I, y = J^T r,
//     x = clip(x - A^{-1} y, -bound, bound),
// with A^{-1} y by LU with partial pivoting rounded as LAPACK's sgetrf /
// sgetrs on the CPU (l = a10 * (1 / a00), u11 = a11 - l * a01, then
// fused multiply-adds and reciprocals in the two triangular solves), and
// non-finite field pixels counted as 0.
//
// Windowed form: the sums run over a win x win window of the field
// (win = S + 2 (ceil(bound) + 3)) starting at pos0 + floor(o) - margin,
// clamped into rows [row_lo, row_hi) and the band's columns.  The base is
// the stamp in a margin-padded canvas, shifted by frac(o), the window's part
// padded by bp = ceil(bound) + 1; shift(base, x) is a slice of that at
// bp - ix - 1, ix = ceil(x) - 1, and a two-tap blend with f2 = x - ix in
// (0, 1], zero where the sample point leaves the window; the Jacobian is
// the blend's derivative written out:
//   tmp(a, b) = f2y e(a, b) + (1 - f2y) e(a + 1, b)
//   out(a, b) = f2x tmp(a, b) + (1 - f2x) tmp(a, b + 1)
//   d out / d x0 = f2x (e(a, b) - e(a + 1, b)) + (1 - f2x) (e(a, b + 1) - e(a + 1, b + 1))
//   d out / d x1 = tmp(a, b) - tmp(a, b + 1).
// Full-field form (fields smaller than the window): the stamp centred in
// the field, base = shift(canvas, o) and shift(base, x) by the generic
// bilinear shift (taps at floor(i - d), zero outside the field and where
// the sample point leaves it), and its derivative.
//
// Design of the windowed kernel, for an H100 (bound by its operations,
// 32 a pixel a step: the blend, the Jacobian, the residual and the five
// products and sums), one block a source:
// - the stamp is staged once into shared memory with a zero border, and
//   the padded base blended from it (no guarded gathers from device
//   memory);
// - each thread owns one column and kRows consecutive rows of the window
//   for all the steps: their field values live in registers, their
//   addresses are fixed offsets, a row's base values serve the next row's
//   blend too (two shared loads a pixel, no division), and a pixel outside
//   the shifted window's extent is masked by selects, not a branch;
// - one barrier a step: each warp writes its five sums into a
//   double-buffered slot, and after the barrier every thread reads all the
//   slots in one fixed order and solves the 2x2 system itself: identical
//   operations in an identical order give every thread the same x, so no
//   broadcast follows;
// - the five sums accumulate by fused multiply-adds; the solve's
//   reciprocals are __frcp_rn, correctly rounded as __fdiv_rn(1, p)
//   without its checked path.
// Built with -fmad=false: the blend, the Jacobian and the residual round
// each multiply and add on their own as the plain PyTorch version does;
// the sums add in another order (and fused) than torch.sum, so the two
// agree to a tolerance.
// Measured on an H100 and not kept (PERF.md): a cluster of two blocks a
// source summing half the rows each through distributed shared memory
// balances the 295-source call's SMs better but is slower (its per-step
// cluster barrier and remote reads cost more); 18, 30 or 36 rows a thread
// instead of 24; a second copy of the pixel loop without the mask for
// threads inside the window (the code size cost more than the selects);
// one thread solving with a second barrier.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;  // the full-field kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 24;      // rows a thread (windowed)
constexpr int kMaxBlockThreads = 512;
constexpr int kSlot = 8;       // floats a warp's five sums take in a slot

struct Sums {
  float a00, a01, a11, y0, y1;
};

__device__ __forceinline__ void add_pixel(Sums& s, float r, float j0, float j1) {
  s.a00 = __fadd_rn(s.a00, __fmul_rn(j0, j0));
  s.a01 = __fadd_rn(s.a01, __fmul_rn(j0, j1));
  s.a11 = __fadd_rn(s.a11, __fmul_rn(j1, j1));
  s.y0 = __fadd_rn(s.y0, __fmul_rn(j0, r));
  s.y1 = __fadd_rn(s.y1, __fmul_rn(j1, r));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ Sums warp_sums(Sums s) {
  return {warp_sum(s.a00), warp_sum(s.a01), warp_sum(s.a11), warp_sum(s.y0), warp_sum(s.y1)};
}

// The block's five sums, in thread 0 (others get garbage).
__device__ __forceinline__ Sums block_sums(Sums s, float (*scratch)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sums(s);
  if (lane == 0) {
    scratch[0][warp] = s.a00;
    scratch[1][warp] = s.a01;
    scratch[2][warp] = s.a11;
    scratch[3][warp] = s.y0;
    scratch[4][warp] = s.y1;
  }
  __syncthreads();
  Sums t = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      t.a00 = __fadd_rn(t.a00, scratch[0][w]);
      t.a01 = __fadd_rn(t.a01, scratch[1][w]);
      t.a11 = __fadd_rn(t.a11, scratch[2][w]);
      t.y0 = __fadd_rn(t.y0, scratch[3][w]);
      t.y1 = __fadd_rn(t.y1, scratch[4][w]);
    }
  }
  return t;
}

// One Gauss-Newton update of x: LAPACK's rounding of the 2x2 solve, then
// the clip.  __frcp_rn(p) is __fdiv_rn(1, p), correctly rounded.
__device__ __forceinline__ void gn_update(float& x0, float& x1, const Sums& s, float bound) {
  const float a00 = __fadd_rn(s.a00, 1e-6f), a11 = __fadd_rn(s.a11, 1e-6f);
  const float a01 = s.a01, a10 = s.a01;
  const bool swap = fabsf(a10) > fabsf(a00);
  const float p00 = swap ? a10 : a00, p01 = swap ? a11 : a01;
  const float p10 = swap ? a00 : a10, p11 = swap ? a01 : a11;
  const float q0 = swap ? s.y1 : s.y0, q1 = swap ? s.y0 : s.y1;
  const float r00 = __frcp_rn(p00);
  const float l = __fmul_rn(p10, r00);
  const float u11 = __fsub_rn(p11, __fmul_rn(l, p01));
  const float z1 = __fmaf_rn(-l, q0, q1);
  const float s1 = __fmul_rn(z1, __frcp_rn(u11));
  const float s0 = __fmul_rn(__fmaf_rn(-p01, s1, q0), r00);
  // NaN stays NaN, as torch.clamp and jnp.clip keep it
  const float v0 = __fsub_rn(x0, s0), v1 = __fsub_rn(x1, s1);
  x0 = v0 < -bound ? -bound : (v0 > bound ? bound : v0);
  x1 = v1 < -bound ? -bound : (v1 > bound ? bound : v1);
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ float bilinear(float fy, float gy, float fx, float gx, float v00, float v10,
                                          float v01, float v11) {
  const float left = __fadd_rn(__fmul_rn(fy, v00), __fmul_rn(gy, v10));
  const float right = __fadd_rn(__fmul_rn(fy, v01), __fmul_rn(gy, v11));
  return __fadd_rn(__fmul_rn(fx, left), __fmul_rn(gx, right));
}

// ------------------------------------------------------------- windowed

// The launch geometry of a window of `win` rows: row groups (threads a
// column) and threads a block.
struct WindowedPlan {
  int groups, threads;
};

__host__ __device__ inline WindowedPlan windowed_plan(int win) {
  const int groups = (win + kRows - 1) / kRows;
  return {groups, (win * groups + 31) / 32 * 32};
}

__device__ __forceinline__ void add_pixel_fused(Sums& s, float r, float j0, float j1) {
  s.a00 = __fmaf_rn(j0, j0, s.a00);
  s.a01 = __fmaf_rn(j0, j1, s.a01);
  s.a11 = __fmaf_rn(j1, j1, s.a11);
  s.y0 = __fmaf_rn(j0, r, s.y0);
  s.y1 = __fmaf_rn(j1, r, s.y1);
}

// Thread t takes the column t % win and the rows (t / win) * kRows + k,
// k < kRows, of the window (a row past the window or a thread past the
// last group adds zeros).  Shared memory: the stamp with a zero border
// ((s + 2)^2), then groups * kRows + 2 bp rows of the padded base.
__global__ void __launch_bounds__(kMaxBlockThreads)
register_windowed_kernel(const float* __restrict__ band, const float* __restrict__ preds,
                         const float* __restrict__ offsets, float* __restrict__ out, int s, int h,
                         int w, int row_lo, int row_hi, int cb, float bound, int iterations) {
  extern __shared__ float smem[];
  __shared__ __align__(16) float slots[2][kMaxBlockThreads / 32][kSlot];
  const int win = s + 2 * (cb + 3), margin = cb + 3, big = win + 2 * margin, bp = cb + 1;
  const int pw = win + 2 * bp, sp = s + 2;
  const WindowedPlan plan = windowed_plan(win);
  const int i = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int brows = plan.groups * kRows + 2 * bp;
  float* tile = smem;            // sp * sp
  float* base = smem + sp * sp;  // brows * pw
  const float* pred = preds + static_cast<size_t>(i) * s * s;

  const float oy = offsets[2 * i], ox = offsets[2 * i + 1];
  const float ioy = floorf(oy), iox = floorf(ox);
  const float fy = __fsub_rn(oy, ioy), fx = __fsub_rn(ox, iox);
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const int pos0y = (h - s) / 2, pos0x = (w - s) / 2;
  const int iy = static_cast<int>(ioy), ix = static_cast<int>(iox);
  const int g0 = min(max(pos0y + iy - margin, row_lo), row_hi - win);
  const int g1 = min(max(pos0x + ix - margin, 0), w - win);
  const int py = min(max(pos0y + iy - g0 + margin, 0), big - s);
  const int px = min(max(pos0x + ix - g1 + margin, 0), big - s);

  for (int e = tid; e < sp * sp; e += nthreads) {
    const int r = e / sp - 1, c = e - (r + 1) * sp - 1;
    tile[e] = (r >= 0 && r < s && c >= 0 && c < s) ? pred[r * s + c] : 0.f;
  }
  // this thread's pixels: column b, rows a0 + k for k < lim; their field
  // values in registers
  const int group = min(tid / win, plan.groups - 1), b = tid - (tid / win) * win;
  const int a0 = group * kRows;
  const int lim = tid < win * plan.groups ? min(kRows, win - a0) : 0;
  float fw[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    fw[k] = k < lim ? finite_or_zero(band[static_cast<long long>(g0 + a0 + k) * w + g1 + b]) : 0.f;
  }
  __syncthreads();
  // base (a, b) is the stamp's canvas at (a + margin, b + margin) shifted
  // by frac(o); canvas (R, C) is stamp (R - py, C - px), zero outside,
  // which the tile's border gives for every clamped index
  for (int e = tid; e < brows * pw; e += nthreads) {
    const int j = e / pw, a = j - bp, c = e - j * pw - bp;
    float v = 0.f;
    if (a >= 0 && a < win && c >= 0 && c < win) {
      const int ty0 = min(max(a + margin - py, 0), s + 1), ty1 = min(max(a + margin + 1 - py, 0), s + 1);
      const int tx0 = min(max(c + margin - px, 0), s + 1), tx1 = min(max(c + margin + 1 - px, 0), s + 1);
      v = bilinear(fy, gy, fx, gx, tile[ty0 * sp + tx0], tile[ty1 * sp + tx0], tile[ty0 * sp + tx1],
                   tile[ty1 * sp + tx1]);
    }
    base[e] = v;
  }
  __syncthreads();

  const float wm1 = static_cast<float>(win - 1), fb = static_cast<float>(b), fa0 = static_cast<float>(a0);
  float x0 = 0.f, x1 = 0.f;
  for (int it = 0; it < iterations; ++it) {
    const float kx0 = __fsub_rn(ceilf(x0), 1.f), kx1 = __fsub_rn(ceilf(x1), 1.f);
    const float f2y = __fsub_rn(x0, kx0), f2x = __fsub_rn(x1, kx1);
    const float g2y = __fsub_rn(1.f, f2y), g2x = __fsub_rn(1.f, f2x);
    const int sy = min(max(bp - static_cast<int>(kx0) - 1, 0), pw - win - 1);
    const int sx = min(max(bp - static_cast<int>(kx1) - 1, 0), pw - win - 1);
    const float hi0 = __fadd_rn(wm1, x0), hi1 = __fadd_rn(wm1, x1);
    const bool col_in = fb >= x1 && fb <= hi1;
    Sums acc = {0.f, 0.f, 0.f, 0.f, 0.f};
    // padded base row sy + a holds the sample row of window row a
    const float* ep = base + (a0 + sy) * pw + sx + b;
    float e00 = ep[0], e01 = ep[1];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const float e10 = ep[(k + 1) * pw], e11 = ep[(k + 1) * pw + 1];
      const float fa = __fadd_rn(fa0, static_cast<float>(k));
      const bool in = k < lim && col_in && fa >= x0 && fa <= hi0;
      const float t0 = __fadd_rn(__fmul_rn(f2y, e00), __fmul_rn(g2y, e10));
      const float t1 = __fadd_rn(__fmul_rn(f2y, e01), __fmul_rn(g2y, e11));
      const float o = __fadd_rn(__fmul_rn(f2x, t0), __fmul_rn(g2x, t1));
      const float d0 = __fadd_rn(__fmul_rn(f2x, __fsub_rn(e00, e10)), __fmul_rn(g2x, __fsub_rn(e01, e11)));
      const float d1 = __fsub_rn(t0, t1);
      add_pixel_fused(acc, __fsub_rn(fw[k], in ? o : 0.f), in ? -d0 : 0.f, in ? -d1 : 0.f);
      e00 = e10;
      e01 = e11;
    }
    const Sums ws = warp_sums(acc);
    float* slot = slots[it & 1][0];
    if ((tid & 31) == 0) {
      float* mine = slot + (tid >> 5) * kSlot;
      mine[0] = ws.a00, mine[1] = ws.a01, mine[2] = ws.a11, mine[3] = ws.y0, mine[4] = ws.y1;
    }
    __syncthreads();
    Sums tot = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int wi = 0; wi < nwarps; ++wi) {
      const float4 q = *reinterpret_cast<const float4*>(slot + wi * kSlot);
      tot.a00 = __fadd_rn(tot.a00, q.x);
      tot.a01 = __fadd_rn(tot.a01, q.y);
      tot.a11 = __fadd_rn(tot.a11, q.z);
      tot.y0 = __fadd_rn(tot.y0, q.w);
      tot.y1 = __fadd_rn(tot.y1, slot[wi * kSlot + 4]);
    }
    gn_update(x0, x1, tot, bound);
  }
  if (tid == 0) {
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
  }
}

// ----------------------------------------------------------- full field

// The generic bilinear shift of an f x f image at (i, j) by d: the value
// and, with `jac`, d/d dy and d/d dx (JAX's forward-mode order).
__device__ __forceinline__ void shift_at(const float* img, int f, int i, int j, float dy, float dx,
                                         bool jac, float* o, float* ddy, float* ddx) {
  const float yy = __fsub_rn(static_cast<float>(i), dy), xx = __fsub_rn(static_cast<float>(j), dx);
  const float y0f = floorf(yy), x0f = floorf(xx);
  const float fy = __fsub_rn(yy, y0f), fx = __fsub_rn(xx, x0f);
  const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
  const int y0 = static_cast<int>(y0f), x0 = static_cast<int>(x0f);
  auto tap = [&](int yi, int xi) {
    return (yi >= 0 && yi < f && xi >= 0 && xi < f) ? img[yi * f + xi] : 0.f;
  };
  const float t00 = tap(y0, x0), t01 = tap(y0, x0 + 1), t10 = tap(y0 + 1, x0), t11 = tap(y0 + 1, x0 + 1);
  const float lim = static_cast<float>(f - 1);
  const bool inside = yy >= 0.f && yy <= lim && xx >= 0.f && xx <= lim;
  if (!inside) {
    *o = 0.f;
    if (jac) *ddy = *ddx = 0.f;
    return;
  }
  float v = __fmul_rn(__fmul_rn(t00, gy), gx);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(t01, gy), fx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(t10, fy), gx));
  *o = __fadd_rn(v, __fmul_rn(__fmul_rn(t11, fy), fx));
  if (jac) {
    float a = __fadd_rn(__fmul_rn(t00, gx), __fmul_rn(t01, fx));
    a = __fsub_rn(a, __fmul_rn(t10, gx));
    *ddy = __fsub_rn(a, __fmul_rn(t11, fx));
    float b = __fsub_rn(__fmul_rn(t00, gy), __fmul_rn(t01, gy));
    b = __fadd_rn(b, __fmul_rn(t10, fy));
    *ddx = __fsub_rn(b, __fmul_rn(t11, fy));
  }
}

__global__ void __launch_bounds__(kThreads)
register_full_kernel(const float* __restrict__ band, const float* __restrict__ preds,
                     const float* __restrict__ offsets, float* __restrict__ out, int s, int f,
                     float bound, int iterations) {
  extern __shared__ float smem[];
  __shared__ float scratch[5][kWarps];
  __shared__ float x[2];
  float* fb = smem;          // f * f field
  float* canvas = smem + f * f;  // the centred stamp, then the base
  float* base = canvas + f * f;
  const int i = blockIdx.x, tid = threadIdx.x;
  const float* pred = preds + static_cast<size_t>(i) * s * s;
  const int pos0 = (f - s) / 2;
  for (int e = tid; e < f * f; e += kThreads) {
    const int r = e / f - pos0, c = e % f - pos0;
    fb[e] = finite_or_zero(band[e]);
    canvas[e] = (r >= 0 && r < s && c >= 0 && c < s) ? pred[r * s + c] : 0.f;
  }
  __syncthreads();
  const float oy = offsets[2 * i], ox = offsets[2 * i + 1];
  for (int e = tid; e < f * f; e += kThreads) {
    shift_at(canvas, f, e / f, e % f, oy, ox, false, base + e, nullptr, nullptr);
  }
  if (tid == 0) x[0] = x[1] = 0.f;
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    const float x0 = x[0], x1 = x[1];
    Sums acc = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int e = tid; e < f * f; e += kThreads) {
      float o, d0, d1;
      shift_at(base, f, e / f, e % f, x0, x1, true, &o, &d0, &d1);
      add_pixel(acc, __fsub_rn(fb[e], o), -d0, -d1);
    }
    const Sums tot = block_sums(acc, scratch);
    if (tid == 0) gn_update(x[0], x[1], tot, bound);
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * i] = x[0];
    out[2 * i + 1] = x[1];
  }
}

// Allow `bytes` of dynamic shared memory beside the kernel's static
// scratch (set every time: at 48 KB the two together pass the default).
int set_shared(const void* kernel, size_t bytes) {
  if (bytes > 226 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

float from_bits(int bits) {
  float v;
  memcpy(&v, &bits, sizeof v);
  return v;
}

}  // namespace

// band (h, w) float32 row-major; preds (n, s, s) float32 contiguous;
// offsets (n, 2) float32 from the band's centre ((h - s) / 2, (w - s) / 2);
// out (n, 2) float32 shifts.  Windows stay inside rows [row_lo, row_hi),
// which must hold one (row_hi - row_lo >= win, w >= win); cb = ceil(bound),
// bound_bits the float32 bits of bound.  Returns the cudaError_t of the
// launch.
extern "C" int dvt_register_windowed(const float* band, const float* preds, const float* offsets,
                                     float* out, int n, int s, int h, int w, int row_lo, int row_hi,
                                     int cb, int bound_bits, int iterations, void* stream) {
  if (n <= 0) return 0;
  const int win = s + 2 * (cb + 3), pw = win + 2 * (cb + 1);
  if (row_hi - row_lo < win || w < win || row_lo < 0 || row_hi > h) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const WindowedPlan plan = windowed_plan(win);
  if (plan.threads > kMaxBlockThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared =
      (static_cast<size_t>(s + 2) * (s + 2) + static_cast<size_t>(plan.groups * kRows + pw - win) * pw) * sizeof(float);
  const int e = set_shared(reinterpret_cast<const void*>(register_windowed_kernel), shared);
  if (e != 0) return e;
  register_windowed_kernel<<<n, plan.threads, shared, static_cast<cudaStream_t>(stream)>>>(
      band, preds, offsets, out, s, h, w, row_lo, row_hi, cb, from_bits(bound_bits), iterations);
  return static_cast<int>(cudaGetLastError());
}

// band (f, f) float32; preds (n, s, s) float32 with s <= f; offsets (n, 2)
// float32 from the field centre; out (n, 2) float32.
extern "C" int dvt_register_full(const float* band, const float* preds, const float* offsets, float* out,
                                 int n, int s, int f, int bound_bits, int iterations, void* stream) {
  if (n <= 0) return 0;
  if (s > f) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = 3 * static_cast<size_t>(f) * f * sizeof(float);
  const int e = set_shared(reinterpret_cast<const void*>(register_full_kernel), shared);
  if (e != 0) return e;
  register_full_kernel<<<n, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      band, preds, offsets, out, s, f, from_bits(bound_bits), iterations);
  return static_cast<int>(cudaGetLastError());
}
