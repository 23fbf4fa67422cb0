// Field render: the sum of N stamps, each bilinearly shifted by the
// fractional part of its offset and placed at field centre + offset.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/render.py
// render_field_pallas (_render_kernel).  For stamps (N, S, S, B), offsets
// (N, 2) and an optional per-source mask, with pos0 = (F - S) / 2,
// io = floor(offset) and (fy, fx) = offset - io in [0, 1):
//   out[y, x, c] (+)= sum over sources, in ascending index, of
//       fx * (fy * s[a, b, c] + (1 - fy) * s[a + 1, b, c])
//     + (1 - fx) * (fy * s[a, b + 1, c] + (1 - fy) * s[a + 1, b + 1, c]),
//   a = y - pos0 - io_y - 1, b = x - pos0 - io_x - 1, s = 0 outside the
//   stamp: the plain version's two-slice shift of the stamp padded by one
//   pixel, so a sample outside the padded stamp is 0.
//
// Bound on the H100: bytes (every stamp read once, the field written once;
// about 20 operations for each stamp pixel and band).  Design: the TPU
// kernel walks all N sources in every 128x128 tile because its gathers are
// scalarised; here a gather is cheap.  One 256-thread block owns a 16x16
// pixel tile of the output.  It reads the offsets 256 sources at a time,
// keeps those whose padded patch overlaps the tile (an ordered compaction
// by warp ballot, so the list stays in ascending source index), and every
// thread adds the listed sources to the tile's elements it owns, in shared
// memory.  The order of the sum is fixed, so the result is deterministic,
// which a scatter with atomics is not.  Threads run along (x, band), the
// contiguous axis of both the field and the stamps.  The output is
// addressed through a row pitch and can be added to in place, so a caller
// streams chunks of sources into the window of its padded canvas with no
// copy.  Built with -fmad=false: each source's contribution rounds like
// the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Placed {
  int src;    // source index
  int y0;     // field row of stamp row 0, less 1 (the first padded row)
  int x0;
  float fy;
  float fx;
};

__global__ void __launch_bounds__(kThreads)
render_kernel(const float* __restrict__ stamps, const float* __restrict__ offsets,
              const uint8_t* __restrict__ mask, float* __restrict__ out, int n, int s, int b,
              int f, int pitch, int accumulate) {
  extern __shared__ float acc[];  // kTile * kTile * b
  __shared__ Placed list[kThreads];
  __shared__ int warp_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int row_elems = kTile * b;
  const int tile_elems = kTile * row_elems;
  const int pos0 = (f - s) / 2;

  for (int e = tid; e < tile_elems; e += kThreads) acc[e] = 0.f;

  for (int base = 0; base < n; base += kThreads) {
    // each thread places one source and tests its padded patch against
    // the tile
    const int i = base + tid;
    Placed p;
    bool hit = false;
    if (i < n && (mask == nullptr || mask[i])) {
      const float oy = offsets[2 * i], ox = offsets[2 * i + 1];
      const float iy = floorf(oy), ix = floorf(ox);
      // offsets beyond any field (or not finite) place nothing
      if (fabsf(iy) < 1e9f && fabsf(ix) < 1e9f) {
        p.src = i;
        p.fy = __fsub_rn(oy, iy);
        p.fx = __fsub_rn(ox, ix);
        p.y0 = pos0 + static_cast<int>(iy) - 1;
        p.x0 = pos0 + static_cast<int>(ix) - 1;
        hit = p.y0 < ty0 + kTile && p.y0 + s + 2 > ty0 && p.x0 < tx0 + kTile &&
              p.x0 + s + 2 > tx0;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_count[w];
      total += warp_count[w];
    }
    if (hit) list[before + __popc(ballot & ((1u << lane) - 1u))] = p;
    __syncthreads();

    for (int k = 0; k < total; ++k) {
      const Placed q = list[k];
      const float* st = stamps + static_cast<size_t>(q.src) * s * s * b;
      const float gy = __fsub_rn(1.f, q.fy), gx = __fsub_rn(1.f, q.fx);
      for (int e = tid; e < tile_elems; e += kThreads) {
        const int r = e / row_elems, rem = e - r * row_elems;
        const int c = rem / b, ch = rem - c * b;
        // stamp rows a, a + 1 and columns bb, bb + 1 under this pixel
        const int a = ty0 + r - q.y0 - 2, bb = tx0 + c - q.x0 - 2;
        if (a < -1 || a >= s || bb < -1 || bb >= s) continue;
        const bool a0 = a >= 0, a1 = a + 1 < s, b0 = bb >= 0, b1 = bb + 1 < s;
        const float* px = st + (static_cast<long long>(a) * s + bb) * b + ch;
        const float v00 = (a0 && b0) ? px[0] : 0.f;
        const float v10 = (a1 && b0) ? px[s * b] : 0.f;
        const float v01 = (a0 && b1) ? px[b] : 0.f;
        const float v11 = (a1 && b1) ? px[s * b + b] : 0.f;
        const float left = __fadd_rn(__fmul_rn(q.fy, v00), __fmul_rn(gy, v10));
        const float right = __fadd_rn(__fmul_rn(q.fy, v01), __fmul_rn(gy, v11));
        acc[e] = __fadd_rn(acc[e], __fadd_rn(__fmul_rn(q.fx, left), __fmul_rn(gx, right)));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < tile_elems; e += kThreads) {
    const int r = e / row_elems, rem = e - r * row_elems;
    const int y = ty0 + r, x = tx0 + rem / b;
    if (y >= f || x >= f) continue;
    float* o = out + static_cast<long long>(y) * pitch + static_cast<long long>(tx0) * b + rem;
    *o = accumulate ? __fadd_rn(*o, acc[e]) : acc[e];
  }
}

}  // namespace

// stamps (n, s, s, b) float32 contiguous; offsets (n, 2) float32; mask n
// bytes (0 drops the source) or null; out: the (f, f, b) window, element
// (y, x, c) at out[y * pitch + x * b + c]; accumulate != 0 adds to what out
// holds, else out is overwritten.  Returns the cudaError_t of the launch.
extern "C" int dvt_render(const float* stamps, const float* offsets, const uint8_t* mask,
                          float* out, int n, int s, int b, int f, int pitch,
                          int accumulate, void* stream) {
  if (f <= 0 || b <= 0) return 0;
  const size_t shared = static_cast<size_t>(kTile) * kTile * b * sizeof(float);
  if (shared > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((f + kTile - 1) / kTile, (f + kTile - 1) / kTile);
  render_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      stamps, offsets, mask, out, n, s, b, f, pitch, accumulate);
  return static_cast<int>(cudaGetLastError());
}
