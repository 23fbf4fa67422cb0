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
//   pixel, so a sample outside the padded stamp is 0.  Sources with a mask
//   entry of 0 or a non-finite or huge offset place nothing.
//
// Bound on the H100: bytes (every stamp read once, the covered part of the
// field read and written once; about 11 operations for each padded stamp
// pixel and band).  The sum order is fixed, so the result is
// deterministic, which a scatter with atomics is not: each output element
// starts from 0, adds the sources that overlap its tile in ascending index
// (each contribution rounded on its own: built with -fmad=false), and is
// then added into `out` once.
//
// Design for B = 6 (render_tile_kernel<6>, the shape of every caller):
// - One block of 32 * B = 192 threads owns a tile of kTileRows = 16 rows
//   x 32 pixels (8 and 32 rows measured slower on the H100: 32 rows
//   double the registers for sums and the shared memory, so fewer blocks
//   fit).
//   Thread t owns element t (pixel t / B, band t % B) of every tile row
//   and keeps those kTileRows sums in registers across the tile's whole
//   source list: no division and no shared read-modify-write in the inner
//   loop.
// - The block builds its tile's source list itself, 192 offsets at a time,
//   by an ordered warp-ballot compaction, so the list stays in ascending
//   source index.  Larger tiles mean fewer blocks that each scan all N
//   offsets.
// - Each listed source's window (the tile plus a one-pixel halo, all
//   bands) is staged into shared memory with cp.async, double-buffered, so
//   the next source's window loads while the current one is added.  A
//   window element outside the stamp is zero-filled by the copy itself
//   (source size 0), so the inner loop tests no bounds.  TMA cannot
//   address the stamps as (N, S, S * B): a row is 59 * 6 * 4 = 1,416 bytes
//   and a stamp 83,544, neither a multiple of 16, and TMA's global strides
//   must be.  For the same reason a 16-byte copy is misaligned on every
//   other pixel (24 bytes a pixel); every pixel starts on 8 bytes, so the
//   copies are 8 bytes (a band pair) each.
// - A tile that no padded patch touches is skipped: with accumulate it is
//   neither read nor written (the canvas there would only receive +0.0,
//   and the plain version's index_put_ touches only covered pixels);
//   without, it is zero-filled with 8-byte stores.
// Any other band count, and stamps or outputs not aligned to 8 bytes, take
// render_generic_kernel: 16x16 tiles, a shared-memory sum per element and
// gathers behind bounds tests, the same sums bit for bit.
//
// dvt_place, the second step of the order-3 render (no Pallas kernel: the
// JAX package adds the patches by a sequential lax.scan, ops/shift.py
// render_field): the stamps arrive already shifted by the PyTorch spline
// as (N, P, P, B) patches with integer canvas corners (y, x), and each is
// added into the padded canvas in place,
//   canvas[y + a, x + b, c] = (...(canvas + q_0) + q_1) + ... ,
// the patches covering the element in ascending source index, q_i the
// patch's value, or +0.0 where the source is not visible (the plain
// version adds where(visible, patch, 0)): the scan's order exactly, so the
// canvas is bit-identical to the plain version's loop of slice adds.
// Bound: bytes (the patches read once, the covered canvas elements read and
// written once; one add a patch element).  The same design as the order-1
// kernel for B = 6 (place_tile_kernel<6>): 16 x 32-pixel tiles over the
// whole canvas, each element's sum in a register that starts from the
// canvas's own value, the ordered ballot list of the patches that overlap
// the tile, each patch's part of the tile staged by 8-byte cp.async,
// double-buffered (zero-filled outside the patch and for a source that is
// not visible), and tiles that no patch touches neither read nor written.
// An element adds a patch only where the patch covers it.  Other B take
// place_generic_kernel (16 x 16 tiles, sums in shared memory, direct
// loads), with the same sums.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Placed {
  int src;  // source index
  int y0;   // field row of stamp row 0, less 1 (the first padded row)
  int x0;
  float fy;
  float fx;
};

// Place source i and test its padded patch against the tile
// [ty0, ty0 + th) x [tx0, tx0 + tw); false for a dropped source.
__device__ __forceinline__ bool place(const float* __restrict__ offsets,
                                      const uint8_t* __restrict__ mask, int i, int n, int s,
                                      int pos0, int ty0, int tx0, int th, int tw, Placed* p) {
  if (i >= n || (mask != nullptr && !mask[i])) return false;
  const float oy = offsets[2 * i], ox = offsets[2 * i + 1];
  const float iy = floorf(oy), ix = floorf(ox);
  // offsets beyond any field (or not finite) place nothing
  if (!(fabsf(iy) < 1e9f && fabsf(ix) < 1e9f)) return false;
  p->src = i;
  p->fy = __fsub_rn(oy, iy);
  p->fx = __fsub_rn(ox, ix);
  p->y0 = pos0 + static_cast<int>(iy) - 1;
  p->x0 = pos0 + static_cast<int>(ix) - 1;
  return p->y0 < ty0 + th && p->y0 + s + 2 > ty0 && p->x0 < tx0 + tw && p->x0 + s + 2 > tx0;
}

// Ordered compaction of one batch of blockDim.x sources into `list`;
// returns the number listed.  Two barriers; the caller keeps the list's
// readers ahead of the next batch's writers.
template <int kWarps, typename Item>
__device__ __forceinline__ int compact(bool hit, const Item& p, Item* list, int* warp_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_count[w];
    total += warp_count[w];
  }
  if (hit) list[before + __popc(ballot & ((1u << lane) - 1u))] = p;
  __syncthreads();
  return total;
}

__device__ __forceinline__ float bilinear(float fy, float gy, float fx, float gx, float v00,
                                          float v10, float v01, float v11) {
  const float left = __fadd_rn(__fmul_rn(fy, v00), __fmul_rn(gy, v10));
  const float right = __fadd_rn(__fmul_rn(fy, v01), __fmul_rn(gy, v11));
  return __fadd_rn(__fmul_rn(fx, left), __fmul_rn(gx, right));
}

// ---------------------------------------------------------------- B fixed

constexpr int kTileCols = 32;
constexpr int kTileRows = 16;

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int B>
struct TileShape {
  static_assert(B % 2 == 0, "a pixel must be whole band pairs (8-byte copies)");
  static constexpr int kThreads = kTileCols * B;          // one thread a row element
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWinRow = (kTileCols + 1) * B;     // floats in a window row
  static constexpr int kWinFloats = (kTileRows + 1) * kWinRow;
  static constexpr int kPairsPerRow = kWinRow / 2;
  static constexpr int kWinPairs = (kTileRows + 1) * kPairsPerRow;
  static constexpr size_t kShared = 2 * kWinFloats * sizeof(float);
};

// Stage stamp rows a0 .. a0 + kTileRows and columns b0 .. b0 + kTileCols
// (all bands) of stamp `st` into `win`, zero outside the stamp.
template <int B>
__device__ __forceinline__ void stage(float* win, const float* __restrict__ st, int s, int a0,
                                      int b0) {
  using T = TileShape<B>;
  for (int w = threadIdx.x; w < T::kWinPairs; w += T::kThreads) {
    const int r = w / T::kPairsPerRow, q = w - r * T::kPairsPerRow;
    const int c = q / (B / 2), part = q - c * (B / 2);
    const int a = a0 + r, bb = b0 + c;
    const bool ok = a >= 0 && a < s && bb >= 0 && bb < s;
    const float* src = ok ? st + (static_cast<long long>(a) * s + bb) * B + 2 * part : st;
    cp_async8(win + 2 * w, src, ok);
  }
}

template <int B>
__global__ void __launch_bounds__(TileShape<B>::kThreads)
render_tile_kernel(const float* __restrict__ stamps, const float* __restrict__ offsets,
                   const uint8_t* __restrict__ mask, float* __restrict__ out, int n, int s,
                   int f, int pitch, int accumulate) {
  using T = TileShape<B>;
  extern __shared__ __align__(16) float win[];  // two windows
  __shared__ Placed list[T::kThreads];
  __shared__ int warp_count[T::kWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int pos0 = (f - s) / 2;
  const size_t stamp_floats = static_cast<size_t>(s) * s * B;

  float acc[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
  bool touched = false;

  for (int base = 0; base < n; base += T::kThreads) {
    Placed p;
    const bool hit =
        place(offsets, mask, base + tid, n, s, pos0, ty0, tx0, kTileRows, kTileCols, &p);
    const int total = compact<T::kWarps>(hit, p, list, warp_count);
    if (total == 0) continue;
    touched = true;

    stage<B>(win, stamps + list[0].src * stamp_floats, s, ty0 - list[0].y0 - 2,
             tx0 - list[0].x0 - 2);
    cp_async_commit();
    for (int k = 0; k < total; ++k) {
      if (k + 1 < total) {
        const Placed& nx = list[k + 1];
        stage<B>(win + ((k + 1) & 1) * T::kWinFloats, stamps + nx.src * stamp_floats, s,
                 ty0 - nx.y0 - 2, tx0 - nx.x0 - 2);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float fy = list[k].fy, fx = list[k].fx;
      const float gy = __fsub_rn(1.f, fy), gx = __fsub_rn(1.f, fx);
      // window row r holds stamp row a0 + r; output row r reads window
      // rows r and r + 1, columns of this element and the next pixel's
      const float* wb = win + (k & 1) * T::kWinFloats + tid;
      float up0 = wb[0], up1 = wb[B];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float dn0 = wb[(r + 1) * T::kWinRow], dn1 = wb[(r + 1) * T::kWinRow + B];
        acc[r] = __fadd_rn(acc[r], bilinear(fy, gy, fx, gx, up0, dn0, up1, dn1));
        up0 = dn0;
        up1 = dn1;
      }
      __syncthreads();  // this window is restaged two sources on
    }
  }

  if (!touched) {
    if (accumulate) return;
    // nothing overlaps: zeros, 8 bytes a store
    constexpr int kPairs = T::kThreads / 2;
    for (int i = tid; i < kTileRows * kPairs; i += T::kThreads) {
      const int r = i / kPairs, q = i - r * kPairs;
      const int y = ty0 + r, x = tx0 + (2 * q) / B;
      if (y < f && x < f) {
        *reinterpret_cast<float2*>(out + static_cast<long long>(y) * pitch +
                                   static_cast<long long>(tx0) * B + 2 * q) =
            make_float2(0.f, 0.f);
      }
    }
    return;
  }
  const int x = tx0 + tid / B;
  if (x >= f) return;
  float* o = out + static_cast<long long>(tx0) * B + tid;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int y = ty0 + r;
    if (y < f) {
      float* e = o + static_cast<long long>(y) * pitch;
      *e = accumulate ? __fadd_rn(*e, acc[r]) : acc[r];
    }
  }
}

// --------------------------------------------------------------- any B

constexpr int kGenTile = 16;
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;

__global__ void __launch_bounds__(kGenThreads)
render_generic_kernel(const float* __restrict__ stamps, const float* __restrict__ offsets,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, int n, int s,
                      int b, int f, int pitch, int accumulate) {
  extern __shared__ float acc_s[];  // kGenTile * kGenTile * b
  __shared__ Placed list[kGenThreads];
  __shared__ int warp_count[kGenWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kGenTile, tx0 = blockIdx.x * kGenTile;
  const int row_elems = kGenTile * b;
  const int tile_elems = kGenTile * row_elems;
  const int pos0 = (f - s) / 2;

  for (int e = tid; e < tile_elems; e += kGenThreads) acc_s[e] = 0.f;

  for (int base = 0; base < n; base += kGenThreads) {
    Placed p;
    const bool hit =
        place(offsets, mask, base + tid, n, s, pos0, ty0, tx0, kGenTile, kGenTile, &p);
    const int total = compact<kGenWarps>(hit, p, list, warp_count);
    for (int k = 0; k < total; ++k) {
      const Placed q = list[k];
      const float* st = stamps + static_cast<size_t>(q.src) * s * s * b;
      const float gy = __fsub_rn(1.f, q.fy), gx = __fsub_rn(1.f, q.fx);
      for (int e = tid; e < tile_elems; e += kGenThreads) {
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
        acc_s[e] = __fadd_rn(acc_s[e], bilinear(q.fy, gy, q.fx, gx, v00, v10, v01, v11));
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < tile_elems; e += kGenThreads) {
    const int r = e / row_elems, rem = e - r * row_elems;
    const int y = ty0 + r, x = tx0 + rem / b;
    if (y >= f || x >= f) continue;
    float* o = out + static_cast<long long>(y) * pitch + static_cast<long long>(tx0) * b + rem;
    *o = accumulate ? __fadd_rn(*o, acc_s[e]) : acc_s[e];
  }
}

template <int B>
int launch_tile(const float* stamps, const float* offsets, const uint8_t* mask, float* out, int n,
                int s, int f, int pitch, int accumulate, cudaStream_t stream) {
  using T = TileShape<B>;
  if constexpr (T::kShared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_tile_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::kShared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((f + kTileCols - 1) / kTileCols, (f + kTileRows - 1) / kTileRows);
  render_tile_kernel<B><<<grid, T::kThreads, T::kShared, stream>>>(
      stamps, offsets, mask, out, n, s, f, pitch, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- order-3 place

struct Patch {
  int src;      // source index
  int y0;       // canvas row of patch row 0
  int x0;
  int visible;  // 0: the patch adds +0.0
};

// Source i's patch and whether it overlaps [ty0, ty0 + th) x [tx0, tx0 + tw).
__device__ __forceinline__ bool patch_hit(const int32_t* __restrict__ corners,
                                          const uint8_t* __restrict__ visible, int i, int n,
                                          int p, int ty0, int tx0, int th, int tw, Patch* q) {
  if (i >= n) return false;
  q->src = i;
  q->y0 = corners[2 * i];
  q->x0 = corners[2 * i + 1];
  q->visible = visible == nullptr || visible[i];
  return q->y0 < ty0 + th && q->y0 + p > ty0 && q->x0 < tx0 + tw && q->x0 + p > tx0;
}

template <int B>
struct PlaceShape {
  static_assert(B % 2 == 0, "a pixel must be whole band pairs (8-byte copies)");
  static constexpr int kThreads = kTileCols * B;  // one thread a row element
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kWinRow = kTileCols * B;   // floats in a window row
  static constexpr int kWinFloats = kTileRows * kWinRow;
  static constexpr int kPairsPerRow = kWinRow / 2;
  static constexpr int kWinPairs = kTileRows * kPairsPerRow;
  static constexpr size_t kShared = 2 * kWinFloats * sizeof(float);
};

// Stage patch rows a0 .. a0 + kTileRows - 1 and columns b0 .. b0 +
// kTileCols - 1 (all bands) of patch `pt` into `win`; zero outside the
// patch, and everywhere when the source is not visible.
template <int B>
__device__ __forceinline__ void place_stage(float* win, const float* __restrict__ pt, int p,
                                            int a0, int b0, bool visible) {
  using T = PlaceShape<B>;
  for (int w = threadIdx.x; w < T::kWinPairs; w += T::kThreads) {
    const int r = w / T::kPairsPerRow, q = w - r * T::kPairsPerRow;
    const int c = q / (B / 2), part = q - c * (B / 2);
    const int a = a0 + r, bb = b0 + c;
    const bool ok = visible && a >= 0 && a < p && bb >= 0 && bb < p;
    const float* src = ok ? pt + (static_cast<long long>(a) * p + bb) * B + 2 * part : pt;
    cp_async8(win + 2 * w, src, ok);
  }
}

template <int B>
__global__ void __launch_bounds__(PlaceShape<B>::kThreads)
place_tile_kernel(const float* __restrict__ patches, const int32_t* __restrict__ corners,
                  const uint8_t* __restrict__ visible, float* __restrict__ canvas, int n, int p,
                  int c) {
  using T = PlaceShape<B>;
  extern __shared__ __align__(16) float win[];  // two windows
  __shared__ Patch list[T::kThreads];
  __shared__ int warp_count[T::kWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const size_t patch_floats = static_cast<size_t>(p) * p * B;
  const long long pitch = static_cast<long long>(c) * B;
  const int col = tid / B;  // this thread's pixel in the tile row
  const bool col_ok = tx0 + col < c;
  float* o = canvas + static_cast<long long>(tx0) * B + tid;

  float acc[kTileRows];
  bool touched = false;

  for (int base = 0; base < n; base += T::kThreads) {
    Patch q;
    const bool hit = patch_hit(corners, visible, base + tid, n, p, ty0, tx0, kTileRows, kTileCols, &q);
    const int total = compact<T::kWarps>(hit, q, list, warp_count);
    if (total == 0) continue;
    if (!touched) {
      // each sum starts from the canvas's own value
      touched = true;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        acc[r] = (col_ok && ty0 + r < c) ? o[(ty0 + r) * pitch] : 0.f;
    }

    place_stage<B>(win, patches + list[0].src * patch_floats, p, ty0 - list[0].y0,
                   tx0 - list[0].x0, list[0].visible);
    cp_async_commit();
    for (int k = 0; k < total; ++k) {
      if (k + 1 < total) {
        const Patch& nx = list[k + 1];
        place_stage<B>(win + ((k + 1) & 1) * T::kWinFloats, patches + nx.src * patch_floats, p,
                       ty0 - nx.y0, tx0 - nx.x0, nx.visible);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      // window row r is patch row a0 + r; only elements the patch covers add
      const int a0 = ty0 - list[k].y0;
      const int bcol = tx0 - list[k].x0 + col;
      const float* wb = win + (k & 1) * T::kWinFloats + tid;
      if (bcol >= 0 && bcol < p) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          if (a0 + r >= 0 && a0 + r < p) acc[r] = __fadd_rn(acc[r], wb[r * T::kWinRow]);
        }
      }
      __syncthreads();  // this window is restaged two patches on
    }
  }

  if (!touched || !col_ok) return;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (ty0 + r < c) o[(ty0 + r) * pitch] = acc[r];
  }
}

__global__ void __launch_bounds__(kGenThreads)
place_generic_kernel(const float* __restrict__ patches, const int32_t* __restrict__ corners,
                     const uint8_t* __restrict__ visible, float* __restrict__ canvas, int n, int p,
                     int b, int c) {
  extern __shared__ float acc_s[];  // kGenTile * kGenTile * b
  __shared__ Patch list[kGenThreads];
  __shared__ int warp_count[kGenWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kGenTile, tx0 = blockIdx.x * kGenTile;
  const int row_elems = kGenTile * b;
  const int tile_elems = kGenTile * row_elems;
  const long long pitch = static_cast<long long>(c) * b;
  bool touched = false;

  for (int base = 0; base < n; base += kGenThreads) {
    Patch q;
    const bool hit = patch_hit(corners, visible, base + tid, n, p, ty0, tx0, kGenTile, kGenTile, &q);
    const int total = compact<kGenWarps>(hit, q, list, warp_count);
    if (total == 0) continue;
    // a thread reads and adds only its own elements e = tid + k * threads
    if (!touched) {
      touched = true;
      for (int e = tid; e < tile_elems; e += kGenThreads) {
        const int r = e / row_elems, rem = e - r * row_elems;
        const int y = ty0 + r, x = tx0 + rem / b;
        acc_s[e] = (y < c && x < c) ? canvas[y * pitch + static_cast<long long>(tx0) * b + rem] : 0.f;
      }
    }
    for (int k = 0; k < total; ++k) {
      const Patch pq = list[k];
      const float* pt = patches + static_cast<size_t>(pq.src) * p * p * b;
      for (int e = tid; e < tile_elems; e += kGenThreads) {
        const int r = e / row_elems, rem = e - r * row_elems;
        const int cc = rem / b, ch = rem - cc * b;
        const int a = ty0 + r - pq.y0, bb = tx0 + cc - pq.x0;
        if (a < 0 || a >= p || bb < 0 || bb >= p) continue;
        const float v = pq.visible ? pt[(static_cast<long long>(a) * p + bb) * b + ch] : 0.f;
        acc_s[e] = __fadd_rn(acc_s[e], v);
      }
    }
    __syncthreads();
  }

  if (!touched) return;
  for (int e = tid; e < tile_elems; e += kGenThreads) {
    const int r = e / row_elems, rem = e - r * row_elems;
    const int y = ty0 + r, x = tx0 + rem / b;
    if (y < c && x < c) canvas[y * pitch + static_cast<long long>(tx0) * b + rem] = acc_s[e];
  }
}

template <int B>
int launch_place(const float* patches, const int32_t* corners, const uint8_t* visible, float* canvas,
                 int n, int p, int c, cudaStream_t stream) {
  using T = PlaceShape<B>;
  if constexpr (T::kShared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        place_tile_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::kShared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((c + kTileCols - 1) / kTileCols, (c + kTileRows - 1) / kTileRows);
  place_tile_kernel<B><<<grid, T::kThreads, T::kShared, stream>>>(patches, corners, visible, canvas,
                                                                   n, p, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// patches (n, p, p, b) float32 contiguous; corners (n, 2) int32, the
// canvas row and column of each patch's element (0, 0); visible n bytes (0:
// the patch adds +0.0) or null; canvas (c, c, b) float32 contiguous, added
// into in place.  Returns the cudaError_t of the launch.
extern "C" int dvt_place(const float* patches, const int32_t* corners, const uint8_t* visible,
                         float* canvas, int n, int p, int b, int c, void* stream) {
  if (n <= 0 || c <= 0 || b <= 0 || p <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 6 && (reinterpret_cast<uintptr_t>(patches) & 7u) == 0) {
    return launch_place<6>(patches, corners, visible, canvas, n, p, c, st);
  }
  const size_t shared = static_cast<size_t>(kGenTile) * kGenTile * b * sizeof(float);
  if (shared > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kGenTile - 1) / kGenTile, (c + kGenTile - 1) / kGenTile);
  place_generic_kernel<<<grid, kGenThreads, shared, st>>>(patches, corners, visible, canvas, n, p, b, c);
  return static_cast<int>(cudaGetLastError());
}

// stamps (n, s, s, b) float32 contiguous; offsets (n, 2) float32; mask n
// bytes (0 drops the source) or null; out: the (f, f, b) window, element
// (y, x, c) at out[y * pitch + x * b + c]; accumulate != 0 adds to what out
// holds, else out is overwritten.  Returns the cudaError_t of the launch.
extern "C" int dvt_render(const float* stamps, const float* offsets, const uint8_t* mask,
                          float* out, int n, int s, int b, int f, int pitch,
                          int accumulate, void* stream) {
  if (f <= 0 || b <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(stamps) & 7u) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 7u) == 0 && (pitch & 1) == 0;
  if (b == 6 && aligned) {
    return launch_tile<6>(stamps, offsets, mask, out, n, s, f, pitch, accumulate, st);
  }
  const size_t shared = static_cast<size_t>(kGenTile) * kGenTile * b * sizeof(float);
  if (shared > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((f + kGenTile - 1) / kGenTile, (f + kGenTile - 1) / kGenTile);
  render_generic_kernel<<<grid, kGenThreads, shared, st>>>(stamps, offsets, mask, out, n, s, b,
                                                           f, pitch, accumulate);
  return static_cast<int>(cudaGetLastError());
}
