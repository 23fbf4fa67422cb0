// Field render: the sum of N stamps, each bilinearly shifted by the
// fractional part of its offset and placed at field centre + offset.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/render.py
// render_field_pallas (_render_kernel).  For stamps (N, S, S, B), offsets
// (N, 2) and an optional per-source mask into an H x W window (the field,
// or a row band of it on the sharded serve, ops/shift.py's (fy, fx)
// field_size), with pos0 = ((H - S) / 2, (W - S) / 2) per axis,
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
//
// bfloat16 canvases (dvt_render_bf16, dvt_place_bf16): bf16 stamps or
// patches into a bf16 canvas, half the bytes of the float32 kernels.  They
// compute what the JAX package computes when the canvas is bf16
// (DeblendField device_dtype='bfloat16'): each source's value is widened
// to float32, interpolated (order 1), rounded to bf16 and added into the
// canvas with a rounding after every add, in ascending source index, each
// element starting from the canvas's own value:
//   canvas = bf16(...bf16(bf16(canvas + bf16(q_0)) + bf16(q_1))...).
// So the order-1 bf16 render, unlike the float32 one, starts from the
// canvas and adds a source only where its padded patch covers the element
// (a bf16 add of +0.0 would turn a -0.0 into +0.0), a masked source +0.0.
// For B = 6 a persistent kernel walks the tiles, each warp scanning the
// sources in ascending order, and adds with packed bf16 arithmetic (the
// section at the end); other B take the generic kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16_rn(v); }

// The add of one contribution into a canvas sum: float32, or bf16 with
// the value and the sum rounded (acc holds a bf16 value).
template <typename T>
__device__ __forceinline__ float add_into(float acc, float v) {
  if constexpr (kIsBf16<T>) {
    return round_bf16(__fadd_rn(acc, round_bf16(v)));
  } else {
    return __fadd_rn(acc, v);
  }
}

struct Placed {
  int src;  // source index
  int y0;   // field row of stamp row 0, less 1 (the first padded row)
  int x0;
  float fy;
  float fx;
};

// Place source i; false for a dropped source.
__device__ __forceinline__ bool placed(const float* __restrict__ offsets, const uint8_t* __restrict__ mask,
                                       int i, int pos0y, int pos0x, Placed* p) {
  if (mask != nullptr && !mask[i]) return false;
  const float oy = offsets[2 * i], ox = offsets[2 * i + 1];
  const float iy = floorf(oy), ix = floorf(ox);
  // offsets beyond any field (or not finite) place nothing
  if (!(fabsf(iy) < 1e9f && fabsf(ix) < 1e9f)) return false;
  p->src = i;
  p->fy = __fsub_rn(oy, iy);
  p->fx = __fsub_rn(ox, ix);
  p->y0 = pos0y + static_cast<int>(iy) - 1;
  p->x0 = pos0x + static_cast<int>(ix) - 1;
  return true;
}

// Place source i and test its padded patch against the tile
// [ty0, ty0 + th) x [tx0, tx0 + tw); false for a dropped source.
__device__ __forceinline__ bool place(const float* __restrict__ offsets,
                                      const uint8_t* __restrict__ mask, int i, int n, int s,
                                      int pos0y, int pos0x, int ty0, int tx0, int th, int tw, Placed* p) {
  if (i >= n || !placed(offsets, mask, i, pos0y, pos0x, p)) return false;
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

// One band pair (8 bytes), zero-filled when !ok.
__device__ __forceinline__ void cp_async_pair(float* dst, const float* src, bool ok) {
  constexpr int kBytes = 8;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(kBytes),
               "r"(ok ? kBytes : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int B>
struct TileShape {
  static_assert(B % 2 == 0, "a pixel must be whole band pairs (pair copies)");
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
__device__ __forceinline__ void stage(float* win, const float* __restrict__ st, int s, int a0, int b0) {
  using Sh = TileShape<B>;
  for (int w = threadIdx.x; w < Sh::kWinPairs; w += Sh::kThreads) {
    const int r = w / Sh::kPairsPerRow, q = w - r * Sh::kPairsPerRow;
    const int c = q / (B / 2), part = q - c * (B / 2);
    const int a = a0 + r, bb = b0 + c;
    const bool ok = a >= 0 && a < s && bb >= 0 && bb < s;
    const float* src = ok ? st + (static_cast<long long>(a) * s + bb) * B + 2 * part : st;
    cp_async_pair(win + 2 * w, src, ok);
  }
}

template <int B>
__global__ void __launch_bounds__(TileShape<B>::kThreads)
render_tile_kernel(const float* __restrict__ stamps, const float* __restrict__ offsets,
                   const uint8_t* __restrict__ mask, float* __restrict__ out, int n, int s, int h,
                   int w, int pitch, int accumulate) {
  using Sh = TileShape<B>;
  extern __shared__ __align__(16) unsigned char win_bytes[];  // two windows
  float* win = reinterpret_cast<float*>(win_bytes);
  __shared__ Placed list[Sh::kThreads];
  __shared__ int warp_count[Sh::kWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const int pos0y = (h - s) / 2, pos0x = (w - s) / 2;
  const size_t stamp_elems = static_cast<size_t>(s) * s * B;
  const int x = tx0 + tid / B;
  float* o = out + static_cast<long long>(tx0) * B + tid;

  float acc[kTileRows];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) acc[r] = 0.f;
  bool touched = false;

  for (int base = 0; base < n; base += Sh::kThreads) {
    Placed p;
    const bool hit =
        place(offsets, mask, base + tid, n, s, pos0y, pos0x, ty0, tx0, kTileRows, kTileCols, &p);
    const int total = compact<Sh::kWarps>(hit, p, list, warp_count);
    if (total == 0) continue;
    touched = true;

    stage<B>(win, stamps + list[0].src * stamp_elems, s, ty0 - list[0].y0 - 2,
             tx0 - list[0].x0 - 2);
    cp_async_commit();
    for (int k = 0; k < total; ++k) {
      if (k + 1 < total) {
        const Placed& nx = list[k + 1];
        stage<B>(win + ((k + 1) & 1) * Sh::kWinFloats, stamps + nx.src * stamp_elems, s,
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
      const float* wb = win + (k & 1) * Sh::kWinFloats + tid;
      float up0 = wb[0], up1 = wb[B];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float dn0 = wb[(r + 1) * Sh::kWinRow], dn1 = wb[(r + 1) * Sh::kWinRow + B];
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
    constexpr int kPairs = Sh::kThreads / 2;
    for (int i = tid; i < kTileRows * kPairs; i += Sh::kThreads) {
      const int r = i / kPairs, q = i - r * kPairs;
      const int y = ty0 + r, xx = tx0 + (2 * q) / B;
      if (y < h && xx < w) {
        *reinterpret_cast<float2*>(out + static_cast<long long>(y) * pitch + static_cast<long long>(tx0) * B +
                                   2 * q) = make_float2(0.f, 0.f);
      }
    }
    return;
  }
  if (x >= w) return;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int y = ty0 + r;
    if (y < h) {
      float* e = o + static_cast<long long>(y) * pitch;
      *e = accumulate ? __fadd_rn(*e, acc[r]) : acc[r];
    }
  }
}

// --------------------------------------------------------------- any B

constexpr int kGenTile = 16;
constexpr int kGenThreads = 256;
constexpr int kGenWarps = kGenThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kGenThreads)
render_generic_kernel(const T* __restrict__ stamps, const float* __restrict__ offsets,
                      const uint8_t* __restrict__ mask, T* __restrict__ out, int n, int s,
                      int b, int h, int w, int pitch, int accumulate) {
  extern __shared__ float acc_s[];  // kGenTile * kGenTile * b
  __shared__ Placed list[kGenThreads];
  __shared__ int warp_count[kGenWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kGenTile, tx0 = blockIdx.x * kGenTile;
  const int row_elems = kGenTile * b;
  const int tile_elems = kGenTile * row_elems;
  const int pos0y = (h - s) / 2, pos0x = (w - s) / 2;
  bool touched = false;

  for (int e = tid; e < tile_elems; e += kGenThreads) acc_s[e] = 0.f;

  for (int base = 0; base < n; base += kGenThreads) {
    Placed p;
    // a bf16 canvas lists a masked source too: it adds +0.0 where it covers
    const bool hit = place(offsets, kIsBf16<T> ? nullptr : mask, base + tid, n, s, pos0y, pos0x, ty0, tx0,
                           kGenTile, kGenTile, &p);
    const int total = compact<kGenWarps>(hit, p, list, warp_count);
    if (total == 0) continue;
    if constexpr (kIsBf16<T>) {
      // a thread reads and adds only its own elements: no barrier needed
      if (!touched) {
        for (int e = tid; e < tile_elems; e += kGenThreads) {
          const int r = e / row_elems, rem = e - r * row_elems;
          const int y = ty0 + r, x = tx0 + rem / b;
          if (y < h && x < w) acc_s[e] = widen(out[static_cast<long long>(y) * pitch + static_cast<long long>(tx0) * b + rem]);
        }
      }
    }
    touched = true;
    for (int k = 0; k < total; ++k) {
      const Placed q = list[k];
      const T* st = stamps + static_cast<size_t>(q.src) * s * s * b;
      const float gy = __fsub_rn(1.f, q.fy), gx = __fsub_rn(1.f, q.fx);
      const bool shown = !kIsBf16<T> || mask == nullptr || mask[q.src];
      for (int e = tid; e < tile_elems; e += kGenThreads) {
        const int r = e / row_elems, rem = e - r * row_elems;
        const int c = rem / b, ch = rem - c * b;
        // stamp rows a, a + 1 and columns bb, bb + 1 under this pixel; the
        // padded patch's first row and column (a or bb = -2) hold +0.0,
        // which only a bf16 canvas adds
        const int a = ty0 + r - q.y0 - 2, bb = tx0 + c - q.x0 - 2;
        constexpr int kFirst = kIsBf16<T> ? -2 : -1;
        if (a < kFirst || a >= s || bb < kFirst || bb >= s) continue;
        const bool a0 = shown && a >= 0, a1 = shown && a >= -1 && a + 1 < s, b0 = bb >= 0, b1 = bb >= -1 && bb + 1 < s;
        const T* px = st + (static_cast<long long>(a) * s + bb) * b + ch;
        const float v00 = (a0 && b0) ? widen(px[0]) : 0.f;
        const float v10 = (a1 && b0) ? widen(px[s * b]) : 0.f;
        const float v01 = (a0 && b1) ? widen(px[b]) : 0.f;
        const float v11 = (a1 && b1) ? widen(px[s * b + b]) : 0.f;
        acc_s[e] = add_into<T>(acc_s[e], bilinear(q.fy, gy, q.fx, gx, v00, v10, v01, v11));
      }
    }
    __syncthreads();
  }

  if (kIsBf16<T> && !touched) return;
  for (int e = tid; e < tile_elems; e += kGenThreads) {
    const int r = e / row_elems, rem = e - r * row_elems;
    const int y = ty0 + r, x = tx0 + rem / b;
    if (y >= h || x >= w) continue;
    T* o = out + static_cast<long long>(y) * pitch + static_cast<long long>(tx0) * b + rem;
    if constexpr (kIsBf16<T>) {
      *o = narrow<T>(acc_s[e]);
    } else {
      *o = accumulate ? __fadd_rn(*o, acc_s[e]) : acc_s[e];
    }
  }
}

template <typename T>
int launch_render_generic(const T* stamps, const float* offsets, const uint8_t* mask, T* out, int n, int s,
                          int b, int h, int w, int pitch, int accumulate, cudaStream_t st) {
  const size_t shared = static_cast<size_t>(kGenTile) * kGenTile * b * sizeof(float);
  if (shared > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kGenTile - 1) / kGenTile, (h + kGenTile - 1) / kGenTile);
  render_generic_kernel<T><<<grid, kGenThreads, shared, st>>>(stamps, offsets, mask, out, n, s, b, h, w, pitch,
                                                              accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <int B>
int launch_tile(const float* stamps, const float* offsets, const uint8_t* mask, float* out, int n, int s,
                int h, int w, int pitch, int accumulate, cudaStream_t stream) {
  using Sh = TileShape<B>;
  if constexpr (Sh::kShared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_tile_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Sh::kShared));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((w + kTileCols - 1) / kTileCols, (h + kTileRows - 1) / kTileRows);
  render_tile_kernel<B><<<grid, Sh::kThreads, Sh::kShared, stream>>>(
      stamps, offsets, mask, out, n, s, h, w, pitch, accumulate);
  return static_cast<int>(cudaGetLastError());
}

// The float32 order-1 launch on an h x w window: the tile kernel for B = 6
// on 8-byte-aligned stamps and window, else the generic kernel.
int render_f32(const float* stamps, const float* offsets, const uint8_t* mask, float* out, int n, int s,
               int b, int h, int w, int pitch, int accumulate, cudaStream_t st) {
  if (h <= 0 || w <= 0 || b <= 0) return 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(stamps) & 7u) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 7u) == 0 && (pitch & 1) == 0;
  if (b == 6 && aligned) {
    return launch_tile<6>(stamps, offsets, mask, out, n, s, h, w, pitch, accumulate, st);
  }
  return launch_render_generic<float>(stamps, offsets, mask, out, n, s, b, h, w, pitch, accumulate, st);
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
  static_assert(B % 2 == 0, "a pixel must be whole band pairs (pair copies)");
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
__device__ __forceinline__ void place_stage(float* win, const float* __restrict__ pt, int p, int a0, int b0,
                                            bool visible) {
  using Sh = PlaceShape<B>;
  for (int w = threadIdx.x; w < Sh::kWinPairs; w += Sh::kThreads) {
    const int r = w / Sh::kPairsPerRow, q = w - r * Sh::kPairsPerRow;
    const int c = q / (B / 2), part = q - c * (B / 2);
    const int a = a0 + r, bb = b0 + c;
    const bool ok = visible && a >= 0 && a < p && bb >= 0 && bb < p;
    const float* src = ok ? pt + (static_cast<long long>(a) * p + bb) * B + 2 * part : pt;
    cp_async_pair(win + 2 * w, src, ok);
  }
}

template <int B>
__global__ void __launch_bounds__(PlaceShape<B>::kThreads)
place_tile_kernel(const float* __restrict__ patches, const int32_t* __restrict__ corners,
                  const uint8_t* __restrict__ visible, float* __restrict__ canvas, int n, int p, int rows,
                  int cols, long long pitch) {
  using Sh = PlaceShape<B>;
  extern __shared__ __align__(16) unsigned char win_bytes[];  // two windows
  float* win = reinterpret_cast<float*>(win_bytes);
  __shared__ Patch list[Sh::kThreads];
  __shared__ int warp_count[Sh::kWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kTileRows, tx0 = blockIdx.x * kTileCols;
  const size_t patch_elems = static_cast<size_t>(p) * p * B;
  const int col = tid / B;  // this thread's pixel in the tile row
  const bool col_ok = tx0 + col < cols;
  float* o = canvas + static_cast<long long>(tx0) * B + tid;

  float acc[kTileRows];
  bool touched = false;

  for (int base = 0; base < n; base += Sh::kThreads) {
    Patch q;
    const bool hit = patch_hit(corners, visible, base + tid, n, p, ty0, tx0, kTileRows, kTileCols, &q);
    const int total = compact<Sh::kWarps>(hit, q, list, warp_count);
    if (total == 0) continue;
    if (!touched) {
      // each sum starts from the canvas's own value
      touched = true;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) acc[r] = (col_ok && ty0 + r < rows) ? o[(ty0 + r) * pitch] : 0.f;
    }

    place_stage<B>(win, patches + list[0].src * patch_elems, p, ty0 - list[0].y0,
                   tx0 - list[0].x0, list[0].visible);
    cp_async_commit();
    for (int k = 0; k < total; ++k) {
      if (k + 1 < total) {
        const Patch& nx = list[k + 1];
        place_stage<B>(win + ((k + 1) & 1) * Sh::kWinFloats, patches + nx.src * patch_elems, p,
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
      const float* wb = win + (k & 1) * Sh::kWinFloats + tid;
      if (bcol >= 0 && bcol < p) {
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) {
          if (a0 + r >= 0 && a0 + r < p) acc[r] = __fadd_rn(acc[r], wb[r * Sh::kWinRow]);
        }
      }
      __syncthreads();  // this window is restaged two patches on
    }
  }

  if (!touched || !col_ok) return;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    if (ty0 + r < rows) o[(ty0 + r) * pitch] = acc[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kGenThreads)
place_generic_kernel(const T* __restrict__ patches, const int32_t* __restrict__ corners,
                     const uint8_t* __restrict__ visible, T* __restrict__ canvas, int n, int p,
                     int b, int rows, int cols, long long pitch) {
  extern __shared__ float acc_s[];  // kGenTile * kGenTile * b
  __shared__ Patch list[kGenThreads];
  __shared__ int warp_count[kGenWarps];

  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * kGenTile, tx0 = blockIdx.x * kGenTile;
  const int row_elems = kGenTile * b;
  const int tile_elems = kGenTile * row_elems;
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
        acc_s[e] = (y < rows && x < cols) ? widen(canvas[y * pitch + static_cast<long long>(tx0) * b + rem]) : 0.f;
      }
    }
    for (int k = 0; k < total; ++k) {
      const Patch pq = list[k];
      const T* pt = patches + static_cast<size_t>(pq.src) * p * p * b;
      for (int e = tid; e < tile_elems; e += kGenThreads) {
        const int r = e / row_elems, rem = e - r * row_elems;
        const int cc = rem / b, ch = rem - cc * b;
        const int a = ty0 + r - pq.y0, bb = tx0 + cc - pq.x0;
        if (a < 0 || a >= p || bb < 0 || bb >= p) continue;
        const float v = pq.visible ? widen(pt[(static_cast<long long>(a) * p + bb) * b + ch]) : 0.f;
        acc_s[e] = add_into<T>(acc_s[e], v);
      }
    }
    __syncthreads();
  }

  if (!touched) return;
  for (int e = tid; e < tile_elems; e += kGenThreads) {
    const int r = e / row_elems, rem = e - r * row_elems;
    const int y = ty0 + r, x = tx0 + rem / b;
    if (y < rows && x < cols) canvas[y * pitch + static_cast<long long>(tx0) * b + rem] = narrow<T>(acc_s[e]);
  }
}

template <typename T>
int launch_place_generic(const T* patches, const int32_t* corners, const uint8_t* visible, T* canvas, int n,
                         int p, int b, int rows, int cols, long long pitch, cudaStream_t st) {
  const size_t shared = static_cast<size_t>(kGenTile) * kGenTile * b * sizeof(float);
  if (shared > 40 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((cols + kGenTile - 1) / kGenTile, (rows + kGenTile - 1) / kGenTile);
  place_generic_kernel<T><<<grid, kGenThreads, shared, st>>>(patches, corners, visible, canvas, n, p, b, rows, cols,
                                                             pitch);
  return static_cast<int>(cudaGetLastError());
}

int place_f32(const float* patches, const int32_t* corners, const uint8_t* visible, float* canvas, int n, int p,
              int b, int rows, int cols, long long pitch, cudaStream_t st) {
  if (n <= 0 || rows <= 0 || cols <= 0 || b <= 0 || p <= 0) return 0;
  if (b == 6 && (reinterpret_cast<uintptr_t>(patches) & 7u) == 0) {
    using Sh = PlaceShape<6>;
    if constexpr (Sh::kShared > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          place_tile_kernel<6>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Sh::kShared));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((cols + kTileCols - 1) / kTileCols, (rows + kTileRows - 1) / kTileRows);
    place_tile_kernel<6><<<grid, Sh::kThreads, Sh::kShared, st>>>(patches, corners, visible, canvas, n, p, rows, cols,
                                                                   pitch);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_place_generic<float>(patches, corners, visible, canvas, n, p, b, rows, cols, pitch, st);
}

// --------------------------------------------- bfloat16 canvases, B = 6
//
// dvt_render_bf16 and dvt_place_bf16 for B = 6 (the shape of every
// caller): one launch a chunk of at most kScanSources sources.
// - A persistent grid (as many blocks as fit on the card at once, never
//   more than the tiles) walks the canvas's 16 x 32-pixel tiles in runs
//   within a tile row (about four runs a block, handed out in turn, so
//   busy and empty stretches spread over the blocks).  A tile no source
//   touches is neither read nor written, so a 4096^2 window costs a few
//   short scans a block and not 32,768 blocks.
// - Each block first stages the chunk's sources into shared memory once
//   (corner, fractions, visibility; a source with a non-finite or huge
//   offset can touch no tile), behind the kernel's only barrier.
// - 96 threads a block: thread t holds band pair t % 3 (two bf16, 4 bytes)
//   of pixel t / 3 of a 32-pixel tile in all 16 rows, its sums in 16
//   bf16x2 registers.
// - At the start of a run each warp lists, in shared memory, the sources
//   whose rows meet the tile row (a ballot a batch of 32, in ascending
//   order); in each tile of the run it tests only those against its own
//   pixels and takes the hits of each ballot in ascending order.  So every
//   element adds its sources in ascending index with no compaction or
//   barrier.  The canvas is read at a warp's first hit.
// - A thread reads what its adds need straight from device memory with
//   4-byte loads, coalesced across the warp (the place one patch pair a
//   row; the render the two columns of its bilinear over 17 stamp rows,
//   the neighbour column served by L1), rounds the two bands' values with
//   one __float22bfloat162_rn (render) and adds them with one __hadd2
//   (add.rn.bf16x2: the exact sum rounded once).  The two-step form
//   bf16(float(acc) + float(v)) gives the same bits: double rounding is
//   innocuous here (24 >= 2 * 8 + 2), and on an H100 the two forms agree
//   on every pair of 65,536 x 4,096 bf16 bit patterns, subnormals, signed
//   zeros, infinities and NaNs included.
// - A masked (render) or hidden (place) source adds +0.0 where its padded
//   patch covers, as the plain versions' where(visible, patch, 0) and the
//   JAX package's scan do: that turns a -0.0 into +0.0.  An element no
//   source covers is not written.

constexpr int kScanSources = 1024;    // sources a launch: at most 32 KB of shared memory
constexpr int kScanRows = 16;         // rows of a scan kernel's tile (its threads own them all)
constexpr int kDropped = -(1 << 30);  // the row of a source that touches nothing

using bf162 = __nv_bfloat162;

__device__ __forceinline__ bf162 zero2() { return __floats2bfloat162_rn(0.f, 0.f); }

template <int B>
struct ScanShape {
  static_assert(B % 2 == 0, "a pixel must be whole band pairs");
  static constexpr int kPairs = B / 2;
  static constexpr int kThreads = kTileCols * kPairs;  // one thread a pixel's band pair
  static_assert(kThreads % 32 == 0, "whole warps");
  static constexpr int kWarps = kThreads / 32;
  static constexpr size_t kListBytes = kWarps * sizeof(int);  // a source's place in each warp's list
};

struct RenderSrc {  // field row and column of padded row 0, fractions, whether unmasked
  int y0, x0;
  float fy, fx;
  int visible;
};

struct PlaceSrc {  // canvas row and column of patch row 0, visibility
  int y0, x0, visible, pad;
};

// Walk this block's runs of tiles on a rows x cols canvas.  Sources cover
// `extent` rows and columns from their corner (y0, x0).  For each run the
// warp lists the sources that meet the tile row; for each tile it calls
// work.tile(ty0, x) (this thread's first row and pixel), then
// work.add(i, src[i]) for each listed source that meets the pixels whose
// outputs the warp holds, in ascending i, then work.done().  Every lane
// of the warp makes the same calls.
template <int B, class Src, class Work>
__device__ __forceinline__ void walk_tiles(const Src* src, int* lists, int n, int rows, int cols, int extent,
                                           Work& work) {
  using Sh = ScanShape<B>;
  const int lane = threadIdx.x & 31, px = threadIdx.x / Sh::kPairs;
  // the pixels of a tile whose outputs the warp's lanes hold
  const int wpx0 = (threadIdx.x - lane) / Sh::kPairs, wpx1 = (threadIdx.x - lane + 31) / Sh::kPairs;
  int* list = lists + (threadIdx.x >> 5) * n;
  const int tile_rows = (rows + kScanRows - 1) / kScanRows, tile_cols = (cols + kTileCols - 1) / kTileCols;
  // runs of `run` tiles within a tile row, about four a block, handed out
  // in turn so that busy and empty stretches spread over the blocks
  const long long n_tiles = static_cast<long long>(tile_rows) * tile_cols;
  const int run = static_cast<int>(max(1LL, n_tiles / (4LL * gridDim.x)));
  const int runs_per_row = (tile_cols + run - 1) / run;
  const long long n_runs = static_cast<long long>(tile_rows) * runs_per_row;
  for (long long item = blockIdx.x; item < n_runs; item += gridDim.x) {
    const int trow = static_cast<int>(item / runs_per_row);
    const int c0 = static_cast<int>(item - static_cast<long long>(trow) * runs_per_row) * run;
    const int c1 = min(c0 + run, tile_cols);
    const int ty0 = trow * kScanRows;
    // the sources that meet the tile row, in ascending order (everything
    // that gates a ballot below is warp-uniform)
    const int wy1 = min(ty0 + kScanRows, rows) - 1;
    int listed = 0;
    __syncwarp();  // every lane is done with the last run's list
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool hit = i < n && src[i].y0 <= wy1 && src[i].y0 + extent > ty0;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (hit) list[listed + __popc(bal & ((1u << lane) - 1u))] = i;
      listed += __popc(bal);
    }
    __syncwarp();
    if (listed == 0) continue;
    for (int tc = c0; tc < c1; ++tc) {
      const int tx0 = tc * kTileCols;
      const int wx0 = tx0 + wpx0, wx1 = min(tx0 + wpx1, cols - 1);
      if (wx0 >= cols) continue;
      bool begun = false;
      for (int base = 0; base < listed; base += 32) {
        const int i = base + lane < listed ? list[base + lane] : 0;
        const bool hit = base + lane < listed && src[i].x0 <= wx1 && src[i].x0 + extent > wx0;
        for (unsigned bal = __ballot_sync(0xffffffffu, hit); bal != 0u; bal &= bal - 1u) {
          const int j = __shfl_sync(0xffffffffu, i, __ffs(bal) - 1);
          if (!begun) {
            work.tile(ty0, tx0 + px);
            begun = true;
          }
          work.add(j, src[j]);
        }
      }
      if (begun) work.done();
    }
  }
}

// Order 1 on a bf16 window: out (f x f, row pitch `pitch` elements).
template <int B>
struct RenderWork {
  using Sh = ScanShape<B>;
  static constexpr int R = kScanRows;
  const bf16* stamps;
  bf16* out;
  int s, f, pitch, pr;
  bf162 acc[R];
  bf162* o;
  int ty0, x;
  unsigned written;

  __device__ void tile(int ty, int xx) {
    ty0 = ty;
    x = xx;
    written = 0u;
    o = reinterpret_cast<bf162*>(out + static_cast<long long>(ty0) * pitch + static_cast<long long>(x) * B + 2 * pr);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = x < f && ty0 + r < f ? o[r * (pitch / 2)] : zero2();
  }
  __device__ void add(int i, const RenderSrc& q) {
    if (x >= f || x < q.x0 || x >= q.x0 + s + 2) return;
    // output row y reads stamp rows y - y0 - 2 and y - y0 - 1, columns
    // x - x0 - 2 and x - x0 - 1 (zero outside the stamp, and everywhere
    // for a masked source)
    const int a0 = ty0 - q.y0 - 2, b = x - q.x0 - 2;
    const bool c0 = q.visible && b >= 0 && b < s, c1 = q.visible && b + 1 >= 0 && b + 1 < s;
    const bf16* st = stamps + static_cast<size_t>(i) * s * s * B + static_cast<long long>(b) * B + 2 * pr;
    const long long row = static_cast<long long>(s) * B;
    const float gy = __fsub_rn(1.f, q.fy), gx = __fsub_rn(1.f, q.fx);
    // the two columns' band pairs, packed (widened where they are used)
    bf162 v0[R + 1], v1[R + 1];
#pragma unroll
    for (int r = 0; r <= R; ++r) {
      const int a = a0 + r;
      const bool ok = a >= 0 && a < s;
      const bf162* e = reinterpret_cast<const bf162*>(st + a * row);
      v0[r] = ok && c0 ? e[0] : zero2();
      v1[r] = ok && c1 ? e[Sh::kPairs] : zero2();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int y = ty0 + r;
      if (y < q.y0 || y >= q.y0 + s + 2 || y >= f) continue;
      const float2 u0 = __bfloat1622float2(v0[r]), d0 = __bfloat1622float2(v0[r + 1]);
      const float2 u1 = __bfloat1622float2(v1[r]), d1 = __bfloat1622float2(v1[r + 1]);
      const float lo = bilinear(q.fy, gy, q.fx, gx, u0.x, d0.x, u1.x, d1.x);
      const float hi = bilinear(q.fy, gy, q.fx, gx, u0.y, d0.y, u1.y, d1.y);
      acc[r] = __hadd2(acc[r], __float22bfloat162_rn(make_float2(lo, hi)));
      written |= 1u << r;
    }
  }
  __device__ void done() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (written & (1u << r)) o[r * (pitch / 2)] = acc[r];
    }
  }
};

template <int B>
__global__ void __launch_bounds__(ScanShape<B>::kThreads, 6)
render_scan_kernel(const bf16* __restrict__ stamps, const float* __restrict__ offsets,
                   const uint8_t* __restrict__ mask, bf16* __restrict__ out, int n, int s, int f, int pitch) {
  using Sh = ScanShape<B>;
  extern __shared__ __align__(16) unsigned char scan_smem[];
  RenderSrc* src = reinterpret_cast<RenderSrc*>(scan_smem);  // n
  const int pos0 = (f - s) / 2;
  for (int i = threadIdx.x; i < n; i += Sh::kThreads) {
    // a masked source adds +0.0 where it covers, as the plain version's
    // where(visible, patch, 0) does; a non-finite or huge offset nothing
    Placed p;
    src[i] = placed(offsets, nullptr, i, pos0, pos0, &p)
                 ? RenderSrc{p.y0, p.x0, p.fy, p.fx, mask == nullptr || mask[i]}
                 : RenderSrc{kDropped, kDropped, 0.f, 0.f, 0};
  }
  __syncthreads();
  RenderWork<B> work;
  work.stamps = stamps;
  work.out = out;
  work.s = s;
  work.f = f;
  work.pitch = pitch;
  work.pr = threadIdx.x % Sh::kPairs;
  walk_tiles<B>(src, reinterpret_cast<int*>(src + n), n, f, f, s + 2, work);
}

// Order 3 on a bf16 canvas (c x c, contiguous; corners ys, xs).
template <int B>
struct PlaceWork {
  using Sh = ScanShape<B>;
  static constexpr int R = kScanRows;
  const bf16* patches;
  bf16* canvas;
  int p, c, pr;
  bf162 acc[R];
  bf162* o;
  int ty0, x;
  unsigned written;

  __device__ void tile(int ty, int xx) {
    ty0 = ty;
    x = xx;
    written = 0u;
    o = reinterpret_cast<bf162*>(canvas + (static_cast<long long>(ty0) * c + x) * B + 2 * pr);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = x < c && ty0 + r < c ? o[static_cast<long long>(r) * c * Sh::kPairs] : zero2();
  }
  __device__ void add(int i, const PlaceSrc& q) {
    const int b = x - q.x0;
    if (x >= c || b < 0 || b >= p) return;
    const int a0 = ty0 - q.y0;
    const bf162* pt =
        reinterpret_cast<const bf162*>(patches + static_cast<size_t>(i) * p * p * B + b * B + 2 * pr);
    bf162 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = a0 + r;
      // a source that is not visible adds +0.0 where it covers
      v[r] = q.visible && a >= 0 && a < p ? pt[a * p * Sh::kPairs] : zero2();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = a0 + r;
      if (a < 0 || a >= p || ty0 + r >= c) continue;
      acc[r] = __hadd2(acc[r], v[r]);
      written |= 1u << r;
    }
  }
  __device__ void done() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (written & (1u << r)) o[static_cast<long long>(r) * c * Sh::kPairs] = acc[r];
    }
  }
};

template <int B>
__global__ void __launch_bounds__(ScanShape<B>::kThreads, 6)
place_scan_kernel(const bf16* __restrict__ patches, const int64_t* __restrict__ ys, const int64_t* __restrict__ xs,
                  const uint8_t* __restrict__ visible, bf16* __restrict__ canvas, int n, int p, int c) {
  using Sh = ScanShape<B>;
  extern __shared__ __align__(16) unsigned char scan_smem[];
  PlaceSrc* src = reinterpret_cast<PlaceSrc*>(scan_smem);  // n
  for (int i = threadIdx.x; i < n; i += Sh::kThreads) {
    src[i] = PlaceSrc{static_cast<int>(ys[i]), static_cast<int>(xs[i]), visible == nullptr || visible[i], 0};
  }
  __syncthreads();
  PlaceWork<B> work;
  work.patches = patches;
  work.canvas = canvas;
  work.p = p;
  work.c = c;
  work.pr = threadIdx.x % Sh::kPairs;
  walk_tiles<B>(src, reinterpret_cast<int*>(src + n), n, c, c, p, work);
}

// Blocks of a persistent grid for `kernel`: as many as fit on the card at
// once with the most shared memory a launch takes (asked once a device: a
// host call of its own), never more than the tiles.
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, size_t max_shared, long long n_tiles) {
  static int fit[32];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 32) dev = 0;
  if (fit[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, max_shared) != cudaSuccess ||
        per_sm * sms <= 0) {
      sms = 132;
      per_sm = 2;
    }
    fit[dev] = per_sm * sms;
  }
  return static_cast<int>(n_tiles < fit[dev] ? n_tiles : fit[dev]);
}

inline long long tiles_of(int rows, int cols) {
  return static_cast<long long>((rows + kScanRows - 1) / kScanRows) * ((cols + kTileCols - 1) / kTileCols);
}

}  // namespace

// patches (n, p, p, b) float32 contiguous; corners (n, 2) int32, the
// canvas row and column of each patch's element (0, 0); visible n bytes (0:
// the patch adds +0.0) or null; canvas (h, w, b) float32, element (y, x, c)
// at canvas[y * pitch + x * b + c], added into in place (a square
// contiguous canvas: h = w = c, pitch = c * b).  Returns the cudaError_t of
// the launch.
extern "C" int dvt_place(const float* patches, const int32_t* corners, const uint8_t* visible,
                         float* canvas, int n, int p, int b, int h, int w, int pitch, void* stream) {
  return place_f32(patches, corners, visible, canvas, n, p, b, h, w, pitch, static_cast<cudaStream_t>(stream));
}

// dvt_place with bf16 patches and a bf16 canvas (2-byte elements), each add
// rounded to bf16, for b = 6, at most 1,024 patches (kScanSources) and
// 4-byte-aligned patches and canvas: the corners as two int64 arrays ys,
// xs; visible n bytes or null.
extern "C" int dvt_place_bf16(const bf16* patches, const int64_t* ys, const int64_t* xs, const uint8_t* visible,
                              bf16* canvas, int n, int p, int c, void* stream) {
  if (n <= 0 || c <= 0 || p <= 0) return 0;
  if (n > kScanSources || (reinterpret_cast<uintptr_t>(patches) & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(canvas) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kThreads = ScanShape<6>::kThreads;
  constexpr size_t kPerSource = sizeof(PlaceSrc) + ScanShape<6>::kListBytes;
  const int grid = persistent_grid(place_scan_kernel<6>, kThreads, kScanSources * kPerSource, tiles_of(c, c));
  const size_t shared = n * kPerSource;
  place_scan_kernel<6><<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(patches, ys, xs, visible,
                                                                                       canvas, n, p, c);
  return static_cast<int>(cudaGetLastError());
}

// dvt_place_bf16 for any b (corners (n, 2) int32): the generic kernel.
extern "C" int dvt_place_bf16_generic(const bf16* patches, const int32_t* corners, const uint8_t* visible,
                                      bf16* canvas, int n, int p, int b, int c, void* stream) {
  if (n <= 0 || c <= 0 || b <= 0 || p <= 0) return 0;
  return launch_place_generic<bf16>(patches, corners, visible, canvas, n, p, b, c, c,
                                    static_cast<long long>(c) * b, static_cast<cudaStream_t>(stream));
}

// stamps (n, s, s, b) float32 contiguous; offsets (n, 2) float32, from the
// window's centre ((h - s) / 2, (w - s) / 2); mask n bytes (0 drops the
// source) or null; out: the (h, w, b) window, element (y, x, c) at
// out[y * pitch + x * b + c]; accumulate != 0 adds to what out holds, else
// out is overwritten.  A square window (h = w) is the field of the render.
// Returns the cudaError_t of the launch.
extern "C" int dvt_render(const float* stamps, const float* offsets, const uint8_t* mask,
                          float* out, int n, int s, int b, int h, int w, int pitch,
                          int accumulate, void* stream) {
  return render_f32(stamps, offsets, mask, out, n, s, b, h, w, pitch, accumulate, static_cast<cudaStream_t>(stream));
}

// dvt_render with bf16 stamps and a bf16 window `out`, always added into:
// each source's value rounded to bf16 and every add rounded, in ascending
// source index, where its padded patch covers the element.  For b = 6, at
// most 1,024 sources (kScanSources), 4-byte-aligned stamps and window and
// an even pitch, the scan kernel; else the generic kernel.
extern "C" int dvt_render_bf16(const bf16* stamps, const float* offsets, const uint8_t* mask, bf16* out, int n,
                               int s, int b, int f, int pitch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f <= 0 || b <= 0 || n <= 0) return 0;
  if (b != 6 || n > kScanSources || (pitch & 1) != 0 || (reinterpret_cast<uintptr_t>(stamps) & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 3u) != 0) {
    return launch_render_generic<bf16>(stamps, offsets, mask, out, n, s, b, f, f, pitch, 1, st);
  }
  constexpr int kThreads = ScanShape<6>::kThreads;
  constexpr size_t kPerSource = sizeof(RenderSrc) + ScanShape<6>::kListBytes;
  const int grid = persistent_grid(render_scan_kernel<6>, kThreads, kScanSources * kPerSource, tiles_of(f, f));
  const size_t shared = n * kPerSource;
  render_scan_kernel<6><<<grid, kThreads, shared, st>>>(stamps, offsets, mask, out, n, s, f, pitch);
  return static_cast<int>(cudaGetLastError());
}
