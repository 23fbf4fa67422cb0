// Watershed label resolution: every pixel's label is its ascent root.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/label_select.py
// label_select_step / label_select_fixpoint (_select_kernel), which
// iterates cur[p] <- cur[parent(p)] as a direction-coded 9-way select, K
// steps a pass, until nothing changes.  The fixpoint is unique: a pixel
// whose chain of direction codes ends at a self-coded pixel r (code 4)
// takes cur0[r].  Ascent paths are acyclic (strict (value, -index) order
// along every edge), so this kernel follows each pixel's chain to its
// root directly and writes cur0[root]: the same labels, bit for bit,
// without a convergence loop on the host.  A code outside 0..8 selects
// nothing in the iteration, so it is a root here too.
//
// Bound on the H100: bytes.  The minimum is one read of cur0 and
// dir_code and one write of the labels (12 bytes a pixel), plus the chase
// along each ascent path, which the data sets.  Design: one thread a
// pixel in blocks of 32 x 8 pixels, the block's origin from the two grid
// indices (the first design divided a 64-bit flat index by W in every
// thread).  A thread loads its code and initial label together; a pixel
// coded 4 (most of a field) stores its label and ends, so a warp whose
// codes are all 4 ends at once.  A chain is followed through the read-only
// data cache (__ldg): its steps stay near each other and near the chains
// of the neighbouring threads.  Staging the tile's codes in shared memory
// (32 x 32 tiles, chasing there until a chain leaves the tile, or 8
// pixels a thread with their chains in flight together) measured slower
// on the card: the barrier holds every warp of a block until its slowest
// load, and most chains leave a tile.  A chain is capped at h*w steps so a
// malformed (cyclic) input cannot hang the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // pixels of a row a block
constexpr int kBlockY = 8;   // rows a block

__device__ __forceinline__ int sanitize(int d) { return static_cast<unsigned>(d) <= 8u ? d : 4; }

__global__ void __launch_bounds__(kBlockX * kBlockY)
label_resolve_kernel(const int32_t* __restrict__ cur0, const int32_t* __restrict__ dir,
                     int32_t* __restrict__ out, int h, int w) {
  int y = blockIdx.x * kBlockY + threadIdx.y, x = blockIdx.y * kBlockX + threadIdx.x;
  if (y >= h || x >= w) return;
  const size_t p = static_cast<size_t>(y) * w + x;
  int d = sanitize(__ldg(dir + p));
  int32_t lab = __ldg(cur0 + p);
  if (d != 4) {
    size_t q = p;
    const int64_t cap = static_cast<int64_t>(h) * w;
    for (int64_t steps = 0; d != 4 && steps < cap; ++steps) {
      const int dy = d / 3 - 1, dx = d % 3 - 1;
      if (y + dy < 0 || y + dy >= h || x + dx < 0 || x + dx >= w) break;
      y += dy;
      x += dx;
      q += static_cast<int64_t>(dy) * w + dx;
      d = sanitize(__ldg(dir + q));
    }
    lab = __ldg(cur0 + q);
  }
  out[p] = lab;
}

}  // namespace

// cur0, dir, out: (h, w) int32, contiguous.  Returns the cudaError_t of
// the launch.
extern "C" int dvt_label_resolve(const int32_t* cur0, const int32_t* dir, int32_t* out,
                                 int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if ((w + kBlockX - 1) / kBlockX > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((h + kBlockY - 1) / kBlockY, (w + kBlockX - 1) / kBlockX);
  label_resolve_kernel<<<grid, dim3(kBlockX, kBlockY), 0, static_cast<cudaStream_t>(stream)>>>(
      cur0, dir, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
