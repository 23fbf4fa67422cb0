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
// without a convergence loop on the host.
//
// Bound on the H100: bytes.  The minimum is one read of cur0 and
// dir_code and one write of the labels (12 bytes a pixel); the chase
// re-reads the dir codes along each path, which stays in L2 for a
// 1024^2 field (4 MB of codes) and is short (source radius).  Design: one
// thread per pixel, no shared memory, no device-wide synchronisation.  A
// chain is capped at h*w steps so a malformed (cyclic) input cannot hang
// the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void label_resolve_kernel(const int32_t* __restrict__ cur0,
                                     const int32_t* __restrict__ dir,
                                     int32_t* __restrict__ out, int h, int w) {
  const int64_t total = static_cast<int64_t>(h) * w;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= total) return;
  int r = static_cast<int>(p / w), c = static_cast<int>(p % w);
  int64_t q = p;
  int d = dir[q];
  for (int64_t steps = 0; d != 4 && steps < total; ++steps) {
    const int nr = r + d / 3 - 1, nc = c + d % 3 - 1;
    if (nr < 0 || nr >= h || nc < 0 || nc >= w) break;
    r = nr;
    c = nc;
    q = static_cast<int64_t>(r) * w + c;
    d = dir[q];
  }
  out[p] = cur0[q];
}

}  // namespace

// cur0, dir, out: (h, w) int32, contiguous.  Returns the cudaError_t of
// the launch.
extern "C" int dvt_label_resolve(const int32_t* cur0, const int32_t* dir, int32_t* out,
                                 int h, int w, void* stream) {
  const int64_t total = static_cast<int64_t>(h) * w;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  label_resolve_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      cur0, dir, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
