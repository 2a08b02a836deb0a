// masks.cu -- per-layer class masks from the compaction bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, MasksKernel).
//
// Replaces the two Pallas kernels of the JAX package's main path, which
// compute the same masks and differ only in how a frame leaves VMEM:
//   tinycarlo_tpu/ops/rasterize_pallas.py `_kernel_env_idx` (:1931, blocked
//   output; uint8 0/255 or float 0/1) and `_kernel_env_dma` (:2107, uint8
//   staged through multi-buffered DMA). Both run `_tier_loops` (:1664) over
//   the `_window_hit` stamp (:134).
//
// Function. For the bundle of `compact_env_idx_soa(pre=False)` (layout,
// band words and stamp arithmetic in stamp.cuh, shared with rank.cu),
// pixel (env, l, y, x) is lit iff some slot s < counts[0, env] whose band
// word decodes to frame l*nxb + x/128 stamps (y, x). Rows [h, hp) are
// never written out; layers with counts[4+l] == 0 and envs with no live
// slot are written as zeros.
//
// Design. One thread block per (env, frame), frame = l*nxb + xb: B*L*nxb
// blocks (stamp.cuh `masks_frame`, shared with exact.cu). The block keeps
// its frame as a uint8 [hp][wb] strip in shared memory (16 KB at 128 rows,
// 61 KB at 480 rows), zeroes it, collects the env's slots that belong to
// its frame into a shared list, stamps each listed slot's rows x wb lanes
// with all threads (stores of 1 are idempotent, so overlapping slots need
// no atomics), then writes rows [0, h) and lanes [xb*128, min(w, xb*128 +
// 128)) to out[env, l] in row-contiguous, 4-wide stores when the width
// allows.
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, LE=528,
// kp=263). Bytes: the uint8 output, 419 MB, written once, plus the
// counts, the live slots' idx entries and their copies' SoA entries,
// ~4 MB -- ~423 MB, 0.126 ms at 3.35 TB/s. Operations: the split stroke
// costs 18 float operations per pixel, and only the pixels of each live
// copy's bounding box, padded by the stroke radius, can be lit: ~0.56 G,
// 0.008 ms at 67 TFLOP/s. So bytes bound it (chip_smoke.py computes both
// from each run's bundle). The design writes each output byte once, with
// row-contiguous stores, but evaluates win*128 = 4096 pixels per short
// slot (more for talls), ~17x the bounding boxes' pixels; it does not yet
// shrink the window to the segment's extent, bit-pack the strip, or keep
// blocks resident across envs -- later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

template <typename Conv>
__global__ void __launch_bounds__(kThreads)
masks_kernel(Params p, typename Conv::T* __restrict__ out, int strip_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  masks_frame<Conv>(
      p, p.counts, p.idx, p.bw, out, smem, strip_bytes,
      [&](int env, int frame, uint8_t* strip, const int* list, int m) {
        for (int j = 0; j < m; ++j) {
          stamp_copy(p, (size_t)env * p.le + list[j], frame,
                     [&](int row, int x) { strip[row * p.wb + x] = 1; });
        }
      });
}

template <typename Conv>
int launch(const Params& p, typename Conv::T* out, cudaStream_t stream) {
  int strip_bytes, smem;
  cudaError_t err = strip_smem(p, 1, masks_kernel<Conv>, &strip_bytes,
                               &smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)p.B * p.L * p.nxb;
  if (blocks > 0) {
    masks_kernel<Conv><<<(unsigned)blocks, kThreads, smem, stream>>>(
        p, out, strip_bytes);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_masks_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, void* out, int out_float, int B, int L, int h, int w,
    int kp, int le, int bres, float lat2, float cap2, void* stream) {
  tc::Params p;
  tc::set_geometry(p, B, L, h, w, kp, le);
  p.counts = counts;
  p.idx = idx;
  p.ax = ax;
  p.ay = ay;
  p.abx = abx;
  p.aby = aby;
  p.inv = inv;
  p.bw = bw;
  p.bres = bres;
  p.lat2 = lat2;
  p.cap2 = cap2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_float) return launch<tc::MaskF32>(p, static_cast<float*>(out), s);
  return launch<tc::MaskU8>(p, static_cast<uint8_t*>(out), s);
}
