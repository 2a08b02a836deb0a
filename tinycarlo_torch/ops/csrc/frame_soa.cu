// frame_soa.cu -- per-layer class masks from the per-frame SoA bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, FrameSoaKernel).
//
// Replaces the Pallas kernel tinycarlo_tpu/ops/rasterize_pallas.py
// `_kernel` (:357, `pallas_call` :510), the first of the JAX package's
// kernels: production replaced it, and the rasterizer benchmark
// (tinycarlo_torch.benchmarks.rasterize_bench, mode `full`) times it.
//
// Function. For the bundle of `compact_soa` at band granularity 8 or 16
// (per (env, layer) frame f = env*L + l: k slots of ax, ay, abx, aby, inv
// float32 and bw = b0c*512 + nb int32, and counts (3, B*L) rows [live,
// short, dropped]), pixel (env, l, y, x) is lit iff some slot s <
// counts[0, f] with nb > 0 stamps it: the two-band window at band b0c and,
// for a tall slot, the tail bands through b0c + nb, with `_kernel`'s
// absolute pixel rows (stamp.cuh `stamp_tile`). The stamp order does not
// matter: the output is an OR. Frames with no live slot are zeros.
//
// Design. One thread block per 128-lane tile of a frame, B*L*ceil(w/128)
// blocks (stamp.cuh `soa_tile`, shared with env_soa.cu and env_seg.cu):
// the TPU kernel keeps a whole (hp, w) frame in VMEM, which at 480x640
// exceeds a block's 227 KB of shared memory. The block zeroes a uint8
// [hp][min(w, 128)] strip, lists the frame's live slots whose x-range
// (widened by the stroke) meets its lanes, stamps each listed slot's
// window and tail over its lanes with all threads, and writes rows [0, h)
// out in 4-wide stores when the width allows. Slots past counts[0], and
// slots with nb == 0, are never walked.
//
// Bound on the H100 at the benchmark's shape (B=4096, L=5, 128x160, t=2,
// gran 8, k=128 per frame). Bytes: the uint8 output, 419 MB, written once,
// plus the counts and the live slots' six SoA entries, ~6 MB: ~0.126 ms at
// 3.35 TB/s. Operations: 18 float32 operations per pixel of each live
// slot's bounding box padded by the stroke, well under that at 67
// TFLOP/s. So bytes bound it (the benchmark's `full` mode and
// chip_smoke.py compute both from the run's bundle). The design writes
// each output byte once but evaluates every pixel of each listed slot's
// window and tail rows over the tile's lanes, many times the bounding
// boxes' pixels; shrinking the windows is later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

template <int Gran>
__global__ void __launch_bounds__(kThreads)
frame_soa_kernel(Params p, uint8_t* __restrict__ out, int strip_bytes,
                 float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile t = block_tile(p);
  const size_t f = (size_t)t.env * p.L + t.l;  // the (env, layer) frame
  const size_t o = f * p.le;                   // its k slots
  soa_tile(
      p, t, p.counts[f], out, smem, strip_bytes,
      [&](int s) {
        return word_live(p.bw[o + s]) &&
               touches(p.ax[o + s], p.abx[o + s], pad, t);
      },
      [&](int s, uint8_t* strip) {
        const size_t q = o + s;
        const int word = p.bw[q];
        const int b0 = word >> kNbShift;
        stamp_tile<Gran>(p, p, t, p.ax[q], p.ay[q], p.abx[q], p.aby[q],
                         p.inv[q], b0, word & kNbMask, b0, strip);
      });
}

}  // namespace

extern "C" int tc_frame_soa_launch(
    const int32_t* counts, const float* ax, const float* ay,
    const float* abx, const float* aby, const float* inv, const int32_t* bw,
    uint8_t* out, int B, int L, int h, int w, int k, int gran, int bres,
    float lat2, float cap2, void* stream) {
  tc::Params p;
  // k slots per frame: the SoA rows are k apart, the list holds k
  tc::set_geometry(p, B, L, h, w, k, k, gran, /*split=*/false);
  p.counts = counts;
  p.idx = nullptr;
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
  if (gran == 8) {
    return tc::launch_tiles(p, frame_soa_kernel<8>, out, k, kThreads, s);
  }
  if (gran == 16) {
    return tc::launch_tiles(p, frame_soa_kernel<16>, out, k, kThreads, s);
  }
  return (int)cudaErrorInvalidValue;
}
