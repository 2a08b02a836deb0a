// env_soa.cu -- per-layer class masks from the env-merged SoA bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, EnvSoaKernel).
//
// Replaces the Pallas kernel tinycarlo_tpu/ops/rasterize_pallas.py
// `_kernel_env` (:689, `pallas_call` :851), which production replaced by
// `_kernel_env_idx`; the rasterizer benchmark
// (tinycarlo_torch.benchmarks.rasterize_bench) times it unsplit (`env`,
// gran 8) and lane-split (`cur`, gran 16).
//
// Function. For the bundle of `compact_env_soa` at band granularity 8 or
// 16 (per env k slots of ax, ay, abx, aby, inv float32 and bw =
// (frame*n_bands + b0c)*512 + nb int32, the stacked frame = l*nxb + xb
// also folded into ay as frame*hp; counts (3, B) rows [live, short,
// dropped]), pixel (env, l, y, x) is lit iff some slot s < counts[0, env]
// with nb > 0 whose band word names the frame of (l, x) stamps it: its
// window and, when tall, its tail bands, with `_kernel_env`'s absolute
// pixel rows (stamp.cuh `stamp_tile`). `split` must match the compaction:
// with it, frames wider than 128 are 128-lane blocks (nxb of them) whose
// slots carry block-local lanes; without it a frame is one strip of its
// width. Envs with no live slot are zeros.
//
// Design. One thread block per 128-lane tile of a frame, B*L*ceil(w/128)
// blocks (stamp.cuh `soa_tile`): in the split layout a tile is a lane
// block; unsplit, a whole-width strip (307 KB of uint8 at 480x640, beyond
// a block's 227 KB of shared memory) is cut into tiles whose blocks list
// only the slots whose x-range, widened by the stroke, meets their lanes.
// The block zeroes a uint8 [hp][min(w, 128)] strip, lists the env's live
// slots of its frame, stamps them with all threads, and writes rows
// [0, h) out. Slots past counts[0] and slots with nb == 0 are never
// walked.
//
// Bound on the H100 at the benchmark's shapes (B=4096, L=5, 128x160,
// t=2): the uint8 output, 419 MB, written once, plus the counts and the
// live slots' SoA entries: ~0.126 ms at 3.35 TB/s; the stamp's float32
// operations over the slots' bounding boxes are well under that, so bytes
// bound it (computed from the run's bundle by the benchmark and
// chip_smoke.py). The design evaluates whole windows over the tile's
// lanes, many times the bounding boxes' pixels; later work.
#include "stamp.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

template <int Gran>
__global__ void __launch_bounds__(kThreads)
env_soa_kernel(Params p, uint8_t* __restrict__ out, int strip_bytes,
               float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile t = block_tile(p);
  const size_t o = (size_t)t.env * p.le;  // the env's k slots
  soa_tile(
      p, t, true, p.counts[t.env], out, smem, strip_bytes,
      [&](int s) {
        const int word = p.bw[o + s];
        return word_live(word) && word_frame(word, p) == t.frame &&
               touches(p.ax[o + s], p.abx[o + s], pad, t);
      },
      [&](int s, uint8_t* strip) {
        const size_t q = o + s;
        const int word = p.bw[q];
        const int rowband = word >> kNbShift;
        stamp_tile<Gran, true>(p, p, t, p.ax[q], p.ay[q], p.abx[q],
                               p.aby[q], p.inv[q], rowband, word & kNbMask,
                               rowband - t.frame * p.n_bands, strip);
      });
}

}  // namespace

extern "C" int tc_env_soa_launch(
    const int32_t* counts, const float* ax, const float* ay,
    const float* abx, const float* aby, const float* inv, const int32_t* bw,
    uint8_t* out, int B, int L, int h, int w, int k, int split, int gran,
    int bres, float lat2, float cap2, void* stream) {
  tc::Params p;
  // k slots per env: the SoA rows are k apart, the list holds k
  tc::set_geometry(p, B, L, h, w, k, k, gran, split != 0);
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
    return tc::launch_tiles(p, env_soa_kernel<8>, out, k, kThreads, s);
  }
  if (gran == 16) {
    return tc::launch_tiles(p, env_soa_kernel<16>, out, k, kThreads, s);
  }
  return (int)cudaErrorInvalidValue;
}
