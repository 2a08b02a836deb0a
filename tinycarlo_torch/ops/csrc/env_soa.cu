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
// pixel rows, apy = (y0s + rr) - ay (env_block.cuh `FastCopies` with
// Absolute). `split` must match the compaction: with it, frames wider
// than 128 are 128-lane blocks (nxb of them) whose slots carry
// block-local lanes; without it a frame is one strip of its width. Envs
// with no live slot are zeros.
//
// Design. The one-block-per-env skeleton of env_block.cuh, shared with
// masks.cu (see there), in its `direct_soa_kernel`, which frame_soa.cu
// launches too: one block of 128 threads per env buckets the
// env's live slots by layer once (`DirectSlots`: slot s is copy s; the
// bundle has no per-layer counts, so a layer with no copy is skipped by
// its empty bucket), stamps only each copy's box (stamp.cuh `copy_box` at
// Gran-row bands) into whole-width row chunks in shared memory, and
// drains each chunk through store.cuh's 16-byte streaming stores; an empty
// env or layer is a register fill of zeros. Unsplit, a frame is one strip
// of the full width (160 lanes at the bench shape, 640 at 480x640, where
// the chunks are 48 rows). Slots past counts[0] are never read; a slot
// with nb == 0 (the even-count pad slot) or whose frame lies past L*nxb
// (a bundle compacted at the other band height) is dropped at its band
// word.
//
// Bound on the H100 at the benchmark's shapes (B=4096, L=5, 128x160,
// t=2): the uint8 output, 419 MB, written once, plus the counts and the
// live slots' SoA entries: ~0.126 ms at 3.35 TB/s; the stamp's float32
// operations over the slots' bounding boxes are well under that, so bytes
// bound it (computed from the run's bundle by the benchmark and
// chip_smoke.py). The design writes each output byte once, 16 bytes a
// store, and tests only the boxes' pixels.
#include "env_block.cuh"

extern "C" int tc_env_soa_launch(
    const int32_t* counts, const float* ax, const float* ay,
    const float* abx, const float* aby, const float* inv, const int32_t* bw,
    uint8_t* out, int B, int L, int h, int w, int k, int split, int gran,
    int bres, float lat2, float cap2, void* stream) {
  tc::Params p;
  // k slots per env, each one copy: the SoA rows are k apart
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
  if (gran == 8) return tc::launch_direct_soa<8>(p, out, s);
  if (gran == 16) return tc::launch_direct_soa<16>(p, out, s);
  return (int)cudaErrorInvalidValue;
}
