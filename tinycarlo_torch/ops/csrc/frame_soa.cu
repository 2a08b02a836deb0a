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
// absolute pixel rows, apy = (y0 + rr) - ay. The stamp order does not
// matter: the output is an OR. Frames with no live slot are zeros.
//
// Design. The bundle is a `compact_env_soa` bundle over B*L one-layer
// envs: its slots are (B*L, k), its counts' row 0 is per frame, its band
// word carries no frame bits (frame 0) and its ay is frame-relative, so
// `_kernel`'s pixel row is `FastCopies<Gran, true>`'s at frame 0. So it
// launches env_soa.cu's kernel (env_block.cuh `direct_soa_kernel`) on
// that geometry (L = 1, unsplit): one block of 128 threads per (env,
// layer) frame, B*L blocks, buckets the frame's live slots once
// (`DirectSlots`: slot s is copy s), stamps only each slot's box
// (stamp.cuh `copy_box` at Gran-row bands, padded by the stroke's reach +
// 1 px) into a whole-width row chunk in shared memory (the whole 128x160
// frame, 48-row chunks at 480x640), and drains the chunk through
// store.cuh's 16-byte streaming stores; a frame with no live slot is a
// register fill of zeros. The TPU kernel's grid is one step per env; a
// block per frame gives the card L times as many. Slots past counts[0]
// are never read; a slot with nb == 0 (the even-count pad slot) or whose
// band lies past the frame's (a bundle compacted at the other band
// height) is dropped at its word.
//
// Bound on the H100 at the benchmark's shape (B=4096, L=5, 128x160, t=2,
// gran 8, k=128 per frame). Bytes: the uint8 output, 419 MB, written once,
// plus the counts and the live slots' six SoA entries, ~6 MB: ~0.126 ms at
// 3.35 TB/s. Operations: 18 float32 operations per pixel of each live
// slot's bounding box padded by the stroke, well under that at 67
// TFLOP/s. So bytes bound it (the benchmark's `full` mode and
// chip_smoke.py compute both from the run's bundle). The design writes
// each output byte once, 16 bytes a store, and tests only the boxes'
// pixels.
#include "env_block.cuh"

extern "C" int tc_frame_soa_launch(
    const int32_t* counts, const float* ax, const float* ay,
    const float* abx, const float* aby, const float* inv, const int32_t* bw,
    uint8_t* out, int B, int L, int h, int w, int k, int gran, int bres,
    float lat2, float cap2, void* stream) {
  tc::Params p;
  // the B*L frames as one-layer envs, unsplit: the SoA rows and the
  // (B, L, h, w) output are (B*L, k) and (B*L, 1, h, w)
  tc::set_geometry(p, B * L, 1, h, w, k, k, gran, /*split=*/false);
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
