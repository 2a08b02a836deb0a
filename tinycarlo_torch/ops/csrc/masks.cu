// masks.cu -- per-layer class masks from the compaction bundle.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/rasterize_kernels.py, MasksKernel).
//
// Replaces the two Pallas kernels of the JAX package's main path, which
// compute the same masks and differ only in how a frame leaves VMEM:
//   tinycarlo_tpu/ops/rasterize_pallas.py `_kernel_env_idx` (:1931, blocked
//   output; uint8 0/255 or float 0/1: float32, or bfloat16 for the TD3
//   trainer's encoder feed) and `_kernel_env_dma` (:2107, uint8
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
// Design. The one-block-per-env skeleton of env_block.cuh, shared with rank.cu,
// exact.cu, env_soa.cu and env_seg.cu: one block of 128 threads per env walks
// the env's work items (layer, row chunk) in order: all w lanes of as many
// rows as fit 32 KB (the whole frame at 128x160 uint8, 20 KB; 48-row chunks
// at 480x640 uint8 or 128x160 float32), so a chunk is one contiguous range
// of out[env, l]. The block reads the env's live slots once and buckets
// their copies by layer in shared memory, each copy with its number of work units: its box (stamp.cuh
// `copy_box`: the segment's bounding box padded by the stroke's reach, clipped
// to the copy's bands and lanes) cut into slabs of rows. The block's 4 warps
// take a layer's units round robin; a warp walks its unit's pixels
// (`FastCopies`), lanes on neighbouring columns, tests them and writes the
// output value (255, 1.0f or bfloat16's 1.0) straight into a zeroed chunk
// buffer laid out at the destination's 16-byte phase, so only output lanes
// of a box are tested. A chunk's first byte lies at the phase of its
// offset, an element multiple, so a 1-, 2- or 4-byte element stays aligned
// in the buffer at any row width (48, 150, 160 and 640 are checked), and
// the buffer's 16 bytes of slack hold any phase. `window_hit` is
// called with the same apx/apy floats as the plain version (integer valued,
// exact), so the masks stay bit-equal. The chunk then leaves through
// store.cuh's 16-byte streaming stores (the fill probe's path), which zero the
// buffer behind them; an item with no unit (empty env or layer) is a register
// fill of zeros. One buffer is enough: stores retire without holding the
// threads, and the other resident blocks stamp while one stores: 128 threads a
// block, so that many envs are in flight on an SM (256 and 512 measured
// slower, as did 64). Envs differ in their work, and a grid of one block per
// env lets the card start the next env wherever one ends; a persistent grid of
// resident blocks, each walking a fixed run of (env, layer, chunk) items,
// measured slower on the H100, and so did one dealing the items round robin
// (each block then buckets an env for every item).
//
// Bound on the H100 at the bench shape (B=4096, L=5, 128x160, LE=528,
// kp=263). Bytes: the uint8 output, 419 MB, written once, plus the
// counts, the live slots' idx entries and their copies' SoA entries,
// ~4 MB -- ~423 MB, 0.126 ms at 3.35 TB/s. Operations: the split stroke
// costs 18 float operations per pixel, and only the pixels of each live
// copy's bounding box, padded by the stroke radius, can be lit: ~0.56 G,
// 0.008 ms at 67 TFLOP/s. So bytes bound it (chip_smoke.py computes both
// from each run's bundle). The design writes each output byte once,
// 16 bytes a store, and tests only the boxes' pixels (with a one-pixel
// margin around the reach).
#include "env_block.cuh"

namespace {

using namespace tc;

template <typename T>
__global__ void __launch_bounds__(kEnvThreads)
masks_kernel(Params p, T* __restrict__ out, Chunks q, float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  env_frames<false>(IdxSlots{p, p.counts, p.idx, p.bw}, FastCopies<>{p, pad},
                    p, out, q, One<T>::value(), smem);
}

template <typename T>
int launch(const Params& p, T* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, (int)sizeof(T), p.kp);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      masks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  masks_kernel<T><<<p.B, kEnvThreads, smem, stream>>>(p, out, q,
                                                      fast_pad(p));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tc_masks_launch(
    const int32_t* counts, const int32_t* idx, const float* ax,
    const float* ay, const float* abx, const float* aby, const float* inv,
    const int32_t* bw, void* out, int out_kind, int B, int L, int h, int w,
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
  switch (out_kind) {
    case tc::kOutUint8:
      return launch<uint8_t>(p, static_cast<uint8_t*>(out), s);
    case tc::kOutFloat32:
      return launch<float>(p, static_cast<float*>(out), s);
    case tc::kOutBfloat16:
      return launch<__nv_bfloat16>(p, static_cast<__nv_bfloat16*>(out), s);
  }
  return (int)cudaErrorInvalidValue;
}
