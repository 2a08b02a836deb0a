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
// masks.cu (see there): one block of 128 threads per env buckets the
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

namespace {

using namespace tc;

// compact_env_soa's slots: slot s of an env is copy s, entry env*le + s of
// the SoA arrays (le = k), counts (3, B) with no per-layer rows.
struct DirectSlots {
  const Geometry& g;
  const int32_t* counts;
  const int32_t* bw;

  __device__ __forceinline__ bool live(int env) const {
    return counts[env] > 0;
  }
  __device__ __forceinline__ int slots(int env) const {
    return min(counts[env], g.le);
  }
  template <typename F>
  __device__ __forceinline__ void copies(int env, int s, F f) const {
    const int word = bw[(size_t)env * g.le + s];
    const int l = word_layer(g, word);
    if (l >= 0) f(l, s, word);
  }
  __device__ __forceinline__ bool layer_live(int, int) const { return true; }
};

template <int Gran>
__global__ void __launch_bounds__(kEnvThreads)
env_soa_kernel(Params p, uint8_t* __restrict__ out, Chunks q, float pad) {
  extern __shared__ __align__(16) uint8_t smem[];
  env_frames<false>(DirectSlots{p, p.counts, p.bw},
                    FastCopies<Gran, true>{p, pad}, p, out, q,
                    One<uint8_t>::value, smem);
}

template <int Gran>
int launch(const Params& p, uint8_t* out, cudaStream_t stream) {
  if ((long long)p.B * p.L * p.h * p.w == 0) return (int)cudaGetLastError();
  const Chunks q = plan_chunks(p, 1, p.le);
  const size_t smem = env_smem(q, p);
  cudaError_t err = cudaFuncSetAttribute(
      env_soa_kernel<Gran>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  env_soa_kernel<Gran><<<p.B, kEnvThreads, smem, stream>>>(p, out, q,
                                                           fast_pad(p));
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (gran == 8) return launch<8>(p, out, s);
  if (gran == 16) return launch<16>(p, out, s);
  return (int)cudaErrorInvalidValue;
}
