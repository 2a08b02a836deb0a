// probe_fill.cu -- a constant fill of a batch of env outputs: the
// output-write floor.
//
// CUDA C++ for sm_90a, built by ops/_build.py and bound through ctypes
// (ops/probe_kernels.py, FillKernel).
//
// Replaces the three `zkernel`s of the JAX package's benchmarks/exp_r2.py
// (`dmaflat[g]` :192 / `pallas_call` :196, `dmaf32` :206 / :210, `dma[g]`
// :224 / :230), which fill (N, L*H*W/128, 128) uint8, (N, L, H, W) float32
// and (N, L, H, W) uint8 outputs with the iteration's value, g envs per
// grid step.
//
// Function. Every byte of the n_envs * env_bytes output holds the byte of
// `word` at its offset mod 4 (a uint8 value repeated, or a float32's bits).
// `group` (the TPU's g envs per grid step) is checked and otherwise
// unused: it changes nothing in the result, and on this card the grid
// follows the output's bytes, not the envs.
//
// Design. On the TPU the flat and the (L, H, W) uint8 layouts differ
// (128-lane tiles against 160-lane rows with masked stores); here both are
// the same contiguous bytes, so the output is one span, and the grid
// follows the span, not the envs: `fill_kernel` runs one block of 256
// threads per 16 KB tile of it, each thread with its kStoreUnroll = 4
// streaming 16-byte stores in flight (store.cuh `fill_span`, the path the
// masks kernel's epilogue and the other two probes store through). Blocks
// that each write a small contiguous tile, started in order, keep the
// card's writes in a compact window of the output. A persistent grid of
// resident blocks striding over the whole span, one whose blocks each
// write a long contiguous share, and TMA bulk copies
// (cp.async.bulk.global.shared::cta) from a filled 32 KB shared-memory
// tile all measured slower on the H100 (PERF.md gives the times).
//
// Bound on the H100 at the benchmark's shape (N = 4096, 5 x 128 x 160):
// the output written once, 419.4 MB (uint8) -> 0.1252 ms, 1.678 GB
// (float32) -> 0.5008 ms at 3.35 TB/s; no input, no arithmetic. The
// kernel issues the widest plain stores (16 bytes) and reads nothing.
#include "store.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;
// the bytes a block of fill_kernel writes: one trip of its threads' stores
constexpr long long kTileBytes = 16LL * kThreads * kStoreUnroll;

__global__ void __launch_bounds__(kThreads)
fill_kernel(uint8_t* __restrict__ out, long long bytes, uint32_t word) {
  const long long lo = static_cast<long long>(blockIdx.x) * kTileBytes;
  const long long hi = lo + kTileBytes < bytes ? lo + kTileBytes : bytes;
  fill_span(out, lo, hi, word, threadIdx.x, kThreads);
}

}  // namespace

extern "C" int tc_probe_fill_launch(void* out, long long env_bytes,
                                    int n_envs, int group, unsigned word,
                                    void* stream) {
  if (group < 1 || env_bytes < 0 || n_envs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long bytes = env_bytes * n_envs;
  const long long blocks = (bytes + kTileBytes - 1) / kTileBytes;
  if (blocks > 0) {
    fill_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(out), bytes, word);
  }
  return (int)cudaGetLastError();
}
