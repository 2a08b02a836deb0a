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
//
// Design. One block of 256 threads per `group` envs (the TPU's g envs per
// grid step), the last block ragged; each block stores its envs' bytes as
// one contiguous range in 16-byte vector stores (probe.cuh `fill_range`).
// On the TPU the flat and the (L, H, W) uint8 layouts differ (128-lane
// tiles against 160-lane rows with masked stores); here both are the same
// contiguous bytes.
//
// Bound on the H100 at the benchmark's shape (N = 4096, 5 x 128 x 160):
// the output written once, 419.4 MB (uint8) -> 0.1252 ms, 1.678 GB
// (float32) -> 0.5008 ms at 3.35 TB/s; no input, no arithmetic. The
// design issues the fewest store instructions (16 bytes each) and reads
// nothing.
#include "probe.cuh"

namespace {

using namespace tc_probe;

__global__ void __launch_bounds__(kThreads)
fill_kernel(uint8_t* __restrict__ out, long long env_bytes, int n_envs,
            int group, uint32_t word) {
  const long long e0 = static_cast<long long>(blockIdx.x) * group;
  const long long e1 = e0 + group < n_envs ? e0 + group : n_envs;
  fill_range(out, e0 * env_bytes, e1 * env_bytes, word);
}

}  // namespace

extern "C" int tc_probe_fill_launch(void* out, long long env_bytes,
                                    int n_envs, int group, unsigned word,
                                    void* stream) {
  if (group < 1 || env_bytes < 0 || n_envs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (n_envs + (long long)group - 1) / group;
  if (blocks > 0 && env_bytes > 0) {
    fill_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(out), env_bytes, n_envs, group, word);
  }
  return (int)cudaGetLastError();
}
