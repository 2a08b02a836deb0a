// probe_skip.cu -- a conditional fill of the live (env, layer) frames:
// the conditional-write floor.
//
// CUDA C++ for sm_90a, built by ops/_build.py and bound through ctypes
// (ops/probe_kernels.py, SkipKernel).
//
// Replaces the JAX package's benchmarks/exp_r2.py `dkernel` (:261,
// `pallas_call` :301; modes `dskip`, `dskipall`), which stages each live
// frame of an (N*L, H, 256) uint8 output in one of three VMEM buffers and
// copies it out with an async DMA, skipping the frames whose
// live[l, env] is 0.
//
// Function. Frame f = env*L + l (frame_bytes each) is filled with `word`'s
// byte iff live[l, env] > 0; every other frame is left as it was.
//
// Design. One block of 256 threads per frame, N*L blocks; a block whose
// frame is dead reads its live entry and exits, a live one stores the
// frame in 16-byte vector stores (probe.cuh `fill_range`). The TPU's
// staging buffers and semaphores are its way of issuing the copies; plain
// stores issue them here. TMA bulk stores from shared memory are later
// work.
//
// Bound on the H100 at the benchmark's shape (N = 4096, L = 5, 128 x 256):
// live (L, N) int32 read once, 80 KB, and the live frames written once,
// 32,768 B each: 671.1 MB with every frame live (`dskipall`) -> 0.2003 ms
// at 3.35 TB/s; `dskip` writes only the frames its reset draws.
#include "probe.cuh"

namespace {

using namespace tc_probe;

__global__ void __launch_bounds__(kThreads)
skip_kernel(uint8_t* __restrict__ out, const int32_t* __restrict__ live,
            int n_envs, int n_layers, long long frame_bytes, uint32_t word) {
  const long long f = blockIdx.x;
  const long long env = f / n_layers;
  const long long l = f - env * n_layers;
  if (live[l * n_envs + env] <= 0) return;
  fill_range(out, f * frame_bytes, (f + 1) * frame_bytes, word);
}

}  // namespace

extern "C" int tc_probe_skip_launch(void* out, const int32_t* live,
                                    int n_envs, int n_layers,
                                    long long frame_bytes, unsigned word,
                                    void* stream) {
  if (n_envs < 0 || n_layers < 1 || frame_bytes < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)n_envs * n_layers;
  if (blocks > 0 && frame_bytes > 0) {
    skip_kernel<<<(unsigned)blocks, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(out), live, n_envs, n_layers, frame_bytes,
        word);
  }
  return (int)cudaGetLastError();
}
