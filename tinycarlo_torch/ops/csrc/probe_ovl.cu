// probe_ovl.cu -- the overlap probe: a per-env float32 multiply-add chain
// on a 128 x 128 tile, then a uint8 fill of the env's output.
//
// CUDA C++ for sm_90a, built by ops/_build.py with -fmad=false and bound
// through ctypes (ops/probe_kernels.py, OvlKernel).
//
// Replaces the JAX package's benchmarks/exp_r2.py `okernel` (:156,
// `pallas_call` :170; mode `ovl<KK>`), which asks whether the TPU's grid
// pipeline overlaps a kernel's compute with its output write: per env it
// runs KK rounds of x = x * 1.000001 + 0.0001 over a (128, 128) float32
// VMEM tile that starts at the scalar v, and fills the env's (L, H, W)
// uint8 block with u = uint8(int32(tile[0, 0])).
//
// Function. out[env, :] = uint8(int32(x_KK)) for every env, x_0 = v,
// x_{r+1} = fl(fl(x_r * 1.000001f) + 0.0001f) (-fmad=false keeps the
// multiply and the add separately rounded, as the plain version rounds
// them); the int32 -> uint8 cast wraps.
//
// Design. One block of 256 threads per env. The block writes v into a
// 64 KB shared-memory tile (the TPU kernel's VMEM scratch `sc`), and after
// a barrier each thread loads its 64 elements into registers: loaded from
// shared memory, the 16384 chains are opaque to the compiler and cannot
// fold into one. Each thread then runs the KK rounds on its 64 independent
// chains, stores them back, and after a second barrier the block reads
// tile[0, 0] and fills the env's bytes in 16-byte streaming vector stores
// (store.cuh `fill_span`, the fill probe's path). Other blocks on the SM
// overlap their chains with this block's stores; three 64 KB tiles fit an
// SM.
//
// Bound on the H100 at the benchmark's shape (N = 4096, 5 x 128 x 160):
// the output written once, 419.4 MB -> 0.1252 ms at 3.35 TB/s, against
// N * 16384 * KK * 2 float32 operations. The multiply and the add are
// rounded apart (a fused multiply-add changes the result), so each is an
// instruction, and the card issues 132 SMs x 128 lanes x 1.98 GHz =
// 3.345e13 of them a second (helper.PEAK_F32_INSTR_PER_S; the 67 TFLOP/s
// peak counts a fused multiply-add as two): KK = 64, 8.6 G -> 0.2568 ms;
// KK = 512, 68.7 G -> 2.0541 ms.
#include "store.cuh"

namespace {

using namespace tc;

constexpr int kThreads = 256;

constexpr int kTile = 128 * 128;
constexpr int kPerThread = kTile / kThreads;
constexpr int kSmem = kTile * (int)sizeof(float);

__global__ void __launch_bounds__(kThreads)
ovl_kernel(uint8_t* __restrict__ out, long long env_bytes, int kk, float v) {
  extern __shared__ __align__(16) float sc[];
  for (int i = threadIdx.x; i < kTile; i += kThreads) sc[i] = v;
  __syncthreads();
  float x[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) x[j] = sc[threadIdx.x + j * kThreads];
#pragma unroll 1
  for (int r = 0; r < kk; ++r) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) x[j] = x[j] * 1.000001f + 0.0001f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) sc[threadIdx.x + j * kThreads] = x[j];
  __syncthreads();
  const uint32_t u = static_cast<uint8_t>(static_cast<int>(sc[0]));
  const long long env = blockIdx.x;
  fill_span(out, env * env_bytes, (env + 1) * env_bytes, u * 0x01010101u,
            threadIdx.x, kThreads);
}

}  // namespace

extern "C" int tc_probe_ovl_launch(void* out, long long env_bytes,
                                   int n_envs, int kk, float v,
                                   void* stream) {
  if (kk < 0 || env_bytes < 0 || n_envs < 0) {
    return (int)cudaErrorInvalidValue;
  }
  // the tile is above the 48 KB default: allow it once
  static bool smem_allowed = false;
  if (!smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        ovl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = true;
  }
  if (n_envs > 0) {
    ovl_kernel<<<(unsigned)n_envs, kThreads, kSmem,
                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint8_t*>(out), env_bytes, kk, v);
  }
  return (int)cudaGetLastError();
}
