// probe.cuh -- the byte fill shared by the output-floor probes
// (probe_ovl.cu, probe_fill.cu, probe_skip.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc_probe {

constexpr int kThreads = 256;

// Byte j of a range filled with `word` holds byte (j & 3) of the
// little-endian word: a uint8 fill repeats its byte four times in the
// word, a float32 fill is the float's bits (base is then 4-byte aligned).
__device__ __forceinline__ uint8_t word_byte(uint32_t word, long long j) {
  return static_cast<uint8_t>(word >> (8 * (j & 3)));
}

// Bytes [lo, hi) of base, filled by the whole block: single bytes up to
// the first 16-byte aligned address, then 16-byte vector stores with
// neighbouring threads on neighbouring addresses, then the tail.
__device__ __forceinline__ void fill_range(uint8_t* __restrict__ base,
                                           long long lo, long long hi,
                                           uint32_t word) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + lo);
  long long head = static_cast<long long>((16 - (addr & 15)) & 15);
  if (head > hi - lo) head = hi - lo;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) {
    base[lo + i] = word_byte(word, lo + i);
  }
  const long long vlo = lo + head;
  const long long n16 = (hi - vlo) / 16;
  // vlo is 16-byte aligned and base 4-byte aligned, so the vector's byte
  // k sits at offset vlo + k with (vlo + k) & 3 == k & 3
  const uint4 v = make_uint4(word, word, word, word);
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(base + vlo);
  for (long long i = threadIdx.x; i < n16; i += blockDim.x) dst[i] = v;
  for (long long j = vlo + n16 * 16 + threadIdx.x; j < hi; j += blockDim.x) {
    base[j] = word_byte(word, j);
  }
}

}  // namespace tc_probe
