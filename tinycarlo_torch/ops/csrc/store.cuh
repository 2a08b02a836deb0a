// store.cuh -- the 16-byte store path that the epilogue of env_block.cuh's
// kernels (masks.cu, rank.cu, exact.cu, env_soa.cu, env_seg.cu; K1, K3-K5,
// K7) and the output-floor probes (probe_ovl.cu, probe_fill.cu,
// probe_skip.cu; K8-K10) share.
//
// A contiguous byte range is written by a set of threads: single bytes up
// to the first 16-byte aligned address, then 16-byte vector stores with
// neighbouring threads on neighbouring addresses, kStoreUnroll of them in
// flight per thread and trip, each a streaming store (st.global.cs: the
// output is not read again by the kernel, so it should not push the
// inputs out of L2), then the tail bytes. `fill_span` stores a 32-bit
// word repeated; `drain_span` copies a shared-memory chunk laid out at the
// destination's 16-byte phase and zeroes it behind itself.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kStoreUnroll = 4;

// Byte j of a range filled with `word` holds byte (j & 3) of the
// little-endian word, j counted from a 4-byte aligned base (a uint8 fill
// repeats its byte four times in the word).
__device__ __forceinline__ uint8_t span_byte(uint32_t word, long long j) {
  return static_cast<uint8_t>(word >> (8 * (j & 3)));
}

// Bytes [lo, hi) of base, as byte (j & 3) of `word` at offset j, written
// by thread t of nt: the head bytes, then vector stores, then the tail.
__device__ __forceinline__ void fill_span(uint8_t* __restrict__ base,
                                          long long lo, long long hi,
                                          uint32_t word, long long t,
                                          long long nt) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + lo);
  long long head = static_cast<long long>((16 - (addr & 15)) & 15);
  if (head > hi - lo) head = hi - lo;
  for (long long j = lo + t; j < lo + head; j += nt) {
    base[j] = span_byte(word, j);
  }
  const long long vlo = lo + head;
  const long long n16 = (hi - vlo) / 16;
  // vlo is 16-byte aligned and base 4-byte aligned, so the vector's byte
  // k sits at offset vlo + k with (vlo + k) & 3 == k & 3
  const uint4 v = make_uint4(word, word, word, word);
  uint4* __restrict__ dst = reinterpret_cast<uint4*>(base + vlo);
  long long i = t;
  for (; i + (kStoreUnroll - 1) * nt < n16; i += kStoreUnroll * nt) {
#pragma unroll
    for (int k = 0; k < kStoreUnroll; ++k) __stcs(dst + i + k * nt, v);
  }
  for (; i < n16; i += nt) __stcs(dst + i, v);
  for (long long j = vlo + n16 * 16 + t; j < hi; j += nt) {
    base[j] = span_byte(word, j);
  }
}

// dst[0, n) = src[0, n), then src[0, n) = 0, by thread t of nt. src lies
// in shared memory at dst's 16-byte phase (src - dst is a multiple of 16),
// so the vector part is aligned on both sides.
__device__ __forceinline__ void drain_span(uint8_t* __restrict__ dst,
                                           uint8_t* __restrict__ src,
                                           long long n, int t, int nt) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dst);
  long long head = static_cast<long long>((16 - (addr & 15)) & 15);
  if (head > n) head = n;
  for (long long j = t; j < head; j += nt) {
    dst[j] = src[j];
    src[j] = 0;
  }
  const long long n16 = (n - head) / 16;
  uint4* __restrict__ d = reinterpret_cast<uint4*>(dst + head);
  uint4* __restrict__ s = reinterpret_cast<uint4*>(src + head);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  long long i = t;
  for (; i + (kStoreUnroll - 1) * nt < n16; i += kStoreUnroll * nt) {
    uint4 v[kStoreUnroll];
#pragma unroll
    for (int k = 0; k < kStoreUnroll; ++k) v[k] = s[i + k * nt];
#pragma unroll
    for (int k = 0; k < kStoreUnroll; ++k) {
      __stcs(d + i + k * nt, v[k]);
      s[i + k * nt] = zero;
    }
  }
  for (; i < n16; i += nt) {
    __stcs(d + i, s[i]);
    s[i] = zero;
  }
  for (long long j = head + n16 * 16 + t; j < n; j += nt) {
    dst[j] = src[j];
    src[j] = 0;
  }
}

}  // namespace tc
