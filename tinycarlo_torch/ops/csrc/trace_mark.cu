// trace_mark.cu -- the tracer's device mark: one thread stamps a mark id
// and the card's clock into a ring, at the point of the stream where the
// mark was enqueued.
//
// CUDA C++ for sm_90a, built by ops/_build.py and bound through ctypes
// (utils/profiling.py, `device_span`).
//
// Replaces no TPU kernel. It exists because a host range
// (`torch.profiler.record_function`) is only open while Python runs, and
// a replayed CUDA graph runs no Python: a mark kernel captured into the
// graph runs at every replay, so the graph's own stages keep their times.
//
// Function. Each launch takes the next slot of the ring with an atomic
// add on `head` (a 64-bit count of every mark ever taken since the tracer
// zeroed it) and writes (id, %globaltimer) at slot mod `cap`: a ring that
// wraps keeps its newest `cap` marks, and head - cap says how many it
// lost. It never blocks. Every replay of a captured graph takes slots of
// its own, so the stamps of replays do not overwrite each other.
//
// Bound: one thread, 16 bytes written and one atomic; its cost is the
// launch (a node of the graph), a few microseconds at most.
#include <cuda_runtime.h>

namespace {

__global__ void mark_kernel(long long* __restrict__ ring,
                            unsigned long long* __restrict__ head,
                            unsigned long long cap, long long id) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(head, 1ULL) % cap;
  ring[2 * slot] = id;
  ring[2 * slot + 1] = static_cast<long long>(now);
}

}  // namespace

extern "C" int tc_trace_mark_launch(void* ring, void* head, long long cap,
                                    long long id, void* stream) {
  if (cap < 1) {
    return (int)cudaErrorInvalidValue;
  }
  mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(head),
      static_cast<unsigned long long>(cap), id);
  return (int)cudaGetLastError();
}
