// Stage stamps and row counters of the graph-replayed training step.
//
// Not a compute kernel: instrumentation, launched only while the trainer
// traces (train/metrics.Tracer). stage_stamp writes the device's
// %globaltimer (nanoseconds) into slot i of an int64 buffer when the
// stream reaches it; captured into a CUDA graph it runs again at that
// point of every replay, inside a conditional node's body too (an event
// record node cannot sit there). stage_count adds a row count read from
// the device to two int64 slots, the rows a count entry computed and the
// rows a tile computed in all, so a graph that replays a data-dependent
// amount of work still counts what it ran. Both are one thread: the
// stream orders them against the work they bracket or count.
#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(long long* buf, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = static_cast<long long>(t);
}

// buf[slot] += min(max(*n, 0), hi) * mult; buf[slot + 1] += that, or
// `computed` where it is not negative.
__global__ void stage_count_kernel(long long* buf, int slot, const int* n,
                                   long long mult, long long hi,
                                   long long computed) {
  long long a = *n;
  a = a < 0 ? 0 : (a > hi ? hi : a);
  a *= mult;
  buf[slot] += a;
  buf[slot + 1] += computed < 0 ? a : computed;
}

}  // namespace

extern "C" {

int stage_stamp(long long* buf, int slot, cudaStream_t stream) {
  stage_stamp_kernel<<<1, 1, 0, stream>>>(buf, slot);
  return cudaGetLastError();
}

int stage_count(long long* buf, int slot, const int* n, long long mult,
                long long hi, long long computed, cudaStream_t stream) {
  stage_count_kernel<<<1, 1, 0, stream>>>(buf, slot, n, mult, hi, computed);
  return cudaGetLastError();
}

}  // extern "C"
