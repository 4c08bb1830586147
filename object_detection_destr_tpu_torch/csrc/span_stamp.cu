// One timestamp of a device span, for Hopper (sm_90a). CUDA C++ with a plain
// C interface, loaded with ctypes by
// object_detection_destr_tpu_torch/ops/cuda/span_stamp.py.
//
// It replaces no TPU kernel: the JAX package has no spans inside its
// compiled step. The port captures a training step in one CUDA graph and
// replays it; a replay is one host call, so no host clock or profiler range
// can say which layer of the step the device's time went to. This kernel,
// launched on the stream between a layer's kernels, reads the device's
// nanosecond clock (%globaltimer) when the stream reaches it and writes it to
// stamps[*slot, column]. Captured with the step, it runs in every replay;
// slot is read on the device, so each replay writes the row its host set.
//
// What bounds it on this card: launch latency alone (one thread, one 8-byte
// store; a few microseconds a stamp inside a graph). The design is the
// least work that orders the read after the stream's previous kernel: one
// block of one thread. A slot outside [0, rows) writes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void span_stamp_kernel(long long* __restrict__ stamps, const long long* __restrict__ slot, int rows,
                                  int columns, int column) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long row = *slot;
  if (row < 0 || row >= rows) return;
  stamps[row * columns + column] = (long long)now;
}

}  // namespace

extern "C" {

int odtt_span_stamp_abi_version() { return 1; }

// stamps (rows, columns) int64 and slot (1,) int64, device pointers; writes
// stamps[*slot, column] on the stream. Returns cudaGetLastError() after the
// launch (0 on success).
int odtt_span_stamp(void* stamps, const void* slot, int rows, int columns, int column, void* stream) {
  if (rows <= 0 || columns <= 0 || column < 0 || column >= columns) return (int)cudaErrorInvalidValue;
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(stamps), static_cast<const long long*>(slot), rows, columns, column);
  return (int)cudaGetLastError();
}

}  // extern "C"
