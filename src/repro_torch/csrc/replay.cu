// Replay of one channel's push/pop/retire events through a ring of slots.
//
// Replaces: src/repro/runtime/pallas_backend.py::_replay_kernel (via
// _replay_call), the kernel behind validate(backend=...).
//
// The host lowers a channel's dataflow trace to an event list (NOOP-padded
// to a power of two) with a ring slot per event.  The kernel runs the
// events in order against a ring initialised to -1 and counts each way the
// structure fails:
//   push into a slot that is not -1        -> overflow
//   pop from a -1 slot                     -> underflow
//   pop of a slot holding another value    -> mismatch
//   pop order the discipline cannot serve  -> order violation
//     FIFO (0) rejects v <= last popped, REGISTER (1) v < last popped,
//     REORDER (2) nothing; last popped starts at -1.
// out = [peak, order_violations, mismatches, overflows, underflows, live].
//
// Bound.  The events are a chain: each depends on the ring state the last
// one left, so one thread runs them.  The roofline bound (12 bytes an
// event over 3.35 TB/s) is far below what a dependent chain of loads
// allows; the latency of each step through L1 sets the time.  Channels
// hold at most a few thousand events, so a launch takes microseconds.
#include <cuda_runtime.h>

namespace {

enum { PUSH = 0, POP = 1, RETIRE = 2 };
enum { FIFO = 0, REGISTER = 1 };

__global__ void replay_kernel(const int* __restrict__ kind,
                              const int* __restrict__ value,
                              const int* __restrict__ slot, int n_events,
                              int* ring, int ring_size, int order_op,
                              int* __restrict__ out) {
  for (int i = 0; i < ring_size; ++i) ring[i] = -1;
  int live = 0, peak = 0, last_p = -1;
  int order_v = 0, mism = 0, ovf = 0, unf = 0;
  for (int e = 0; e < n_events; ++e) {
    const int k = kind[e], v = value[e], s = slot[e];
    const int cur = ring[s];
    const bool push = k == PUSH, pop = k == POP, retire = k == RETIRE;
    if (push && cur != -1) ++ovf;
    if (pop && cur == -1) ++unf;
    if (pop && cur != v && cur != -1) ++mism;
    if (pop) {
      if (order_op == FIFO ? v <= last_p
                           : order_op == REGISTER ? v < last_p : false)
        ++order_v;
      if (v > last_p) last_p = v;
    }
    ring[s] = push ? v : retire ? -1 : cur;
    live += (push ? 1 : 0) - (retire ? 1 : 0);
    if (live > peak) peak = live;
  }
  out[0] = peak; out[1] = order_v; out[2] = mism;
  out[3] = ovf; out[4] = unf; out[5] = live;
}

}  // namespace

// kind/value/slot: int32 (n_events,); ring: int32 (ring_size,) scratch;
// out: int32 (6,); all on the device.  Returns cudaGetLastError().
extern "C" int replay_i32(const int* kind, const int* value, const int* slot,
                          int n_events, int* ring, int ring_size,
                          int order_op, int* out, cudaStream_t stream) {
  replay_kernel<<<1, 1, 0, stream>>>(kind, value, slot, n_events, ring,
                                     ring_size, order_op, out);
  return (int)cudaGetLastError();
}
