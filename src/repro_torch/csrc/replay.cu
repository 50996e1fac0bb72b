// Replay of one channel's push/pop/retire events through a ring of slots.
//
// Replaces: src/repro/runtime/pallas_backend.py::_replay_kernel (via
// _replay_call), the kernel behind validate(backend=...).
//
// The host lowers a channel's dataflow trace to an event list (NOOP-padded
// to a power of two) with a ring slot per event.  The events run in order
// against a ring initialised to -1, and the kernel counts each way the
// structure fails:
//   push into a slot that is not -1        -> overflow
//   pop from a -1 slot                     -> underflow
//   pop of a slot holding another value    -> mismatch
//   pop order the discipline cannot serve  -> order violation
//     FIFO (0) rejects v <= last popped, REGISTER (1) v < last popped,
//     REORDER (2) nothing; last popped starts at -1.
// A push writes its value into its slot, a retire writes -1, and a pop or a
// NOOP (3) writes nothing.  out = [peak, order_violations, mismatches,
// overflows, underflows, live], where live counts pushes less retires and
// peak is its running maximum (from 0).
//
// Design: a tiled scan.  The walk looks like a chain, but only the state of
// one slot is sequential, and only within that slot:
//   - live after an event is a prefix sum of push - retire, peak the
//     maximum of it;
//   - the last popped value an event sees is an exclusive prefix maximum of
//     the pops' values;
//   - the state an event sees in its slot is what the last push or retire
//     on that slot before it wrote, else what the ring held.
// One CTA of THREADS threads walks the list in tiles of TILE events, ITEMS
// a thread, and runs every event of a tile at once: block scans for live
// and the pop order; a stable block radix sort of the tile by slot, then a
// segmented "last writer" scan over the sorted events, for the slot state;
// per-event predicates summed by a block reduction.  At the tile's end each
// slot's last writer updates the ring, and live, peak, the last popped
// value and the counters carry to the next tile.  The ring lives in shared
// memory where ring_size <= SMEM_RING and in the caller's global scratch
// where it does not.  An event whose slot lies outside the ring is not run
// (the caller checks the range on the host: `_RingReplay.run`).
//
// Bound.  12 bytes an event over 3.35 TB/s (0.0000147 ms for 4,096
// events): far below what the tile's scans and its sort, a few hundred
// cycles each with their barriers, cost.  The lists hold at most a few
// thousand events, one or two tiles, so a launch takes a few microseconds,
// the latency of a tile's steps on one SM.
#include <climits>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

enum { PUSH = 0, POP = 1, RETIRE = 2, NOOP = 3 };
enum { FIFO = 0, REGISTER = 1 };

constexpr int THREADS = 512;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;
constexpr int SMEM_RING = 16384;    // slots the ring may keep in shared memory
constexpr size_t SMEM_BYTES = (3 * TILE + SMEM_RING) * sizeof(int);

// A sorted event's contribution to the last-writer scan: HEAD where it
// starts its slot's segment, HAS where it writes (a push or a retire), and
// the value it writes in the low 32 bits.
typedef unsigned long long u64;
constexpr u64 HEAD = 1ull << 33, HAS = 1ull << 32;

struct LastWriter {
  __device__ __forceinline__ u64 operator()(const u64& a, const u64& b) const {
    if (b & HEAD) return b;                  // b starts a segment
    if (b & HAS) return b | (a & HEAD);      // b's write is the last one
    return a;
  }
};

struct Max {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

struct Sum4 {
  __device__ __forceinline__ int4 operator()(const int4& a,
                                             const int4& b) const {
    return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

typedef cub::BlockScan<int, THREADS> ScanInt;
typedef cub::BlockScan<u64, THREADS> ScanWriter;
typedef cub::BlockRadixSort<unsigned, THREADS, ITEMS, int> SortBySlot;
typedef cub::BlockReduce<int, THREADS> ReduceInt;
typedef cub::BlockReduce<int4, THREADS> Reduce4;

__global__ void __launch_bounds__(THREADS)
replay_kernel(const int* __restrict__ kind, const int* __restrict__ value,
              const int* __restrict__ slot, int n_events,
              int* __restrict__ ring_scratch, int ring_size, int order_op,
              int* __restrict__ out) {
  __shared__ union {
    typename ScanInt::TempStorage scan;
    typename ScanWriter::TempStorage writer;
    typename SortBySlot::TempStorage sort;
    typename ReduceInt::TempStorage reduce;
    typename Reduce4::TempStorage reduce4;
  } tmp;
  extern __shared__ int dyn[];
  int* t_kind = dyn;                                 // (TILE,) by event
  int* t_value = t_kind + TILE;                      // (TILE,) by event
  unsigned* t_slot = reinterpret_cast<unsigned*>(t_value + TILE);  // sorted
  int* ring = ring_size <= SMEM_RING ? reinterpret_cast<int*>(t_slot + TILE)
                                     : ring_scratch;
  const int tid = threadIdx.x;
  for (int i = tid; i < ring_size; i += THREADS) ring[i] = -1;

  // carried from tile to tile: the same in every thread, and thread 0's
  // peak and counters
  int live = 0, last_p = -1, peak = 0;
  int4 counts = make_int4(0, 0, 0, 0);  // overflows, underflows, mismatches,
                                        // order violations
  // events past the list and outside the ring sort after every slot
  const unsigned none = (unsigned)ring_size;
  const int end_bit = 32 - __clz(ring_size);

  for (int base = 0; base < n_events; base += TILE) {
    int k[ITEMS], v[ITEMS], idx[ITEMS], step[ITEMS], popped[ITEMS];
    unsigned key[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int li = tid * ITEMS + i, e = base + li;
      int kk = NOOP, vv = 0;
      unsigned s = none;
      if (e < n_events) {
        const int se = slot[e];
        if (se >= 0 && se < ring_size) {
          kk = kind[e];
          vv = value[e];
          s = (unsigned)se;
        }
      }
      k[i] = kk;
      v[i] = vv;
      key[i] = s;
      idx[i] = li;
      t_kind[li] = kk;
      t_value[li] = vv;
      step[i] = (kk == PUSH) - (kk == RETIRE);
      popped[i] = kk == POP ? vv : INT_MIN;
    }

    // live and peak
    int live_after[ITEMS], tile_live;
    ScanInt(tmp.scan).InclusiveSum(step, live_after, tile_live);
    int my_peak = INT_MIN;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) my_peak = max(my_peak, live + live_after[i]);
    __syncthreads();
    const int tile_peak = ReduceInt(tmp.reduce).Reduce(my_peak, Max());
    __syncthreads();

    // pop order: the largest value popped before each event
    int popped_before[ITEMS], tile_popped;
    ScanInt(tmp.scan).ExclusiveScan(popped, popped_before, INT_MIN, Max(),
                                    tile_popped);
    int4 mine = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (k[i] != POP) continue;
      const int lp = max(last_p, popped_before[i]);
      mine.w += order_op == FIFO ? v[i] <= lp
                : order_op == REGISTER ? v[i] < lp : 0;
    }
    __syncthreads();

    // slot state: sort by slot (stable), then the last writer before each
    // event within its slot's segment
    SortBySlot(tmp.sort).Sort(key, idx, 0, end_bit);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) t_slot[tid * ITEMS + i] = key[i];
    __syncthreads();
    u64 x[ITEMS], before[ITEMS];
    bool tail[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int p = tid * ITEMS + i;
      const bool head = p == 0 || t_slot[p - 1] != key[i];
      tail[i] = p == TILE - 1 || t_slot[p + 1] != key[i];
      const int kk = t_kind[idx[i]];
      const bool writes = kk == PUSH || kk == RETIRE;
      x[i] = (head ? HEAD : 0ull)
             | (writes ? HAS | (unsigned)(kk == PUSH ? t_value[idx[i]] : -1)
                       : 0ull);
    }
    ScanWriter(tmp.writer).ExclusiveScan(x, before, 0ull, LastWriter());
    int write[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      write[i] = 0;
      if (key[i] == none) continue;
      const int kk = t_kind[idx[i]], vv = t_value[idx[i]];
      const int cur = !(x[i] & HEAD) && (before[i] & HAS)
                          ? (int)(unsigned)before[i] : ring[key[i]];
      mine.x += kk == PUSH && cur != -1;
      mine.y += kk == POP && cur == -1;
      mine.z += kk == POP && cur != vv && cur != -1;
      const u64 after = LastWriter()(before[i], x[i]);
      write[i] = tail[i] && (after & HAS);
      if (write[i]) x[i] = after;
    }
    __syncthreads();                 // every read of the ring precedes ...
#pragma unroll
    for (int i = 0; i < ITEMS; ++i)  // ... each slot's last write
      if (write[i]) ring[key[i]] = (int)(unsigned)x[i];
    const int4 tile_counts = Reduce4(tmp.reduce4).Reduce(mine, Sum4());
    __syncthreads();
    if (tid == 0) {
      peak = max(peak, tile_peak);
      counts = Sum4()(counts, tile_counts);
    }
    live += tile_live;
    last_p = max(last_p, tile_popped);
  }
  if (tid == 0) {
    out[0] = peak; out[1] = counts.w; out[2] = counts.z;
    out[3] = counts.x; out[4] = counts.y; out[5] = live;
  }
}

}  // namespace

// kind/value/slot: int32 (n_events,); ring: int32 (ring_size,) scratch,
// used where the ring does not fit shared memory; out: int32 (6,); all on
// the device.  Returns cudaFuncSetAttribute's error or cudaGetLastError().
extern "C" int replay_i32(const int* kind, const int* value, const int* slot,
                          int n_events, int* ring, int ring_size,
                          int order_op, int* out, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch check would read it
    return (int)err;
  }
  const size_t smem = ring_size <= SMEM_RING
                          ? (3 * TILE + ring_size) * sizeof(int)
                          : 3 * TILE * sizeof(int);
  replay_kernel<<<1, THREADS, smem, stream>>>(kind, value, slot, n_events,
                                              ring, ring_size, order_op, out);
  return (int)cudaGetLastError();
}
