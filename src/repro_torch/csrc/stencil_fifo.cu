// The hand-written Fig. 3 jacobi-1d: `steps` time levels over parallelogram
// tiles, with the dependences that cross a block boundary carried by FIFO
// channels between the workers of consecutive blocks.
//
// Replaces: src/repro/kernels/stencil_fifo/kernel.py:30, _kernel (launched by
// jacobi_fifo).
//
// What it computes.  x (N,) is cut into nblocks = N / block blocks, with
// steps == block, plus an all-zero flush block nblocks.  In skewed positions
// p in [0, N + block), level t is
//   y_t[p] = ((y_{t-1}[p-2] + y_{t-1}[p-1]) + y_{t-1}[p]) / 3,
// zero where cell p - t lies outside [0, N), with y_{t-1} taken as zero left
// of p = 0 and y_0 = x followed by the flush block; the output is
// y_steps[block:].  Block j holds positions [j * block, (j + 1) * block).
// Its level t needs its own level t - 1 and the two FIFO cells of block
// j - 1's level t - 1 (the cells the Pallas kernel carries from grid step
// j - 1 to grid step j).  A one-cell block puts its cell in both FIFO
// slots, as the reference's `fifo[t] = row[-2:]` broadcasts it.
//
// Design: in-flight blocks and their channels.  A worker holds one block in
// registers: `tpw` consecutive threads with up to CELLS cells each (an even
// split, at least two cells a thread where block >= 2; the kernel is
// compiled for 1, 2, 4 and 8 cells a thread, and a thread computes only
// that many).  One CTA runs
// `workers` workers at once; worker g takes blocks g, g + workers, ... in
// rounds.  Every in-flight block computes level t as soon as its left FIFO
// holds level t - 1: the dependences allow all of them to run on one level
// together (the lag of the wavefront is zero), so a round's chain is
// `steps` levels, not the grid walk's (nblocks + 1) * steps.  The FIFO
// between two threads of one warp is a pair of __shfl_up_sync; between
// warps it is a channel in shared memory of CHANNEL_DEPTH levels, where
// each FIFO cell travels in one 64-bit word with its level's tag: the
// consumer polls for the tag and needs no fence a level (no CTA-wide
// barrier either).  The consumer acknowledges what it has read every
// ACK_EVERY levels with a release store, and the producer waits for that
// before it reuses a slot, so a warp runs at most CHANNEL_DEPTH - 1 levels
// ahead of its right neighbour.  A wait that never ends traps.
// The last worker's FIFO wraps to worker 0 for the next round's first block
// through a (2, steps) buffer, one copy for each round parity; a
// __syncthreads ends each round.  Block 0's left FIFO is zero at every
// level (the Dirichlet edge).
//
// Arithmetic.  ((l + c) + r) / 3, the reference's order, with the quotient
// correctly rounded (`level` below, the IEEE division where it does not
// apply); the library is built with -fmad=false.  So at the same tiling
// this kernel and the generated ring (ring_stencil.cu) agree to the last
// bit.
//
// Bound.  One call must read x and write the output once: 8 bytes a cell
// over 3.35 TB/s (0.0000096 ms at N = 4000), with 3 flops a cell a level
// far below the fp32 rate.  The kernel is latency-bound by its chain:
// rounds * steps levels (8 at PolyBench EXTRALARGE, N = 4000, steps = block
// = 8: 501 blocks in one round), each a shuffle, a channel hand-over and up
// to 8 cells of adds and a corrected product, a chain of dependent
// instructions in every warp: 0.323 us a level for one warp of 4 cells,
// 0.490 us for the 9 warps of (1024, 128) and 0.740 us for the 17 warps of
// 8 cells of (4096, 256), which share one SM's four schedulers (NVIDIA H100
// 80GB HBM3 at 700 W; bench/fifo_sweep.py, PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int CELLS = 8;           // cells a thread holds, at most
constexpr int CHANNEL_DEPTH = 32;  // levels a warp-to-warp channel holds
constexpr int ACK_EVERY = 8;       // levels between a consumer's acks
constexpr int MAX_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned POLLS = 1u << 26;  // about a second: then trap, not hang
typedef unsigned long long u64;

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A FIFO cell in a channel slot: its level's tag in the high half and the
// value's bits in the low half of one 64-bit word, stored and loaded whole,
// so a consumer that sees the tag sees the value (no fence a level).
__device__ __forceinline__ u64 tagged(int tag, float v) {
  return (u64)(unsigned)tag << 32 | __float_as_uint(v);
}

// One level of a thread's cells, in place: new v[i] = ((a + b) + v[i]) / 3
// over prev_full = [a, b, v[0], v[1], ...], and zero where MASK and cell i
// is outside [lo, hi) or past cnt.  The quotient is RN(1/3)'s product with
// one FMA correction (Markstein): RN(s / 3) for 2^-100 <= |s| <= FLT_MAX, as
// tests/test_torch_kernels.py checks on a whole binade (both sides scale by
// powers of two over that range).  No branch, so the cells overlap.
// Returns false where a kept sum lies outside that range (zero, tiny or
// infinite): the caller divides those again.
template <int C, bool MASK>
__device__ __forceinline__ bool level(float (&v)[C], float (&sum)[C], float a,
                                      float b, int lo, int hi, int cnt) {
  const float third = 0x1.555556p-2f;             // RN(1/3)
  float lo_mag = 1.0f, hi_mag = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const float c = v[i];
    const float s = (a + b) + c;
    const float q0 = __fmul_rn(s, third);
    const float q = __fmaf_rn(__fmaf_rn(-3.0f, q0, s), third, q0);
    const bool in = !MASK || (i >= lo && i < hi && i < cnt);
    v[i] = in ? q : 0.0f;
    lo_mag = fminf(lo_mag, in ? fabsf(s) : 1.0f);
    hi_mag = fmaxf(hi_mag, in ? fabsf(s) : 0.0f);
    sum[i] = s;
    a = b;
    b = c;
  }
  return lo_mag >= 0x1p-100f && hi_mag <= 3.40282347e38f;
}

// The two FIFO cells a thread hands to the next: its last two cells, or its
// one cell twice.
template <int C>
__device__ __forceinline__ float2 fifo_cells(const float (&v)[C], int cnt) {
  if constexpr (C >= 2) {
    if (cnt == C) return make_float2(v[C - 2], v[C - 1]);
  }
  const int tail0 = cnt >= 2 ? cnt - 2 : 0, tail1 = cnt >= 1 ? cnt - 1 : 0;
  float2 f = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (i == tail0) f.x = v[i];
    if (i == tail1) f.y = v[i];
  }
  return f;
}

// C: the cells a thread holds, at least ceil(block / tpw).
template <int C>
__global__ void __launch_bounds__(MAX_THREADS)
stencil_fifo_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, int block, int steps, int workers, int tpw) {
  extern __shared__ u64 smem[];
  const int warps = blockDim.x / 32;
  // chan[w]: warp w's FIFO to warp w + 1, CHANNEL_DEPTH slots of two
  // tagged cells; wrap: the last worker's FIFO to the next round's first,
  // (2, steps); ack[w]: the levels warp w + 1 has read from chan[w]
  volatile u64* chan = smem;
  float2* wrap = reinterpret_cast<float2*>(smem + warps * CHANNEL_DEPTH * 2);
  int* ack = reinterpret_cast<int*>(wrap + 2 * steps);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / tpw, k = tid - g * tpw;     // worker, its k-th thread
  const int base = block / tpw, extra = block % tpw;
  const int cnt = g < workers ? base + (k < extra) : 0;
  const int s0 = k * base + min(k, extra);        // first cell in the block
  const int nblocks = n / block;
  const int rounds = (nblocks + workers) / workers;
  const bool wrap_writer = tid == workers * tpw - 1;

  for (int i = tid; i < warps * CHANNEL_DEPTH * 2; i += blockDim.x)
    chan[i] = 0;                                  // tag 0: no level yet
  for (int w = tid; w < warps; w += blockDim.x) ack[w] = 0;
  __syncthreads();
  int acked = 0;                                  // a producer's last view

  for (int r = 0; r < rounds; ++r) {
    const int j = r * workers + g;                // this worker's block
    const int p0 = j * block + s0;                // position of cell 0
    const bool owns = cnt > 0 && j <= nblocks;
    // level t of this round has the tag done + t + 1, and ack[w] counts
    // levels from the first round on
    const int done = r * (steps + 1);
    float v[C];
#pragma unroll
    for (int i = 0; i < C; ++i)
      v[i] = (owns && j < nblocks && i < cnt) ? x[p0 + i] : 0.0f;
    float2 mine = fifo_cells<C>(v, cnt);             // level 0's FIFO cells

    for (int t = 0; t <= steps; ++t) {
      if (t > 0) {
        float2 left;
        left.x = __shfl_up_sync(FULL, mine.x, 1);
        left.y = __shfl_up_sync(FULL, mine.y, 1);
        // the whole warp waits, so it stays converged; lane 0 takes the cells
        if (warp > 0) {                           // level t - 1 from warp - 1
          const volatile u64* slot =
              chan + ((warp - 1) * CHANNEL_DEPTH + (t - 1) % CHANNEL_DEPTH) * 2;
          u64 c0, c1;
          for (unsigned polls = 0;; ++polls) {
            c0 = slot[0];
            c1 = slot[1];
            if ((int)(c0 >> 32) == done + t && (int)(c1 >> 32) == done + t)
              break;
            if (polls == POLLS) __trap();
          }
          __syncwarp();             // every lane's read precedes the ack
          if (lane == 0) {
            left = make_float2(__uint_as_float((unsigned)c0),
                               __uint_as_float((unsigned)c1));
            if (t % ACK_EVERY == 0) store_release(&ack[warp - 1], done + t);
          }
        } else if (tid == 0) {                    // block 0: the Dirichlet edge
          left = r > 0 ? wrap[((r - 1) & 1) * steps + t - 1]
                       : make_float2(0.0f, 0.0f);
        }
        float sum[C];
        const int lo = t - p0, hi = n + t - p0;   // cell p0 + i - t in [0, n)
        const bool exact =
            cnt == C && lo <= 0 && hi >= C
                ? level<C, false>(v, sum, left.x, left.y, lo, hi, cnt)
                : level<C, true>(v, sum, left.x, left.y, lo, hi, cnt);
        if (!exact) {                             // rare: divide again
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const float m = fabsf(sum[i]);
            if (i >= lo && i < hi && i < cnt &&
                !(m >= 0x1p-100f && m <= 3.40282347e38f))
              v[i] = sum[i] / 3.0f;
          }
        }
        mine = fifo_cells<C>(v, cnt);
      }
      if (t < steps) {                            // hand level t over
        if (warp < warps - 1) {                   // to warp + 1, by lane 31
          // slot t % CHANNEL_DEPTH last held level t - CHANNEL_DEPTH
          const int need = done + t - CHANNEL_DEPTH + 1;
          for (unsigned polls = 0; acked < need; ++polls) {
            acked = load_acquire(&ack[warp]);
            if (polls == POLLS) __trap();
          }
          volatile u64* slot =
              chan + (warp * CHANNEL_DEPTH + t % CHANNEL_DEPTH) * 2;
          if (lane == 31) {
            slot[0] = tagged(done + t + 1, mine.x);
            slot[1] = tagged(done + t + 1, mine.y);
          }
        }
        if (wrap_writer) wrap[(r & 1) * steps + t] = mine;
      }
    }
    if (owns && j >= 1) {
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (i < cnt) out[p0 - block + i] = v[i];
    }
    __syncwarp();
    if (lane == 0 && warp > 0) store_release(&ack[warp - 1], done + steps + 1);
    __syncthreads();                // the round's wrap copy is complete
  }
}

}  // namespace

// x, out: float32 (n,), contiguous, distinct, on the device; n % block == 0
// and steps == block (the wrapper checks both).  `workers` blocks are in
// flight at once, each held by `tpw` threads of ceil(block / tpw) <= CELLS
// cells: the wrapper picks both (`kernel.fifo_launch`), and the kernel is
// instantiated for 1, 2, 4 and 8 cells a thread.  Returns
// cudaErrorInvalidValue for a split the kernel cannot run,
// cudaFuncSetAttribute's error where the shared memory passes the 227 KB a
// CTA may hold, else cudaGetLastError().
extern "C" int stencil_fifo_f32(const float* x, float* out, int n, int block,
                                int steps, int workers, int tpw,
                                cudaStream_t stream) {
  if (block < 1 || steps < 1 || tpw < 1 || workers < 1 ||
      (block + tpw - 1) / tpw > CELLS || (tpw > 1 && block < 2 * tpw) ||
      (long long)workers * tpw > MAX_THREADS ||
      (long long)n + (long long)(workers + 1) * block > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int cells = (block + tpw - 1) / tpw;
  void (*kernel)(const float*, float*, int, int, int, int, int) =
      cells <= 1   ? stencil_fifo_kernel<1>
      : cells <= 2 ? stencil_fifo_kernel<2>
      : cells <= 4 ? stencil_fifo_kernel<4>
                   : stencil_fifo_kernel<8>;
  const int threads = (workers * tpw + 31) / 32 * 32;
  const size_t smem = (size_t)threads / 32 * CHANNEL_DEPTH * 2 * sizeof(u64)
                      + (size_t)2 * steps * sizeof(float2)
                      + (size_t)threads / 32 * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch check would read it
      return (int)err;
    }
  }
  kernel<<<1, threads, smem, stream>>>(x, out, n, block, steps, workers, tpw);
  return (int)cudaGetLastError();
}
