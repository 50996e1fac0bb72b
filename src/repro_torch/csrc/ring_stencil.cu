// Fused time-tiled band stencil with the cross-block channels in a ring,
// spread over many CTAs: one thread-block cluster, a cooperative grid, or
// blocks in flight across the card with the ring a FIFO from CTA to CTA.
//
// Replaces: src/repro/runtime/pallas_codegen.py::_ring_kernel (launched by
// CompiledStencil.__call__ in "fifo-ring" mode).
//
// What it computes.  The streamed axis (cells for jacobi-1d, rows for
// jacobi-2d, planes for heat-3d; radius 1) is cut into `nblocks` blocks of
// `block` items, plus `flush` = steps / block zero blocks that drain the
// skew.  Block j runs `steps` levels; level t of row position s is item
// j*block - t + s.  Its left neighbours at level t-1 come from ring level
// (t-1) % depth, filled by the blocks before it: after each level the
// block deposits concat(ring_old[t % depth], new_row)[-halo:] into
// ring_new.  Items outside [0, n_items) are Dirichlet zero.  Block j's
// final row is output block j - flush.
//
// Order.  Pallas runs the grid in order and carries the ring between grid
// steps; CUDA blocks run in no order.  In the SHARED and GRID modes the
// CTAs walk the streamed axis together in a loop, and the ring is carried
// between its iterations.  ring_old is read-only within a block and
// ring_new write-only, and they swap at the block's end, which keeps the
// Pallas semantics exactly: the undersized ring (depth < steps+1) and the
// narrowed halo (halo < 2) corrupt the output as there, and block = 1
// works (the halo window then spans several predecessors).  Where the
// ring is full (depth > steps) and the halo is two items, ring level t-1
// as block j reads it is the last two items of block j - 1's level t - 1,
// and nothing later: so block j's level t needs only block j - 1's level
// t - 1, and every block in flight may compute level t at once (a lag-0
// wavefront).  The WAVE mode runs that order; the undersized ring and the
// narrowed halo read block j - 1's later levels, which the wavefront has
// not computed yet, and keep the other two modes.
//
// Design.  An item is d1 rows of d2 cells (jacobi-2d: d1 columns of one
// cell; jacobi-1d: one cell).  Three launch modes (Mode below;
// runtime/cuda_codegen.ring_launch picks one).
//   SHARED and GRID tile the rows over the CTAs, each owning whole rows of
// every ring level and working row: its tile.  The only values a CTA
// reads from another are its neighbours' edge rows of level t-1, needed by
// the update's inner neighbours; so a barrier across the CTAs ends every
// level (and the start of every block), and no cell is computed twice.
// Overlapped (ghost-zone) tiles were ruled out: they are exact only for a
// full ring, since with depth < steps+1 a block reads a slot that another
// level wrote, whose valid ghost region is narrower, and the invalid
// values would creep into the owned tile block by block.  Where the tiles
// fit the shared memory of a cluster of up to 16 CTAs (jacobi-1d; jacobi-2d
// at 2800 wide: 50 KB a CTA), they live there, the neighbours' edges are
// read through distributed shared memory and a cluster barrier ends a
// level.  Where they do not (heat-3d at 200x200: 11 MB in all), they live
// in a global scratch that stays in the 50 MB L2, spread over a
// cooperative grid of up to one CTA an SM (100 CTAs for heat-3d: 16 were
// 3.9x slower, pulling their tiles from L2), with a grid-wide barrier; the
// neighbours' edges there are read past L1 (ld.cg).  Both barriers have
// release/acquire semantics.
//   A working row holds a level's prev_full, the ring level's items then
// the block's, so every read of a level is one address pattern; the next
// level's ring items are copied into the next row as it is computed, and
// a block's input row is loaded during the block before.  A thread owns
// columns of the tile and walks SEG items of them (a template parameter:
// 8, 4, 2 or 1), loading all it needs of a column before it stores;
// indices are 32-bit, with no division in the loop over cells.  The
// launch shape comes from the wrapper (runtime/cuda_codegen.ring_launch).
//   WAVE, for a full ring whose block (2 to 8 items) fits one CTA's
// registers: a cooperative grid of up to one CTA an SM, CTA c taking
// blocks c, c + P, ... in rounds, each whole in its threads' registers
// (jacobi-2d at 2800: 8 x 2800 cells over 700 threads of 4 columns; 351
// blocks are 3 rounds on 132 SMs).  The ring between consecutive blocks
// is a channel in device memory (L2) from one CTA to the next, `depth`
// slots of a level's two items, each with a full/empty flag: the full
// ring's capacity is what lets a producer run a round ahead (with fewer
// slots each CTA's reuse of a slot waits on the next CTA's, around the
// ring: a deadlock).  A courier warp moves the
// flags (release stores, acquire polls) beside the compute threads, which
// never wait on a GPU-scope fence; a level hands over its last two items
// as soon as they are computed and computes the items that need only its
// own last level while its predecessor's hand-over is in flight.  One
// barrier of the compute threads a level, for the neighbours along d1 and
// d2, exchanged through shared memory; Dirichlet zero along the
// contiguous axis is data there (zero guards and padding), so jacobi-2d
// takes no mask.  The next round's input is prefetched into L2 two levels
// before the round ends, and outputs are stored evict-first.  The
// arithmetic is stencil_update's, in the same order, so the three modes
// agree to the last bit.
//
// Bound.  One call must read the input and write the output once:
// 8 bytes per cell over 3.35 TB/s; the arithmetic (3 to 15 flops a cell a
// level) is far below the fp32 rate.  SHARED and GRID cannot reach either:
// their chain of (blocks + 1) x steps levels each ends in a barrier, 2808
// of them for jacobi-2d at 2800 wide, and the cluster barrier compiles to
// a GPU-scope fence and an L1 invalidation (MEMBAR.ALL.GPU, CCTL.IVALL),
// the grid barrier to an atomic on device memory.  WAVE's chain is rounds
// x steps levels (24 there), each one CTA's level of work and one barrier
// of its threads, with the hand-over off the critical path.  Its floor is
// the latency of a warp's cells: the IEEE division (-prec-div, kept for
// its bits) compiles to a check (FCHK) and a branch around a call to its
// slow path, one region a cell, so a warp's cells do not overlap and 23
// warps an SM do not hide them; a zero sum takes the slow path, which is
// why columns past the item are not updated.  Then the rounds' boundaries,
// where every CTA writes its outputs and reads its next input at once,
// and the rounds' imbalance (351 blocks on 132 SMs: 2.66 rounds of work
// in 3).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil_update.cuh"

namespace cg = cooperative_groups;

namespace {

// threads a CTA may have, its launch bound (ring_stencil_limits reports it
// to the wrapper): walking 8 items takes more registers
constexpr int max_threads(int seg) { return seg >= 8 ? 512 : 1024; }

struct Geometry {
  int n_items, I, J, K;      // items; cells of an item = J rows of K
  int steps, block, depth, halo, nblocks, flush;
  int rows;                  // rows a CTA owns (the last may own fewer)
  int stride;                // floats of one item of a tile
  int tile;                  // floats of one CTA's rings and rows
};

// A neighbour CTA's value: distributed shared memory, or global memory
// read past this SM's L1 (another SM wrote it).
template <bool SMEM>
__device__ __forceinline__ float ld_other(const float* p) {
  if (SMEM) return *p;
  return __ldcg(p);
}

// SEG: the items of the block one thread walks (threadIdx.y picks which).
// Where the CTAs are and where their tiles live.  SHARED: one cluster,
// tiles in shared memory, a cluster barrier a level; GRID: a cooperative
// grid of up to one CTA an SM, tiles in the global scratch, a grid-wide
// barrier a level.
enum Mode { SHARED = 0, GRID = 1 };

template <int KIND, int MODE, int SEG>
__global__ void __launch_bounds__(max_threads(SEG))
ring_stencil_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* scratch, const Geometry g) {
  constexpr bool SMEM = MODE == SHARED;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = g.n_items, I = g.I, J = g.J, K = g.K, steps = g.steps;
  const int block = g.block, depth = g.depth, halo = g.halo;
  const int stride = g.stride, rows = g.rows;
  const int ctas = gridDim.x;
  const int rank = MODE == GRID ? (int)blockIdx.x
                   : ctas > 1   ? (int)cluster.block_rank()
                                : 0;
  float* own = SMEM ? reinterpret_cast<float*>(smem4)
                    : scratch + (long long)rank * g.tile;
  const float* left = nullptr;       // the CTAs owning the rows around ours
  const float* right = nullptr;
  if (rank > 0)
    left = SMEM ? cluster.map_shared_rank(own, rank - 1) : own - g.tile;
  if (rank < ctas - 1)
    right = SMEM ? cluster.map_shared_rank(own, rank + 1) : own + g.tile;

  const int bx = blockDim.x;
  const int row0 = rank * rows;                       // first row owned
  const int width = min(rows, J - row0) * K;          // cells of an item
  const int gi0 = row0 * K;                           // first inner index
  const int s_begin = threadIdx.y * SEG;
  const bool first_seg = threadIdx.y == 0;
  // this thread's first column (r, k) and its step between columns
  const int r_first = threadIdx.x / K, k_first = threadIdx.x % K;
  const int dr = bx / K, dk = bx % K;
  const int gone = halo < 2 ? 2 - halo : 0;           // narrowed halo
  const int level = halo * stride;                    // one ring level
  // A working row holds prev_full: the ring level's `halo` items, then the
  // block's `block` items, so item q of prev_full (after the `gone` zeros)
  // is at row + q * stride, wherever it came from.
  const int row_sz = (halo + block) * stride;
  int ring_old = 0, ring_new = depth * level;         // offsets in a tile
  int cur = 2 * depth * level, nxt = cur + row_sz, spare = nxt + row_sz;

  if (steps == 0) {                                   // nothing to carry
    for (int s = s_begin; s < s_begin + SEG; ++s)
      for (int c = threadIdx.x; c < width; c += bx)
        for (int j = 0; j < g.nblocks; ++j)
          out[(j * block + s) * I + gi0 + c] =
              x[(j * block + s) * I + gi0 + c];
    return;
  }
  for (int e = threadIdx.y * bx + threadIdx.x; e < 2 * depth * level;
       e += bx * blockDim.y)
    own[e] = 0.0f;                                    // left of the domain
  __syncthreads();
  for (int s = s_begin; s < s_begin + SEG; ++s)
    for (int c = threadIdx.x; c < width; c += bx)
      own[cur + (halo + s) * stride + c] =
          g.nblocks > 0 ? x[s * I + gi0 + c] : 0.0f;
  auto sync_all = [ctas, &cluster]() {
    if (MODE == GRID)
      cg::this_grid().sync();
    else if (ctas > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  for (int j = 0; j < g.nblocks + g.flush; ++j) {
    // the first level's ring items into the row (ring_old is read-only
    // within a block, and the last block has written it all)
    if (first_seg)
      for (int q = 0; q < halo; ++q)
        for (int c = threadIdx.x; c < width; c += bx)
          own[cur + q * stride + c] = own[ring_old + q * stride + c];
    sync_all();
    int slot = 0;                                     // (t - 1) % depth
    for (int t = 1; t <= steps; ++t) {
      const int top = slot + 1 == depth ? 0 : slot + 1;   // t % depth
      const bool last = t == steps;
      int r = r_first, k = k_first;
      for (int c = threadIdx.x; c < width; c += bx) {
        const int jj = row0 + r;
        // prev_full item q of this column, of the row's left and right
        // neighbours along d1 (another CTA's at the tile's edge), and of
        // the cells beside it along d2
        const float* P = own + cur + c;
        const float* Pl = r > 0 ? P - K : left + cur + (rows - 1) * K + k;
        const float* Pr = r < rows - 1 ? P + K : right + cur + k;
        const bool has_l = jj > 0, has_r = jj < J - 1;
        const bool has_kl = k > 0, has_kr = k < K - 1;
        // every load first: nothing below stores where they read
        float v[SEG + 2], jl[SEG], jr[SEG], kl[SEG], kr[SEG];
#pragma unroll
        for (int i = 0; i < SEG + 2; ++i) {
          const int q = s_begin + i - gone;
          v[i] = q < 0 ? 0.0f : P[q * stride];
        }
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int q = s_begin + i + 1 - gone;
          const bool in = q >= 0;
          jl[i] = jr[i] = kl[i] = kr[i] = 0.0f;
          if (KIND != JACOBI_1D) {
            if (in && has_l)
              jl[i] = r > 0 ? Pl[q * stride] : ld_other<SMEM>(Pl + q * stride);
            if (in && has_r)
              jr[i] = r < rows - 1 ? Pr[q * stride]
                                   : ld_other<SMEM>(Pr + q * stride);
          }
          if (KIND == HEAT_3D) {
            if (in && has_kl) kl[i] = P[q * stride - 1];
            if (in && has_kr) kr[i] = P[q * stride + 1];
          }
        }
        // level t-1 into the ring: concat(ring_old[slot], row)[-halo:] is
        // the row's last `halo` items, each written by its owner (where
        // the block is narrower than the halo, the first are ring_old's)
        float prev[SEG], nx[SEG];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int s = s_begin + i;
          prev[i] = s >= block - halo ? P[(halo + s) * stride] : 0.0f;
          nx[i] = last && j + 1 < g.nblocks
                      ? x[((j + 1) * block + s) * I + gi0 + c]
                      : 0.0f;
        }
        // the next level's ring items, for the next row's first items
        float pre[2] = {0.0f, 0.0f};
        if (first_seg && !last) {
          pre[0] = own[ring_old + top * level + c];
          if (halo > 1) pre[1] = own[ring_old + top * level + stride + c];
        }
        // Keep every load above this line: the compiler may not sink one
        // below a store, where its latency (L2's, for the global scratch)
        // would be paid once a cell instead of once a column.
        asm volatile("" ::: "memory");
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int s = s_begin + i;
          const int item = j * block - t + s;
          const float val =
              item >= 0 && item < n
                  ? stencil_update(KIND, v[i], v[i + 1], v[i + 2], jl[i],
                                   jr[i], kl[i], kr[i])
                  : 0.0f;
          own[nxt + (halo + s) * stride + c] = val;
          if (s >= block - halo) {           // level t-1 first, then t
            const int q = s - block + halo;
            own[ring_new + slot * level + q * stride + c] = prev[i];
            if (last) own[ring_new + top * level + q * stride + c] = val;
          }
          if (last) {
            if (j >= g.flush)
              out[((j - g.flush) * block + s) * I + gi0 + c] = val;
            own[spare + (halo + s) * stride + c] = nx[i];
          }
        }
        if (first_seg) {
          // where the block is narrower than the halo, the ring's first
          // items come from ring_old; and the next level's ring items go
          // into the next row
          for (int q = 0; q < halo - block; ++q) {
            own[ring_new + slot * level + q * stride + c] =
                P[(block + q) * stride];
            if (last)
              own[ring_new + top * level + q * stride + c] =
                  own[ring_old + top * level + (block + q) * stride + c];
          }
          if (!last) {
            own[nxt + c] = pre[0];
            if (halo > 1) own[nxt + stride + c] = pre[1];
            for (int q = 2; q < halo; ++q)
              own[nxt + q * stride + c] =
                  own[ring_old + top * level + q * stride + c];
          }
        }
        k += dk;
        r += dr;
        if (k >= K) {
          k -= K;
          ++r;
        }
      }
      sync_all();
      const int was_cur = cur, was_nxt = nxt;
      if (last) {                            // the next block's input row
        cur = spare;
        spare = was_nxt;
      } else {
        cur = was_nxt;
      }
      nxt = was_cur;
      slot = slot + 1 == depth ? 0 : slot + 1;
    }
    const int tmp = ring_old;
    ring_old = ring_new;
    ring_new = tmp;
  }
  sync_all();                    // no CTA leaves while others read it
}

template <int KIND, int MODE, int SEG>
int launch(const float* x, float* out, float* scratch, const Geometry& g,
           int ctas, int threads, int segments, int smem_bytes,
           cudaStream_t stream) {
  auto kernel = ring_stencil_kernel<KIND, MODE, SEG>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads, segments);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (MODE == GRID) {
    // every CTA must be resident at once, or the grid barrier never opens:
    // a grid that does not fit is refused here, not run
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    int device = 0, sms = 0, per_sm = 0;
    if (err == 0) err = (int)cudaGetDevice(&device);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads * segments, smem_bytes);
    if (err == 0 && per_sm * sms < ctas)
      err = (int)cudaErrorCooperativeLaunchTooLarge;
  } else {
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    // a cluster that cannot be placed is refused here, not queued forever
    int clusters = 0;
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err == 0 && clusters < 1) err = (int)cudaErrorLaunchOutOfResources;
  }
  if (err == 0) err = (int)cudaLaunchKernelEx(&cfg, kernel, x, out, scratch, g);
  const int last = (int)cudaGetLastError();     // and clear it
  return err != 0 ? err : last;
}

// ---------------------------------------------------------------- WAVE --
// Blocks in flight across the card (the header's Design, the third mode).

constexpr int WAVE = 2;                // the mode number of ring_stencil_f32
constexpr int WAVE_ITEMS = 8;          // items of a block a thread holds, most
constexpr int COURIER = 32;            // the last warp: the channels' flags
constexpr int FLAG_INTS = 32;          // ints from one flag to the next
constexpr unsigned FLAG_POLLS = 1u << 21;  // about a second of L2 round trips
constexpr unsigned WORD_POLLS = 1u << 26;  // about two of shared memory's

// threads a CTA may have, the courier's warp included, where a thread
// holds `cols` columns (ring_stencil_limits reports it to the wrapper)
constexpr int wave_max_threads(int cols) { return cols >= 4 ? 768 : 1024; }

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

// A thread's COLS columns [c0, c0 + COLS) of one item, to registers or
// back: 16 or 8 bytes at once where every item's columns are aligned to
// them (VEC), else one cell at a time.  Columns past the item read 0.
template <int COLS, bool CG>
__device__ __forceinline__ void load_cols(float (&v)[COLS], const float* row,
                                          int c0, int I, bool vec) {
  if (COLS == 4 && vec) {
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c0 < I)
      q = CG ? __ldcg(reinterpret_cast<const float4*>(row + c0))
             : *reinterpret_cast<const float4*>(row + c0);
    const float w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < COLS; ++k) v[k] = w[k % 4];
    return;
  }
  if (COLS == 2 && vec) {
    float2 q = make_float2(0.0f, 0.0f);
    if (c0 < I)
      q = CG ? __ldcg(reinterpret_cast<const float2*>(row + c0))
             : *reinterpret_cast<const float2*>(row + c0);
    v[0] = q.x;
    v[COLS - 1] = q.y;
    return;
  }
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    v[k] = c0 + k < I ? (CG ? __ldcg(row + c0 + k) : row[c0 + k]) : 0.0f;
}

// STREAM: a store that is not read again soon (st.cs, evicted first).
template <int COLS, bool STREAM = false>
__device__ __forceinline__ void store_cols(const float (&v)[COLS], float* row,
                                           int c0, int I, bool vec) {
  if (COLS == 4 && vec) {
    const float4 q = make_float4(v[0], v[1 % COLS], v[2 % COLS], v[3 % COLS]);
    float4* dst = reinterpret_cast<float4*>(row + c0);
    if (c0 < I) {
      if (STREAM)
        __stcs(dst, q);
      else
        *dst = q;
    }
    return;
  }
  if (COLS == 2 && vec) {
    const float2 q = make_float2(v[0], v[COLS - 1]);
    float2* dst = reinterpret_cast<float2*>(row + c0);
    if (c0 < I) {
      if (STREAM)
        __stcs(dst, q);
      else
        *dst = q;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < COLS; ++k)
    if (c0 + k < I) {
      if (STREAM)
        __stcs(row + c0 + k, v[k]);
      else
        row[c0 + k] = v[k];
    }
}

// The shared-memory words between a wave CTA's compute threads and its
// courier: H for level id has come (ARRIVED >= id) and level id's slot is
// free (FREED >= id), set by the courier; the compute warps that stored
// their part of the level's hand-over (STORED) and read their part of the
// one that came (READ), counted over all levels.
enum Word { ARRIVED = 0, FREED = 1, STORED = 2, READ = 3 };

__device__ __forceinline__ void wait_flag(const int* f, int want) {
  for (unsigned polls = 0; ld_acquire_gpu(f) != want; ++polls)
    if (polls == FLAG_POLLS) __trap();
}

__device__ __forceinline__ void wait_word(const int* w, int least) {
  for (unsigned polls = 0; ld_acquire_cta(w) < least; ++polls)
    if (polls == WORD_POLLS) __trap();
}

// One count for the whole warp, after every lane's accesses before it.
__device__ __forceinline__ void count_warp(int* w) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    asm volatile("red.release.cta.shared.add.u32 [%0], 1;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(w))
                 : "memory");
}

// Named barrier 2: the compute threads alone (`count` of them).
__device__ __forceinline__ void sync_compute(int count) {
  asm volatile("bar.sync 2, %0;" ::"r"(count) : "memory");
}

// H_j(t), the level's last two items, into `dst` (block j + 1's channel
// slot; null where no block takes it), then the warp's count for the
// courier.
template <int COLS>
__device__ __forceinline__ void hand_over(const float (&r)[WAVE_ITEMS][COLS],
                                          float* dst, int block, int c0,
                                          int I, bool vec, int* words,
                                          int id) {
  if (dst != nullptr) {
    wait_word(&words[FREED], id);
#pragma unroll
    for (int q = 0; q < WAVE_ITEMS; ++q)
      if (q >= block - 2 && q < block)
        store_cols<COLS>(r[q], dst + (q - block + 2) * I, c0, I, vec);
  }
  count_warp(&words[STORED]);
}

// The two items of H_{j-1}(t-1) at this thread's columns, the centre's
// (h1's) cells beside them, and for heat-3d its d1 neighbours, read past
// L1 from `src`; zero where `src` is null.
template <int KIND, int COLS>
__device__ __forceinline__ void load_halo(
    float (&h0)[COLS], float (&h1)[COLS], float (&h1jl)[COLS],
    float (&h1jr)[COLS], float& h1l, float& h1r, const float* src, int c0,
    int I, int K, bool vec, bool get_l, bool get_r, const bool (&hjl)[COLS],
    const bool (&hjr)[COLS]) {
  if (src == nullptr) {
#pragma unroll
    for (int k = 0; k < COLS; ++k) h0[k] = h1[k] = h1jl[k] = h1jr[k] = 0.0f;
    h1l = h1r = 0.0f;
    return;
  }
  load_cols<COLS, true>(h0, src, c0, I, vec);
  load_cols<COLS, true>(h1, src + I, c0, I, vec);
  h1l = get_l ? __ldcg(src + I + c0 - 1) : 0.0f;
  h1r = get_r ? __ldcg(src + I + c0 + COLS) : 0.0f;
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    h1jl[k] = KIND == HEAT_3D && hjl[k] ? __ldcg(src + I + c0 + k - K) : 0.0f;
    h1jr[k] = KIND == HEAT_3D && hjr[k] ? __ldcg(src + I + c0 + k + K) : 0.0f;
  }
}

// stencil_update at column k of a thread's columns: `up`, `ctr` and
// `down` its cells at streamed offsets -1, 0, +1, `el` and `er` the
// centre's cells left and right of the thread's columns, `cr` the centre's
// row in shared memory (null where the centre is the hand-over: its d1
// neighbours are then in h1jl/h1jr).  Jacobi-2d needs no mask: past the
// array are zeros.
template <int KIND, int COLS>
__device__ __forceinline__ float update_col(
    int k, const float (&up)[COLS], const float (&ctr)[COLS], float down,
    float el, float er, const float* cr, const float (&h1jl)[COLS],
    const float (&h1jr)[COLS], int c0, int K, const bool (&hl)[COLS],
    const bool (&hr)[COLS], const bool (&hjl)[COLS],
    const bool (&hjr)[COLS]) {
  const float left = k > 0 ? ctr[k > 0 ? k - 1 : 0] : el;
  const float right = k < COLS - 1 ? ctr[k < COLS - 1 ? k + 1 : 0] : er;
  float jl = 0.0f, jr = 0.0f, kl = 0.0f, kr = 0.0f;
  if (KIND == JACOBI_2D) {
    jl = left;
    jr = right;
  }
  if (KIND == HEAT_3D) {
    if (hl[k]) kl = left;
    if (hr[k]) kr = right;
    if (hjl[k]) jl = cr != nullptr ? cr[c0 + k - K] : h1jl[k];
    if (hjr[k]) jr = cr != nullptr ? cr[c0 + k + K] : h1jr[k];
  }
  return stencil_update(KIND, up[k], ctr[k], down, jl, jr, kl, kr);
}

// The wave mode.  CTA c of P takes blocks c, c + P, c + 2P, ... of the
// nblocks + flush blocks, and holds one whole block at a time: a compute
// thread owns COLS neighbouring cells of every item (its columns), all the
// block's items of them in registers.  Level t of block j is Pallas's:
// prev_full = concat(ring[t-1], row), where, the ring being full, ring[t-1]
// is H_{j-1}(t-1), the last two items of block j - 1's level t - 1 (of its
// input for t = 1, zero for block 0).  So a level needs the block's own
// last level and one hand-over from the block before, and all blocks in
// flight compute level t together (a lag-0 wavefront).
//   The hand-over.  Channel c carries H_j(t), t = 1 .. steps - 1, from CTA
// c to CTA c + 1 (mod P): `depth` slots of two items, slot t % depth for
// level t, each with a flag in device memory, 1 full and 0 empty.  The
// compute threads store the items; the courier, the CTA's last warp, runs
// beside them and moves the flags, so no compute thread waits on device
// memory or on a GPU-scope fence: it releases a flag once every compute
// warp has counted its part stored (STORED), polls its predecessor's flag
// with acquire loads and tells the compute threads (ARRIVED), clears a
// flag once every warp has counted its part read (READ), and before a
// level reuses a slot waits until the slot's last contents were read,
// across rounds too (FREED).  Every flag a launch sets is cleared in it,
// so the flags are zero between launches (the wrapper keeps them, zeroed
// once).
//   A level.  Items block-1 .. 2 need only the block's own last level:
// they are computed first (the last two are H_j(t), handed over then),
// while the predecessor's hand-over is on its way (it is loaded at the
// level's start where it has already come); items 1 and 0 need it.  An
// item's neighbours in other threads' columns come from the last level's
// rows in shared memory (two copies, by level parity), so one barrier of
// the compute threads ends a level.  A wait that never ends traps.
template <int KIND, int COLS>
__global__ void __launch_bounds__(wave_max_threads(COLS))
ring_stencil_kernel_wave(const float* __restrict__ x, float* __restrict__ out,
                         float* chan, int* flags, const Geometry g) {
  extern __shared__ float4 smem4[];
  const int n = g.n_items, I = g.I, J = g.J, K = g.K, steps = g.steps;
  const int block = g.block, depth = g.depth, S = g.stride;
  const int P = gridDim.x, c = blockIdx.x, prev = c == 0 ? P - 1 : c - 1;
  const int B = g.nblocks + g.flush;
  const int T = blockDim.x - COURIER;           // compute threads
  const bool courier = (int)threadIdx.x >= T;
  const int lane = threadIdx.x & 31;
  const int RP = block - 1;                     // centre rows a level
  const int RS = S + 8;                         // 4 zeros, S columns, 4 zeros
  // [2][RP][RS]: row q of copy p at rows + (p * RP + q) * RS
  float* rows = reinterpret_cast<float*>(smem4) + 4;
  int* words = reinterpret_cast<int*>(rows - 4 + 2 * RP * RS);  // Word
  const long long slot_floats = 2LL * I;
  auto flag = [&](int cta, int t) {
    return flags + ((long long)cta * depth + t % depth) * FLAG_INTS;
  };
  auto slot = [&](int cta, int t) {
    return chan + ((long long)cta * depth + t % depth) * slot_floats;
  };

  const int c0 = threadIdx.x * COLS;            // this thread's columns
  const bool vec = I % COLS == 0;
  if (steps == 0) {                             // nothing to carry: a copy
    if (courier) return;
    for (int j = c; j < B; j += P)
      for (int s = 0; s < block; ++s) {
        float v[COLS];
        load_cols<COLS, false>(v, x + (long long)(j * block + s) * I, c0, I,
                               vec);
        store_cols<COLS>(v, out + (long long)(j * block + s) * I, c0, I, vec);
      }
    return;
  }
  // Dirichlet zero past the array.  Along the contiguous axis it is data:
  // columns past the item are zero in registers and in the rows, and so
  // are the 4 cells either side of a row; heat-3d's rows of d2 cells and
  // its d1 neighbours need masks.
  bool hl[COLS], hr[COLS], hjl[COLS], hjr[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) {
    const int cc = c0 + k, jj = cc / K, kk = cc - jj * K;
    const bool in = cc < I;
    hl[k] = in && kk > 0;
    hr[k] = in && kk < K - 1;
    hjl[k] = in && jj > 0;
    hjr[k] = in && jj < J - 1;
  }
  const bool pad = c0 + COLS > I;               // columns past the item
  const bool get_l = KIND != JACOBI_1D && c0 > 0 && c0 <= I;
  const bool get_r = KIND != JACOBI_1D && c0 + COLS < I;
  for (int e = threadIdx.x; e < 2 * RP; e += blockDim.x) {
    *reinterpret_cast<float4*>(rows + e * RS - 4) = make_float4(0, 0, 0, 0);
    *reinterpret_cast<float4*>(rows + e * RS + S) = make_float4(0, 0, 0, 0);
  }
  if (threadIdx.x < 4) words[threadIdx.x] = 0;
  __syncthreads();                              // the guards and the words
  const int W = T / 32;                         // compute warps

  if (courier) {
    if (lane != 0) return;
    int lev = 0;
    for (int j = c; j < B; j += P, lev += steps) {
      const bool producer = j > 0, consumer = j + 1 < B;
      // level 1 stores into slot 1: its last contents must have been read
      if (consumer && steps > 1 && j >= P) wait_flag(flag(c, 1), 0);
      st_release_cta(&words[FREED], lev + 1);
      st_release_cta(&words[ARRIVED], lev + 1); // H(0) is the input's
      for (int t = 1; t <= steps; ++t) {
        const int id = lev + t;
        wait_word(&words[STORED], W * id);      // H_j(t) is stored
        if (consumer && t < steps) st_release_gpu(flag(c, t), 1);
        if (t < steps) {                        // what level t + 1 needs
          if (consumer && t + 1 < steps && j >= P)
            wait_flag(flag(c, t + 1), 0);
          st_release_cta(&words[FREED], id + 1);
          if (producer) wait_flag(flag(prev, t), 1);
          st_release_cta(&words[ARRIVED], id + 1);
        }
        wait_word(&words[READ], W * id);        // H_{j-1}(t-1) is read
        if (producer && t > 1) st_release_gpu(flag(prev, t - 1), 0);
      }
    }
    return;
  }

  float r[WAVE_ITEMS][COLS];                    // the block's items
  float h0[COLS], h1[COLS], h1jl[COLS], h1jr[COLS], h1l, h1r;
  int lev = 0;                                  // levels done, all blocks
  for (int j = c; j < B; j += P, lev += steps) {
    const bool producer = j > 0, consumer = j + 1 < B;
#pragma unroll
    for (int s = 0; s < WAVE_ITEMS; ++s)
      if (s < block) {
        if (j < g.nblocks)
          load_cols<COLS, false>(r[s], x + (long long)(j * block + s) * I, c0,
                                 I, vec);
        else
#pragma unroll
          for (int k = 0; k < COLS; ++k) r[s][k] = 0.0f;
        if (s < RP) store_cols<COLS>(r[s], rows + s * RS, c0, S, true);
      }
    sync_compute(T);

    for (int t = 1; t <= steps; ++t) {
      const int id = lev + t;
      const bool hand = consumer && t < steps;  // H_j(t) goes to block j+1
      const float* crow = rows + ((t - 1) & 1) * RP * RS;  // level t-1's
      float* nrow = rows + (t & 1) * RP * RS;              // level t's
      const bool keep = t < steps;              // the next level reads it
      // the next block's input into L2, late enough that the channels and
      // the outputs do not push it out again first
      if (t == (steps > 2 ? steps - 2 : 1) && j + P < g.nblocks) {
        const char* next =
            reinterpret_cast<const char*>(x + (long long)(j + P) * block * I);
        const int lines = (int)(((long long)block * I * 4 + 127) / 128);
        for (int e = threadIdx.x; e < lines; e += T)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(next + 128LL * e));
      }
      // H_{j-1}(t-1): block j - 1's input for t = 1, zero left of block 0;
      // loaded now where it has come, else once items block-1 .. 2 are done
      const float* src =
          !producer || (t == 1 && j > g.nblocks) ? nullptr
          : t == 1 ? x + (long long)(j * block - 2) * I
                   : slot(prev, t - 1);
      bool have = t == 1 || src == nullptr ||
                  ld_acquire_cta(&words[ARRIVED]) >= id;
      if (have)
        load_halo<KIND, COLS>(h0, h1, h1jl, h1jr, h1l, h1r, src, c0, I, K,
                              vec, get_l, get_r, hjl, hjr);
      // new item s in place, from s = block - 1 down: it reads r[s]
      // (down), r[s-1] (centre) and r[s-2] (up), with r[-1] = h1 and
      // r[-2] = h0, and the centre's neighbours in the columns beside
#pragma unroll
      for (int s = WAVE_ITEMS - 1; s >= 0; --s) {
        if (s == 1) {
          // items block-1 .. 2 are done: where they hold H_j(t), hand it
          // over now, while H_{j-1}(t-1) may still be on its way
          if (block >= 4)
            hand_over<COLS>(r, hand ? slot(c, t) : nullptr, block, c0, I,
                            vec, words, id);
          if (!have) {
            wait_word(&words[ARRIVED], id);
            load_halo<KIND, COLS>(h0, h1, h1jl, h1jr, h1l, h1r, src, c0, I,
                                  K, vec, get_l, get_r, hjl, hjr);
          }
        }
        if (s >= block) continue;
        const int item = j * block - t + s;
        if (item < 0 || item >= n) {            // the same for every thread
#pragma unroll
          for (int k = 0; k < COLS; ++k) r[s][k] = 0.0f;
        } else {
          const float* cr = crow + (s >= 1 ? s - 1 : 0) * RS;
          float ctr[COLS], up[COLS];
#pragma unroll
          for (int k = 0; k < COLS; ++k) {
            ctr[k] = s >= 1 ? r[s >= 1 ? s - 1 : 0][k] : h1[k];
            up[k] = s >= 2 ? r[s >= 2 ? s - 2 : 0][k] : s == 1 ? h1[k] : h0[k];
          }
          // the centre's cells beside this thread's columns
          const float el = s >= 1 ? cr[c0 - 1] : h1l;
          const float er = s >= 1 ? cr[c0 + COLS] : h1r;
          // a column past the item stays zero, and is not updated: the
          // division's slow path takes a zero sum (FCHK), and one warp on
          // it holds the whole CTA at the level's barrier
          if (!pad) {
#pragma unroll
            for (int k = 0; k < COLS; ++k)
              r[s][k] = update_col<KIND, COLS>(k, up, ctr, r[s][k], el, er,
                                               s >= 1 ? cr : nullptr, h1jl,
                                               h1jr, c0, K, hl, hr, hjl, hjr);
          } else {
#pragma unroll
            for (int k = 0; k < COLS; ++k)
              r[s][k] = c0 + k < I ? update_col<KIND, COLS>(
                                         k, up, ctr, r[s][k], el, er,
                                         s >= 1 ? cr : nullptr, h1jl, h1jr,
                                         c0, K, hl, hr, hjl, hjr)
                                   : 0.0f;
          }
        }
        if (keep && s < RP) store_cols<COLS>(r[s], nrow + s * RS, c0, S, true);
      }
      if (block < 4)                            // H_j(t) is done only now
        hand_over<COLS>(r, hand ? slot(c, t) : nullptr, block, c0, I, vec,
                        words, id);
      count_warp(&words[READ]);                 // H_{j-1}(t-1) is read
      sync_compute(T);
    }
    if (j >= g.flush)
#pragma unroll
      for (int s = 0; s < WAVE_ITEMS; ++s)
        if (s < block)
          store_cols<COLS, true>(
              r[s], out + (long long)((j - g.flush) * block + s) * I, c0, I,
              vec);
  }
}

template <int KIND, int COLS>
int launch_wave(const float* x, float* out, float* chan, int* flags,
                const Geometry& g, int ctas, int threads, int smem_bytes,
                cudaStream_t stream) {
  auto kernel = ring_stencil_kernel_wave<KIND, COLS>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads + COURIER);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  // every CTA waits on others: all must be resident, or the launch is
  // refused here, not run
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int device = 0, sms = 0, per_sm = 0;
  if (err == 0) err = (int)cudaGetDevice(&device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads + COURIER, smem_bytes);
  if (err == 0 && per_sm * sms < ctas)
    err = (int)cudaErrorCooperativeLaunchTooLarge;
  if (err == 0)
    err = (int)cudaLaunchKernelEx(&cfg, kernel, x, out, chan, flags, g);
  const int last = (int)cudaGetLastError();     // and clear it
  return err != 0 ? err : last;
}

template <int KIND>
int launch_wave_cols(const float* x, float* out, float* chan, int* flags,
                     const Geometry& g, int ctas, int threads, int cols,
                     int smem_bytes, cudaStream_t stream) {
  switch (cols) {
    case 1: return launch_wave<KIND, 1>(x, out, chan, flags, g, ctas,
                                        threads, smem_bytes, stream);
    case 2: return launch_wave<KIND, 2>(x, out, chan, flags, g, ctas,
                                        threads, smem_bytes, stream);
    case 4: return launch_wave<KIND, 4>(x, out, chan, flags, g, ctas,
                                        threads, smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND, int MODE>
int launch_seg(const float* x, float* out, float* scratch,
               const Geometry& g, int ctas, int threads, int segments,
               int smem_bytes, cudaStream_t stream) {
  switch (g.block / segments) {
    case 1: return launch<KIND, MODE, 1>(x, out, scratch, g, ctas, threads,
                                         segments, smem_bytes, stream);
    case 2: return launch<KIND, MODE, 2>(x, out, scratch, g, ctas, threads,
                                         segments, smem_bytes, stream);
    case 4: return launch<KIND, MODE, 4>(x, out, scratch, g, ctas, threads,
                                         segments, smem_bytes, stream);
    case 8: return launch<KIND, MODE, 8>(x, out, scratch, g, ctas, threads,
                                         segments, smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int KIND>
int launch_kind(const float* x, float* out, float* scratch,
                const Geometry& g, int ctas, int threads, int segments,
                int smem_bytes, int grid, cudaStream_t stream) {
  if (grid)
    return launch_seg<KIND, GRID>(x, out, scratch, g, ctas, threads,
                                  segments, 0, stream);
  return launch_seg<KIND, SHARED>(x, out, scratch, g, ctas, threads,
                                  segments, smem_bytes, stream);
}

}  // namespace

// x, out: float32 (n_items, d1, d2), contiguous, on the device.  Radius 1.
// The launch shape (runtime/cuda_codegen.ring_launch), by `mode`:
//   0, 1: `ctas` CTAs, in one cluster (0) or a cooperative grid (1), each
// owning `rows` of the d1 rows, of `threads` x `segments` threads (block /
// segments is 1, 2, 4 or 8), with its tile of (2*depth*halo + 3*(halo +
// block)) * stride floats in `smem_bytes` of shared memory (a cluster),
// or at scratch + rank * tile floats (a grid; ctas * tile floats on the
// device);
//   2 (WAVE): `ctas` CTAs in a cooperative grid, each holding one block at
// a time, of `threads` compute threads of `cols` columns (1, 2 or 4) and
// the courier's warp, with two copies of block - 1 rows of `stride` =
// threads * cols floats and 8 more, and 16 bytes more, in `smem_bytes` of
// shared memory; the channels at scratch (ctas * depth * 2 * d1 * d2
// floats) and their flags at `flags` (ctas * depth * 32 ints, zero, and
// left zero).
// It takes a full ring only: depth > steps, halo 2, block 2 to 8.
// Returns 0 or the first CUDA error (cudaErrorInvalidValue for another
// split of the block, a grid with shared memory or a cluster without, a
// wave mode the geometry does not take, or an array of 2**31 cells or
// more: the kernels index in 32 bits).
extern "C" int ring_stencil_f32(const float* x, float* out, float* scratch,
                                int* flags, int kind, int n_items, int d1,
                                int d2, int steps, int block, int depth,
                                int halo, int ctas, int rows, int stride,
                                int threads, int segments, int cols,
                                int smem_bytes, int mode,
                                cudaStream_t stream) {
  if ((long long)n_items * d1 * d2 >= (1LL << 31) || mode < 0 || mode > WAVE)
    return (int)cudaErrorInvalidValue;
  if (mode == WAVE) {
    const int cells = d1 * d2, blocks = n_items / block + steps / block;
    if (depth < steps + 1 || halo != 2 || block < 2 || block > WAVE_ITEMS ||
        !(cols == 1 || cols == 2 || cols == 4) || threads < 32 ||
        threads % 32 || threads + COURIER > wave_max_threads(cols) ||
        (long long)threads * cols < cells || stride != threads * cols ||
        smem_bytes < 8 * (block - 1) * (stride + 8) + 16 || ctas < 1 ||
        (ctas < 2 && blocks > 1 && steps > 1))
      return (int)cudaErrorInvalidValue;
    Geometry g{n_items, cells, d1, d2, steps, block, depth, halo,
               n_items / block, steps / block, d1, stride, 0};
    if (kind == JACOBI_1D)
      return launch_wave_cols<JACOBI_1D>(x, out, scratch, flags, g, ctas,
                                         threads, cols, smem_bytes, stream);
    if (kind == JACOBI_2D)
      return launch_wave_cols<JACOBI_2D>(x, out, scratch, flags, g, ctas,
                                         threads, cols, smem_bytes, stream);
    return launch_wave_cols<HEAT_3D>(x, out, scratch, flags, g, ctas,
                                     threads, cols, smem_bytes, stream);
  }
  const int grid = mode;
  const long long tile =
      (2LL * depth * halo + 3LL * (halo + block)) * stride;
  if (tile * ctas >= (1LL << 31) || segments < 1 || block % segments ||
      (grid != 0) == (smem_bytes > 0))
    return (int)cudaErrorInvalidValue;
  Geometry g{n_items, d1 * d2, d1, d2, steps, block, depth, halo,
             n_items / block, steps / block, rows, stride, (int)tile};
  if (kind == JACOBI_1D)
    return launch_kind<JACOBI_1D>(x, out, scratch, g, ctas, threads,
                                  segments, smem_bytes, grid, stream);
  if (kind == JACOBI_2D)
    return launch_kind<JACOBI_2D>(x, out, scratch, g, ctas, threads,
                                  segments, smem_bytes, grid, stream);
  return launch_kind<HEAT_3D>(x, out, scratch, g, ctas, threads, segments,
                              smem_bytes, grid, stream);
}


// The limits runtime/cuda_codegen.ring_launch shapes a launch by, on
// `device`: out[0] its SMs, out[1] the shared memory a CTA may opt in to,
// in bytes, out[2 + i] the threads a CTA may have where a thread walks
// 2**i items (i = 0..3: the kernel's launch bound), and out[6 + i] the
// threads a CTA of the wave mode may have, its courier's warp included,
// where a thread holds 2**i columns (i = 0..2).  Returns 0 or the first
// CUDA error.
extern "C" int ring_stencil_limits(int device, int* out) {
  int err = (int)cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMultiProcessorCount, device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (int i = 0; i < 4; ++i) out[2 + i] = max_threads(1 << i);
  for (int i = 0; i < 3; ++i) out[6 + i] = wave_max_threads(1 << i);
  return err;
}
