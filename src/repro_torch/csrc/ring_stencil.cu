// Fused time-tiled band stencil with the cross-block channels in a ring,
// spread over many CTAs: one thread-block cluster, or a cooperative grid.
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
// steps; CUDA blocks run in no order.  So the CTAs walk the streamed axis
// together in a loop, and the ring is carried between its iterations.
// ring_old is read-only within a block and ring_new write-only, and they
// swap at the block's end, which keeps the Pallas semantics exactly:
// the undersized ring (depth < steps+1) and the narrowed halo (halo < 2)
// corrupt the output as there, and block = 1 works (the halo window then
// spans several predecessors).
//
// Design.  An item is d1 rows of d2 cells (jacobi-2d: d1 columns of one
// cell; jacobi-1d: one cell).  The rows are tiled over the CTAs, each
// owning whole rows of every ring level and working row: its tile.  The
// only values a CTA reads from another are its neighbours' edge rows of
// level t-1, needed by the update's inner neighbours; so a barrier across
// the CTAs ends every level (and the start of every block), and no cell
// is computed twice.  Overlapped (ghost-zone) tiles were ruled out: they
// are exact only for a full ring, since with depth < steps+1 a block
// reads a slot that another level wrote, whose valid ghost region is
// narrower, and the invalid values would creep into the owned tile block
// by block.
//   Two launch modes (Mode below; runtime/cuda_codegen.ring_launch picks
// one).  Where the tiles fit the shared memory of a cluster of up to 16
// CTAs (jacobi-1d; jacobi-2d at 2800 wide: 50 KB a CTA), they live there,
// the neighbours' edges are read through distributed shared memory and a
// cluster barrier ends a level.  Where they do not (heat-3d at 200x200:
// 11 MB in all), they live in a global scratch that stays in the 50 MB L2,
// spread over a cooperative grid of up to one CTA an SM (100 CTAs for
// heat-3d: 16 were 3.9x slower, pulling their tiles from L2), with a
// grid-wide barrier; the neighbours' edges there are read past L1
// (ld.cg).  Both barriers have release/acquire semantics.
//   A working row holds a level's prev_full, the ring level's items then
// the block's, so every read of a level is one address pattern; the next
// level's ring items are copied into the next row as it is computed, and
// a block's input row is loaded during the block before.  A thread owns
// columns of the tile and walks SEG items of them (a template parameter:
// 8, 4, 2 or 1), loading all it needs of a column before it stores;
// indices are 32-bit, with no division in the loop over cells.  The
// launch shape comes from the wrapper (runtime/cuda_codegen.ring_launch).
//
// Bound.  One call must read the input and write the output once:
// 8 bytes per cell over 3.35 TB/s; the arithmetic (3 to 15 flops a cell a
// level) is far below the fp32 rate.  The kernel cannot reach that: its
// chain of (blocks + 1) x steps levels each ends in a barrier, 2808 of
// them for jacobi-2d at 2800 wide, and the cluster barrier compiles to a
// GPU-scope fence and an L1 invalidation (MEMBAR.ALL.GPU, CCTL.IVALL), the
// grid barrier to an atomic on device memory.  Several blocks in flight
// at different levels (a wavefront) would shorten the chain to blocks +
// steps.
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
// The launch shape (runtime/cuda_codegen.ring_launch): `ctas` CTAs, in one
// cluster or, where `grid` is 1, in a cooperative grid, each owning
// `rows` of the d1 rows, of `threads` x `segments` threads (block /
// segments is 1, 2, 4 or 8), with its tile of (2*depth*halo + 3*(halo +
// block)) * stride floats in `smem_bytes` of shared memory (a cluster),
// or at scratch + rank * tile floats (a grid; ctas * tile floats on the
// device).  Returns 0 or the first CUDA error (cudaErrorInvalidValue for
// another split of the block, a grid with shared memory or a cluster
// without, or an array of 2**31 cells or more: the kernel indexes in 32
// bits).
extern "C" int ring_stencil_f32(const float* x, float* out, float* scratch,
                                int kind, int n_items, int d1, int d2,
                                int steps, int block, int depth, int halo,
                                int ctas, int rows, int stride, int threads,
                                int segments, int smem_bytes, int grid,
                                cudaStream_t stream) {
  const long long tile =
      (2LL * depth * halo + 3LL * (halo + block)) * stride;
  if ((long long)n_items * d1 * d2 >= (1LL << 31) ||
      tile * ctas >= (1LL << 31) || segments < 1 || block % segments ||
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
// in bytes, and out[2 + i] the threads a CTA may have where a thread walks
// 2**i items (i = 0..3: the kernel's launch bound).  Returns 0 or the
// first CUDA error.
extern "C" int ring_stencil_limits(int device, int* out) {
  int err = (int)cudaDeviceGetAttribute(
      &out[0], cudaDevAttrMultiProcessorCount, device);
  if (err == 0)
    err = (int)cudaDeviceGetAttribute(
        &out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  for (int i = 0; i < 4; ++i) out[2 + i] = max_threads(1 << i);
  return err;
}
