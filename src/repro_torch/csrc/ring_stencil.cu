// Fused time-tiled band stencil with the cross-block channels in a ring.
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
// steps; CUDA blocks run in no order.  So ONE block walks the streamed
// axis in a loop, and the ring is carried between iterations of that
// loop.  ring_old is read-only within a block and ring_new write-only, and
// they swap at the block's end (every slot that is read later is written
// in every block), which keeps the Pallas semantics exactly, including
// the undersized-ring (depth < steps+1) and narrowed-halo (halo < 2)
// injections that must corrupt the output, and block = 1 (the halo window
// then spans several predecessors).  Output blocks j < flush, which the
// Pallas kernel writes as dummies that block `flush` overwrites, are not
// written.
//
// Memory.  The rings take 2 * depth * halo * inner floats and the working
// rows 2 * block * inner floats: 403 KB of ring for jacobi-2d at 2800
// wide and 5.8 MB for heat-3d at 200x200, beyond the 227 KB of shared
// memory a block may hold.  So they live in a global scratch the wrapper
// allocates, which stays resident in the 50 MB L2.  __syncthreads() orders
// the block's global writes before the next level reads them.
//
// Bound.  One call must read the input and write the output once:
// 8 bytes per cell over 3.35 TB/s; the arithmetic (3 to 15 flops a cell a
// level) is far below the fp32 rate.  This kernel is far from that bound:
// one block uses one SM of 132 and every level re-reads its rows from L2.
// Spreading the inner axes over several blocks needs a grid-wide barrier
// per level, which is left for a later change.
#include <cuda_runtime.h>

#include "stencil_update.cuh"

namespace {

struct Geometry {
  int n_items, d1, d2, steps, block, depth, halo, nblocks, flush;
};

// prev_full[p] at inner index i: `gone` zeros (narrowed halo), then the
// ring level's `halo` items, then the block's current row.
__device__ __forceinline__ float prev_item(int p, long long i, long long I,
                                           const float* left,
                                           const float* row, int gone,
                                           int halo) {
  if (p < gone) return 0.0f;
  p -= gone;
  if (p < halo) return left[p * I + i];
  return row[(p - halo) * I + i];
}

__global__ void __launch_bounds__(1024)
ring_stencil_kernel(const float* __restrict__ x, float* __restrict__ out,
                    float* __restrict__ base, int kind, Geometry g) {
  const long long I = (long long)g.d1 * g.d2;
  const long long lvl = (long long)g.halo * I;       // one ring level
  const long long ring = (long long)g.depth * lvl;
  const long long row_sz = (long long)g.block * I;
  float* ring_old = base;
  float* ring_new = base + ring;
  float* cur = base + 2 * ring;
  float* nxt = cur + row_sz;
  const int gone = g.halo < 2 ? 2 - g.halo : 0;

  for (long long e = threadIdx.x; e < 2 * ring; e += blockDim.x)
    base[e] = 0.0f;                      // left of the domain: zero
  __syncthreads();

  // ring_new[t % depth] = concat(ring_old[t % depth], row)[-halo:]
  auto publish = [&](int t, const float* row) {
    const long long off = (long long)(t % g.depth) * lvl;
    for (long long e = threadIdx.x; e < lvl; e += blockDim.x) {
      const long long q = e / I, i = e - q * I;
      const long long p = g.block + q;
      ring_new[off + e] = p < g.halo ? ring_old[off + p * I + i]
                                     : row[(p - g.halo) * I + i];
    }
  };

  for (int j = 0; j < g.nblocks + g.flush; ++j) {
    for (long long e = threadIdx.x; e < row_sz; e += blockDim.x)
      cur[e] = j < g.nblocks ? x[(long long)j * row_sz + e] : 0.0f;
    __syncthreads();
    for (int t = 1; t <= g.steps; ++t) {
      const float* left = ring_old + (long long)((t - 1) % g.depth) * lvl;
      for (long long e = threadIdx.x; e < row_sz; e += blockDim.x) {
        const int s = (int)(e / I);
        const long long i = e - (long long)s * I;
        const long long item = (long long)j * g.block - t + s;
        float v = 0.0f;
        if (item >= 0 && item < g.n_items) {
          const float up = prev_item(s, i, I, left, cur, gone, g.halo);
          const float c = prev_item(s + 1, i, I, left, cur, gone, g.halo);
          const float down = prev_item(s + 2, i, I, left, cur, gone, g.halo);
          float jl = 0.0f, jr = 0.0f, kl = 0.0f, kr = 0.0f;
          if (kind != JACOBI_1D) {
            const long long J = kind == JACOBI_2D ? I : g.d1;
            const long long K = kind == JACOBI_2D ? 1 : g.d2;
            const long long jj = i / K, kk = i - jj * K;
            if (jj > 0) jl = prev_item(s + 1, i - K, I, left, cur, gone, g.halo);
            if (jj < J - 1) jr = prev_item(s + 1, i + K, I, left, cur, gone, g.halo);
            if (kind == HEAT_3D) {
              if (kk > 0) kl = prev_item(s + 1, i - 1, I, left, cur, gone, g.halo);
              if (kk < K - 1) kr = prev_item(s + 1, i + 1, I, left, cur, gone, g.halo);
            }
          }
          v = stencil_update(kind, up, c, down, jl, jr, kl, kr);
        }
        nxt[e] = v;
      }
      publish(t - 1, cur);               // level t-1 into the ring
      __syncthreads();
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    publish(g.steps, cur);
    if (j >= g.flush)
      for (long long e = threadIdx.x; e < row_sz; e += blockDim.x)
        out[(long long)(j - g.flush) * row_sz + e] = cur[e];
    __syncthreads();
    float* tmp = ring_old; ring_old = ring_new; ring_new = tmp;
  }
}

}  // namespace

// x, out: float32 (n_items, d1, d2), contiguous, on the device.  scratch:
// (2 * depth * halo + 2 * block) * d1 * d2 floats on the device.  Radius 1.
// Returns cudaGetLastError().
extern "C" int ring_stencil_f32(const float* x, float* out, float* scratch,
                                int kind, int n_items, int d1, int d2,
                                int steps, int block, int depth, int halo,
                                cudaStream_t stream) {
  Geometry g{n_items, d1, d2, steps, block, depth, halo, n_items / block,
             steps / block};
  const long long I = (long long)d1 * d2;
  const long long work = (long long)block * I > (long long)halo * I
                             ? (long long)block * I : (long long)halo * I;
  int threads = (int)((work + 31) / 32 * 32);
  if (threads > 1024) threads = 1024;
  ring_stencil_kernel<<<1, threads, 0, stream>>>(x, out, scratch, kind, g);
  return (int)cudaGetLastError();
}
