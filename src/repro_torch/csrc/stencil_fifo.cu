// The hand-written Fig. 3 jacobi-1d: `steps` time levels, with the
// dependences that cross a block boundary carried in a (steps+1) x 2 FIFO.
//
// Replaces: src/repro/kernels/stencil_fifo/kernel.py:30, _kernel (launched by
// jacobi_fifo).
//
// What it computes.  x (N,) is cut into nblocks = N / block blocks, with
// steps == block.  Grid step j (0 <= j <= nblocks; j == nblocks is an
// all-zero flush block) loads block j, deposits its trailing two cells into
// fifo_new[0], and runs `steps` levels: level t of row position s is cell
// j*block - t + s, computed from concat(fifo_old[t-1], row) as
// ((l + c) + r) / 3 and zero outside [0, N); its trailing two cells go to
// fifo_new[t].  Since steps == block, grid step j's final row is output
// block j - 1.  Block 0's write, which the Pallas kernel makes as a dummy
// that grid step 1 overwrites, is not made.  fifo_old starts at zero (the
// Dirichlet left edge) and takes fifo_new at the end of each grid step.
//
// Order.  Pallas runs the grid in order and carries the FIFO between grid
// steps; CUDA blocks run in no order.  So ONE CTA walks the nblocks + 1
// grid steps in a loop, with the FIFO carried between iterations.  The
// FIFO (2 (steps+1) floats a copy, 8 KB for both at steps = 1000) and the
// two working rows (block floats each) sit in shared memory; a row is
// walked by a thread loop, so a block may be wider than the CTA.
//
// Arithmetic.  ((l + c) + r) / 3.0f, the reference's order, with an exact
// division; the library is built with -fmad=false.  So at the same tiling
// this kernel and the generated ring (ring_stencil.cu) agree to the last
// bit.
//
// Bound.  One call must read x and write the output once: 8 bytes a cell
// over 3.35 TB/s, with 3 flops a cell a level far below the fp32 rate.
// This kernel is far from that bound by design: one CTA on one SM of 132,
// with a barrier per level ((nblocks + 1) * steps barriers a call).  It is
// the paper's hand-written counterpart of the generated ring, and shares
// its single-CTA walk; spreading it over SMs is a later change.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
stencil_fifo_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int n, int block, int steps) {
  extern __shared__ float smem[];
  const int levels = steps + 1;
  float* fifo_old = smem;                    // (steps+1, 2)
  float* fifo_new = fifo_old + 2 * levels;   // (steps+1, 2)
  float* cur = fifo_new + 2 * levels;        // (block,)
  float* nxt = cur + block;                  // (block,)
  const int nblocks = n / block;
  // fifo[t, q] = row[-2:][q]; a one-cell row broadcasts to both slots, as
  // the reference's assignment does.
  const int tail0 = block >= 2 ? block - 2 : 0;
  const int tail1 = block - 1;

  for (int e = threadIdx.x; e < 2 * levels; e += blockDim.x)
    fifo_old[e] = 0.0f;                      // left of the domain: zero

  for (int j = 0; j <= nblocks; ++j) {
    for (int s = threadIdx.x; s < block; s += blockDim.x) {
      const float v = j < nblocks ? x[(long long)j * block + s] : 0.0f;
      cur[s] = v;
      if (s == tail0) fifo_new[0] = v;
      if (s == tail1) fifo_new[1] = v;
    }
    __syncthreads();
    for (int t = 1; t <= steps; ++t) {
      const float l2 = fifo_old[2 * (t - 1)];
      const float l1 = fifo_old[2 * (t - 1) + 1];
      for (int s = threadIdx.x; s < block; s += blockDim.x) {
        // prev_full = [l2, l1, cur[0], cur[1], ...]; new[s] reads
        // prev_full[s], prev_full[s+1], prev_full[s+2]
        const float l = s == 0 ? l2 : (s == 1 ? l1 : cur[s - 2]);
        const float c = s == 0 ? l1 : cur[s - 1];
        const float r = cur[s];
        const long long cell = (long long)j * block - t + s;
        const float v = (cell >= 0 && cell < n) ? ((l + c) + r) / 3.0f
                                                : 0.0f;
        nxt[s] = v;
        if (s == tail0) fifo_new[2 * t] = v;
        if (s == tail1) fifo_new[2 * t + 1] = v;
      }
      __syncthreads();
      float* tmp = cur; cur = nxt; nxt = tmp;
    }
    if (j >= 1)
      for (int s = threadIdx.x; s < block; s += blockDim.x)
        out[(long long)(j - 1) * block + s] = cur[s];
    // every FIFO slot 0..steps was written in this grid step, so swapping
    // the copies is the reference's fifo_old[...] = fifo_new[...]
    float* tmp = fifo_old; fifo_old = fifo_new; fifo_new = tmp;
    __syncthreads();
  }
}

}  // namespace

// x, out: float32 (n,), contiguous, distinct, on the device; n % block == 0
// and steps == block (the wrapper checks both).  Returns cudaGetLastError(),
// or cudaFuncSetAttribute's error where the shared memory passes the 227 KB
// a CTA may hold.
extern "C" int stencil_fifo_f32(const float* x, float* out, int n, int block,
                                int steps, cudaStream_t stream) {
  const size_t smem = (size_t)(4 * (steps + 1) + 2 * block) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_fifo_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch check would read it
      return (int)err;
    }
  }
  int threads = (block + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  stencil_fifo_kernel<<<1, threads, smem, stream>>>(x, out, n, block, steps);
  return (int)cudaGetLastError();
}
