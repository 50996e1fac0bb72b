// One time step of a band stencil over the whole array.
//
// Replaces: src/repro/runtime/pallas_codegen.py::_addressable_step, the
// fallback a reorder-buffer plan forces: one launch per time step, the
// whole level written to device memory and read back by the next launch.
// That round trip is the cost the paper's FIFO recovery removes, so the
// kernel stays unfused on purpose: it is the measured baseline.
//
// One thread per cell, grid-stride.  Radius 1 along the streamed axis
// (axis 0), Dirichlet zero outside the array on every axis.
//
// Bound.  Each launch reads the level and writes the next: 8 bytes a cell
// over 3.35 TB/s; 3 to 15 flops a cell are far below the fp32 rate.  The
// neighbours' re-reads hit L1/L2, so the kernel should run near the
// memory bound at the large sizes.
#include <cuda_runtime.h>

#include "stencil_update.cuh"

namespace {

__global__ void addressable_step_kernel(const float* __restrict__ x,
                                        float* __restrict__ out, int kind,
                                        int n_items, int d1, int d2) {
  const long long I = (long long)d1 * d2;
  const long long total = (long long)n_items * I;
  const long long J = kind == JACOBI_2D ? I : d1;
  const long long K = kind == JACOBI_2D ? 1 : d2;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long s = e / I, i = e - s * I;
    const float c = x[e];
    const float up = s > 0 ? x[e - I] : 0.0f;
    const float down = s < n_items - 1 ? x[e + I] : 0.0f;
    float jl = 0.0f, jr = 0.0f, kl = 0.0f, kr = 0.0f;
    if (kind != JACOBI_1D) {
      const long long jj = i / K, kk = i - jj * K;
      if (jj > 0) jl = x[e - K];
      if (jj < J - 1) jr = x[e + K];
      if (kind == HEAT_3D) {
        if (kk > 0) kl = x[e - 1];
        if (kk < K - 1) kr = x[e + 1];
      }
    }
    out[e] = stencil_update(kind, up, c, down, jl, jr, kl, kr);
  }
}

}  // namespace

// x, out: float32 (n_items, d1, d2), contiguous, distinct, on the device.
// Returns cudaGetLastError().
extern "C" int addressable_step_f32(const float* x, float* out, int kind,
                                    int n_items, int d1, int d2,
                                    cudaStream_t stream) {
  const long long total = (long long)n_items * d1 * d2;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  if (blocks < 1) blocks = 1;
  addressable_step_kernel<<<(int)blocks, threads, 0, stream>>>(
      x, out, kind, n_items, d1, d2);
  return (int)cudaGetLastError();
}
