// One time step of the three band stencils of `runtime/cuda_codegen.py`
// (STENCIL_PROGRAMS), shared by ring_stencil.cu and addressable_step.cu.
//
// The operations run in the order of the PyTorch update functions and
// oracles, and the sources build with -fmad=false, so no product is fused
// into an add: the kernels compute the same float32 operations as the
// plain versions.
#pragma once

enum StencilKind { JACOBI_1D = 0, JACOBI_2D = 1, HEAT_3D = 2 };

// up/c/down: the previous level at streamed offsets -1/0/+1.  jl/jr and
// kl/kr: the centre item's inner neighbours at -1/+1 along the first and
// second inner axis (0 outside the array: Dirichlet).
__device__ __forceinline__ float stencil_update(int kind, float up, float c,
                                                float down, float jl,
                                                float jr, float kl,
                                                float kr) {
  if (kind == JACOBI_1D) return ((up + c) + down) / 3.0f;
  if (kind == JACOBI_2D) return ((((c + jl) + jr) + up) + down) / 5.0f;
  return ((c + 0.125f * ((up - 2.0f * c) + down))
          + 0.125f * ((jl - 2.0f * c) + jr))
         + 0.125f * ((kl - 2.0f * c) + kr);
}
