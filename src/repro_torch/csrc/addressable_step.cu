// Time steps of a band stencil over the whole array, one launch a step.
//
// Replaces: src/repro/runtime/pallas_codegen.py::_addressable_step, the
// fallback a reorder-buffer plan forces: one launch per time step, the
// whole level written to device memory and read back by the next launch.
// That round trip is the cost the paper's FIFO recovery removes, so the
// steps stay unfused on purpose: it is the measured baseline.
//
// Host path.  addressable_steps_f32 runs a whole job: `steps` launches,
// queued from C, ping-ponging between two buffers the caller allocated
// once.  Queued one at a time from Python, each step cost 34-43 us of
// host work (checks, allocation, device context, stream query, ctypes)
// against 7 us on the device, so the job was host bound.
//
// Device.  The array is (n_items, d1, d2): the streamed axis (radius 1)
// and up to two inner axes, the last contiguous; Dirichlet zero outside it
// on every axis.  A 3-D launch indexed without division, in 32-bit
// arithmetic: x over groups of VEC contiguous cells (float4 where the
// rows are 16-byte aligned), y over the middle axis, z over runs of RUN
// items along the streamed axis.  A thread walks its run keeping the
// previous, current and next item in registers, so each cell loads one
// new value along that axis, not three.  jacobi-1d has no inner axis: its
// streamed axis is the contiguous one, so a thread takes VEC neighbouring
// cells and reads one cell on each side.
//
// Bound.  Each launch reads the level and writes the next: 8 bytes a cell
// over 3.35 TB/s; 3 to 15 flops a cell are far below the fp32 rate.
#include <cuda_runtime.h>

#include "stencil_update.cuh"

namespace {

constexpr int RUN = 8;          // items a thread walks along the streamed axis

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float get(float v, int) { return v; }
  static __device__ __forceinline__ float set(float* v) { return v[0]; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(float4 v, int l) {
    return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float4 set(float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T load(const float* p) {
  return *reinterpret_cast<const typename Vec<VEC>::T*>(p);
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T zero() {
  float z[VEC] = {};
  return Vec<VEC>::set(z);
}

// jacobi-1d: thread g takes cells [g*VEC, g*VEC + VEC).
template <int VEC>
__global__ void __launch_bounds__(256)
jacobi1d_step(const float* __restrict__ x, float* __restrict__ out, int n) {
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= n) return;
  using V = Vec<VEC>;
  const typename V::T c = load<VEC>(x + e0);
  const float left = e0 > 0 ? x[e0 - 1] : 0.0f;
  const float right = e0 + VEC < n ? x[e0 + VEC] : 0.0f;
  float r[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    const float up = l == 0 ? left : V::get(c, l - 1);
    const float down = l == VEC - 1 ? right : V::get(c, l + 1);
    r[l] = stencil_update(JACOBI_1D, up, V::get(c, l), down, 0.f, 0.f, 0.f,
                          0.f);
  }
  *reinterpret_cast<typename V::T*>(out + e0) = V::set(r);
}

// jacobi-2d and heat-3d: the item is (d1, d2); jacobi-2d has d2 = 1 and
// its neighbours along d1 are the contiguous ones, so for it the "row"
// below is one item and W = d1.  heat-3d: rows j of W = d2 cells.
template <int KIND, int VEC>
__global__ void __launch_bounds__(256)
band_step(const float* __restrict__ x, float* __restrict__ out, int n,
          int rows, int W) {
  const int c0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (c0 >= W || j >= rows) return;
  const int I = rows * W;                  // one item
  const int s0 = blockIdx.z * RUN;
  const int s1 = min(s0 + RUN, n);
  using V = Vec<VEC>;
  int e = s0 * I + j * W + c0;
  typename V::T up = s0 > 0 ? load<VEC>(x + e - I) : zero<VEC>();
  typename V::T c = load<VEC>(x + e);
  for (int s = s0; s < s1; ++s, e += I) {
    const typename V::T down = s + 1 < n ? load<VEC>(x + e + I) : zero<VEC>();
    // contiguous neighbours: inside the group, else one cell on each side
    const float left = c0 > 0 ? x[e - 1] : 0.0f;
    const float right = c0 + VEC < W ? x[e + VEC] : 0.0f;
    typename V::T jm = zero<VEC>(), jp = zero<VEC>();
    if (KIND == HEAT_3D) {
      if (j > 0) jm = load<VEC>(x + e - W);
      if (j < rows - 1) jp = load<VEC>(x + e + W);
    }
    float r[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      const float cl = V::get(c, l);
      const float lo = l == 0 ? left : V::get(c, l - 1);
      const float hi = l == VEC - 1 ? right : V::get(c, l + 1);
      if (KIND == JACOBI_2D)
        r[l] = stencil_update(KIND, V::get(up, l), cl, V::get(down, l), lo,
                              hi, 0.f, 0.f);
      else
        r[l] = stencil_update(KIND, V::get(up, l), cl, V::get(down, l),
                              V::get(jm, l), V::get(jp, l), lo, hi);
    }
    *reinterpret_cast<typename V::T*>(out + e) = V::set(r);
    up = c;
    c = down;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

template <int VEC>
void launch_step(const float* x, float* out, int kind, int n, int d1, int d2,
                 cudaStream_t stream) {
  if (kind == JACOBI_1D) {
    const int groups = (n + VEC - 1) / VEC;
    jacobi1d_step<VEC><<<(groups + 255) / 256, 256, 0, stream>>>(x, out, n);
    return;
  }
  // jacobi-2d: one row of W = d1 cells an item; heat-3d: d1 rows of d2
  const int rows = kind == JACOBI_2D ? 1 : d1;
  const int W = kind == JACOBI_2D ? d1 : d2;
  const int groups = (W + VEC - 1) / VEC;
  const int bx = groups >= 128 ? 128 : groups >= 64 ? 64 : 32;
  const int by = rows < 256 / bx ? rows : 256 / bx;
  const dim3 grid((groups + bx - 1) / bx, (rows + by - 1) / by,
                  (n + RUN - 1) / RUN);
  const dim3 threads(bx, by);
  if (kind == JACOBI_2D)
    band_step<JACOBI_2D, VEC><<<grid, threads, 0, stream>>>(x, out, n, rows,
                                                            W);
  else
    band_step<HEAT_3D, VEC><<<grid, threads, 0, stream>>>(x, out, n, rows, W);
}

}  // namespace

// `steps` time steps of x (float32 (n_items, d1, d2), contiguous, on the
// device), one launch each: step 0 reads x and writes a, step t reads the
// buffer step t-1 wrote and writes a if t is even, b if odd, so the
// result is in a if steps is odd and in b if it is even.  b may be null
// when steps is 1.  x, a and b are distinct.  Returns the first
// cudaGetLastError() that is not 0, or 0; cudaErrorInvalidValue if the
// array has 2**31 cells or more (the kernels index in 32 bits).
extern "C" int addressable_steps_f32(const float* x, float* a, float* b,
                                     int kind, int n_items, int d1, int d2,
                                     int steps, cudaStream_t stream) {
  if ((long long)n_items * d1 * d2 >= (1LL << 31)) return cudaErrorInvalidValue;
  const int W = kind == JACOBI_1D ? n_items : kind == JACOBI_2D ? d1 : d2;
  const bool vec4 = W % 4 == 0 && aligned16(x) && aligned16(a) &&
                    (steps < 2 || aligned16(b));
  const float* src = x;
  for (int t = 0; t < steps; ++t) {
    float* dst = t % 2 == 0 ? a : b;
    if (vec4)
      launch_step<4>(src, dst, kind, n_items, d1, d2, stream);
    else
      launch_step<1>(src, dst, kind, n_items, d1, d2, stream);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}
