// Chunkwise RWKV-6 / GLA time-mix with an fp32 hd x hd state carried from
// chunk to chunk.
//
// Replaces: src/repro/kernels/gla_timemix/kernel.py:23, _kernel (launched by
// gla_timemix).
//
// What it computes.  r, k, v, logw (B,S,H,hd) and u (H,hd), float32 or
// bf16; out (B,S,H,hd) in r's dtype.  For each (b, h) the sequence is cut
// into chunks of C steps.  Per chunk, in float32: cl = cumsum(logw)
// (inclusive), cl_prev = cl - logw, tot = cl[C-1];
//   y_inter[t] = (r[t] * exp(cl_prev[t])) @ state
//   att[t,s]   = sum_d r[t,d] k[s,d] exp(cl_prev[t,d] - cl[s,d])  (t > s)
//   y_intra[t] = sum_{s<t} att[t,s] v[s]
//   y_diag[t]  = (sum_d r[t,d] u[d] k[t,d]) v[t]
//   out[t]     = (y_inter + y_intra) + y_diag
//   state      = exp(tot)^T * state + (k * exp(tot - cl))^T @ v
// The intra-chunk decay is the PAIRWISE form: cl_prev[t] - cl[s] <= 0 for
// t > s, so every exponent is bounded.  The factored form
// (r e^{cl_prev}) . (k e^{-cl}) overflows float32 once a chunk's decay
// passes e^88, which fast channels reach at chunk >= 64.
//
// Order.  The Pallas grid (B, H, S/C) carries the state in scratch across
// its sequential chunk axis.  Here one CTA takes one (b, h) and loops over
// the chunks itself, with the state in shared memory.  Each chunk runs in
// six phases between barriers: load; the cumulative sums (one thread a
// channel); att and the diagonal term; r and k scaled by their decays in
// place; the outputs; the state update.
//
// Memory.  The chunk's r, k, v, cl and cl_prev (C x (hd+1) floats each, rows
// padded so that threads reading k[s] and cl[s] for consecutive s hit
// distinct banks), the state (hd x hd), att (C x C) and three vectors:
// 116,736 bytes at (C, hd) = (64, 64) and 110,720 at (128, 16), so the
// kernel asks for dynamic shared memory above 48 KB.
//
// Bound.  At rwkv6-1.6b's width (H = 32, hd = 64, S = 4096, C = 64) one call
// reads 134 MB and writes 34 MB in float32, and needs about 4.1e9 float32
// operations, nearly half of them in the C(C-1)/2 x hd pairwise terms (the
// reference forms all C x C pairs, 6e9): bound by operations at about
// 0.062 ms against the fp32 rate.  B * H CTAs (32 at that width) fill only
// 32 of 132 SMs, and each walks its 64 chunks in sequence, so the kernel is
// far above that bound.  Splitting the state's value columns across CTAs is
// the redesign, in a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ inline size_t smem_floats(int C, int hd) {
  const size_t P = (size_t)hd + 1;
  return 5 * (size_t)C * P + (size_t)hd * hd + (size_t)C * C + 3 * (size_t)hd
         + C;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gla_timemix_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ lw,
                   const T* __restrict__ u, T* __restrict__ out, int S, int H,
                   int hd, int C) {
  extern __shared__ float smem[];
  const int P = hd + 1;
  float* R = smem;                 // r, then r * exp(cl_prev)
  float* K = R + C * P;            // k, then k * exp(tot - cl)
  float* V = K + C * P;
  float* CL = V + C * P;           // logw, then cl
  float* CLP = CL + C * P;         // cl_prev
  float* ST = CLP + C * P;         // state (hd, hd): key row, value column
  float* ATT = ST + hd * hd;       // (C, C)
  float* U = ATT + C * C;          // (hd,)
  float* TOT = U + hd;             // (hd,)
  float* ET = TOT + hd;            // exp(tot), (hd,)
  float* DG = ET + hd;             // (C,)

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long row = (long long)H * hd;   // stride between time steps
  const long long base = ((long long)b * S * H + h) * hd;

  for (int e = tid; e < hd * hd; e += THREADS) ST[e] = 0.0f;
  for (int d = tid; d < hd; d += THREADS) U[d] = to_f32(u[h * hd + d]);

  for (int t0 = 0; t0 < S; t0 += C) {
    for (int e = tid; e < C * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      const long long g = base + (t0 + t) * row + d;
      R[t * P + d] = to_f32(r[g]);
      K[t * P + d] = to_f32(k[g]);
      V[t * P + d] = to_f32(v[g]);
      CL[t * P + d] = to_f32(lw[g]);
    }
    __syncthreads();
    for (int d = tid; d < hd; d += THREADS) {
      float c = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float w = CL[t * P + d];
        c = c + w;
        CL[t * P + d] = c;
        CLP[t * P + d] = c - w;
      }
      TOT[d] = c;
      ET[d] = expf(c);
    }
    __syncthreads();
    for (int e = tid; e < C * C; e += THREADS) {
      const int t = e / C, s = e % C;
      float a = 0.0f;
      if (t > s) {
        const float* rt = R + t * P;
        const float* clpt = CLP + t * P;
        const float* ks = K + s * P;
        const float* cls = CL + s * P;
        for (int d = 0; d < hd; ++d)
          a = fmaf(rt[d] * ks[d], expf(clpt[d] - cls[d]), a);
      }
      ATT[e] = a;
    }
    for (int t = tid; t < C; t += THREADS) {
      float g = 0.0f;
      for (int d = 0; d < hd; ++d)
        g = fmaf(R[t * P + d] * U[d], K[t * P + d], g);
      DG[t] = g;
    }
    __syncthreads();
    for (int e = tid; e < C * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      R[t * P + d] = R[t * P + d] * expf(CLP[t * P + d]);
      K[t * P + d] = K[t * P + d] * expf(TOT[d] - CL[t * P + d]);
    }
    __syncthreads();
    for (int e = tid; e < C * hd; e += THREADS) {
      const int t = e / hd, j = e % hd;
      float yi = 0.0f, ya = 0.0f;
      for (int d = 0; d < hd; ++d) yi = fmaf(R[t * P + d], ST[d * hd + j], yi);
      for (int s = 0; s < t; ++s) ya = fmaf(ATT[t * C + s], V[s * P + j], ya);
      const float yd = DG[t] * V[t * P + j];
      out[base + (t0 + t) * row + j] = from_f32<T>((yi + ya) + yd);
    }
    __syncthreads();
    for (int e = tid; e < hd * hd; e += THREADS) {
      const int d = e / hd, j = e % hd;
      float a = 0.0f;
      for (int s = 0; s < C; ++s) a = fmaf(K[s * P + d], V[s * P + j], a);
      ST[e] = ET[d] * ST[e] + a;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* out, int B, int S, int H, int hd, int C,
           cudaStream_t stream) {
  const size_t smem = smem_floats(C, hd) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gla_timemix_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch check would read it
      return (int)err;
    }
  }
  const dim3 grid(H, B);
  gla_timemix_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const T*>(u), static_cast<T*>(out), S, H, hd, C);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, logw, out: (B,S,H,hd); u: (H,hd); contiguous, on the device, all
// of one dtype: 0 float32, 1 bfloat16.  S % C == 0 (the wrapper checks it).
// Returns cudaGetLastError(), cudaFuncSetAttribute's error where
// smem_floats(C, hd) floats pass the 227 KB a CTA may hold, and
// cudaErrorInvalidValue for another dtype.
extern "C" int gla_timemix_fwd(const void* r, const void* k, const void* v,
                               const void* lw, const void* u, void* out,
                               int B, int S, int H, int hd, int C, int dtype,
                               cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch<float>(r, k, v, lw, u, out, B, S, H, hd, C, stream);
    case 1: return launch<__nv_bfloat16>(r, k, v, lw, u, out, B, S, H, hd, C, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
