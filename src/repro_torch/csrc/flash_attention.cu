// Blocked GQA flash attention, causal or not, with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:29, _kernel (launched
// by flash_attention).
//
// What it computes.  q (B,S,H,hd), k and v (B,S,KV,hd) in float32, bf16 or
// f16; query head h reads kv head h % KV.  q is scaled by `scale` in the
// input dtype (the reference scales before its kernel; the wrapper rounds
// the scale itself to the dtype, as JAX does with a Python float), then
// everything runs in float32: scores q.k, masked to -1e30 above the
// diagonal, a running max m, sum l and accumulator acc over the kv tiles,
// and the output acc / max(l, 1e-30) cast to q's dtype.  kv tiles wholly
// above the diagonal are skipped.
//
// Order.  The Pallas grid (B, H, S/bq, S/bk) carries (m, l, acc) in scratch
// across its sequential kv axis.  Here one CTA takes one (b, h, q tile) and
// runs the kv loop itself, with m and l in registers (one copy in each of
// the 16 threads that share a row) and acc in registers: thread (ty, tx)
// of 16 x 16 holds rows 4ty..4ty+3 and output columns tx + 16j.  The
// kernel's tiles are 64 x 64, whatever bq and bk the caller named; the
// result does not depend on the tiling beyond float32 rounding.  Tiles with
// the most kv work are launched first (blockIdx.x counts q tiles down).
//
// Memory.  The q tile and the k and v tiles are held in shared memory as
// float32, rows padded so that the 16 threads of a row group read distinct
// banks; the probabilities P reuse the k tile's space once the scores are
// in registers.  At hd = 128 that is 98,816 bytes a CTA, so two CTAs fit
// on an SM.
//
// Bound.  2 * 2 * S_eff * hd flops a query row (S_eff the keys it sees:
// about S/2 causal), against reading q, k, v once and writing o once.  At
// qwen2-7b's width (H = 28, KV = 4, hd = 128, S = 4096, causal) that is
// 1.2e11 flops and 67 MB in bf16: bound by operations on the tensor cores
// (989 TFLOP/s bf16) at about 0.12 ms.  This kernel does its products on
// the CUDA cores in float32 with explicit fmaf (the library is built with
// -fmad=false), 16 products for 8 shared-memory loads, so it is bound by
// shared-memory bandwidth and the fp32 rate, far above that bound.  wgmma
// tiles fed by TMA are the redesign, in a later change.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Row strides in shared memory (floats).  Q: rows 4ty+i are read by two
// row groups per warp, 4 rows apart; K: rows tx+16j are read by 16 threads
// at once; P: written by two row groups per warp.  The padding puts each
// set on distinct banks.
template <int HD> struct Layout {
  static constexpr int QS = HD + 1, KS = HD + 1, PS = BK + 4;
  static constexpr int Q = BQ * QS;
  static constexpr int KP = BK * KS > BQ * PS ? BK * KS : BQ * PS;
  static constexpr int V = BK * HD;
  static constexpr size_t bytes = (size_t)(Q + KP + V) * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KV, int causal, float scale) {
  using L = Layout<HD>;
  constexpr int NJ = HD / 16;               // output columns a thread holds
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::Q;
  float* Ps = Ks;                           // P reuses the k tile
  float* Vs = Ks + L::KP;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h % KV;
  const int q0 = qt * BQ;
  const long long qrow = (long long)H * HD, krow = (long long)KV * HD;
  const T* qb = q + ((long long)b * S * H + h) * HD;
  const T* kb = k + ((long long)b * S * KV + kvh) * HD;
  const T* vb = v + ((long long)b * S * KV + kvh) * HD;
  T* ob = o + ((long long)b * S * H + h) * HD;

  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    float x = 0.0f;
    if (q0 + r < S)
      x = to_f32(from_f32<T>(to_f32(qb[(q0 + r) * qrow + d]) * scale));
    Qs[r * L::QS + d] = x;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  // causal: keys at or after q0 + BQ are masked for every row of the tile
  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                        // last tile's P and V are read
    for (int e = tid; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const bool in = k0 + c < S;
      Ks[c * L::KS + d] = in ? to_f32(kb[(k0 + c) * krow + d]) : 0.0f;
      Vs[c * HD + d] = in ? to_f32(vb[(k0 + c) * krow + d]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= S || (causal && kpos > qpos)) s[i][j] = NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                        // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(4 * ty + i) * L::PS + tx + 16 * j] = s[i][j];
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(4 * ty + i) * L::PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[qpos * qrow + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch check would read it
      return (int)err;
    }
  }
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, int causal, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,S,H,hd); k, v: (B,S,KV,hd); contiguous, on the device, all of one
// dtype: 0 float32, 1 bfloat16, 2 float16.  hd is 32, 64 or 128; H % KV ==
// 0.  `scale` is already rounded to the dtype.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a dtype or hd the kernel does not take).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KV, int hd, int causal,
                                   float scale, int dtype,
                                   cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_hd<float>(q, k, v, o, B, S, H, KV, hd, causal, scale, stream);
    case 1: return launch_hd<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal, scale, stream);
    case 2: return launch_hd<__half>(q, k, v, o, B, S, H, KV, hd, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
