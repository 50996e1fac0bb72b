// Chunkwise RWKV-6 / GLA time-mix, chunk-parallel: the chunks' own work runs
// on one CTA each, and only an (hd x hd) state scan runs along the sequence.
//
// Replaces: src/repro/kernels/gla_timemix/kernel.py:23, _kernel (launched by
// gla_timemix).
//
// What it computes.  r, k, v, logw (B,S,H,hd) and u (H,hd), float32 or
// bf16; out (B,S,H,hd) in r's dtype.  For each (b, h) the sequence is cut
// into chunks of C steps.  Per chunk, in float32: cl = cumsum(logw)
// (inclusive), cl_prev[t] = cl[t-1] (0 at t = 0), tot = cl[C-1];
//   y_inter[t] = (r[t] * exp(cl_prev[t])) @ state
//   att[t,s]   = sum_d r[t,d] k[s,d] exp(cl_prev[t,d] - cl[s,d])  (t > s)
//   y_intra[t] = sum_{s<t} att[t,s] v[s]
//   y_diag[t]  = (sum_d r[t,d] u[d] k[t,d]) v[t]
//   out[t]     = (y_inter + y_intra) + y_diag
//   state      = exp(tot)^T * state + (k * exp(tot - cl))^T @ v
// No exponent may exceed 0: the factored form (r e^{cl_prev}) . (k e^{-cl})
// overflows float32 once a chunk's decay passes e^88.
//
// Order.  Only y_inter and the state depend on earlier chunks, and the state
// is a linear recurrence over chunks, S_c = e^{tot_c} S_{c-1} + D_c with
// D_c = (k e^{tot-cl})^T v.  So the work runs in three launches:
//   A  one CTA per (b, h, chunk): D_c (on the tensor cores) and e^{tot_c}
//      into the caller's workspace;
//   B  one thread per four elements (b, h, d, j..j+3) of the state: the
//      chain of one multiply-add a chunk, overwriting each D_c with the
//      state that enters chunk c;
//   C  one CTA per (b, h, chunk): att, y_diag and
//      out = [r e^{cl_prev} | att] @ [state ; v] + y_diag, one product on
//      the tensor cores with depth hd + C.
// A chunk is held as sub-chunks of SUB = 16 rows (the tensor cores' tile;
// a chunk that is no multiple of 16 is padded with zero rows, which change
// nothing: k = 0 adds no term, logw = 0 no decay).  Inside each 8-row half
// of a diagonal sub-chunk att is formed pairwise on the CUDA cores.
// Elsewhere below the diagonal, with m a row between s and t (the last row
// of sub-chunk j for t in a later sub-chunk i, row 7 of the sub-chunk for
// its lower half against its upper half),
//   exp(cl_prev[t] - cl[s]) = exp(cl_prev[t] - cl[m]) * exp(cl[m] - cl[s]),
// both exponents <= 0 and each factor at least the product, so neither
// overflows nor underflows where the pairwise term does not, and the block
// is a product (r e^{cl_prev - cl[m]}) . (k e^{cl[m] - cl})^T on the tensor
// cores.  That cuts the exponentials of phase C a chunk from the pairwise
// form's C(C-1)/2 * hd (129,024 at (C, hd) = (64, 64)) to 34,816.
// Exponentials are ex2.approx on cumulative sums kept in log2 units.
//
// Precision.  Every product takes three TF32 passes on mma.sync m16n8k8
// (x = hi + lo; lo*hi' + hi*lo' + hi*hi'), about 20 bits, as float32
// attention does; one pass keeps about 3 digits, too close to the
// reference's 2e-3.  Sums are float32; bf16 inputs are widened on load and
// the output rounded once.
//
// Memory.  Shared memory of phase C: r, k, cl (C x (hd+4) each), att
// (C x (C+4)), u and the diagonal terms; v (C x (hd+8)) is loaded into k's
// place once att is formed, and the state (hd x (hd+8)) into cl's once r
// is decayed: 73,216 bytes at (C, hd) = (64, 64), three CTAs an SM, and
// 157,440 at (64, 128).  Row pitches are chosen so that the fragment loads
// hit 32 distinct banks.  hd is 16, 32, 64 or 128 (the wrapper pads other
// widths with zero channels); a chunk whose tiles pass what a CTA may hold
// (227 KB) is refused at the launch.
//
// Bound.  At rwkv6-1.6b's width (H = 32, hd = 64, S = 4096, C = 64, float32)
// one call reads r, k, v, logw (134 MB) and u and writes out (34 MB):
// 167,780,352 bytes, 0.05008 ms at 3.35 TB/s.  The work, counted as
// chip_smoke.py's gla_work counts it, per chunk of each (b, h) (2,048
// chunks): on the CUDA cores 174,144 operations (the 8 x 28 x 64 pairwise
// terms inside the halves at 5 each, 71,680; the factors of the 6 blocks
// between sub-chunks and the 4 half blocks, (6 x 32 + 4 x 16) x 64 at 3,
// 49,152; the cumulative sums, decays, y_diag and the state chain, 53,312),
// 3.57e8 in all, 0.0053 ms at 67 TFLOP/s; products 1,536,000 flops (D_c and
// y_inter 524,288 each, y_intra over the 2,016 pairs t > s 258,048, the
// factored blocks 196,608 + 32,768), 3.15e9 in all, 0.0191 ms at three TF32
// passes (165 TFLOP/s).  The two units run side by side, so the work's
// least time is 0.0191 ms, and bytes bound the call.  The workspace (D_c
// and the entering states, 34 MB, made in A, rewritten in B and read in C)
// comes on top of that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SUB = 16;                 // sub-chunk rows
constexpr float LOG2E = 1.4426950408889634f;

// The A fragment (rows g, g+8; columns q, q+4 of a 16 x 8 tile) in TF32
// parts.
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, hi[0], lo[0]);
    split_tf32(a1, hi[1], lo[1]);
    split_tf32(a2, hi[2], lo[2]);
    split_tf32(a3, hi[3], lo[3]);
  }
};

// 16 bytes of T widened to float32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes from global to shared memory without a register (cp.async);
// cp_async_wait waits for all of a thread's copies.
__device__ __forceinline__ void cp_async16(float* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Rows [0, CP) of a (CP, HD) tile into shared memory at pitch `ld`, 16 bytes
// a copy: row t < rows from src + t * stride, later rows zero.  float32
// rows go by cp.async, so that every copy of the chunk is in flight at
// once (the caller waits with cp_async_wait before its barrier); bf16 rows
// are widened in registers, BATCH loads in flight a thread before they are
// stored.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long stride, int rows, int CP,
                                          int tid) {
  constexpr int N = Vec<T>::N, PER_ROW = HD / N, BATCH = 4;
  const int total = CP * PER_ROW;
  if constexpr (N == 4) {
    for (int e = tid; e < total; e += THREADS) {
      const int t = e / PER_ROW, d = (e % PER_ROW) * N;
      if (t < rows)
        cp_async16(dst + t * ld + d, src + t * stride + d);
      else
        *reinterpret_cast<float4*>(dst + t * ld + d) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int e0 = tid; e0 < total; e0 += BATCH * THREADS) {
      float x[BATCH][N];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS, t = e / PER_ROW;
        const int d = (e % PER_ROW) * N;
        if (e < total && t < rows) {
          Vec<T>::load(src + t * stride + d, x[b]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) x[b][i] = 0.0f;
        }
      }
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int e = e0 + b * THREADS, t = e / PER_ROW;
        const int d = (e % PER_ROW) * N;
        if (e < total) {
#pragma unroll
          for (int i = 0; i < N; i += 4)
            *reinterpret_cast<float4*>(dst + t * ld + d + i) = make_float4(
                x[b][i], x[b][i + 1], x[b][i + 2], x[b][i + 3]);
        }
      }
    }
  }
}

// In place, the inclusive cumulative sum of CL's CP rows, channel by
// channel, times log2(e).  Each channel's rows are cut into THREADS / HD
// segments, summed apart and then offset by the segments before them
// (`part` holds THREADS floats).
template <int HD>
__device__ __forceinline__ void cumsum_log2(float* CL, int ld, float* part,
                                            int CP, int tid) {
  constexpr int P = THREADS / HD;
  const int d = tid % HD, p = tid / HD, len = CP / P;
  float c = 0.0f;
  for (int t = p * len; t < (p + 1) * len; ++t) {
    c = c + CL[t * ld + d];
    CL[t * ld + d] = c;
  }
  part[p * HD + d] = c;
  __syncthreads();
  float off = 0.0f;
  for (int q = 0; q < p; ++q) off = off + part[q * HD + d];
  for (int t = p * len; t < (p + 1) * len; ++t)
    CL[t * ld + d] = (CL[t * ld + d] + off) * LOG2E;
  __syncthreads();
}

// Shared-memory layout of phase A, in floats: k, v at pitch HD + 8 (read as
// fragments whose k index runs down the rows), cl at HD + 4, and the
// cumulative sum's partials.
template <int HD> struct LayoutA {
  static constexpr int LDK = HD + 8, LDC = HD + 4;
  int CP;
  __host__ __device__ size_t k() const { return 0; }
  __host__ __device__ size_t v() const { return (size_t)CP * LDK; }
  __host__ __device__ size_t cl() const { return 2 * (size_t)CP * LDK; }
  __host__ __device__ size_t part() const { return cl() + (size_t)CP * LDC; }
  __host__ __device__ size_t bytes() const {
    return (part() + THREADS) * sizeof(float);
  }
};

// Shared-memory layout of phase C, in floats.  r and k at pitch HD + 4
// (row-major A fragments and float4 rows), then v (pitch HD + 8, read as
// B fragments) in k's place once att is formed; cl at HD + 4, then the
// state entering the chunk (HD + 8) in its place once r is decayed; att at
// CP + 4; u, the diagonal terms and the cumulative sum's partials.
template <int HD> struct LayoutC {
  static constexpr int LDR = HD + 4, LDV = HD + 8;
  int CP;
  __host__ __device__ int lda() const { return CP + 4; }
  __host__ __device__ size_t cl_floats() const {
    const size_t a = (size_t)CP * LDR, b = (size_t)HD * LDV;
    return a > b ? a : b;
  }
  __host__ __device__ size_t r() const { return 0; }
  __host__ __device__ size_t kv() const { return (size_t)CP * LDR; }
  __host__ __device__ size_t cl() const { return kv() + (size_t)CP * LDV; }
  __host__ __device__ size_t att() const { return cl() + cl_floats(); }
  __host__ __device__ size_t u() const { return att() + (size_t)CP * lda(); }
  __host__ __device__ size_t dg() const { return u() + HD; }
  __host__ __device__ size_t part() const { return dg() + CP; }
  __host__ __device__ size_t bytes() const {
    return (part() + THREADS) * sizeof(float);
  }
};

// The (b, h, chunk) a CTA of phase A or C takes, and its first element.
struct ChunkAt {
  long long base;      // element offset of (b, c * C, h, 0)
  long long ws;        // (b, h, c) as one index
};

__device__ __forceinline__ ChunkAt chunk_at(int S, int H, int HD, int C) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NC = S / C;
  ChunkAt at;
  at.base = (((long long)b * S + (long long)c * C) * H + h) * HD;
  at.ws = ((long long)b * H + h) * NC + c;
  return at;
}

// Phase A: D_c = (k e^{tot - cl})^T v into ws[(b,h,c)] (HD x HD) and
// e^{tot_c} into et[(b,h,c)] (HD).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 2 : 1)
gla_delta_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ lw, float* __restrict__ ws,
                 float* __restrict__ et, int S, int H, int C) {
  extern __shared__ __align__(16) float smem[];
  const LayoutA<HD> L{(C + SUB - 1) / SUB * SUB};
  constexpr int LDK = LayoutA<HD>::LDK, LDC = LayoutA<HD>::LDC;
  const int CP = L.CP;
  float* K = smem + L.k();
  float* V = smem + L.v();
  float* CL = smem + L.cl();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const ChunkAt at = chunk_at(S, H, HD, C);
  const long long row = (long long)H * HD;

  load_tile<T, HD>(K, LDK, k + at.base, row, C, CP, tid);
  load_tile<T, HD>(V, LDK, v + at.base, row, C, CP, tid);
  load_tile<T, HD>(CL, LDC, lw + at.base, row, C, CP, tid);
  cp_async_wait();
  __syncthreads();
  cumsum_log2<HD>(CL, LDC, smem + L.part(), CP, tid);
  const float* tot = CL + (CP - 1) * LDC;
  for (int e = tid; e < CP * HD; e += THREADS) {
    const int s = e / HD, d = e % HD;
    K[s * LDK + d] = K[s * LDK + d] * ex2(tot[d] - CL[s * LDC + d]);
  }
  if (tid < HD) et[at.ws * HD + tid] = ex2(tot[tid]);
  __syncthreads();

  // D (HD x HD) = K^T (HD x CP) @ V (CP x HD): each warp task is 16 rows d
  // and half the columns j.
  constexpr int NTW = HD / 16;            // n tiles of 8 a task
  float* D = ws + at.ws * HD * HD;
  for (int task = warp; task < 2 * (HD / 16); task += WARPS) {
    const int d0 = 16 * (task >> 1), j0 = 8 * NTW * (task & 1);
    float acc[NTW][4] = {};
    for (int s0 = 0; s0 < CP; s0 += 8) {
      const float* k0 = K + (s0 + q) * LDK + d0 + g;
      const float* k4 = k0 + 4 * LDK;
      AFrag a;
      a.set(k0[0], k0[8], k4[0], k4[8]);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* vb = V + (s0 + q) * LDK + j0 + 8 * n + g;
        mma_3xtf32(acc[n], a.hi, a.lo, vb[0], vb[4 * LDK]);
      }
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      float* o = D + (d0 + g) * HD + j0 + 8 * n + 2 * q;
      store2(o, acc[n][0], acc[n][1]);
      store2(o + 8 * HD, acc[n][2], acc[n][3]);
    }
  }
}

// Phase B: for each (b, h, d, j), the chain over the chunks, VEC
// consecutive j a thread.  ws holds D_c on entry and the state entering
// chunk c on return (zero for c = 0).
template <int HD, int VEC>
__global__ void __launch_bounds__(THREADS)
gla_scan_kernel(float* __restrict__ ws, const float* __restrict__ et,
                int NC, long long total) {
  constexpr int AHEAD = 8;                 // chunks in flight a thread
  using V = typename std::conditional<
      VEC == 4, float4, typename std::conditional<VEC == 2, float2,
                                                  float>::type>::type;
  const long long e = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (e >= total) return;
  const long long bh = e / (HD * HD);
  const int dj = (int)(e % (HD * HD)), d = dj / HD;
  V* p = reinterpret_cast<V*>(ws + bh * NC * HD * HD + dj);
  const float* w = et + bh * NC * HD + d;
  constexpr int STEP = HD * HD / VEC;      // one chunk, in V
  float s[VEC] = {};
  for (int c0 = 0; c0 < NC; c0 += AHEAD) {
    V dl[AHEAD];
    float wc[AHEAD];
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (c0 + i < NC) {
        dl[i] = p[(long long)(c0 + i) * STEP];
        wc[i] = w[(long long)(c0 + i) * HD];
      }
    }
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) {
      if (c0 + i < NC) {
        V out;
        float* o = reinterpret_cast<float*>(&out);
        const float* x = reinterpret_cast<const float*>(&dl[i]);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          o[v] = s[v];
          s[v] = wc[i] * s[v] + x[v];
        }
        p[(long long)(c0 + i) * STEP] = out;
      }
    }
  }
}

// att[t, s] for the 16 rows t of [tb, tb + 16) and the 8 * NT columns s of
// [sb, sb + 8 NT), factored through row m (s <= m for every column):
// (r e^{cl_prev - cl[m]}) @ (k e^{cl[m] - cl})^T on the tensor cores.  Rows
// t <= m (the upper 8 rows where m = tb + 7) take zeros and are not
// stored: their pairs are formed pairwise.
template <int HD, int NT>
__device__ __forceinline__ void att_block(const float* R, const float* K,
                                          const float* CL, float* ATT,
                                          int LDA, int tb, int sb, int m,
                                          int g, int q) {
  constexpr int LDR = HD + 4;
  const float* cm = CL + m * LDR;
  const int t0 = tb + g, t1 = t0 + 8;
  const bool upper = t0 > m;              // the same for the whole warp
  const float* p0 = CL + (t0 - 1) * LDR;
  const float* p1 = CL + (t1 - 1) * LDR;
  float acc[NT][4] = {};
#pragma unroll 2
  for (int d0 = 0; d0 < HD; d0 += 8) {
    const int da = d0 + q, db = da + 4;
    AFrag a;
    a.set(upper ? R[t0 * LDR + da] * ex2(p0[da] - cm[da]) : 0.0f,
          R[t1 * LDR + da] * ex2(p1[da] - cm[da]),
          upper ? R[t0 * LDR + db] * ex2(p0[db] - cm[db]) : 0.0f,
          R[t1 * LDR + db] * ex2(p1[db] - cm[db]));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int s = sb + 8 * n + g;
      const float* cs = CL + s * LDR;
      mma_3xtf32(acc[n], a.hi, a.lo, K[s * LDR + da] * ex2(cm[da] - cs[da]),
                 K[s * LDR + db] * ex2(cm[db] - cs[db]));
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int s = sb + 8 * n + 2 * q;
    if (upper) store2(ATT + t0 * LDA + s, acc[n][0], acc[n][1]);
    store2(ATT + t1 * LDA + s, acc[n][2], acc[n][3]);
  }
}

// Phase C: the chunk's output from its inputs and the state entering it.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, HD <= 64 ? 3 : 1)
gla_out_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ lw,
               const T* __restrict__ u, const float* __restrict__ ws,
               T* __restrict__ out, int S, int H, int C) {
  extern __shared__ __align__(16) float smem[];
  const LayoutC<HD> L{(C + SUB - 1) / SUB * SUB};
  constexpr int LDR = LayoutC<HD>::LDR, LDV = LayoutC<HD>::LDV;
  const int CP = L.CP, LDA = L.lda(), NB = CP / SUB;
  float* R = smem + L.r();
  float* K = smem + L.kv();
  float* V = K;                  // once att is formed
  float* CL = smem + L.cl();
  float* ST = CL;                // once r is decayed
  float* ATT = smem + L.att();
  float* U = smem + L.u();
  float* DG = smem + L.dg();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const ChunkAt at = chunk_at(S, H, HD, C);
  const long long row = (long long)H * HD;
  const int h = blockIdx.y;

  load_tile<T, HD>(R, LDR, r + at.base, row, C, CP, tid);
  load_tile<T, HD>(K, LDR, k + at.base, row, C, CP, tid);
  load_tile<T, HD>(CL, LDR, lw + at.base, row, C, CP, tid);
  for (int d = tid; d < HD; d += THREADS) U[d] = to_f32(u[h * HD + d]);
  cp_async_wait();
  __syncthreads();
  cumsum_log2<HD>(CL, LDR, smem + L.part(), CP, tid);

  // att: zeros on and above the diagonal of each diagonal sub-chunk
  for (int p = tid; p < NB * SUB * SUB; p += THREADS) {
    const int i = p / (SUB * SUB), tt = (p / SUB) % SUB, ss = p % SUB;
    if (tt <= ss) ATT[(SUB * i + tt) * LDA + SUB * i + ss] = 0.0f;
  }
  // pairwise inside each half of a diagonal sub-chunk: 28 pairs t > s an
  // 8-row half, one a thread
  constexpr int HALF = SUB / 2, PAIRS = HALF * (HALF - 1) / 2;
  for (int p = tid; p < 2 * NB * PAIRS; p += THREADS) {
    const int half = p / PAIRS;
    int tt = 1, ss = p % PAIRS;           // the ss-th pair of row tt
    while (ss >= tt) { ss -= tt; ++tt; }
    const int t = HALF * half + tt, s = HALF * half + ss;
    const float* rt = R + t * LDR;
    const float* pt = CL + (t - 1) * LDR;
    const float* ks = K + s * LDR;
    const float* cs = CL + s * LDR;
    float a = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(rt + d);
      const float4 p4 = *reinterpret_cast<const float4*>(pt + d);
      const float4 k4 = *reinterpret_cast<const float4*>(ks + d);
      const float4 c4 = *reinterpret_cast<const float4*>(cs + d);
      a = fmaf(r4.x * k4.x, ex2(p4.x - c4.x), a);
      a = fmaf(r4.y * k4.y, ex2(p4.y - c4.y), a);
      a = fmaf(r4.z * k4.z, ex2(p4.z - c4.z), a);
      a = fmaf(r4.w * k4.w, ex2(p4.w - c4.w), a);
    }
    ATT[t * LDA + s] = a;
  }
  // the factored blocks, as warp tasks of equal work: every sub-chunk
  // j < i against sub-chunk i (16 x 16, through the last row of j), then
  // the lower half of each sub-chunk against its upper half (8 x 8, through
  // its row 7), two sub-chunks a task
  const int FULL = NB * (NB - 1) / 2;
  for (int task = warp; task < FULL + (NB + 1) / 2; task += WARPS) {
    if (task < FULL) {
      int i = 1, j = task;
      while (j >= i) { j -= i; ++i; }
      att_block<HD, 2>(R, K, CL, ATT, LDA, SUB * i, SUB * j,
                       SUB * j + SUB - 1, g, q);
    } else {
      for (int i = 2 * (task - FULL); i < NB && i < 2 * (task - FULL) + 2;
           ++i)
        att_block<HD, 1>(R, K, CL, ATT, LDA, SUB * i, SUB * i,
                         SUB * i + HALF - 1, g, q);
    }
  }
  // y_diag's weights, a warp a row
  for (int t = warp; t < CP; t += WARPS) {
    float a = 0.0f;
    for (int d = lane; d < HD; d += 32)
      a = fmaf(R[t * LDR + d] * U[d], K[t * LDR + d], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) DG[t] = a;
  }
  __syncthreads();
  // v in k's place, in flight while r is decayed: r * e^{cl_prev}, in place
  load_tile<T, HD>(V, LDV, v + at.base, row, C, CP, tid);
  for (int e = tid; e < CP * HD; e += THREADS) {
    const int t = e / HD, d = e % HD;
    if (t > 0) R[t * LDR + d] = R[t * LDR + d] * ex2(CL[(t - 1) * LDR + d]);
  }
  __syncthreads();
  // the state in cl's place
  load_tile<float, HD>(ST, LDV, ws + at.ws * HD * HD, HD, HD, HD, tid);
  cp_async_wait();
  __syncthreads();

  // out = [r e^{cl_prev} | att] @ [state ; v] + dg * v: a warp task is 16
  // rows t and half the columns j; att's depth stops at the diagonal.
  constexpr int NTW = HD / 16;
  for (int task = warp; task < 2 * NB; task += WARPS) {
    const int mt = task >> 1, j0 = 8 * NTW * (task & 1);
    const int t0 = SUB * mt + g, t1 = t0 + 8;
    float acc[NTW][4] = {};
    for (int d0 = 0; d0 < HD; d0 += 8) {
      const int da = d0 + q;
      AFrag a;
      a.set(R[t0 * LDR + da], R[t1 * LDR + da], R[t0 * LDR + da + 4],
            R[t1 * LDR + da + 4]);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* sb = ST + da * LDV + j0 + 8 * n + g;
        mma_3xtf32(acc[n], a.hi, a.lo, sb[0], sb[4 * LDV]);
      }
    }
#pragma unroll 2
    for (int s0 = 0; s0 < SUB * (mt + 1); s0 += 8) {
      const int sa = s0 + q;
      AFrag a;
      a.set(ATT[t0 * LDA + sa], ATT[t1 * LDA + sa], ATT[t0 * LDA + sa + 4],
            ATT[t1 * LDA + sa + 4]);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* vb = V + sa * LDV + j0 + 8 * n + g;
        mma_3xtf32(acc[n], a.hi, a.lo, vb[0], vb[4 * LDV]);
      }
    }
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int j = j0 + 8 * n + 2 * q;
      if (t0 < C)
        store2(out + at.base + t0 * row + j,
               acc[n][0] + DG[t0] * V[t0 * LDV + j],
               acc[n][1] + DG[t0] * V[t0 * LDV + j + 1]);
      if (t1 < C)
        store2(out + at.base + t1 * row + j,
               acc[n][2] + DG[t1] * V[t1 * LDV + j],
               acc[n][3] + DG[t1] * V[t1 * LDV + j + 1]);
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device,
// asking the runtime only for more than `granted` (bytes granted so far, by
// device ordinal) holds.  Returns the CUDA error, cleared (the next launch
// check would read it).
constexpr int MAX_DEVICES = 64;
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t (&granted)[MAX_DEVICES]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < MAX_DEVICES && granted[dev] >= bytes)
    return cudaSuccess;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < MAX_DEVICES) granted[dev] = bytes;
  return cudaSuccess;
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, void* out, void* ws, int B, int S, int H, int C,
           int phases, cudaStream_t stream) {
  static size_t granted_a[MAX_DEVICES], granted_c[MAX_DEVICES];
  const int CP = (C + SUB - 1) / SUB * SUB, NC = S / C;
  const size_t smem_a = LayoutA<HD>{CP}.bytes();
  const size_t smem_c = LayoutC<HD>{CP}.bytes();
  cudaError_t err = allow_smem(gla_delta_kernel<T, HD>, smem_a, granted_a);
  if (err == cudaSuccess)
    err = allow_smem(gla_out_kernel<T, HD>, smem_c, granted_c);
  if (err != cudaSuccess) return (int)err;
  float* wsf = static_cast<float*>(ws);
  float* et = wsf + (size_t)B * H * NC * HD * HD;
  const dim3 grid(NC, H, B);
  if (phases & 1)
    gla_delta_kernel<T, HD><<<grid, THREADS, smem_a, stream>>>(
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(lw), wsf, et, S, H, C);
  if (phases & 2) {
    constexpr int VEC = 4;
    const long long n = (long long)B * H * HD * HD;
    const long long blocks = (n / VEC + THREADS - 1) / THREADS;
    gla_scan_kernel<HD, VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
        wsf, et, NC, n);
  }
  if (phases & 4)
    gla_out_kernel<T, HD><<<grid, THREADS, smem_c, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(lw),
        static_cast<const T*>(u), wsf, static_cast<T*>(out), S, H, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* r, const void* k, const void* v, const void* lw,
              const void* u, void* out, void* ws, int B, int S, int H,
              int hd, int C, int phases, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, lw, u, out, ws, B, S, H, C, phases, stream);
    case 32: return launch<T, 32>(r, k, v, lw, u, out, ws, B, S, H, C, phases, stream);
    case 64: return launch<T, 64>(r, k, v, lw, u, out, ws, B, S, H, C, phases, stream);
    case 128: return launch<T, 128>(r, k, v, lw, u, out, ws, B, S, H, C, phases, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, logw, out: (B,S,H,hd); u: (H,hd); contiguous, 16-byte aligned,
// on the device, all of one dtype: 0 float32, 1 bfloat16.  hd is 16, 32,
// 64 or 128; S % C == 0 (the wrapper checks it).  ws: float32 workspace of
// B*H*(S/C)*(hd*hd + hd) floats.  `phases` picks the launches, A = 1,
// B = 2, C = 4 (7 for the whole function; the others time a phase alone).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another dtype or
// hd, or cudaFuncSetAttribute's error where a phase's tiles pass the 227 KB
// a CTA may hold (nothing is launched then).
extern "C" int gla_timemix_fwd(const void* r, const void* k, const void* v,
                               const void* lw, const void* u, void* out,
                               void* ws, int B, int S, int H, int hd, int C,
                               int dtype, int phases, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_hd<float>(r, k, v, lw, u, out, ws, B, S, H, hd, C, phases, stream);
    case 1: return launch_hd<__nv_bfloat16>(r, k, v, lw, u, out, ws, B, S, H, hd, C, phases, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
