// Blocked GQA flash attention, causal or not, with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py:29, _kernel (launched
// by flash_attention).
//
// What it computes.  q (B,S,H,hd), k and v (B,S,KV,hd) in float32, bf16 or
// f16; query head h reads kv head h % KV.  q is scaled by `scale` in the
// input dtype (the reference scales before its kernel; the wrapper rounds
// the scale itself to the dtype, as JAX does with a Python float), then the
// scores q.k, masked to -1e30 above the diagonal and past S, a running max
// m, sum l and accumulator acc over the kv tiles are float32, and the output
// is acc / max(l, 1e-30) cast to q's dtype.  kv tiles wholly above the
// diagonal are skipped.  The Pallas grid (B, H, S/bq, S/bk) carries
// (m, l, acc) in scratch across its sequential kv axis; here one CTA takes
// one (b, h, 128-row q tile) and runs the kv loop itself.  The q tile index
// is the grid's slowest axis, counted down, so the tiles with the most kv
// work are launched first.  The result does not depend on the caller's bq
// and bk beyond float32 rounding.
//
// Bound.  4 * hd flops for each (query, key) pair it sees, against reading
// q, k, v once and writing o once.  At qwen2-7b's width (H = 28, KV = 4,
// hd = 128, S = 4096, causal) that is 1.2e11 flops and 67 MB in bf16: bound
// by operations, at 0.12 ms on the tensor cores (989 TFLOP/s) in bf16 and
// f16.  In float32 each product takes three TF32 passes on the tensor
// cores, so the bound is 3 * 1.2e11 flops at the TF32 rate (495 TFLOP/s),
// 0.73 ms, below the CUDA cores' 1.8 ms at 67 TFLOP/s.
//
// bf16 and f16: tensor cores.  Three warpgroups: two consumers of 64 q rows
// each and one producer.  One producer thread brings the q tile and a ring
// of NST k and v stages into shared memory by TMA (cp.async.bulk.tensor),
// each stage guarded by mbarriers: "full" (k and v apart, so that Q.K^T can
// start before v lands) and "empty" (one arrival per consumer warp once its
// products have read the stage).  The tensor maps run over (hd, heads, S,
// B), so a ragged last tile zero-fills at S and never reads the next
// sequence's rows, and kv head h % KV is a coordinate.  Tiles are stored in
// panels of 128 (hd >= 64) or 64 bytes (hd = 32) a row with the matching
// TMA swizzle, which the wgmma descriptors name.  A consumer scales its q
// rows in place, then per kv tile: S = Q.K^T by wgmma m64n128k16 with both
// operands in shared memory (K-major); the softmax in float32 registers;
// P rounded to the input dtype (as the reference's chunked oracle rounds
// its probabilities to v's dtype) and kept in registers, where the score
// accumulator's layout is already wgmma's A-fragment layout; O += P.V by
// wgmma m64n{hd}k16 with A from registers and V, stored (keys, hd), read
// MN-major through the transpose bit.  The consumers raise their register
// budget to 240 with setmaxnreg and the producer lowers its own to 24.
//
// float32: tensor cores in three TF32 passes.  One pass of TF32 would round
// q, k, v and P to 10 bits, outside the reference's 1e-5; each operand x is
// split into TF32 parts hi + lo and a product taken as lo*hi' + hi*lo' +
// hi*hi' (mma.sync m16n8k8), about 20 bits of it.  Eight warps of 16 q rows
// each, 64-key tiles in two cp.async stages; the scores' accumulator
// layout is the PV product's A fragment once the keys of each 8-key block
// are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, and V's rows are read in
// that order.  The tensor cores' float32 sums lose accuracy with the length
// of the chain, so each tile's PV sums start from zero and are added to O
// on the CUDA cores (summed over all of S = 4096 in the accumulator, they
// used 0.69 of the tolerance; per tile, 0.14).  Each warp splits the k and
// v values it reads, 8 times over for the CTA.  The library is built with
// -fmad=false: the softmax fuses nowhere.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Two floats rounded to T and packed into 32 bits, the first in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One TMA load of a box of a rank-4 tensor map into shared memory; the
// bytes are credited to mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running.
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, float32) = [D +] A (64 x 16) . B (128 x 16)^T, both K-major
// in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d);
// D (64 x N) += A (64 x 16, registers) . B (16 x N), B MN-major in shared
// memory (the transpose bit).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

#define FA_WGMMA_SS(TY, PTX)                                                  \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_ss<TY>(float(&d)[64], uint64_t da,    \
                                               uint64_t db, int scale_d) {    \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {"       \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                  \
        "%64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "l"(da), "l"(db), "r"(scale_d));                                    \
  }

#define FA_WGMMA_RS32(TY, PTX)                                                \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs<TY, 32>(                           \
      float(&d)[16], const uint32_t(&a)[4], uint64_t db) {                    \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " {"        \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));       \
  }

#define FA_WGMMA_RS64(TY, PTX)                                                \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs<TY, 64>(                           \
      float(&d)[32], const uint32_t(&a)[4], uint64_t db) {                    \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " {"        \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31])                                            \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));       \
  }

#define FA_WGMMA_RS128(TY, PTX)                                               \
  template <>                                                                 \
  __device__ __forceinline__ void wgmma_rs<TY, 128>(                          \
      float(&d)[64], const uint32_t(&a)[4], uint64_t db) {                    \
    asm volatile(                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " {"       \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "                  \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),         \
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),    \
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),    \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),    \
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),    \
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),    \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                  \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));       \
  }

FA_WGMMA_SS(__nv_bfloat16, "bf16")
FA_WGMMA_SS(__half, "f16")
FA_WGMMA_RS32(__nv_bfloat16, "bf16")
FA_WGMMA_RS32(__half, "f16")
FA_WGMMA_RS64(__nv_bfloat16, "bf16")
FA_WGMMA_RS64(__half, "f16")
FA_WGMMA_RS128(__nv_bfloat16, "bf16")
FA_WGMMA_RS128(__half, "f16")

// ------------------------------------------- bf16 / f16: wgmma fed by TMA

constexpr int TC_BQ = 128, TC_BK = 128, TC_NST = 2, TC_THREADS = 384;

// Shared-memory layout of the tensor-core kernel at head width HD.  A tile
// of R rows is HD / PW panels of R rows x SW bytes, each panel as TMA's
// SW-byte swizzle leaves it.
template <int HD> struct TcLayout {
  static constexpr int SW = HD >= 64 ? 128 : 64;     // swizzle span, bytes
  static constexpr int PW = SW / 2;                  // panel width, elements
  static constexpr int NP = HD / PW;                 // panels a row
  static constexpr int SWZ = SW == 128 ? 1 : 2;      // descriptor code
  static constexpr int Q_BYTES = TC_BQ * HD * 2;
  static constexpr int KV_BYTES = TC_BK * HD * 2;    // one k or v stage
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + TC_NST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + TC_NST * KV_BYTES;
  // barriers: q full, k full[NST], v full[NST], empty[NST]
  static constexpr size_t bytes = BAR_OFF + 8 * (1 + 3 * TC_NST) + 1024;
};

// S = Q K^T for one consumer warpgroup's 64 rows against a 128-key tile:
// hd / 16 steps of 16 columns, 32 bytes apart within a panel.  Issued and
// committed, not waited for.
template <typename T, int HD>
__device__ __forceinline__ void issue_qk(float (&sacc)[64], uint32_t q_tile,
                                         uint32_t k_tile) {
  using L = TcLayout<HD>;
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk / (L::PW / 16);
    const uint32_t off = (kk % (L::PW / 16)) * 32;
    const uint64_t da = gmma_desc(q_tile + p * TC_BQ * L::SW + off, 16,
                                  8 * L::SW, L::SWZ);
    const uint64_t db = gmma_desc(k_tile + p * TC_BK * L::SW + off, 16,
                                  8 * L::SW, L::SWZ);
    wgmma_ss<T>(sacc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P V: TC_BK / 16 steps of 16 keys, 16 rows of every panel apart; V
// is MN-major, its panels TC_BK rows apart.  Issued, not waited for.
template <typename T, int HD>
__device__ __forceinline__ void issue_pv(float (&oacc)[HD / 2],
                                         const uint32_t (&pfrag)[TC_BK / 16][4],
                                         uint32_t v_tile) {
  using L = TcLayout<HD>;
  fence_regs(oacc);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < TC_BK / 16; ++kb) {
    const uint64_t db = gmma_desc(v_tile + kb * 16 * L::SW, TC_BK * L::SW,
                                  8 * L::SW, L::SWZ);
    wgmma_rs<T, HD>(oacc, pfrag[kb], db);
  }
  wgmma_commit();
}

// The online softmax of one score tile, in place.  sacc[v] holds row row0 +
// 8 ((v / 2) % 2) and key k0 + 8 (v / 4) + 2c + v % 2; the four lanes of a
// quad share a row.  Masks keys past S and above the diagonal, updates m
// and this lane's part of l, returns the correction of the old sums in
// corr and leaves the probabilities in sacc.
__device__ __forceinline__ void softmax_tile(float (&sacc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int row0, int c, int S,
                                             int causal, int first_row) {
  if (k0 + TC_BK > S || (causal && k0 + TC_BK - 1 > first_row)) {
#pragma unroll
    for (int v = 0; v < 64; ++v) {
      const int kpos = k0 + 8 * (v / 4) + 2 * c + (v % 2);
      const int qpos = row0 + 8 * ((v / 2) % 2);
      if (kpos >= S || (causal && kpos > qpos)) sacc[v] = NEG;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = ex2((m[r] - mx) * LOG2E);
    m[r] = mx;
    const float mb = mx * LOG2E;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(__fmaf_rn(sacc[4 * j + 2 * r], LOG2E, -mb));
      const float p1 = ex2(__fmaf_rn(sacc[4 * j + 2 * r + 1], LOG2E, -mb));
      sacc[4 * j + 2 * r] = p0;
      sacc[4 * j + 2 * r + 1] = p1;
      ps += p0 + p1;
    }
    l[r] = l[r] * corr[r] + ps;
  }
}

// P rounded to T as wgmma's A fragments: the score accumulator's n8 block
// j is half j % 2 of the fragment of k step j / 2.
template <typename T>
__device__ __forceinline__ void pack_p(const float (&sacc)[64],
                                       uint32_t (&pfrag)[TC_BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      pfrag[j / 2][2 * (j % 2) + r] =
          pack2<T>(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_attention_tc(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                   int S, int H, int KV, int causal, float scale) {
  using L = TcLayout<HD>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment for the 128-byte swizzle's 8-row atoms
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * TC_NST;
  const uint32_t empty = v_full + 8 * TC_NST;

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h % KV;
  const int q0 = qt * TC_BQ;
  const int kv_end = causal ? min(S, q0 + TC_BQ) : S;
  const int ntiles = (kv_end + TC_BK - 1) / TC_BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_NST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int p = 0; p < L::NP; ++p)
        tma_load(base + L::Q_OFF + p * TC_BQ * L::SW, &qmap, q_full,
                 p * L::PW, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % TC_NST;
        mbar_wait(empty + 8 * s, ((i / TC_NST) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, L::KV_BYTES);
        for (int p = 0; p < L::NP; ++p)
          tma_load(base + L::K_OFF + s * L::KV_BYTES + p * TC_BK * L::SW,
                   &kmap, k_full + 8 * s, p * L::PW, kvh, i * TC_BK, b);
        mbar_expect_tx(v_full + 8 * s, L::KV_BYTES);
        for (int p = 0; p < L::NP; ++p)
          tma_load(base + L::V_OFF + s * L::KV_BYTES + p * TC_BK * L::SW,
                   &vmap, v_full + 8 * s, p * L::PW, kvh, i * TC_BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, c = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;   // and row0 + 8

    // scale this warpgroup's q rows in place, in T
    mbar_wait(q_full, 0);
    for (int p = 0; p < L::NP; ++p) {
      T* rows = reinterpret_cast<T*>(smem + L::Q_OFF + p * TC_BQ * L::SW +
                                     64 * wg * L::SW);
      for (int e = tid; e < 64 * L::PW; e += 128)
        rows[e] = from_f32<T>(to_f32(rows[e]) * scale);
    }
    // the async proxy (wgmma) reads what the generic proxy wrote
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");

    const uint32_t q_tile = base + L::Q_OFF + 64 * wg * L::SW;
    const uint32_t k_tiles = base + L::K_OFF, v_tiles = base + L::V_OFF;
    float oacc[HD / 2], sacc[64];
    uint32_t pfrag[TC_BK / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f}, corr[2];

    // Per kv tile: S = Q K^T, the softmax, O += P V.  The other consumer
    // warpgroup's products fill the tensor cores while this one's softmax
    // runs.  Three schedules measured no faster: tile i + 1's scores
    // issued before tile i's PV product within the warpgroup (with two
    // stages or three), three stages alone, and the two warpgroups taking
    // strict turns on the tensor cores.
    for (int i = 0; i < ntiles; ++i) {
      const int s = i % TC_NST;
      const uint32_t parity = (i / TC_NST) & 1;
      mbar_wait(k_full + 8 * s, parity);
      issue_qk<T, HD>(sacc, q_tile, k_tiles + s * L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(sacc);
      softmax_tile(sacc, m, l, corr, i * TC_BK, row0, c, S, causal,
                   q0 + 64 * wg);
#pragma unroll
      for (int v = 0; v < HD / 2; ++v) oacc[v] *= corr[(v / 2) % 2];
      pack_p<T>(sacc, pfrag);
      mbar_wait(v_full + 8 * s, parity);
      issue_pv<T, HD>(oacc, pfrag, v_tiles + s * L::KV_BYTES);
      wgmma_wait<0>();
      fence_regs(oacc);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // out = acc / max(l, 1e-30); l is the sum over the quad's four lanes
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const long long qrow = (long long)H * HD;
    T* ob = o + ((long long)b * S * H + h) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos >= S) continue;
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        T* dst = ob + qpos * qrow + 8 * j + 2 * c;
        dst[0] = from_f32<T>(oacc[4 * j + 2 * r] / den);
        dst[1] = from_f32<T>(oacc[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

// The driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda;
// cudaGetDriverEntryPointByVersion needs CUDA 12.5).
#if CUDART_VERSION < 12050
#error "flash_attention.cu needs the CUDA 12.5 runtime or later"
#endif
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename T> struct TmaType;
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// A map over a (B, S, heads, hd) tensor as (hd, heads, S, B), whose box is
// one panel of `rows` sequence positions of one head.
template <typename T, int HD>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int rows) {
  using L = TcLayout<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::PW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, TmaType<T>::value, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                L::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int causal, float scale,
              cudaStream_t stream) {
  // TMA wants 16-byte aligned bases (every stride here is a multiple of 16)
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<T, HD>(&qmap, q, B, S, H, TC_BQ) ||
      !make_map<T, HD>(&kmap, k, B, S, KV, TC_BK) ||
      !make_map<T, HD>(&vmap, v, B, S, KV, TC_BK))
    return (int)cudaErrorInvalidValue;
  const size_t smem = TcLayout<HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch check would read it
    return (int)err;
  }
  const dim3 grid(H, B, (S + TC_BQ - 1) / TC_BQ);
  flash_attention_tc<T, HD><<<grid, TC_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(o), S, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------ float32: 3xTF32 on the tensor cores

constexpr int X_BQ = 128, X_BK = 64, X_THREADS = 256;

// Shared memory (floats): the scaled q tile and two stages of k and v, all
// row-major with rows padded by 4 floats, so that the fragment reads of a
// warp (eight rows by four columns, or four row pairs by eight columns)
// fall on 32 distinct banks.
template <int HD> struct XLayout {
  static constexpr int LD = HD + 4;
  static constexpr int Q = X_BQ * LD;
  static constexpr int KV = X_BK * LD;               // one stage of k or v
  static constexpr size_t bytes = (size_t)(Q + 4 * KV) * sizeof(float);
};

// The k and v rows of kv tile k0 into one stage, 16 bytes a copy, zero past
// S; committed as one cp.async group.
template <int HD>
__device__ __forceinline__ void x_fetch(float* Ks, float* Vs, const float* kb,
                                        const float* vb, long long krow,
                                        int k0, int S, int tid) {
  using L = XLayout<HD>;
#pragma unroll
  for (int it = 0; it < X_BK * (HD / 4) / X_THREADS; ++it) {
    const int e = tid + it * X_THREADS;
    const int j = e / (HD / 4), d4 = 4 * (e % (HD / 4));
    const bool in = k0 + j < S;
    const long long src = in ? (k0 + j) * krow + d4 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(Ks + j * L::LD + d4)),
                 "l"(kb + src), "r"(in ? 16 : 0) : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_addr(Vs + j * L::LD + d4)),
                 "l"(vb + src), "r"(in ? 16 : 0) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Eight warps, each owning 16 q rows; lane (g, c) = (lane / 4, lane % 4)
// holds rows g and g + 8 of the warp and, per 8-key block nb, keys
// 8nb + 2c and 8nb + 2c + 1 of the scores (mma's C fragment).  For O += P V
// the keys of a block are taken in the order 0, 2, 4, 6, 1, 3, 5, 7, which
// makes that C fragment mma's A fragment; V's rows are read in that order.
template <int HD>
__global__ void __launch_bounds__(X_THREADS, 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int S, int H, int KV, int causal, float scale) {
  using L = XLayout<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::Q;                      // [stage][key][d]
  float* Vs = Ks + 2 * L::KV;                 // [stage][key][d]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, kvh = h % KV;
  const int q0 = qt * X_BQ, w0 = q0 + 16 * warp;   // the warp's first row
  const long long qrow = (long long)H * HD, krow = (long long)KV * HD;
  const float* qb = q + ((long long)b * S * H + h) * HD;
  const float* kb = k + ((long long)b * S * KV + kvh) * HD;
  const float* vb = v + ((long long)b * S * KV + kvh) * HD;
  float* ob = o + ((long long)b * S * H + h) * HD;

  const int kv_end = causal ? min(S, q0 + X_BQ) : S;
  const int ntiles = (kv_end + X_BK - 1) / X_BK;
  x_fetch<HD>(Ks, Vs, kb, vb, krow, 0, S, tid);
  for (int e = tid; e < X_BQ * (HD / 4); e += X_THREADS) {
    const int r = e / (HD / 4), d4 = 4 * (e % (HD / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (q0 + r < S)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * qrow + d4);
    *reinterpret_cast<float4*>(Qs + r * L::LD + d4) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  float oacc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  const float* qw = Qs + (16 * warp + g) * L::LD + c;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * X_BK, st = kt & 1;
    const float* Kst = Ks + st * L::KV;
    const float* Vst = Vs + st * L::KV;
    // the next tile lands in the other stage while this one is used
    if (kt + 1 < ntiles) {
      x_fetch<HD>(Ks + (st ^ 1) * L::KV, Vs + (st ^ 1) * L::KV, kb, vb, krow,
                  k0 + X_BK, S, tid);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();

    // a warp whose rows all lie above this tile's first key skips it
    if (!causal || k0 <= w0 + 15) {
      float sacc[X_BK / 8][4];
#pragma unroll
      for (int n = 0; n < X_BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll 2
      for (int ks = 0; ks < HD / 8; ++ks) {
        uint32_t ahi[4], alo[4];
        split_tf32(qw[8 * ks], ahi[0], alo[0]);
        split_tf32(qw[8 * L::LD + 8 * ks], ahi[1], alo[1]);
        split_tf32(qw[8 * ks + 4], ahi[2], alo[2]);
        split_tf32(qw[8 * L::LD + 8 * ks + 4], ahi[3], alo[3]);
        const float* kr = Kst + g * L::LD + 8 * ks + c;
#pragma unroll
        for (int n = 0; n < X_BK / 8; ++n)
          mma_3xtf32(sacc[n], ahi, alo, kr[8 * n * L::LD],
                     kr[8 * n * L::LD + 4]);
      }

      // online softmax of rows g (r = 0) and g + 8 (r = 1)
      if (k0 + X_BK > S || (causal && k0 + X_BK - 1 > w0)) {
#pragma unroll
        for (int n = 0; n < X_BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * n + 2 * c + (e % 2);
            const int qpos = w0 + g + 8 * (e / 2);
            if (kpos >= S || (causal && kpos > qpos)) sacc[n][e] = NEG;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG;
#pragma unroll
        for (int n = 0; n < X_BK / 8; ++n)
          mx = fmaxf(mx, fmaxf(sacc[n][2 * r], sacc[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        float ps = 0.0f;
#pragma unroll
        for (int n = 0; n < X_BK / 8; ++n) {
          sacc[n][2 * r] = expf(sacc[n][2 * r] - m_new);
          sacc[n][2 * r + 1] = expf(sacc[n][2 * r + 1] - m_new);
          ps += sacc[n][2 * r] + sacc[n][2 * r + 1];
        }
        l[r] = l[r] * corr + ps;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          oacc[n][2 * r] *= corr;
          oacc[n][2 * r + 1] *= corr;
        }
      }

      // O += P V, 8 keys a step (V rows 8kb + 2c and 8kb + 2c + 1): this
      // tile's sums, a quarter of the output columns at a time, taken in a
      // fresh accumulator and added to O on the CUDA cores
#pragma unroll
      for (int part = 0; part < 4; ++part) {
        float pacc[HD / 32][4];
#pragma unroll
        for (int n = 0; n < HD / 32; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pacc[n][e] = 0.0f;
#pragma unroll
        for (int kb8 = 0; kb8 < X_BK / 8; ++kb8) {
          uint32_t ahi[4], alo[4];
          split_tf32(sacc[kb8][0], ahi[0], alo[0]);
          split_tf32(sacc[kb8][2], ahi[1], alo[1]);
          split_tf32(sacc[kb8][1], ahi[2], alo[2]);
          split_tf32(sacc[kb8][3], ahi[3], alo[3]);
          const float* vr =
              Vst + (8 * kb8 + 2 * c) * L::LD + g + part * (HD / 4);
#pragma unroll
          for (int n = 0; n < HD / 32; ++n)
            mma_3xtf32(pacc[n], ahi, alo, vr[8 * n],
                       vr[L::LD + 8 * n]);
        }
#pragma unroll
        for (int n = 0; n < HD / 32; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            oacc[part * (HD / 32) + n][e] += pacc[n][e];
      }
    }
    __syncthreads();                         // this stage is read
  }

  // out = acc / max(l, 1e-30); l is the sum over the quad's four lanes
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = w0 + g + 8 * r;
    if (qpos >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float* dst = ob + qpos * qrow + 8 * n + 2 * c;
      dst[0] = oacc[n][2 * r] / den;
      dst[1] = oacc[n][2 * r + 1] / den;
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KV, int causal, float scale,
               cudaStream_t stream) {
  const size_t smem = XLayout<HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch check would read it
    return (int)err;
  }
  const dim3 grid(H, B, (S + X_BQ - 1) / X_BQ);
  flash_attention_f32<HD><<<grid, X_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KV, int hd, int causal, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<T, 32>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 64: return launch_tc<T, 64>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 128: return launch_tc<T, 128>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <>
int launch_hd<float>(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int H, int KV, int hd, int causal,
                     float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 64: return launch_f32<64>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    case 128: return launch_f32<128>(q, k, v, o, B, S, H, KV, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,S,H,hd); k, v: (B,S,KV,hd); contiguous, on the device, all of one
// dtype: 0 float32, 1 bfloat16, 2 float16.  hd is 32, 64 or 128; H % KV ==
// 0; bf16 and f16 pointers 16-byte aligned.  `scale` is already rounded to
// the dtype.  Returns cudaGetLastError() (cudaErrorInvalidValue for a dtype,
// hd or alignment the kernel does not take, or a tensor map the driver
// refuses).
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
