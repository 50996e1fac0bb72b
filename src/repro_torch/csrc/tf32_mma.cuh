// Float32 products on the tensor cores in three TF32 passes (mma.sync
// m16n8k8), and 2^x on the special-function unit: shared by
// flash_attention.cu (its float32 path) and gla_timemix.cu.
#pragma once

#include <stdint.h>

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability or decay below 2^-126 adds nothing at float32's precision).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, hi rounded to TF32 (10 explicit bits); the tensor cores
// read only the top 10 bits of lo's mantissa, so hi*hi' + hi*lo' + lo*hi'
// carries about 20 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 in, float32 sums.  The A fragment holds rows
// g and g+8 at columns q and q+4 of the 16 x 8 tile, the B fragment rows q
// and q+4 at column g of the 8 x 8 tile, the sums rows g and g+8 at
// columns 2q and 2q+1 (g = lane / 4, q = lane % 4).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in three TF32 products, the small terms first.  The tensor
// cores round the float32 sums they accumulate less carefully than IEEE
// float32 does, an error that grows with the number of products summed
// into one accumulator: callers keep those chains to one tile.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0,
                                           float b1) {
  uint32_t h0, l0, h1, l1;
  split_tf32(b0, h0, l0);
  split_tf32(b1, h1, l1);
  mma_tf32(d, alo, h0, h1);
  mma_tf32(d, ahi, l0, l1);
  mma_tf32(d, ahi, h0, h1);
}
