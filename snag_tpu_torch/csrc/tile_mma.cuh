// Tensor-core building blocks on Hopper: for fp32 data the 3xTF32 split
// and one m16n8k8 TF32 mma.sync; for bf16 data one m16n8k16 bf16 mma.sync
// and the packing of two floats into its operand registers; cp.async
// copies with zero fill.
//
// 3xTF32: an fp32 x is split into hi = rna_tf32(x) and lo = rna_tf32(x -
// hi) (x - hi is exact in fp32), and a product a b is taken as a_lo b_hi +
// a_hi b_lo + a_hi b_hi, accumulated in fp32; the dropped a_lo b_lo is
// below fp32's rounding.  That keeps ~fp32 accuracy at a third of the TF32
// tensor-core rate (495 / 3 TFLOP/s on an H100 SXM), where one TF32 product
// keeps ~3 decimal digits.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA), for
// lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, rows x k):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, k x cols):   b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8, rows x cols): c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
// A product sums over k in any order, so a caller may feed k slot t from
// element 2t of an 8-wide slice and slot t + 4 from element 2t + 1, in A
// and B alike: then a0, a2 (and b0, b1 of a k-contiguous B) are adjacent.
//
// Fragments of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, each 32-bit
// register holding two bf16, the lower k in its low half:
//   A (16 x 16):  r0 (g, 2t..2t+1)  r1 (g + 8, 2t..)  r2 (g, 2t+8..2t+9)  r3 (g + 8, 2t+8..)
//   B (16 x 8):   r0 (2t..2t+1, g)  r1 (2t+8..2t+9, g)
//   C: as for TF32.
// The same freedom lets a caller feed k slots 2t, 2t + 1, 2t + 8, 2t + 9
// from elements 4t .. 4t + 3 of a 16-wide slice: one 64-bit load of a
// k-contiguous row gives r0 and r2 (A) or r0 and r1 (B).  The products of
// two bf16 are exact in fp32, so a bf16 product is as close to fp32
// products of the same operands as the accumulation lets it be.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cvt.rna.tf32.f32 for finite x: round to 10 mantissa bits, ties away
// from zero (sm_90 has no instruction for it; this is its integer form
// without the inf / NaN check).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = rna_tf32(x), lo = rna_tf32(x - hi).  lo keeps its low 13 bits:
// the tensor cores ignore them, so adding half a TF32 ulp is its rounding.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b in TF32, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// d += a b in bf16 with fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 (to nearest, ties to even) in one register,
// lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two raw bf16 (their bits) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes from global to shared memory, or write zeros when !ok
// (src is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 8 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The same for an n known only at run time, 0 <= n <= 2.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

}  // namespace
