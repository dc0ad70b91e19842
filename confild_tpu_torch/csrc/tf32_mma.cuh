// Device helpers shared by the port's tensor-core kernels
// (flash_attention.cu, siren_decode_bwd.cu): 16-byte cp.async copies into
// shared memory, and float32 products on the tensor cores as a 3xTF32 split
// on mma.sync.m16n8k8.
//
// A plain TF32 product keeps 11 significant bits and misses the float32
// criterion the kernels are held to (|kernel - f64| <= 2 |plain f32 - f64|
// + 1e-6 max|f64|) by some 300x, so each f32 operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and a product
// accumulates small*big + big*small (first) + big*big: about 22
// significant bits per operand.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, zeros when !valid (src is not read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds a finite x; by bit arithmetic (two
// integer operations), because ptxas expands the cvt into five
__device__ __forceinline__ uint32_t rna_tf32(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32; an operand that is exact in TF32 (bfloat16
// data) is its own big half
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if constexpr (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = rna_tf32(__float_as_uint(x));
    small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));
  }
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b as small*big + big*small (the correction terms first) + big*big
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3_into(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                          const uint32_t bb[2], const uint32_t bs[2]) {
  if constexpr (!EXACT_A) mma_tf32(c, as, bb);
  if constexpr (!EXACT_B) mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// The tensor cores truncate their sums toward zero.  Carried across a whole
// loop in their accumulator that bias grows with the step count (4-5x the
// plain float32 error, and the float32 check failed), so the products go
// into a zeroed partial, which a float32 add (round to nearest) carries into
// the running sum: in the flash kernels every k8 step for S and dP, whose
// error exp amplifies, and every second step for the products with P and
// dS; in the SIREN backward every second step.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                     const uint32_t bb[2], const uint32_t bs[2]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  mma3_into<EXACT_A, EXACT_B>(part, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += part[e];
}

}  // namespace tf32mma
