// Helpers shared by the port's tensor-core kernels (flash_attention.cu,
// and through siren_cluster.cuh the cluster kernels and
// siren_decode_bwd.cu): the shared-memory address of a pointer, the split
// of a float32 operand into two TF32 halves for 3xTF32 products on wgmma,
// and on the host the dynamic shared-memory attribute, set once per kernel
// and device.
//
// A plain TF32 product keeps 11 significant bits and misses the float32
// criterion the kernels are held to (|kernel - f64| <= 2 |plain f32 - f64|
// + 1e-6 max|f64|) by some 300x, so each f32 operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and a product
// accumulates small*big + big*small (first) + big*big: about 22
// significant bits per operand.
//
// The tensor cores truncate their sums toward zero.  Carried across a whole
// loop in their accumulator that bias grows with the step count (4-5x the
// plain float32 error, and the float32 check failed), so the kernels'
// products go into zeroed partials, which a float32 add (round to nearest)
// carries into the running sums: in the flash kernels every k16 step for S
// and dP, whose error exp amplifies, and every tile for the products with
// P and dS; in the SIREN kernels every K-slice.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// the dynamic shared-memory attribute of one kernel, set once per device
// (done holds a bit per device, one static per kernel): a
// cudaFuncSetAttribute on every launch costs host time on short calls
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

}  // namespace tf32mma
