// Device helpers shared by the SIREN-FiLM decode kernels
// (siren_fwd_cluster.cu, siren_chain_cluster.cu, siren_decode_bwd.cu): the
// polynomial sine in turns.  See siren_fwd_cluster.cu for the operand
// layouts.
#pragma once

#include <cuda_runtime.h>

namespace siren {

constexpr float TWO_PI = 6.283185307179586f;

// sin(2*pi*r): round-reduce, then the JAX package's odd minimax polynomial
// (confild_tpu/ops/siren_decode.py:52-69), max abs error 9.6e-8.
__device__ __forceinline__ float sin2pi(float r) {
  r = r - rintf(r);  // round half to even, as jnp.round
  const float r2 = r * r;
  float p = -12.271581478633225f;
  p = p * r2 + 41.20559778878122f;
  p = p * r2 + -76.58014706347774f;
  p = p * r2 + 81.59618849495108f;
  p = p * r2 + -41.341421583622676f;
  p = p * r2 + 6.283182820587522f;
  return r * p;
}

}  // namespace siren
