// Device helpers shared by the SIREN-FiLM decode kernels: the polynomial
// sine in turns (siren_decode.cu and siren_decode_bwd.cu) and the dz
// kernel's per-thread tile products and shape rule (siren_decode.cu).  See
// siren_decode.cu for the operand layouts.
#pragma once

#include <cuda_runtime.h>

namespace siren {

constexpr int TP = 32;          // (row, point) pairs per tile
constexpr int MAX_THREADS = 512;
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

// acc[p] += sum_k tile[p][k] * w[k][j] for k < K; tile rows have stride K.
// K % 4 == 0 and tile is 16-byte aligned.
__device__ __forceinline__ void tile_matmul(const float* __restrict__ tile,
                                            const float* __restrict__ w,
                                            int K, int N, int j,
                                            float (&acc)[TP]) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = __ldg(w + (size_t)(k + 0) * N + j);
    const float w1 = __ldg(w + (size_t)(k + 1) * N + j);
    const float w2 = __ldg(w + (size_t)(k + 2) * N + j);
    const float w3 = __ldg(w + (size_t)(k + 3) * N + j);
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(tile + p * K + k);
      float a = acc[p];
      a = fmaf(x.x, w0, a);
      a = fmaf(x.y, w1, a);
      a = fmaf(x.z, w2, a);
      a = fmaf(x.w, w3, a);
      acc[p] = a;
    }
  }
}

// First layer for a tile: acc[p] = sum_c cs[p][c] * w_first[c][j].
__device__ __forceinline__ void first_layer(const float* __restrict__ cs,
                                            const float* __restrict__ w_first,
                                            int C_in, int H, int j,
                                            float (&acc)[TP]) {
#pragma unroll
  for (int p = 0; p < TP; ++p) acc[p] = 0.f;
  for (int c = 0; c < C_in; ++c) {
    const float w = __ldg(w_first + (size_t)c * H + j);
#pragma unroll
    for (int p = 0; p < TP; ++p) acc[p] = fmaf(cs[p * C_in + c], w, acc[p]);
  }
}

inline bool shape_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 32 == 0 && H <= MAX_THREADS && n_mod >= 1 && C_in >= 1 && C_out >= 1;
}

}  // namespace siren
