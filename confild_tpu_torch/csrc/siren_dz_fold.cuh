// dz's row slots and the fold of its per-unit row sums, for the cluster
// chain's dz mode (siren_chain_cluster.cu: a unit is a cluster of P pairs).
// A unit sums dpre_l over its pairs in pair order, one sum per latent row
// it touches, into its partial parts[unit][l][slot][H] (slot: the row less
// the row of the unit's first pair); the fold adds each row's partials in
// unit order to what earlier chunks left in dz.  No atomics: two launches
// are bitwise equal.
#pragma once

#include <cuda_runtime.h>

namespace siren {

// latent rows that cp consecutive pairs can touch when a row has M
// points, ceil((cp - 1) / M) + 1: the slots of a dz partial of cp pairs
__host__ __device__ inline int dz_slots(int M, int cp) {
  const int s = (cp - 2 + M) / M + 1;
  return s < cp ? s : cp;
}

constexpr int FOLD_THREADS = 256;

// One thread per (layer, row of the chunk, column): dz += the partials
// parts[unit][l][slot][H] of the chunk's units of cp pairs (clusters) that
// hold the row, in unit order.
__global__ void __launch_bounds__(FOLD_THREADS)
siren_dz_fold_kernel(const float* __restrict__ parts, float* __restrict__ dz, long long p0,
                     int Q, int T, int M, int H, int n_mod, int cp) {
  const int slots = dz_slots(M, cp);
  const long long t_lo = p0 / M;
  const int rows = (int)((p0 + Q - 1) / M - t_lo + 1);
  const long long total = (long long)n_mod * rows * H;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % H);
    const int r = (int)((e / H) % rows);
    const int l = (int)(e / H / rows);
    const long long t = t_lo + r;
    // the row's pairs in the chunk: q in [a, b)
    const int a = (int)((t * M > p0 ? t * M : p0) - p0);
    const int b = (int)(((t + 1) * M < p0 + Q ? (t + 1) * M : p0 + Q) - p0);
    float* out = dz + ((size_t)l * T + t) * H + j;
    float acc = *out;
    for (int bk = a / cp; bk <= (b - 1) / cp; ++bk) {
      const long long slot = t - (p0 + (long long)bk * cp) / M;
      acc += parts[(((size_t)bk * n_mod + l) * slots + slot) * H + j];
    }
    *out = acc;
  }
}

// the fold of one chunk's partials, on the stream
inline int launch_dz_fold(const float* parts, float* dz, long long p0, int Q, int T, int M, int H,
                          int n_mod, int cp, cudaStream_t stream) {
  if (cp <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (p0 + Q - 1) / M - p0 / M + 1;
  const long long want = (n_mod * rows * H + FOLD_THREADS - 1) / FOLD_THREADS;
  const unsigned int blocks = (unsigned int)(want < 4096 ? want : 4096);
  siren_dz_fold_kernel<<<blocks, FOLD_THREADS, 0, stream>>>(parts, dz, p0, Q, T, M, H, n_mod, cp);
  return (int)cudaGetLastError();
}

}  // namespace siren
