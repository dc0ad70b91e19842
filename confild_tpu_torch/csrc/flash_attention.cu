// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two-pass backward, float32 arithmetic for float32 and bfloat16 inputs.
//
// Layouts (row-major, contiguous): q, k, v, dO, out, dq, dk, dv are
// (BH, N, D); lse and delta are (BH, N) float32.  D is 32, 64 or 128.
// Logits are scaled by 1 / sqrt(D); the softmax runs in float32.
//
// ---------------------------------------------------------------------------
// flash_forward replaces the Pallas kernel _flash_kernel
// (confild_tpu/ops/flash_attention.py:56, launched at :118 by _flash_forward).
// flash_bwd_dq replaces _bwd_dq_kernel (:158, launched at :257) and
// flash_bwd_dkv replaces _bwd_dkv_kernel (:188, launched at :282), both of
// _flash_backward.
//
// Bound on the H100: operations.  The forward does 4*N*N*D flops per head
// (two products) and the backward 10*N*N*D (S, dP, dV, dQ, dK) against
// O(N*D) bytes, so at N >= 144 the float32 FMA rate bounds all three (no
// tensor cores: float32 inputs stay in full float32, as in the JAX path).
//
// Design.  The TPU kernels carry the running max, denominator and output
// accumulator in VMEM across a sequential kv grid axis; Hopper blocks run in
// no order, so here each block loops over the other axis itself:
//   * forward and dq: one block per (head, 64 query rows), looping over
//     64-key tiles;
//   * dk/dv: one block per (head, 64 keys), looping over 64-query tiles.
// Every output element has one owner thread, so there are no atomics and two
// launches give bitwise-equal results.  A block has 256 threads; thread
// (ty, tx) = (t / 16, t % 16) owns tile rows 4*ty .. 4*ty + 3 and columns
// tx + 16*j, so the 16 threads of one row sit in one half-warp and the row
// max and sum are shuffle reductions.  Tiles are staged in shared memory as
// float32 with a row stride of D + 1 (no bank conflicts on the column walks);
// above 48 KB that needs cudaFuncSetAttribute.  Ragged edges are masked in
// the kernels, with no padded copy: keys past N get probability 0 (the tile
// of a forward block always holds a real key, so the running max is finite
// and exp never sees -inf - -inf), and query rows past N add nothing to
// dK and dV.  The (N, N) matrices never leave shared memory: memory is O(N).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // query rows and keys per tile
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 tile entries each
constexpr int PLD = TILE + 1;  // row stride of the P / dS tiles

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows row0 .. row0 + TILE - 1 of a (N, D) matrix into a float tile of row
// stride D + 1; rows past n are zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          int row0, int n) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, c = e % D, gr = row0 + r;
    dst[r * (D + 1) + c] = gr < n ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

// sum and max over the 16 threads of a half-warp (one tile row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

// acc[i][j] = sum_d a[(4*ty + i)][d] * b[(tx + 16*j)][d] over two tiles of
// row stride D + 1
template <int D>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* __restrict__ a,
                                         const float* __restrict__ b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_k p[(4*ty + i)][k] * m[k][(tx + 16*c)]: a TILE x TILE
// probability tile (stride PLD) times a TILE x D value tile (stride D + 1)
template <int D>
__device__ __forceinline__ void tile_pv(float out[4][D / 16], const float* __restrict__ p,
                                        const float* __restrict__ m, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < TILE; ++k) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(4 * ty + i) * PLD + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = m[k * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][c] = fmaf(pv[i], mv, out[i][c]);
    }
  }
}

template <int D>
constexpr size_t fwd_smem() { return sizeof(float) * (3 * TILE * (D + 1) + TILE * PLD); }
template <int D>
constexpr size_t dq_smem() { return sizeof(float) * (4 * TILE * (D + 1) + TILE * PLD); }
template <int D>
constexpr size_t dkv_smem() { return sizeof(float) * (4 * TILE * (D + 1) + 2 * TILE * PLD + 2 * TILE); }

// ---------------------------------------------------------------------------
// forward: out = softmax(q k^T * scale) v, lse = logsumexp of each row
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + TILE * (D + 1);
  float* sV = sK + TILE * (D + 1);
  float* sP = sV + TILE * (D + 1);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;

  load_tile<D>(sQ, q + base, q0, n);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();   // the previous tile's readers are done
    load_tile<D>(sK, k + base, k0, n);
    load_tile<D>(sV, v + base, k0, n);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (k0 + tx + 16 * j < n) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));   // finite: the tile holds a key
      const float alpha = expf(m[i] - m_new);         // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);        // 0 for masked keys
        sP[(4 * ty + i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_pv<D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= n) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      out[base + (size_t)r * D + tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (tx == 0) lse[(size_t)blockIdx.y * n + r] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 1: dQ = scale * sum_j dS_ij K_j,
//   P = exp(S - lse), dS = P * (dO V^T - delta)
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + TILE * (D + 1);   // dO tile
  float* sK = sO + TILE * (D + 1);
  float* sV = sK + TILE * (D + 1);
  float* sS = sV + TILE * (D + 1);   // dS tile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;

  load_tile<D>(sQ, q + base, q0, n);
  load_tile<D>(sO, dout + base, q0, n);
  float lr[4], dr[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    lr[i] = r < n ? lse[rbase + r] : 0.f;
    dr[i] = r < n ? delta[rbase + r] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();
    load_tile<D>(sK, k + base, k0, n);
    load_tile<D>(sV, v + base, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_ok = q0 + 4 * ty + i < n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && k0 + tx + 16 * j < n;
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        sS[(4 * ty + i) * PLD + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    tile_pv<D>(acc, sS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      dq[base + (size_t)r * D + tx + 16 * c] = from_float<T>(acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij Q_i.
// The block's tiles are transposed: rows are keys, columns are queries.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int n, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE * (D + 1);
  float* sQ = sV + TILE * (D + 1);
  float* sO = sQ + TILE * (D + 1);   // dO tile
  float* sP = sO + TILE * (D + 1);   // P^T tile (keys x queries)
  float* sS = sP + TILE * PLD;       // dS^T tile
  float* sL = sS + TILE * PLD;       // lse of the query tile
  float* sD = sL + TILE;             // delta of the query tile
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;

  load_tile<D>(sK, k + base, k0, n);
  load_tile<D>(sV, v + base, k0, n);
  float acc_k[4][D / 16], acc_v[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += TILE) {
    __syncthreads();
    load_tile<D>(sQ, q + base, q0, n);
    load_tile<D>(sO, dout + base, q0, n);
    if (threadIdx.x < TILE) {
      const int r = q0 + threadIdx.x;
      sL[threadIdx.x] = r < n ? lse[rbase + r] : 0.f;
      sD[threadIdx.x] = r < n ? delta[rbase + r] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, sK, sQ, ty, tx);   // s[i][j]: key 4*ty + i, query tx + 16*j
    tile_dot<D>(dp, sV, sO, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qc = tx + 16 * j;
      const bool ok = q0 + qc < n;    // query rows past N add nothing
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok ? expf(s[i][j] * scale - sL[qc]) : 0.f;
        sP[(4 * ty + i) * PLD + qc] = p;
        sS[(4 * ty + i) * PLD + qc] = p * (dp[i][j] - sD[qc]);
      }
    }
    __syncthreads();
    tile_pv<D>(acc_v, sP, sO, ty, tx);
    tile_pv<D>(acc_k, sS, sQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const size_t o = base + (size_t)r * D + tx + 16 * c;
      dk[o] = from_float<T>(acc_k[i][c] * scale);
      dv[o] = from_float<T>(acc_v[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: one instantiation per (D, type)
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

dim3 grid_for(int bh, int n) { return dim3((unsigned)((n + TILE - 1) / TILE), (unsigned)bh); }

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int n, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t err = prepare(flash_fwd_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, n, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int n, cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, n,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int n, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, n,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16
bool args_ok(int bh, int n, int d, int dtype) {
  return bh > 0 && bh <= 65535 && n > 0 && (d == 32 || d == 64 || d == 128) &&
         (dtype == 0 || dtype == 1);
}

#define FLASH_DISPATCH(LAUNCH, ...)                                         \
  switch (d * 2 + dtype) {                                                  \
    case 64: return LAUNCH<32, float>(__VA_ARGS__);                         \
    case 65: return LAUNCH<32, __nv_bfloat16>(__VA_ARGS__);                 \
    case 128: return LAUNCH<64, float>(__VA_ARGS__);                        \
    case 129: return LAUNCH<64, __nv_bfloat16>(__VA_ARGS__);                \
    case 256: return LAUNCH<128, float>(__VA_ARGS__);                       \
    case 257: return LAUNCH<128, __nv_bfloat16>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

extern "C" {

int flash_forward(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int n, int d, int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, n, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int bh, int n, int d,
                 int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, n, (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                  int d, int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, n, (cudaStream_t)stream)
}

}  // extern "C"
