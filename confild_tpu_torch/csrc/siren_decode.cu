// SIREN-FiLM decode kernels for Hopper (sm_90a), float32 throughout.
//
// Both kernels take operands that the Python wrapper
// (confild_tpu_torch/ops/siren_decode.py) has already folded: the first and
// middle weights and the FiLM table z are scaled by w0 / (2*pi), so every
// pre-activation is "in turns" and the activation is sin2pi(r) = sin(2*pi*r),
// evaluated with the same odd minimax polynomial as the JAX package
// (confild_tpu/ops/siren_decode.py:52-69).  The fast intrinsic __sinf is not
// used: it is inaccurate for the large arguments that w0 = 30 produces.
//
// Layouts (all row-major, contiguous):
//   coords  (M, C_in)          normalized query points
//   z       (n_mod, T, H)      scaled FiLM rows  z_l = (latents @ W2_l + b1_l) * s
//   w_first (C_in, H)          scaled first weight  [in][out]
//   w_mid   (n_mod - 1, H, H)  scaled middle weights [in][out]
//   w_mid_t (n_mod - 1, H, H)  the same, transposed  [out][in]   (dz only)
//   w_head  (H, C_out), b_head (C_out)
//
// One thread per hidden unit (blockDim.x == H, H % 32 == 0, H <= 512).
//
// ---------------------------------------------------------------------------
// siren_decode_forward replaces the Pallas kernel _decode_kernel
// (confild_tpu/ops/siren_decode.py:96, launched at :177 by _fused_forward).
//
// Bound on the H100: operations.  Each (row, point) pair costs
// 2*H*(C_in + (n_mod-1)*H + C_out) flops (4.4 MFLOP at Case4) against 12
// bytes of coordinates and outputs, so f32 FMA throughput bounds it.
// Design: a block owns TP consecutive (row, point) pairs and keeps their
// activation tile TP x H in shared memory for the whole layer stack (48 KB
// at H = 384); only the weights stream, and the 8.8 MB of middle weights
// stay resident in the 50 MB L2.  Thread j accumulates column j of the
// tile product in TP registers; weight row k is a coalesced read across j,
// the activation read is a shared-memory broadcast of 16 bytes that feeds
// 4 * TP FMAs.  The ragged edge is masked, not padded.
//
// siren_decode_dz replaces the Pallas kernel _decode_dz_kernel
// (confild_tpu/ops/siren_decode.py:315, launched at :393 by
// fused_siren_decode_dz).
//
// Bound on the H100: operations (a forward recompute plus a backward of the
// same size, about twice the forward's flops).  The TPU kernel accumulates
// dz across a sequential grid; Hopper blocks run in no order, so here one
// block owns whole latent rows (grid-stride over t) and walks that row's
// points in chunks of TP, keeping dz[l][j] for its row in shared memory
// (thread j owns column j: deterministic, no atomics).  The n_mod
// pre-activations of a chunk (n_mod * TP * H floats, 786 KB at Case4) do not
// fit in shared memory; they go to a per-block slice of a global workspace
// that only the writing thread reads back.  The backward product
// dx = dpre @ W_l^T reads W_l^T (w_mid_t) so that it is coalesced as well.
// Known cost: at Case4's 10 sensors per row, a chunk holds 10 live pairs of
// TP and each block rereads every weight for them.
// ---------------------------------------------------------------------------

#include "siren_common.cuh"

namespace {

using siren::MAX_THREADS;
using siren::TP;
using siren::TWO_PI;
using siren::first_layer;
using siren::shape_ok;
using siren::sin2pi;
using siren::tile_matmul;

__global__ void __launch_bounds__(MAX_THREADS)
siren_forward_kernel(const float* __restrict__ coords,
                     const float* __restrict__ z,
                     const float* __restrict__ w_first,
                     const float* __restrict__ w_mid,
                     const float* __restrict__ w_head,
                     const float* __restrict__ b_head,
                     float* __restrict__ out,
                     int T, int M, int C_in, int H, int n_mod, int C_out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // TP * H activation tile
  float* cs = xs + TP * H;              // TP * C_in coordinates
  int* zrow = reinterpret_cast<int*>(cs + TP * C_in);  // TP row offsets t*H

  const int j = threadIdx.x;
  const long long P = (long long)T * M;
  const long long p0 = (long long)blockIdx.x * TP;

  for (int i = j; i < TP * C_in; i += blockDim.x) {
    const long long q = p0 + i / C_in;
    cs[i] = q < P ? coords[(q % M) * C_in + i % C_in] : 0.f;
  }
  for (int p = j; p < TP; p += blockDim.x) {
    const long long q = p0 + p < P ? p0 + p : P - 1;
    zrow[p] = (int)(q / M) * H;
  }
  __syncthreads();

  float acc[TP];
  first_layer(cs, w_first, C_in, H, j, acc);
#pragma unroll
  for (int p = 0; p < TP; ++p) xs[p * H + j] = sin2pi(acc[p] + z[zrow[p] + j]);
  __syncthreads();

  for (int l = 1; l < n_mod; ++l) {
#pragma unroll
    for (int p = 0; p < TP; ++p) acc[p] = 0.f;
    tile_matmul(xs, w_mid + (size_t)(l - 1) * H * H, H, H, j, acc);
    __syncthreads();  // every thread has read the tile
    const float* zl = z + (size_t)l * T * H;
#pragma unroll
    for (int p = 0; p < TP; ++p) xs[p * H + j] = sin2pi(acc[p] + zl[zrow[p] + j]);
    __syncthreads();
  }

  // linear head: one warp per (pair, output), lanes stride over H
  const int warp = j >> 5, lane = j & 31, n_warps = H >> 5;
  for (int o_idx = warp; o_idx < TP * C_out; o_idx += n_warps) {
    const int p = o_idx / C_out, o = o_idx % C_out;
    float s = 0.f;
    for (int k = lane; k < H; k += 32) s = fmaf(xs[p * H + k], __ldg(w_head + k * C_out + o), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && p0 + p < P) out[(p0 + p) * C_out + o] = s + b_head[o];
  }
}

__global__ void __launch_bounds__(MAX_THREADS)
siren_dz_kernel(const float* __restrict__ coords,
                const float* __restrict__ z,
                const float* __restrict__ g,
                const float* __restrict__ w_first,
                const float* __restrict__ w_mid,
                const float* __restrict__ w_mid_t,
                const float* __restrict__ w_head,
                float* __restrict__ dz,
                float* __restrict__ workspace,
                int T, int M, int C_in, int H, int n_mod, int C_out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // TP * H: activations, then dpre
  float* dzs = xs + TP * H;             // n_mod * H row accumulators
  float* cs = dzs + n_mod * H;          // TP * C_in
  float* gs = cs + TP * C_in;           // TP * C_out

  const int j = threadIdx.x;
  // pre-activations of this block's chunk: [l][p][j]; thread j only ever
  // reads back what it wrote, so no synchronisation guards it
  float* pre = workspace + (size_t)blockIdx.x * n_mod * TP * H;

  for (int t = blockIdx.x; t < T; t += gridDim.x) {
    for (int l = 0; l < n_mod; ++l) dzs[l * H + j] = 0.f;

    for (int m0 = 0; m0 < M; m0 += TP) {
      __syncthreads();  // the previous chunk is done with cs, gs and xs
      for (int i = j; i < TP * C_in; i += blockDim.x) {
        const int m = m0 + i / C_in;
        cs[i] = m < M ? coords[(size_t)m * C_in + i % C_in] : 0.f;
      }
      for (int i = j; i < TP * C_out; i += blockDim.x) {
        const int m = m0 + i / C_out;
        // masked pairs get g = 0, so they add nothing to dz
        gs[i] = m < M ? g[((size_t)t * M + m) * C_out + i % C_out] : 0.f;
      }
      __syncthreads();

      // forward recompute, storing every pre-activation r_l
      float acc[TP];
      first_layer(cs, w_first, C_in, H, j, acc);
      {
        const float zj = z[(size_t)t * H + j];
#pragma unroll
        for (int p = 0; p < TP; ++p) {
          const float r = acc[p] + zj;
          pre[p * H + j] = r;
          xs[p * H + j] = sin2pi(r);
        }
      }
      __syncthreads();
      for (int l = 1; l < n_mod; ++l) {
#pragma unroll
        for (int p = 0; p < TP; ++p) acc[p] = 0.f;
        tile_matmul(xs, w_mid + (size_t)(l - 1) * H * H, H, H, j, acc);
        __syncthreads();
        const float zj = z[((size_t)l * T + t) * H + j];
        float* pre_l = pre + (size_t)l * TP * H;
#pragma unroll
        for (int p = 0; p < TP; ++p) {
          const float r = acc[p] + zj;
          pre_l[p * H + j] = r;
          xs[p * H + j] = sin2pi(r);
        }
        __syncthreads();
      }

      // backward: dx = g @ w_head^T, then per layer dpre = dx * 2pi cos2pi(r)
      float dx[TP];
#pragma unroll
      for (int p = 0; p < TP; ++p) dx[p] = 0.f;
      for (int o = 0; o < C_out; ++o) {
        const float w = __ldg(w_head + (size_t)j * C_out + o);
#pragma unroll
        for (int p = 0; p < TP; ++p) dx[p] = fmaf(gs[p * C_out + o], w, dx[p]);
      }
      for (int l = n_mod - 1; l >= 0; --l) {
        const float* pre_l = pre + (size_t)l * TP * H;
        float dsum = 0.f;
#pragma unroll
        for (int p = 0; p < TP; ++p) {
          dx[p] *= TWO_PI * sin2pi(pre_l[p * H + j] + 0.25f);  // d sin2pi / dr
          dsum += dx[p];
        }
        dzs[l * H + j] += dsum;
        if (l > 0) {
#pragma unroll
          for (int p = 0; p < TP; ++p) xs[p * H + j] = dx[p];
          __syncthreads();
#pragma unroll
          for (int p = 0; p < TP; ++p) acc[p] = 0.f;
          tile_matmul(xs, w_mid_t + (size_t)(l - 1) * H * H, H, H, j, acc);
          __syncthreads();
#pragma unroll
          for (int p = 0; p < TP; ++p) dx[p] = acc[p];
        }
      }
    }
    for (int l = 0; l < n_mod; ++l) dz[((size_t)l * T + t) * H + j] = dzs[l * H + j];
  }
}

size_t forward_smem_bytes(int H, int C_in) {
  return sizeof(float) * ((size_t)TP * H + (size_t)TP * C_in) + sizeof(int) * TP;
}

size_t dz_smem_bytes(int H, int n_mod, int C_in, int C_out) {
  return sizeof(float) * ((size_t)TP * H + (size_t)n_mod * H + (size_t)TP * (C_in + C_out));
}

}  // namespace

extern "C" {

int siren_tile_pairs() { return TP; }

int siren_decode_forward(const float* coords, const float* z, const float* w_first,
                         const float* w_mid, const float* w_head, const float* b_head,
                         float* out, int T, int M, int C_in, int H, int n_mod, int C_out,
                         void* stream) {
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = forward_smem_bytes(H, C_in);
  cudaError_t err = cudaFuncSetAttribute(siren_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)T * M;
  const unsigned int blocks = (unsigned int)((pairs + TP - 1) / TP);
  siren_forward_kernel<<<blocks, H, smem, (cudaStream_t)stream>>>(
      coords, z, w_first, w_mid, w_head, b_head, out, T, M, C_in, H, n_mod, C_out);
  return (int)cudaGetLastError();
}

int siren_decode_dz(const float* coords, const float* z, const float* g, const float* w_first,
                    const float* w_mid, const float* w_mid_t, const float* w_head, float* dz,
                    float* workspace, int grid, int T, int M, int C_in, int H, int n_mod,
                    int C_out, void* stream) {
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = dz_smem_bytes(H, n_mod, C_in, C_out);
  cudaError_t err = cudaFuncSetAttribute(siren_dz_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  siren_dz_kernel<<<grid, H, smem, (cudaStream_t)stream>>>(
      coords, z, g, w_first, w_mid, w_mid_t, w_head, dz, workspace, T, M, C_in, H, n_mod, C_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
