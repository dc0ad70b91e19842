// SIREN-FiLM training backward for Hopper (sm_90a), float32 throughout.
//
// Replaces the Pallas kernel _decode_bwd_kernel
// (confild_tpu/ops/siren_decode.py:434, launched at :523 by
// fused_siren_decode_bwd): every training cotangent of the decode on the
// folded operands of siren_decode.cu (w_first, w_mid and z scaled by
// w0 / (2*pi)):
//
//   dz      (n_mod, T, H)      dL/dz_l, summed over the points of each row
//   dw_first(C_in, H)          coords^T . (sum over rows of dpre_0)
//   dw_mid  (n_mod - 1, H, H)  sin2pi(r_{l-1})^T . dpre_l
//   dw_head (H, C_out)         sin2pi(r_last)^T . g
//
// with dpre_l = dx_l * 2*pi*cos2pi(r_l) and dx_{l-1} = dpre_l . W_l^T.
//
// Bound on the H100: operations.  A pair costs a forward recompute, the
// dx chain and the dW products, about three times the forward's flops
// (13.3 MFLOP at Case4), against 24 bytes of coordinates and cotangent.
//
// Design.  The TPU kernel keeps the 8.8 MB dW_mid accumulator in VMEM
// across a sequential grid.  Hopper blocks run in no order and a block has
// 227 KB of shared memory, so the work is split in two kernels over a
// chunk of Q consecutive (row, point) pairs (p = t * M + m):
//
// * siren_bwd_chain_kernel: a block owns TP pairs, one thread per hidden
//   unit, as the forward kernel does.  It recomputes the forward and walks
//   the dx chain back, writing every pre-activation r_l and every dpre_l of
//   its pairs to a global workspace (2 * n_mod * Q * H floats; only the
//   writing thread reads its r_l back).
// * siren_bwd_reduce_kernel: every output element (of dw_mid, dw_head,
//   dw_first and dz) is a sum over the chunk's pairs of a product of two
//   workspace columns: out[a][b] += sum_q A[q][a] * B[q][b].  A block owns
//   a 64 x 64 output tile and walks the pairs in steps of 16 through shared
//   memory; A is sin2pi(r) (applied as the tile is loaded), the coordinates
//   of the pair's point, or the 0/1 indicator of the pair's row (dz).
//   Each thread sums RSEG steps (512 pairs) apart before adding them to its
//   total: a single running f32 sum over a 32768-pair chunk lost about 2.5x
//   the accuracy of the plain version's cuBLAS product at Case4.
//
// The host runs the two kernels chunk after chunk on one stream.  Each
// output element is owned by one thread, which adds its chunk sum to the
// running total: no atomics, a fixed summation order, bitwise the same
// result from run to run.  Matrix products on the tensor cores, wgmma and
// TMA are left for later work; this keeps the JAX kernel's f32 arithmetic.
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

constexpr int RT = 64;           // output tile of the reduction product
constexpr int RK = 16;           // pairs per shared-memory step
constexpr int RTHREADS = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int RSEG = 32;         // steps summed apart before joining the total

enum AMode { A_SIN = 0, A_COORD = 1, A_ROW = 2 };

// Workspace: R[l][q][j] and D[l][q][j], layer stride Qa * H.
__global__ void __launch_bounds__(MAX_THREADS)
siren_bwd_chain_kernel(const float* __restrict__ coords,
                       const float* __restrict__ z,
                       const float* __restrict__ g,
                       const float* __restrict__ w_first,
                       const float* __restrict__ w_mid,
                       const float* __restrict__ w_mid_t,
                       const float* __restrict__ w_head,
                       float* __restrict__ R,
                       float* __restrict__ D,
                       long long p0, int Q, int Qa, int T, int M, int C_in,
                       int H, int n_mod, int C_out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // TP * H: activations, then dpre
  float* cs = xs + TP * H;              // TP * C_in
  float* gs = cs + TP * C_in;           // TP * C_out
  int* zrow = reinterpret_cast<int*>(gs + TP * C_out);  // TP row offsets t*H

  const int j = threadIdx.x;
  const int q0 = blockIdx.x * TP;
  const size_t lstride = (size_t)Qa * H;
  float* Rb = R + (size_t)q0 * H;
  float* Db = D + (size_t)q0 * H;

  for (int i = j; i < TP * C_in; i += blockDim.x) {
    const int q = q0 + i / C_in;
    cs[i] = q < Q ? coords[((p0 + q) % M) * C_in + i % C_in] : 0.f;
  }
  for (int i = j; i < TP * C_out; i += blockDim.x) {
    const int q = q0 + i / C_out;
    // masked pairs get g = 0, so their dpre is 0
    gs[i] = q < Q ? g[(p0 + q) * C_out + i % C_out] : 0.f;
  }
  for (int p = j; p < TP; p += blockDim.x) {
    const int q = q0 + p < Q ? q0 + p : Q - 1;
    zrow[p] = (int)((p0 + q) / M) * H;
  }
  __syncthreads();

  // forward recompute, storing every pre-activation r_l
  float acc[TP];
  first_layer(cs, w_first, C_in, H, j, acc);
#pragma unroll
  for (int p = 0; p < TP; ++p) {
    const float r = acc[p] + z[zrow[p] + j];
    Rb[p * H + j] = r;
    xs[p * H + j] = sin2pi(r);
  }
  __syncthreads();
  for (int l = 1; l < n_mod; ++l) {
#pragma unroll
    for (int p = 0; p < TP; ++p) acc[p] = 0.f;
    tile_matmul(xs, w_mid + (size_t)(l - 1) * H * H, H, H, j, acc);
    __syncthreads();  // every thread has read the tile
    const float* zl = z + (size_t)l * T * H;
    float* Rl = Rb + l * lstride;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const float r = acc[p] + zl[zrow[p] + j];
      Rl[p * H + j] = r;
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
    const float* Rl = Rb + l * lstride;
    float* Dl = Db + l * lstride;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      dx[p] *= TWO_PI * sin2pi(Rl[p * H + j] + 0.25f);  // d sin2pi / dr
      Dl[p * H + j] = dx[p];
    }
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

// Jobs (blockIdx.y): 0 .. n_mod-2 dw_mid[l] = sin(R[l])^T D[l+1];
// n_mod-1 dw_head = sin(R[last])^T g; n_mod dw_first = coords^T D[0];
// n_mod+1+l dz[l][rows] = indicator^T D[l].  blockIdx.x walks the job's
// 64 x 64 output tiles; surplus blocks return.
__global__ void __launch_bounds__(RTHREADS)
siren_bwd_reduce_kernel(const float* __restrict__ R,
                        const float* __restrict__ D,
                        const float* __restrict__ coords,
                        const float* __restrict__ g,
                        float* __restrict__ dz,
                        float* __restrict__ dw_first,
                        float* __restrict__ dw_mid,
                        float* __restrict__ dw_head,
                        long long p0, int Q, int Qa, int T, int M, int C_in,
                        int H, int n_mod, int C_out) {
  __shared__ __align__(16) float As[RK][RT];
  __shared__ __align__(16) float Bs[RK][RT];

  const int job = blockIdx.y;
  const size_t lstride = (size_t)Qa * H;
  const long long t0 = p0 / M;
  const int n_rows = (int)((p0 + Q - 1) / M - t0 + 1);

  int amode, na, nb, ldb, ldo;
  const float* A = nullptr;
  const float* B;
  float* out;
  if (job < n_mod - 1) {
    amode = A_SIN; A = R + job * lstride; na = H;
    B = D + (job + 1) * lstride; nb = H; ldb = H;
    out = dw_mid + (size_t)job * H * H; ldo = H;
  } else if (job == n_mod - 1) {
    amode = A_SIN; A = R + job * lstride; na = H;
    B = g + p0 * C_out; nb = C_out; ldb = C_out;
    out = dw_head; ldo = C_out;
  } else if (job == n_mod) {
    amode = A_COORD; na = C_in;
    B = D; nb = H; ldb = H;
    out = dw_first; ldo = H;
  } else {
    const int l = job - n_mod - 1;
    amode = A_ROW; na = n_rows;
    B = D + l * lstride; nb = H; ldb = H;
    out = dz + ((size_t)l * T + t0) * H; ldo = H;
  }
  const int tiles_b = (nb + RT - 1) / RT;
  const int tiles_a = (na + RT - 1) / RT;
  if ((int)blockIdx.x >= tiles_a * tiles_b) return;
  const int a0 = (blockIdx.x / tiles_b) * RT;
  const int b0 = (blockIdx.x % tiles_b) * RT;

  int q_begin = 0, q_end = Q;
  if (amode == A_ROW) {  // only the pairs of this tile's rows
    const long long lo = (t0 + a0) * M - p0, hi = (t0 + a0 + RT) * M - p0;
    q_begin = lo > 0 ? (int)lo : 0;
    q_end = hi < Q ? (int)hi : Q;
  }

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = part[i][k] = 0.f;

  int seg = 0;
  for (int q = q_begin; q < q_end; q += RK) {
    for (int e = tid; e < RK * RT; e += RTHREADS) {
      const int k = e / RT, c = e % RT, qq = q + k;
      float av = 0.f, bv = 0.f;
      if (qq < q_end) {
        const int a = a0 + c, b = b0 + c;
        if (a < na) {
          if (amode == A_SIN) av = sin2pi(A[(size_t)qq * H + a]);
          else if (amode == A_COORD) av = coords[((p0 + qq) % M) * C_in + a];
          else av = (p0 + qq) / M == t0 + a ? 1.f : 0.f;
        }
        if (b < nb) bv = B[(size_t)qq * ldb + b];
      }
      As[k][c] = av;
      Bs[k][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < RK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) part[i][n] = fmaf(av[i], bv[n], part[i][n]);
    }
    __syncthreads();
    if (++seg == RSEG) {
      seg = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          acc[i][n] += part[i][n];
          part[i][n] = 0.f;
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[i][n] += part[i][n];

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= na) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int b = b0 + tx * 4 + n;
      if (b < nb) out[(size_t)a * ldo + b] += acc[i][n];
    }
  }
}

size_t chain_smem_bytes(int H, int C_in, int C_out) {
  return sizeof(float) * ((size_t)TP * H + (size_t)TP * (C_in + C_out)) + sizeof(int) * TP;
}

}  // namespace

extern "C" {

int siren_bwd_tile_pairs() { return TP; }

int siren_bwd_chain(const float* coords, const float* z, const float* g, const float* w_first,
                    const float* w_mid, const float* w_mid_t, const float* w_head, float* R,
                    float* D, long long p0, int Q, int Qa, int T, int M, int C_in, int H,
                    int n_mod, int C_out, void* stream) {
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q)
    return (int)cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(H, C_in, C_out);
  cudaError_t err = cudaFuncSetAttribute(siren_bwd_chain_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)((Q + TP - 1) / TP);
  siren_bwd_chain_kernel<<<blocks, H, smem, (cudaStream_t)stream>>>(
      coords, z, g, w_first, w_mid, w_mid_t, w_head, R, D, p0, Q, Qa, T, M, C_in, H, n_mod,
      C_out);
  return (int)cudaGetLastError();
}

int siren_bwd_reduce(const float* R, const float* D, const float* coords, const float* g,
                     float* dz, float* dw_first, float* dw_mid, float* dw_head, long long p0,
                     int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
                     void* stream) {
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q)
    return (int)cudaErrorInvalidValue;
  const long long t0 = p0 / M;
  const int n_rows = (int)((p0 + Q - 1) / M - t0 + 1);
  const int th = (H + RT - 1) / RT;
  const int tc_in = (C_in + RT - 1) / RT, tc_out = (C_out + RT - 1) / RT;
  int tiles = th * th;
  tiles = tiles > th * tc_out ? tiles : th * tc_out;
  tiles = tiles > tc_in * th ? tiles : tc_in * th;
  const int t_rows = ((n_rows + RT - 1) / RT) * th;
  tiles = tiles > t_rows ? tiles : t_rows;
  const dim3 grid((unsigned int)tiles, (unsigned int)(2 * n_mod + 1));
  siren_bwd_reduce_kernel<<<grid, RTHREADS, 0, (cudaStream_t)stream>>>(
      R, D, coords, g, dz, dw_first, dw_mid, dw_head, p0, Q, Qa, T, M, C_in, H, n_mod, C_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
