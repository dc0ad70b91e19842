// SIREN-FiLM decode kernels for Hopper (sm_90a): float32 results, every
// hidden-by-hidden product on the tensor cores as 3xTF32.
//
// The kernel takes operands that the Python wrapper
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
//   wsplit  the middle weights (n_mod - 1, H, H) split into TF32 halves in
//           B-fragment order (siren_tc.cuh): the forward's n_mod - 1
//           products
//   w_head  (H, C_out), b_head (C_out)
//
// ---------------------------------------------------------------------------
// siren_decode_forward replaces the Pallas kernel _decode_kernel
// (confild_tpu/ops/siren_decode.py:96, launched at :177 by _fused_forward).
//
// Bound on the H100: operations.  Each (row, point) pair costs
// 2*H*(C_in + (n_mod-1)*H + C_out) flops (4.4 MFLOP at Case4) against 12
// bytes of coordinates and outputs.  With the products at the tensor
// cores' dense TF32 rate and three products each (495 / 3 TFLOP/s),
// 16 x 262144 pairs at Case4 take at least 112.6 ms.
//
// Design: the training chain's forward half (siren_decode_bwd.cu), without
// its workspace.  A block owns CP = 64 consecutive (row, point) pairs,
// p = t * M + m (the M dimension of every product), and keeps their
// 64 x H activations in shared memory for the whole layer stack.  Eight
// warps each own H / 8 output columns.  Every H x H product is a 3xTF32
// mma.sync.m16n8k8 (tf32_mma.cuh): the middle weights are split once a call
// (siren_split_kernel, the n_mod - 1 forward products only, 17.7 MB at
// Case4) and stream as 16-row K-slices through a two-stage cp.async buffer,
// in one stream across the layers, so the next layer's first slice loads
// while a layer's epilogue runs (chain_product, siren_tc.cuh).  The
// epilogue adds the FiLM row and applies sin2pi in place; nothing goes to
// global memory until the head.  The first layer (C_in columns) and the
// head (C_out columns, one warp per output, lanes striding over H, a
// shuffle tree) stay on the CUDA cores in float32.  The ragged last block
// is masked.  No atomics: two launches are bitwise equal.
// Known cost: every block rereads the whole split stream from L2, 64 pairs
// a read (1.16 TB per 16 x 262144 call at Case4).
//
// The dz kernel (the DPS guidance gradient) is the training chain's dz mode
// and lives with it in siren_decode_bwd.cu.
// ---------------------------------------------------------------------------

#include "siren_common.cuh"
#include "siren_tc.cuh"

namespace {

using siren::sin2pi;

// ---------------------------------------------------------------------------
// forward: eight warps over 64 pairs (siren_tc.cuh)
// ---------------------------------------------------------------------------

size_t fwd_smem_bytes(int H) {
  using namespace siren_tc;
  return sizeof(float) * ((size_t)CP * (H + A_PAD) + 2 * (size_t)kslice_floats(H) +
                          (size_t)CP * MAX_C) + sizeof(int) * CP;
}

template <int NT>
__global__ void __launch_bounds__(siren_tc::THREADS, 1)
siren_fwd_kernel(const float* __restrict__ coords,
                 const float* __restrict__ z,
                 const float* __restrict__ w_first,
                 const float* __restrict__ wstream,
                 const float* __restrict__ w_head,
                 const float* __restrict__ b_head,
                 float* __restrict__ out,
                 int T, int M, int C_in, int n_mod, int C_out) {
  using namespace siren_tc;
  constexpr int H = NT * 64;
  constexpr int lda = H + A_PAD;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                              // CP x (H + A_PAD) activations
  float* stage = As + CP * lda;                  // two K-slices
  float* cs = stage + 2 * kslice_floats(H);      // CP x C_in
  int* zrow = reinterpret_cast<int*>(cs + CP * MAX_C);  // CP row offsets t * H

  const int tid = threadIdx.x;
  const long long P = (long long)T * M;
  const long long p0 = (long long)blockIdx.x * CP;
  const int u_total = (n_mod - 1) * (H / KS);
  int u = 0;
  issue_kslice(stage, wstream, 0, u_total, H);

  for (int i = tid; i < CP * C_in; i += THREADS) {
    const long long q = p0 + i / C_in;
    cs[i] = q < P ? coords[(q % M) * C_in + i % C_in] : 0.f;
  }
  for (int p = tid; p < CP; p += THREADS) {
    const long long q = p0 + p < P ? p0 + p : P - 1;
    zrow[p] = (int)(q / M) * H;
  }
  __syncthreads();

  float acc[4][NT][4];
  // first layer on the CUDA cores: r_0 = coords . w_first + z_0
  first_layer_frags<NT>(cs, w_first, C_in, H, acc);
  for (int l = 0; l < n_mod; ++l) {
    if (l > 0) {
      chain_product<NT>(As, stage, wstream, u, u_total, H, acc);
      __syncthreads();  // every warp is done reading As
    }
    const float* zl = z + (size_t)l * T * H;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, col;
          frag_pos<NT>(mt, nt, h, row, col);
          const float2 zz = *reinterpret_cast<const float2*>(zl + zrow[row] + col);
          *reinterpret_cast<float2*>(As + row * lda + col) =
              make_float2(sin2pi(acc[mt][nt][2 * h] + zz.x), sin2pi(acc[mt][nt][2 * h + 1] + zz.y));
        }
  }
  __syncthreads();  // the last activations are complete

  // linear head on the CUDA cores: one warp per (pair, output), lanes
  // stride over H, then a shuffle tree
  const int warp = tid >> 5, lane = tid & 31;
  for (int o_idx = warp; o_idx < CP * C_out; o_idx += THREADS / 32) {
    const int p = o_idx / C_out, o = o_idx % C_out;
    float s = 0.f;
    for (int k = lane; k < H; k += 32) s = fmaf(As[p * lda + k], __ldg(w_head + k * C_out + o), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && p0 + p < P) out[(p0 + p) * C_out + o] = s + b_head[o];
  }
}

template <int NT>
int launch_fwd(const float* coords, const float* z, const float* w_first, const float* wsplit,
               const float* w_head, const float* b_head, float* out, int T, int M, int C_in,
               int n_mod, int C_out, cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = fwd_smem_bytes(NT * 64);
  cudaError_t err = tf32mma::allow_smem(siren_fwd_kernel<NT>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)T * M;
  const unsigned int blocks = (unsigned int)((pairs + siren_tc::CP - 1) / siren_tc::CP);
  siren_fwd_kernel<NT><<<blocks, siren_tc::THREADS, smem, stream>>>(
      coords, z, w_first, wsplit, w_head, b_head, out, T, M, C_in, n_mod, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int siren_fwd_shape_ok(int H, int n_mod, int C_in, int C_out) {
  return siren_tc::shape_ok(H, n_mod, C_in, C_out) ? 1 : 0;
}

// the forward's n_mid products only
int siren_fwd_split(const float* w_mid, float* wsplit, int H, int n_mid, void* stream) {
  return siren_tc::launch_split(w_mid, wsplit, H, n_mid, n_mid, (cudaStream_t)stream);
}

int siren_decode_forward(const float* coords, const float* z, const float* w_first,
                         const float* wsplit, const float* w_head, const float* b_head,
                         float* out, int T, int M, int C_in, int H, int n_mod, int C_out,
                         void* stream) {
  if (!siren_tc::shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 ||
      (long long)T * M > 2147483647LL * siren_tc::CP || (long long)T * H > 2147483647LL ||
      (n_mod > 1 && wsplit == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SIREN_FWD(NT)                                                                         \
  case NT:                                                                                    \
    return launch_fwd<NT>(coords, z, w_first, wsplit, w_head, b_head, out, T, M, C_in, n_mod, \
                          C_out, s);
  switch (H / 64) {
    SIREN_FWD(1)
    SIREN_FWD(2)
    SIREN_FWD(3)
    SIREN_FWD(4)
    SIREN_FWD(5)
    SIREN_FWD(6)
  }
#undef SIREN_FWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
