// The SIREN-FiLM decode forward with bfloat16 operands for Hopper (sm_90a):
// float32 results, every product on the tensor cores.  The float32 forward
// is siren_fwd_cluster.cu's.
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
//   wfrag   the middle weights (n_mod - 1, H, H) rounded to bf16 in
//           B-fragment order (siren_bf16_frag_kernel)
//   w_head  (H, C_out), b_head (C_out)
//
// ---------------------------------------------------------------------------
// siren_decode_forward_bf16 replaces the Pallas kernel _decode_kernel
// (confild_tpu/ops/siren_decode.py:96, launched at :177 by _fused_forward)
// with the JAX kernel's compute_dtype = bfloat16 (_decode_kernel's mxu
// helper, siren_decode.py:109-111): both operands of every product (coords x w_first, activations x
// w_mid[l], activations x w_head) are rounded to bf16, the weights after the
// w0 / (2*pi) scale, and the products accumulate in float32; the FiLM row,
// the bias and sin2pi stay float32.
//
// Bound on the H100: operations.  The same 4.4 MFLOP a pair at Case4, at the
// tensor cores' dense bf16 rate (989 TFLOP/s, one product where 3xTF32 takes
// three), beside the sines on the CUDA cores (6144 a pair at Case4, about 15
// flops each at 67 TFLOP/s); 16 x 262144 pairs take at least 18.8 ms of
// products and 5.8 ms of sines.
//
// Design: mma.sync.m16n8k16.bf16 with an f32 accumulator, at every H up to
// 1024.  A block owns CP pairs (64 up to H = 384, 32 at 448 and 512, 16
// from 576 to 1024, siren_tc.cuh::block_pairs) and keeps their activations
// in shared memory as bf16 (the rounding JAX applies at the next product), row
// stride H + 8 so that A fragments hit 32 banks.  Eight warps each own H / 8
// output columns.  The middle weights are rounded to bf16 once a call, in
// B-fragment order (siren_bf16_frag_kernel: no split, half the bytes of one
// TF32 half), and stream as 32-row K-slices (two k16 steps) through a
// two-stage cp.async buffer, one stream across the layers.  The first layer
// is one m16n8k16 per fragment with K = C_in padded to 16 by zeros, and the
// head one per warp of 16 pairs and n8 block of outputs, N = C_out padded
// to a multiple of 8, so
// every product is a tensor-core product on bf16 operands.  The products
// accumulate in the mma's float32 accumulator: the tensor cores' truncation
// of their sums (2^-23 relative an add) is far below the bf16 rounding of
// the operands (2^-9).  The ragged last block is masked.  No atomics: two
// launches are bitwise equal.  Every block reads the whole bf16 stream from
// L2 (4.4 MB at Case4, 0.29 TB per 16 x 262144 call).
//
// The dz kernel (the DPS guidance gradient) is the cluster chain's dz mode
// (siren_chain_cluster.cu); as in JAX it runs in float32 whatever the
// forward's compute dtype.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>

#include "siren_common.cuh"
#include "siren_tc.cuh"

namespace {

using siren::sin2pi;

// ---------------------------------------------------------------------------
// forward, compute dtype bfloat16: mma.sync.m16n8k16 on bf16 operands
// ---------------------------------------------------------------------------

constexpr int KS16 = 32;      // weight rows a streamed K-slice holds (two k16 steps)
constexpr int A_PAD16 = 8;    // bf16 activation row stride H + 8: A fragments hit 32 banks

// lo in the low half, as the mma reads the smaller k index of a pair
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b, bf16 operands, float32 accumulator.  A (16 x 16): a[0] row g,
// columns 2t, 2t + 1; a[1] row g + 8; a[2], a[3] the same rows, columns + 8.
// B (16 x 8): b[0] rows 2t, 2t + 1 of column g; b[1] rows + 8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// uint2 B fragments of one streamed K-slice: two k16 blocks x H / 8 n8 blocks
// x 32 lanes
__host__ __device__ inline int kslice16_frags(int H) { return 2 * (H / 8) * 32; }

// w_mid (n_mid, H, H) [k][n], scaled, rounded to bf16 in B-fragment order:
// [product][k16 block][n8 block][lane] {b0, b1}
__global__ void __launch_bounds__(siren_tc::THREADS)
siren_bf16_frag_kernel(const float* __restrict__ w_mid, uint2* __restrict__ wfrag, int H,
                       int n_mid) {
  const int nb8 = H / 8;
  const long long per = (long long)(H / 16) * nb8 * 32;
  const long long total = (long long)n_mid * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int rem = (int)(e % per);
    const int lane = rem % 32, nb = (rem / 32) % nb8, kb = rem / 32 / nb8;
    const int n = nb * 8 + (lane >> 2), k = kb * 16 + 2 * (lane & 3);
    const float* w = w_mid + (size_t)(e / per) * H * H + n;
    wfrag[e] = make_uint2(pack_bf16(w[(size_t)k * H], w[(size_t)(k + 1) * H]),
                          pack_bf16(w[(size_t)(k + 8) * H], w[(size_t)(k + 9) * H]));
  }
}

// K-slice u of the fragment stream, when there is one, into stage buffer u & 1
__device__ __forceinline__ void issue_kslice16(uint2* stage, const uint2* wfrag, int u,
                                               int u_total, int H) {
  const int n = kslice16_frags(H);
  if (u >= u_total) return;
  uint2* dst = stage + (u & 1) * n;
  const uint2* src = wfrag + (size_t)u * n;
  for (int i = threadIdx.x; i < n / 2; i += siren_tc::THREADS)
    tf32mma::cp_async16(dst + 2 * i, src + 2 * i, true);
  tf32mma::cp_async_commit();
}

// acc = A (CP x H bf16 in shared memory, row stride H + A_PAD16) . B, B being
// the H / KS16 slices u .. of the fragment stream.  On entry slice u is in
// flight into stage buffer u & 1; each slice waits for its copy and a block
// barrier, then issues the next slice's copy before its products.
template <int NT>
__device__ __forceinline__ void bf16_product(const __nv_bfloat16* As, uint2* stage,
                                             const uint2* wfrag, int& u, int u_total,
                                             float (&acc)[siren_tc::m_tiles(NT)][NT][4]) {
  constexpr int H = NT * 64, lda2 = (H + A_PAD16) / 2, nb8 = H / 8;
  constexpr int MT = siren_tc::m_tiles(NT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* A32 = reinterpret_cast<const uint32_t*>(As);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int s = 0; s < H / KS16; ++s, ++u) {
    tf32mma::cp_async_wait_all();
    __syncthreads();  // slice u visible to all; every warp is done with slice u - 1
    issue_kslice16(stage, wfrag, u + 1, u_total, H);
    const uint2* sb = stage + (u & 1) * kslice16_frags(H) + warp * NT * 32 + lane;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kw = (s * KS16 + kk * 16) / 2 + t;   // the word of columns 2t, 2t + 1
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* r = A32 + (mt * 16 + g) * lda2 + kw;
        a[mt][0] = r[0];
        a[mt][1] = r[8 * lda2];
        a[mt][2] = r[4];
        a[mt][3] = r[8 * lda2 + 4];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint2 b = sb[(kk * nb8 + nt) * 32];
        const uint32_t bb[2] = {b.x, b.y};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], bb);
      }
    }
  }
}

size_t fwd_bf16_smem_bytes(int H) {
  using namespace siren_tc;
  const size_t cp = block_pairs(H);
  return sizeof(__nv_bfloat16) * cp * (H + A_PAD16) +
         sizeof(uint2) * 2 * (size_t)kslice16_frags(H) + sizeof(float) * cp * MAX_C +
         sizeof(int) * cp;
}

template <int NT>
__global__ void __launch_bounds__(siren_tc::THREADS, 1)
siren_fwd_bf16_kernel(const float* __restrict__ coords,
                      const float* __restrict__ z,
                      const float* __restrict__ w_first,
                      const uint2* __restrict__ wfrag,
                      const float* __restrict__ w_head,
                      const float* __restrict__ b_head,
                      float* __restrict__ out,
                      int T, int M, int C_in, int n_mod, int C_out) {
  using namespace siren_tc;
  constexpr int H = NT * 64;
  constexpr int lda2 = (H + A_PAD16) / 2;        // words of a bf16 activation row
  constexpr int CP = block_pairs(H), MT = m_tiles(NT);
  extern __shared__ __align__(16) unsigned char smem16[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem16);   // CP x (H + A_PAD16)
  uint32_t* A32 = reinterpret_cast<uint32_t*>(As);
  uint2* stage = reinterpret_cast<uint2*>(As + CP * (H + A_PAD16));   // two K-slices
  float* cs = reinterpret_cast<float*>(stage + 2 * kslice16_frags(H));   // CP x C_in
  int* zrow = reinterpret_cast<int*>(cs + CP * MAX_C);   // CP row offsets t * H

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long P = (long long)T * M;
  const long long p0 = (long long)blockIdx.x * CP;
  const int u_total = (n_mod - 1) * (H / KS16);
  int u = 0;
  issue_kslice16(stage, wfrag, 0, u_total, H);

  for (int i = tid; i < CP * C_in; i += THREADS) {
    const long long q = p0 + i / C_in;
    cs[i] = q < P ? coords[(q % M) * C_in + i % C_in] : 0.f;
  }
  for (int p = tid; p < CP; p += THREADS) {
    const long long q = p0 + p < P ? p0 + p : P - 1;
    zrow[p] = (int)(q / M) * H;
  }
  __syncthreads();

  float acc[MT][NT][4];
  {  // first layer: coords . w_first, K = C_in padded to 16 by zeros
    uint32_t a[MT][4];
    auto cv = [&](int row, int c) { return c < C_in ? cs[row * C_in + c] : 0.f; };
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = mt * 16 + g;
      a[mt][0] = pack_bf16(cv(row, 2 * t), cv(row, 2 * t + 1));
      a[mt][1] = pack_bf16(cv(row + 8, 2 * t), cv(row + 8, 2 * t + 1));
      a[mt][2] = pack_bf16(cv(row, 2 * t + 8), cv(row, 2 * t + 9));
      a[mt][3] = pack_bf16(cv(row + 8, 2 * t + 8), cv(row + 8, 2 * t + 9));
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = (warp * NT + nt) * 8 + g;
      auto wv = [&](int c) { return c < C_in ? __ldg(w_first + (size_t)c * H + n) : 0.f; };
      const uint32_t b[2] = {pack_bf16(wv(2 * t), wv(2 * t + 1)),
                             pack_bf16(wv(2 * t + 8), wv(2 * t + 9))};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  }
  for (int l = 0; l < n_mod; ++l) {
    if (l > 0) {
      bf16_product<NT>(As, stage, wfrag, u, u_total, acc);
      __syncthreads();  // every warp is done reading As
    }
    const float* zl = z + (size_t)l * T * H;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, col;
          frag_pos<NT>(mt, nt, h, row, col);
          const float2 zz = *reinterpret_cast<const float2*>(zl + zrow[row] + col);
          A32[row * lda2 + col / 2] = pack_bf16(sin2pi(acc[mt][nt][2 * h] + zz.x),
                                                sin2pi(acc[mt][nt][2 * h + 1] + zz.y));
        }
  }
  __syncthreads();  // the last activations are complete

  // linear head: warp w < MT owns pairs 16w .. 16w + 15 and takes the
  // outputs 8 at a time, N = C_out padded to a multiple of 8
  if (warp < MT) {
    for (int n0 = 0; n0 < C_out; n0 += 8) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      auto wv = [&](int k) {
        return n0 + g < C_out ? __ldg(w_head + (size_t)k * C_out + n0 + g) : 0.f;
      };
      for (int kb = 0; kb < H / 16; ++kb) {
        const uint32_t* r = A32 + (warp * 16 + g) * lda2 + kb * 8 + t;
        const uint32_t a[4] = {r[0], r[8 * lda2], r[4], r[8 * lda2 + 4]};
        const int k = kb * 16 + 2 * t;
        const uint32_t b[2] = {pack_bf16(wv(k), wv(k + 1)), pack_bf16(wv(k + 8), wv(k + 9))};
        mma_bf16(c, a, b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e / 2), col = n0 + 2 * t + e % 2;
        if (col < C_out && p0 + row < P) out[(p0 + row) * C_out + col] = c[e] + b_head[col];
      }
    }
  }
}

template <int NT>
int launch_fwd_bf16(const float* coords, const float* z, const float* w_first,
                    const uint2* wfrag, const float* w_head, const float* b_head, float* out,
                    int T, int M, int C_in, int n_mod, int C_out, cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = fwd_bf16_smem_bytes(NT * 64);
  cudaError_t err = tf32mma::allow_smem(siren_fwd_bf16_kernel<NT>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)T * M, cp = siren_tc::block_pairs(NT * 64);
  const unsigned int blocks = (unsigned int)((pairs + cp - 1) / cp);
  siren_fwd_bf16_kernel<NT><<<blocks, siren_tc::THREADS, smem, stream>>>(
      coords, z, w_first, wfrag, w_head, b_head, out, T, M, C_in, n_mod, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pairs a block of the bf16 forward owns at hidden width H
int siren_fwd_bf16_pairs(int H) { return siren_tc::block_pairs(H); }

// compute dtype bfloat16: the n_mid middle weights as bf16 B fragments
int siren_fwd_bf16_frags(const float* w_mid, void* wfrag, int H, int n_mid, void* stream) {
  if (H <= 0 || H % 64 != 0 || n_mid < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_mid * (H / 16) * (H / 8) * 32;
  const unsigned int blocks = (unsigned int)((items + siren_tc::THREADS - 1) / siren_tc::THREADS);
  siren_bf16_frag_kernel<<<blocks, siren_tc::THREADS, 0, (cudaStream_t)stream>>>(
      w_mid, (uint2*)wfrag, H, n_mid);
  return (int)cudaGetLastError();
}

int siren_decode_forward_bf16(const float* coords, const float* z, const float* w_first,
                              const void* wfrag, const float* w_head, const float* b_head,
                              float* out, int T, int M, int C_in, int H, int n_mod, int C_out,
                              void* stream) {
  if (!siren_tc::shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 ||
      (long long)T * M > 2147483647LL * siren_tc::block_pairs(H) || (long long)T * H > 2147483647LL ||
      (n_mod > 1 && wfrag == nullptr))
    return (int)cudaErrorInvalidValue;
  return siren_tc::with_width<siren_tc::MAX_H>(H, [&](auto nt) {
    return launch_fwd_bf16<decltype(nt)::value>(coords, z, w_first, (const uint2*)wfrag,
                                                 w_head, b_head, out, T, M, C_in, n_mod,
                                                 C_out, (cudaStream_t)stream);
  });
}

}  // extern "C"
