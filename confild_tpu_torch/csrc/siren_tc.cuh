// Tensor-core pieces shared by the SIREN-FiLM decode forward
// (siren_decode.cu, siren_fwd_kernel) and the training backward's chain
// (siren_decode_bwd.cu, siren_bwd_chain_kernel): the middle weights split
// once a call into 3xTF32 B fragments, and the product of a block's CP x H
// activation tile with one of them, streamed through a two-stage cp.async
// buffer of K-slices.
//
// A block owns CP = 64 (row, point) pairs (the M dimension of every
// product) and keeps their activations in shared memory, row stride
// H + A_PAD.  Eight warps each own H / 8 output columns for all 64 rows,
// 16 * H / 64 accumulators a thread.  Every product is a 3xTF32
// mma.sync.m16n8k8 (tf32_mma.cuh); the tensor cores truncate their own f32
// sums, so a fragment's products of two k8 steps go into a zeroed partial
// that a float32 add carries into the running sum.
#pragma once

#include <stdint.h>

#include "tf32_mma.cuh"

namespace siren_tc {

using namespace tf32mma;

constexpr int MAX_H = 384;       // widest hidden layer the accumulators' registers hold
constexpr int MAX_C = 4;         // widest C_in and C_out
constexpr int THREADS = 256;     // 8 warps
constexpr int CP = 64;           // pairs a block owns
constexpr int KS = 16;           // weight rows a streamed K-slice holds (two k8 steps)
constexpr int A_PAD = 4;         // activation row stride H + 4: A fragments hit 32 banks

// H a multiple of 64 up to MAX_H, C_in and C_out up to MAX_C
inline bool shape_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= MAX_H && n_mod >= 1 && C_in >= 1 && C_in <= MAX_C &&
         C_out >= 1 && C_out <= MAX_C;
}

// floats of one streamed K-slice: KS rows x H columns, big and small
__host__ __device__ inline int kslice_floats(int H) { return KS * H * 2; }

// ---------------------------------------------------------------------------
// weights: big and small halves in B-fragment order
// ---------------------------------------------------------------------------

// wsplit[i] for product i < n_prod: for i < n_mid it is B = w_mid[i]
// ([k][n]), the forward's products; for i >= n_mid it is
// B = w_mid[n_mid - 1 - (i - n_mid)]^T, the backward's dx chain (n_prod =
// n_mid for the forward alone, 2 n_mid for the training chain).  Within a
// product: [k8 block][n8 block][lane][big(t, g), big(t + 4, g), small(t, g),
// small(t + 4, g)], g = lane / 4, t = lane % 4 (the m16n8k8 B fragment).
__global__ void __launch_bounds__(THREADS)
siren_split_kernel(const float* __restrict__ w_mid, float* __restrict__ wsplit, int H,
                   int n_mid, int n_prod) {
  const int nb8 = H / 8;
  const long long per = (long long)nb8 * nb8 * 32;
  const long long total = (long long)n_prod * per;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(e / per);
    const int rem = (int)(e % per);
    const int lane = rem % 32, nb = (rem / 32) % nb8, kb = rem / 32 / nb8;
    const int g = lane >> 2, t = lane & 3;
    const int n = nb * 8 + g, k0 = kb * 8 + t, k1 = k0 + 4;
    float x0, x1;
    if (i < n_mid) {
      const float* w = w_mid + (size_t)i * H * H;
      x0 = w[(size_t)k0 * H + n];
      x1 = w[(size_t)k1 * H + n];
    } else {
      const float* w = w_mid + (size_t)(n_mid - 1 - (i - n_mid)) * H * H;
      x0 = w[(size_t)n * H + k0];
      x1 = w[(size_t)n * H + k1];
    }
    uint32_t b0, s0, b1, s1;
    split<false>(x0, b0, s0);
    split<false>(x1, b1, s1);
    reinterpret_cast<uint4*>(wsplit)[e] = make_uint4(b0, b1, s0, s1);
  }
}

// the split of n_prod products of H x H, on the stream
inline int launch_split(const float* w_mid, float* wsplit, int H, int n_mid, int n_prod,
                        cudaStream_t stream) {
  if (H <= 0 || H % 64 != 0 || n_mid < 1 || n_prod < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_prod * (H / 8) * (H / 8) * 32;
  const unsigned int blocks = (unsigned int)((items + THREADS - 1) / THREADS);
  siren_split_kernel<<<blocks, THREADS, 0, stream>>>(w_mid, wsplit, H, n_mid, n_prod);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the streamed product
// ---------------------------------------------------------------------------

// K-slice u of the whole weight stream, when there is one, into stage
// buffer u & 1
__device__ __forceinline__ void issue_kslice(float* stage, const float* wstream, int u,
                                             int u_total, int H) {
  const int n = kslice_floats(H);
  if (u >= u_total) return;
  float* dst = stage + (u & 1) * n;
  const float* src = wstream + (size_t)u * n;
  for (int i = threadIdx.x; i < n / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i, true);
  cp_async_commit();
}

// acc = A (CP x H in shared memory, row stride H + A_PAD) . B, B being the
// H / KS slices u .. u + H / KS - 1 of the weight stream.  On entry slice u
// is in flight into stage buffer u & 1; on exit the slice after the last
// is (when there is one), and u has moved past this product.
template <int NT>
__device__ __forceinline__ void chain_product(const float* As, float* stage,
                                              const float* wstream, int& u, int u_total,
                                              int H, float (&acc)[4][NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lda = H + A_PAD;
  const int nb8 = H / 8;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int s = 0; s < H / KS; ++s, ++u) {
    cp_async_wait_all();
    __syncthreads();  // slice u visible to all; every warp is done with slice u - 1
    issue_kslice(stage, wstream, u + 1, u_total, H);
    const float4* sb = reinterpret_cast<const float4*>(stage + (u & 1) * kslice_floats(H));
    // the slice's two k8 steps go into one zeroed partial per fragment
    uint32_t ab[2][4][4], as[2][4][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float* a = As + (mt * 16 + g) * lda + s * KS + kk * 8 + t;
        split<false>(a[0], ab[kk][mt][0], as[kk][mt][0]);
        split<false>(a[8 * lda], ab[kk][mt][1], as[kk][mt][1]);
        split<false>(a[4], ab[kk][mt][2], as[kk][mt][2]);
        split<false>(a[8 * lda + 4], ab[kk][mt][3], as[kk][mt][3]);
      }
    const float4* bf = sb + warp * NT * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bb[2][2], bs[2][2];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const float4 b = bf[(kk * nb8 + nt) * 32];
        bb[kk][0] = __float_as_uint(b.x);
        bb[kk][1] = __float_as_uint(b.y);
        bs[kk][0] = __float_as_uint(b.z);
        bs[kk][1] = __float_as_uint(b.w);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3_into<false, false>(part, ab[0][mt], as[0][mt], bb[0], bs[0]);
        mma3_into<false, false>(part, ab[1][mt], as[1][mt], bb[1], bs[1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
      }
    }
  }
}

// Fragment element e of (mt, nt) sits at row mt*16 + g + 8*(e/2), column
// warp*NT*8 + nt*8 + 2t + e%2.
template <int NT>
__device__ __forceinline__ void frag_pos(int mt, int nt, int h, int& row, int& col) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  row = mt * 16 + (lane >> 2) + 8 * h;
  col = (warp * NT + nt) * 8 + 2 * (lane & 3);
}

// the first layer on the CUDA cores, into the accumulator fragments:
// acc = coords . w_first (cs: CP x C_in in shared memory)
template <int NT>
__device__ __forceinline__ void first_layer_frags(const float* cs, const float* w_first,
                                                  int C_in, int H, float (&acc)[4][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        frag_pos<NT>(mt, nt, e / 2, row, col);
        col += e % 2;
        float a = 0.f;
        for (int c = 0; c < C_in; ++c)
          a = fmaf(cs[row * C_in + c], __ldg(w_first + (size_t)c * H + col), a);
        acc[mt][nt][e] = a;
      }
}

}  // namespace siren_tc
