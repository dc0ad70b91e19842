// Tensor-core pieces shared by the SIREN-FiLM decode kernels: the middle
// weights split once a call into 3xTF32 B fragments, the product of a
// block's activation tile (its pairs x H) with one of them, streamed through a
// two-stage cp.async buffer of K-slices (the forward, siren_fwd_kernel in
// siren_decode.cu, and the chain), and the chain itself: a forward
// recompute then the dx chain, in two modes, the training backward's
// (siren_bwd_chain_kernel) and dz's (siren_dz_chain_kernel), both in
// siren_decode_bwd.cu.
//
// A block owns block_pairs(H) (row, point) pairs (the M dimension of every
// product: 64 up to H = 384, 32 at 448 and 512, and, for the bf16 forward
// alone, 16 from 576 to 1024) and keeps their activations in shared memory,
// row stride H + A_PAD.  Eight warps each own H / 8 output columns for all
// of the block's rows, 4 * m_tiles * H / 64 accumulators a thread (96 at
// H = 384 with 64 pairs, 64 at H = 512 with 32).  Every product is a
// 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh); the tensor cores truncate their
// own f32 sums, so a fragment's products of one K-slice (two k8 steps) go
// into a zeroed partial that a float32 add carries into the running sum.
// The float32 kernels here take H up to CHAIN_MAX_H; wider float32 widths
// are the cluster kernels' (siren_cluster.cuh).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "siren_common.cuh"
#include "tf32_mma.cuh"

namespace siren_tc {

using namespace tf32mma;

constexpr int MAX_H = 1024;      // widest hidden layer (the bf16 forward)
constexpr int CHAIN_MAX_H = 512; // widest of the float32 forward and the chain
constexpr int MAX_C = 16;        // widest C_in and C_out
constexpr int THREADS = 256;     // 8 warps
constexpr int WIDE_NT = 6;       // widest H / 64 whose blocks own 64 pairs
constexpr int MID_NT = 8;        // widest H / 64 whose blocks own 32 pairs
constexpr int A_PAD = 4;         // activation row stride H + 4: A fragments hit 32 banks

// m16 tiles of pairs a block owns at H = 64 NT: four (64 pairs) up to
// H = 384; two (32 pairs) at H = 448 and 512, where 64 pairs would need
// 112 and 128 accumulators a thread and, with the two K-slice stages, more
// than the 227 KB of shared memory a block may take; one (16 pairs) from
// H = 576 to 1024 (the bf16 forward), where 32 pairs would need 72 to 128
// accumulators
__host__ __device__ constexpr int m_tiles(int NT) {
  return NT <= WIDE_NT ? 4 : NT <= MID_NT ? 2 : 1;
}
// pairs a block owns at hidden width H
__host__ __device__ constexpr int block_pairs(int H) { return 16 * m_tiles(H / 64); }
// weight rows a streamed K-slice holds: two k8 steps
constexpr int KROWS = 16;

// H a multiple of 64 up to MAX_H, C_in and C_out up to MAX_C
inline bool shape_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= MAX_H && n_mod >= 1 && C_in >= 1 && C_in <= MAX_C &&
         C_out >= 1 && C_out <= MAX_C;
}

// f(std::integral_constant<int, H / 64>()) for the instantiation of width
// H up to WIDEST, or cudaErrorInvalidValue when there is none
template <int WIDEST, int NT = 1, typename F>
int with_width(int H, F&& f) {
  if (H == NT * 64) return f(std::integral_constant<int, NT>());
  if constexpr (NT < WIDEST / 64) {
    return with_width<WIDEST, NT + 1>(H, f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// floats of one streamed K-slice: KROWS rows x H columns, big and small
__host__ __device__ inline int kslice_floats(int H) { return KROWS * H * 2; }

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

// acc = A (block_pairs(H) x H in shared memory, row stride H + A_PAD) . B,
// B being the H / KROWS slices u .. u + H / KROWS - 1 of the weight
// stream.  On entry slice u is in flight into stage buffer u & 1; on exit
// the slice after the last is (when there is one), and u has moved past
// this product.
template <int NT>
__device__ __forceinline__ void chain_product(const float* As, float* stage,
                                              const float* wstream, int& u, int u_total,
                                              int H, float (&acc)[m_tiles(NT)][NT][4]) {
  static_assert(NT * 64 <= CHAIN_MAX_H, "the float32 kernels' widest H");
  constexpr int MT = m_tiles(NT), KS = KROWS, KK = KS / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lda = H + A_PAD;
  const int nb8 = H / 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int s = 0; s < H / KS; ++s, ++u) {
    cp_async_wait_all();
    __syncthreads();  // slice u visible to all; every warp is done with slice u - 1
    issue_kslice(stage, wstream, u + 1, u_total, H);
    const float4* sb = reinterpret_cast<const float4*>(stage + (u & 1) * kslice_floats(H));
    // the slice's k8 steps go into one zeroed partial per fragment
    uint32_t ab[KK][MT][4], as[KK][MT][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = As + (mt * 16 + g) * lda + s * KS + kk * 8 + t;
        split<false>(a[0], ab[kk][mt][0], as[kk][mt][0]);
        split<false>(a[8 * lda], ab[kk][mt][1], as[kk][mt][1]);
        split<false>(a[4], ab[kk][mt][2], as[kk][mt][2]);
        split<false>(a[8 * lda + 4], ab[kk][mt][3], as[kk][mt][3]);
      }
    const float4* bf = sb + warp * NT * 32 + lane;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bb[KK][2], bs[KK][2];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const float4 b = bf[(kk * nb8 + nt) * 32];
        bb[kk][0] = __float_as_uint(b.x);
        bb[kk][1] = __float_as_uint(b.y);
        bs[kk][0] = __float_as_uint(b.z);
        bs[kk][1] = __float_as_uint(b.w);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < KK; ++kk)
          mma3_into<false, false>(part, ab[kk][mt], as[kk][mt], bb[kk], bs[kk]);
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
// acc = coords . w_first (cs: the block's pairs x C_in in shared memory)
template <int NT>
__device__ __forceinline__ void first_layer_frags(const float* cs, const float* w_first,
                                                  int C_in, int H,
                                                  float (&acc)[m_tiles(NT)][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < m_tiles(NT); ++mt)
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

// ---------------------------------------------------------------------------
// the chain: forward recompute, then the dx chain
// ---------------------------------------------------------------------------

// dynamic shared memory of a chain block
inline size_t chain_smem_bytes(int H) {
  const size_t cp = block_pairs(H);
  return sizeof(float) * (cp * (H + A_PAD) + 2 * (size_t)kslice_floats(H) + 2 * cp * MAX_C) +
         sizeof(int) * cp;
}

// dz mode: thread j sums column j of the tile's first n rows (dpre of the
// block's pairs) in row order, one sum per latent row, into that row's
// slot: the row less the row of the block's first pair
template <int H>
__device__ __forceinline__ void row_sums(const float* As, const int* zrow, float* part, int n) {
  constexpr int lda = H + A_PAD;
  for (int j = threadIdx.x; j < H; j += THREADS) {
    int slot = 0;
    float s = 0.f;
    for (int r = 0; r < n; ++r) {
      const int rs = (zrow[r] - zrow[0]) / H;
      if (rs != slot) {
        part[(size_t)slot * H + j] = s;
        s = 0.f;
        slot = rs;
      }
      s += As[r * lda + j];
    }
    part[(size_t)slot * H + j] = s;
  }
}

// The chain over a block's CP = block_pairs(H) pairs q0 .. q0 + CP - 1
// (q0 = blockIdx.x * CP)
// of a chunk of Q pairs that starts at pair p0 (pair p = t * M + m): the
// forward recompute stores every pre-activation r_l in R[l][q][j] (layer
// stride Qa * H) and keeps sin2pi(r_l) as the next A; then the dx chain,
// dpre_l = dx_l * 2pi cos2pi(r_l) (r read back where this thread wrote it),
// dx_{l-1} = dpre_l . W_l^T.  wstream is the split of the forward's n_mod - 1
// products followed by the dx chain's (siren_split_kernel, n_prod =
// 2 (n_mod - 1)).
//
// Training mode (DZ false): out = D[l][q][j], every dpre_l.  dz mode: no D;
// after each layer the block sums dpre_l over its pairs, per latent row
// (row_sums), into out = parts[block][l][slot][j], slots per block.
template <int NT, bool DZ>
__device__ __forceinline__ void chain_body(float* smem, const float* __restrict__ coords,
                                           const float* __restrict__ z,
                                           const float* __restrict__ g,
                                           const float* __restrict__ w_first,
                                           const float* __restrict__ wstream,
                                           const float* __restrict__ w_head,
                                           float* __restrict__ R, float* __restrict__ out,
                                           long long p0, int Q, int Qa, int T, int M, int C_in,
                                           int n_mod, int C_out, int slots) {
  using siren::TWO_PI;
  using siren::sin2pi;
  constexpr int H = NT * 64;
  constexpr int lda = H + A_PAD;
  constexpr int CP = block_pairs(H), MT = m_tiles(NT);
  float* As = smem;                              // CP x (H + A_PAD): activations, then dpre
  float* stage = As + CP * lda;                  // two K-slices
  float* cs = stage + 2 * kslice_floats(H);      // CP x C_in
  float* gs = cs + CP * MAX_C;                   // CP x C_out
  int* zrow = reinterpret_cast<int*>(gs + CP * MAX_C);  // CP row offsets t * H

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * CP;
  const size_t lstride = (size_t)Qa * H;
  const int u_total = 2 * (n_mod - 1) * (H / KROWS);
  int u = 0;
  issue_kslice(stage, wstream, 0, u_total, H);

  for (int i = tid; i < CP * C_in; i += THREADS) {
    const int q = q0 + i / C_in;
    cs[i] = q < Q ? coords[((p0 + q) % M) * C_in + i % C_in] : 0.f;
  }
  for (int i = tid; i < CP * C_out; i += THREADS) {
    const int q = q0 + i / C_out;
    // masked pairs get g = 0, so their dpre is 0
    gs[i] = q < Q ? g[(p0 + q) * C_out + i % C_out] : 0.f;
  }
  for (int p = tid; p < CP; p += THREADS) {
    const int q = q0 + p < Q ? q0 + p : Q - 1;
    zrow[p] = (int)((p0 + q) / M) * H;
  }
  __syncthreads();

  float acc[MT][NT][4];
  // first layer on the CUDA cores: r_0 = coords . w_first + z_0
  first_layer_frags<NT>(cs, w_first, C_in, H, acc);

  // forward recompute: store r_l, keep sin2pi(r_l) as the next A
  for (int l = 0; l < n_mod; ++l) {
    if (l > 0) {
      chain_product<NT>(As, stage, wstream, u, u_total, H, acc);
      __syncthreads();  // every warp is done reading As
    }
    const float* zl = z + (size_t)l * T * H;
    float* Rl = R + l * lstride + (size_t)q0 * H;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, col;
          frag_pos<NT>(mt, nt, h, row, col);
          const float2 zz = *reinterpret_cast<const float2*>(zl + zrow[row] + col);
          const float2 r = make_float2(acc[mt][nt][2 * h] + zz.x, acc[mt][nt][2 * h + 1] + zz.y);
          *reinterpret_cast<float2*>(Rl + (size_t)row * H + col) = r;
          *reinterpret_cast<float2*>(As + row * lda + col) = make_float2(sin2pi(r.x), sin2pi(r.y));
        }
  }

  // backward, the head on the CUDA cores: dx = g . w_head^T
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        frag_pos<NT>(mt, nt, e / 2, row, col);
        col += e % 2;
        float a = 0.f;
        for (int o = 0; o < C_out; ++o)
          a = fmaf(gs[row * C_out + o], __ldg(w_head + (size_t)col * C_out + o), a);
        acc[mt][nt][e] = a;
      }
  // per layer dpre = dx * 2pi cos2pi(r) (r read back where this thread wrote
  // it), then dx = dpre . W_l^T
  for (int l = n_mod - 1; l >= 0; --l) {
    const float* Rl = R + l * lstride + (size_t)q0 * H;
    float* Dl = out + l * lstride + (size_t)q0 * H;  // training mode
    // every warp is done reading As (the last product's final K-slice has
    // no barrier after it); training mode writes no As at l = 0
    if (DZ || l > 0) __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int row, col;
          frag_pos<NT>(mt, nt, h, row, col);
          const float2 r = *reinterpret_cast<const float2*>(Rl + (size_t)row * H + col);
          float2 d;
          d.x = acc[mt][nt][2 * h] * (TWO_PI * sin2pi(r.x + 0.25f));  // d sin2pi / dr
          d.y = acc[mt][nt][2 * h + 1] * (TWO_PI * sin2pi(r.y + 0.25f));
          if constexpr (!DZ) *reinterpret_cast<float2*>(Dl + (size_t)row * H + col) = d;
          if (DZ || l > 0) *reinterpret_cast<float2*>(As + row * lda + col) = d;
        }
    if constexpr (DZ) {
      __syncthreads();  // As holds dpre_l of every pair
      row_sums<H>(As, zrow, out + ((size_t)blockIdx.x * n_mod + l) * slots * H, min(CP, Q - q0));
    }
    if (l > 0) chain_product<NT>(As, stage, wstream, u, u_total, H, acc);
  }
}

}  // namespace siren_tc
