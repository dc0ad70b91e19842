// The SIREN-FiLM decode forward, float32 and bf16, as a thread-block
// cluster kernel for Hopper (sm_90a): wgmma on the tensor cores (3xTF32, or
// one bf16 product), the weights streamed by bulk asynchronous copies into a
// ring of shared-memory stages, the activations spread over the cluster's
// blocks and read through distributed shared memory.
//
// siren_decode_forward_cluster and siren_decode_forward_cluster_bf16
// replace the Pallas kernel _decode_kernel (confild_tpu/ops/siren_decode.py:96,
// launched at :177 by _fused_forward) with compute_dtype float32 and
// bfloat16 at every hidden width up to 3072.  Operands as the wrapper
// (confild_tpu_torch/ops/siren_decode.py) folds them: the first and middle
// weights and the FiLM table z scaled by w0 / (2 pi), so the activation is
// sin2pi(r) = sin(2 pi r), the JAX package's odd minimax polynomial
// (confild_tpu/ops/siren_decode.py:52-69; not __sinf, which is inaccurate
// at the large arguments w0 = 30 gives).
//   coords  (M, C_in)        z (n_mod, T, H)       w_first (C_in, H)
//   wprep   the middle weights (n_mod - 1, H, H) as the stages'
//           shared-memory images: split into TF32 halves
//           (siren_fwd_cluster_prep), or rounded to bf16
//           (siren_fwd_cluster_prep_bf16)
//   w_head  (H, C_out)       b_head (C_out)        out (T, M, C_out)
// H is a width the cluster plan gives (plan_for): CL blocks of S columns.
//
// Bound on the H100: operations.  A (row, point) pair costs 2 H (C_in +
// (n_mod - 1) H + C_out) flops, the (n_mod - 1) H x H products on the tensor
// cores, in float32 at the dense TF32 rate over three products each (495 /
// 3 TFLOP/s): 4 x 262144 pairs at 16 modulated layers of 1024 take at least
// 200 ms, 16 x 262144 at Case4 (16 of 384) 112.6 ms.  A design of blocks
// that each hold their pairs' full activation rows (16 pairs at H = 1024,
// 64 at Case4) is bound instead by its L2 weight stream: every block rereads
// the whole split stream, 8.25 TB a call at the first shape, 1.16 TB at the
// second (the HMMA forward this kernel replaced at H <= 512 ran at that
// stream's rate, 343 ms at Case4).
//
// Design.  A cluster of CL blocks owns P = 64 MT consecutive pairs, p = t M
// + m (MT m64 tiles: 128 pairs up to H = 2048, 64 above).  Block b owns
// columns [b S, (b + 1) S) of every layer's output and keeps only that share
// of the P x H activations in shared memory, so no block ever holds a full
// activation row and the weight stream is read once per cluster, not once
// per block: 1.03 TB at the first shape above, 0.58 TB at Case4.
//   The weights stream as the blocks' stage images (the preparation, one
//   bulk copy a K-slice), the activations are read from the owner blocks
//   through distributed shared memory, and two consumer warpgroups run
//   3xTF32 wgmma into ping-pong partials: siren_cluster.cuh, which the
//   chain (siren_chain_cluster.cu) shares.
//   * After each layer the epilogue adds the FiLM row z[l, t, cols] and
//     applies sin2pi in registers; two cluster barriers (every block done
//     reading the shares, then every share written) publish the new shares.
//   * The first layer stays on the CUDA cores in float32, each block its
//     own columns.  The head: each block forms its P x C_out partial over
//     its columns, block 0 sums the CL partials in rank order through
//     distributed shared memory and adds b_head.  No atomics: two launches
//     are bitwise equal.  The ragged last cluster is masked.
//   * Any C_in and C_out, as the TPU kernel, which blocks on the whole
//     feature axis: the tables of coordinates and head partials hold MAX_C
//     = 16 features, and wider ones go through them in chunks of 16, so a
//     block's shared memory and registers, and so every plan, do not
//     depend on C.  The first layer carries each pre-activation across
//     the chunks of C_in in the share (float32) or in registers (bf16,
//     whose share is bf16: a thread keeps its item's 16 sums while all
//     threads take the chunks in lockstep); the head runs once a chunk of
//     C_out, its partials summed and written before the next.  (Reading
//     the coordinates from global memory in place of a table would save
//     the chunks' barriers, but add a load to every product of the first
//     layer.)  At C <= 16 there is one chunk and the code path is the one
//     before.
//
// The bf16 forward (siren_fwd_cluster_bf16_kernel, the same body with BF16)
// computes what _decode_kernel computes with compute_dtype bfloat16
// (_decode_kernel's mxu helper, siren_decode.py:109-111): both operands of
// every product (coords x w_first, activations x w_mid[l], activations x
// w_head) rounded to bf16, the weights after the w0 / (2 pi) scale, the
// products accumulated in float32; the FiLM row, b_head and sin2pi stay
// float32.  It runs on the float32 forward's plan.
//   * Bound: the same flops with the products at the dense bf16 rate (989
//     TFLOP/s, one product where 3xTF32 takes three), beside the sines on
//     the CUDA cores (about 15 flops each at 67 TFLOP/s): 16 x 262144 pairs
//     at Case4 take at least 18.8 ms of products and 5.8 ms of sines, 4 x
//     262144 at 16 layers of 1024 33.4 ms.
//   * The shares hold bf16.  That is exact against JAX: an activation feeds
//     only the next product (or the head), and JAX rounds it to bf16 there;
//     the epilogue adds FiLM and applies sin2pi in float32, then rounds to
//     nearest even on the store, as astype(bfloat16) does.  Half the share
//     bytes, so two buffers fit, which the layers take in turns: a layer
//     writes the buffer no block reads any more, and one cluster barrier a
//     layer publishes it, not two.
//   * One bf16 wgmma (m64nNk16, N the warpgroup's 128 to 256 columns) a
//     K-slice, A from registers (bf16 read from the owners' shares, a
//     block's own columns from its shared memory directly, four K-slices a
//     batch), B from the stage image (the middle weights rounded to bf16
//     once a call), accumulated in the wgmma accumulators over the whole K,
//     no partials (siren_cluster.cuh).  A ring of 10 to 16 stages of 16 x S
//     bf16: the coordinates live in the second share buffer while the first
//     layer runs and the head's tables in the ring after the last product.
//   * The first layer and the head stay on the CUDA cores on bf16-rounded
//     operands with float32 products and sums; the first layer loads a
//     column's w_first and FiLM values ahead, the head reads w_head's rows
//     from the idle ring.
//   * What bounds it (tools/siren_bf16_ablation.py): not the products.  The
//     weight stream from L2 (read once per cluster of 128 pairs, 64 above
//     2048: 0.145 TB at Case4's 16 x 262144, 0.26 TB at 16 layers of 1024
//     over 4 x 262144, where the HMMA forward this replaced reread it in
//     every block of 16 to 64 pairs, 0.29 and 2.06 TB), the A reads through
//     distributed shared memory (each block reads all P x H activations a
//     layer, (CL - 1) / CL of them from other blocks), the sines, the first
//     layer and the cluster barrier each take their turn, one after another.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "siren_cluster.cuh"
#include "siren_common.cuh"

namespace {

using namespace siren_cluster;
using siren::sin2pi;

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

// The bf16 forward's first layer: the share (P x S bf16, row stride LDS)
// = sin2pi(coords . w_first + z_0) over this block's columns, the
// coordinates (cs, P x MAX_C, already rounded, zero past C_in) and w_first
// rounded to bf16, the products and sums in float32.  A thread takes a
// column and G pairs at a time (an item), its column of w_first in
// registers, and loads the next item's w_first column and FiLM values
// while it computes this one's.
template <int S, int P, int LDS>
__device__ __forceinline__ void first_layer16(__nv_bfloat16* share, const float* cs,
                                              const int* zrow, const float* __restrict__ w_first,
                                              const float* __restrict__ z, int rank, int H,
                                              int C_in) {
  constexpr int G = 16, ITEMS = S * (P / G);
  float wf[MAX_C], zz[G], wf_next[MAX_C], zz_next[G];
  auto load = [&](int item, float (&w)[MAX_C], float (&f)[G]) {
    const int col = rank * S + item % S, p0 = item / S * G;
#pragma unroll
    for (int k = 0; k < MAX_C; ++k)
      w[k] = k < C_in ? round_bf16(__ldg(w_first + (size_t)k * H + col)) : 0.f;
#pragma unroll
    for (int p = 0; p < G; ++p) f[p] = __ldg(z + zrow[p0 + p] + col);
  };
  if (threadIdx.x < ITEMS) load(threadIdx.x, wf, zz);
  for (int item = threadIdx.x; item < ITEMS; item += THREADS) {
    if (item + THREADS < ITEMS) load(item + THREADS, wf_next, zz_next);
    const int c = item % S, p0 = item / S * G;
#pragma unroll
    for (int p = 0; p < G; ++p) {
      const float4* c4 = reinterpret_cast<const float4*>(cs + (p0 + p) * MAX_C);
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_C; k += 4)
        if (k < C_in) {
          const float4 x = c4[k / 4];
          a = fmaf(x.x, wf[k], a);
          a = fmaf(x.y, wf[k + 1], a);
          a = fmaf(x.z, wf[k + 2], a);
          a = fmaf(x.w, wf[k + 3], a);
        }
      share[(p0 + p) * LDS + c] = __float2bfloat16_rn(sin2pi(a + zz[p]));
    }
#pragma unroll
    for (int k = 0; k < MAX_C; ++k) wf[k] = wf_next[k];
#pragma unroll
    for (int p = 0; p < G; ++p) zz[p] = zz_next[p];
  }
}

// The bf16 first layer at C_in > MAX_C: as first_layer16, over the chunks
// of MAX_C coordinates.  Every thread takes its items in lockstep rounds
// (a round an item a thread), and in each round the chunks one after
// another: the block stages a chunk's coordinates in cs (P x MAX_C,
// rounded, zero past C_in), then each thread adds the chunk's products to
// its item's G sums, kept in registers across the chunks.
template <int S, int P, int LDS>
__device__ __forceinline__ void first_layer16_chunks(__nv_bfloat16* share, float* cs,
                                                     const int* zrow,
                                                     const float* __restrict__ coords,
                                                     const float* __restrict__ w_first,
                                                     const float* __restrict__ z, int rank, int H,
                                                     int C_in, long long p0, long long Ptot,
                                                     int M) {
  constexpr int G = 16, ITEMS = S * (P / G);
  static_assert(ITEMS % THREADS == 0, "every thread takes the same rounds");
  const int n_cc = (C_in + MAX_C - 1) / MAX_C;
  for (int item = threadIdx.x; item < ITEMS; item += THREADS) {
    const int c = item % S, col = rank * S + c, pi = item / S * G;
    float a[G];
#pragma unroll
    for (int p = 0; p < G; ++p) a[p] = 0.f;
    for (int kc = 0; kc < n_cc; ++kc) {
      const int k0 = kc * MAX_C;
      __syncthreads();   // every thread is done with the table
      for (int i = threadIdx.x; i < P * MAX_C; i += THREADS) {
        const long long q = p0 + i / MAX_C;
        const int k = k0 + i % MAX_C;
        cs[i] = q < Ptot && k < C_in ? round_bf16(coords[(q % M) * C_in + k]) : 0.f;
      }
      __syncthreads();
      float wf[MAX_C];
#pragma unroll
      for (int k = 0; k < MAX_C; ++k)
        wf[k] = k0 + k < C_in ? round_bf16(__ldg(w_first + (size_t)(k0 + k) * H + col)) : 0.f;
#pragma unroll
      for (int p = 0; p < G; ++p) {
        const float4* c4 = reinterpret_cast<const float4*>(cs + (pi + p) * MAX_C);
#pragma unroll
        for (int k = 0; k < MAX_C; k += 4) {
          const float4 x = c4[k / 4];
          a[p] = fmaf(x.x, wf[k], a[p]);
          a[p] = fmaf(x.y, wf[k + 1], a[p]);
          a[p] = fmaf(x.z, wf[k + 2], a[p]);
          a[p] = fmaf(x.w, wf[k + 3], a[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < G; ++p)
      share[(pi + p) * LDS + c] =
          __float2bfloat16_rn(sin2pi(a[p] + __ldg(z + zrow[pi + p] + col)));
  }
}

// The bf16 forward's head partials of one chunk of no <= MAX_C outputs:
// hpart (P x no) = the last layer's share (P x S bf16) . this block's rows
// of w_head's columns o0 .. o0 + no - 1 rounded to bf16, in float32, each
// sum in column order.  The rows (S x no) are first copied into ws; hpart
// and ws are the ring's stages, which the last product has finished with.
template <int S, int P, int LDS>
__device__ __forceinline__ void head16(float* hpart, const __nv_bfloat16* share, float* ws,
                                       const float* __restrict__ wh, int C_out, int o0, int no) {
  for (int i = threadIdx.x; i < S * no; i += THREADS)
    ws[i] = round_bf16(__ldg(wh + (size_t)(i / no) * C_out + o0 + i % no));
  __syncthreads();
  for (int i = threadIdx.x; i < P * no; i += THREADS) {
    const int p = i / no, o = i % no;
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < S; ++k)
      a = fmaf(__bfloat162float(share[p * LDS + k]), ws[k * no + o], a);
    hpart[i] = a;
  }
}

// The forward of one cluster, float32 or (BF16) bf16: the shares and the
// stream are then bf16, and so are the operands of the first layer's and
// the head's products.
template <int S, int MT, bool BF16>
__device__ __forceinline__ void fwd_cluster(const float* __restrict__ coords,
                                            const float* __restrict__ z,
                                            const float* __restrict__ w_first,
                                            const void* __restrict__ wprep,
                                            const float* __restrict__ w_head,
                                            const float* __restrict__ b_head,
                                            float* __restrict__ out,
                                            int T, int M, int C_in, int n_mod, int C_out) {
  using C = Consumer<S, MT, BF16>;
  using E = std::conditional_t<BF16, __nv_bfloat16, float>;   // a share's element
  constexpr int P = cluster_pairs(MT), LDS = C::LDS, NSUB = C::NSUB;
  static_assert(!BF16 || C::NS * C::STAGE >= (P + S) * MAX_C * 4,
                "the head's partials and rows fit the ring");
  static_assert(!BF16 || LDS * 2 >= MAX_C * 4, "a pair's coordinates fit a share row");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((ALIGN - raw % ALIGN) % ALIGN);
  unsigned char* stages = base;                                    // NS x STAGE
  E* share = reinterpret_cast<E*>(stages + C::NS * C::STAGE);      // P x LDS (bf16: two)
  // a chunk of the coordinates, P x nc (bf16: P x MAX_C, in the second
  // share buffer, idle in the first layer), then a chunk of the head's
  // partials, P x no (bf16: in the ring, idle after the last product), then
  // P row offsets t H
  float* cs = reinterpret_cast<float*>(share + P * LDS);
  float* hpart = BF16 ? reinterpret_cast<float*>(stages) : cs + P * MAX_C;
  int* zrow = reinterpret_cast<int*>(BF16 ? reinterpret_cast<float*>(share + 2 * P * LDS)
                                          : hpart + P * MAX_C);
  uint64_t* bars = reinterpret_cast<uint64_t*>(zrow + P);   // full, then release counts

  const int tid = threadIdx.x;
  const int cl = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
  const int H = cl * S;
  const long long Ptot = (long long)T * M;
  const long long p0 = (long long)cluster_id() * P;
  // block rank's columns of every middle weight stream through the ring,
  // one K-slice a stage, in one stream across the layers
  const C wg(stages, wprep, bars, share, rank, (n_mod - 1) * (H / KS));

  // the coordinates' chunk kc (float32: P x its nc features)
  const int n_cc = (C_in + MAX_C - 1) / MAX_C;
  auto stage_coords = [&](int kc) {
    const int k0 = kc * MAX_C, nc = min(MAX_C, C_in - k0);
    for (int i = tid; i < P * nc; i += THREADS) {
      const long long q = p0 + i / nc;
      cs[i] = q < Ptot ? coords[(q % M) * C_in + k0 + i % nc] : 0.f;
    }
  };
  if (tid == 0) wg.init(bars);
  if constexpr (BF16) {   // P x MAX_C, rounded, zero past C_in (wider: in the first layer)
    if (n_cc == 1)
      for (int i = tid; i < P * MAX_C; i += THREADS) {
        const long long q = p0 + i / MAX_C;
        const int k = i % MAX_C;
        cs[i] = q < Ptot && k < C_in ? round_bf16(coords[(q % M) * C_in + k]) : 0.f;
      }
  } else {
    stage_coords(0);
  }
  for (int p = tid; p < P; p += THREADS) {
    const long long q = p0 + p < Ptot ? p0 + p : Ptot - 1;
    zrow[p] = (int)(q / M) * H;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers initialised
  wg.start();

  // first layer on the CUDA cores: share = sin2pi(coords . w_first + z_0)
  if constexpr (BF16) {
    if (n_cc == 1)
      first_layer16<S, P, LDS>(share, cs, zrow, w_first, z, rank, H, C_in);
    else
      first_layer16_chunks<S, P, LDS>(share, cs, zrow, coords, w_first, z, rank, H, C_in, p0,
                                      Ptot, M);
  } else {
    // chunk by chunk of the coordinates, the sums carried in the share
    for (int kc = 0; kc < n_cc; ++kc) {
      if (kc > 0) {
        __syncthreads();   // every thread is done with the table
        stage_coords(kc);
        __syncthreads();
      }
      const int k0 = kc * MAX_C, nc = min(MAX_C, C_in - k0);
      const bool last = kc + 1 == n_cc;
      for (int i = tid; i < P * S; i += THREADS) {
        const int p = i / S, c = i % S, col = rank * S + c;
        float a = kc > 0 ? share[p * LDS + c] : 0.f;
        for (int k = 0; k < nc; ++k)
          a = fmaf(cs[p * nc + k], __ldg(w_first + (size_t)(k0 + k) * H + col), a);
        share[p * LDS + c] = last ? sin2pi(a + __ldg(z + zrow[p] + col)) : a;
      }
    }
  }
  cluster_sync();

  float acc[NSUB][32];
  // the epilogue of layer l: acc = sin2pi(acc + z[l, t, cols])
  auto film_sin2pi = [&](float (&a)[NSUB][32], const float* zl) {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 zz =
            __ldg(reinterpret_cast<const float2*>(zl + zrow[wg.row(i)] + wg.col(j, i)));
        a[j][i] = sin2pi(a[j][i] + zz.x);
        a[j][i + 1] = sin2pi(a[j][i + 1] + zz.y);
      }
  };
  int u = 0;
  if constexpr (BF16) {
    // layer l reads the buffer of layer l - 1 and writes the other: no block
    // still reads it, since every block passed the barrier after layer l - 1
    for (int l = 1; l < n_mod; ++l) {
      wg.product16(acc, u, H / KS, smem_addr(share + ((l - 1) & 1) * P * LDS));
      film_sin2pi(acc, z + (size_t)l * T * H + rank * S);
      wg.store_share16(share + (l & 1) * P * LDS, acc);
      cluster_sync();   // every block's buffer of layer l written
    }
  } else {
    float part[2][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.f;
    for (int l = 1; l < n_mod; ++l) {
      wg.product(acc, part, u, H / KS);
      // every block is done reading the shares of layer l - 1 ...
      cluster_arrive();
      film_sin2pi(acc, z + (size_t)l * T * H + rank * S);
      cluster_wait();
      // ... so this block's share takes layer l's activations
      wg.store_share(share, acc);
      cluster_sync();
    }
  }

  // head, a chunk of MAX_C outputs at a time: this block's P x no partial
  // over its columns, in column order
  for (int o0 = 0; o0 < C_out; o0 += MAX_C) {
    const int no = min(MAX_C, C_out - o0);
    if constexpr (BF16)
      head16<S, P, LDS>(hpart, share + ((n_mod - 1) & 1) * P * LDS, hpart + P * MAX_C,
                        w_head + (size_t)rank * S * C_out, C_out, o0, no);
    else
      for (int i = tid; i < P * no; i += THREADS) {
        const int p = i / no, o = i % no;
        const float* wh = w_head + (size_t)rank * S * C_out + o0 + o;
        float a = 0.f;
        for (int k = 0; k < S; ++k)
          a = fmaf(share[p * LDS + k], __ldg(wh + (size_t)k * C_out), a);
        hpart[i] = a;
      }
    cluster_sync();
    if (rank == 0) {
      // block 0 sums the partials in rank order
      const uint32_t h0 = smem_addr(hpart);
      for (int i = tid; i < P * no; i += THREADS) {
        const long long q = p0 + i / no;
        if (q >= Ptot) continue;
        float a = 0.f;
        for (int r = 0; r < cl; ++r) a += ld_cluster(map_rank(h0 + 4u * i, r));
        out[q * C_out + o0 + i % no] = a + b_head[o0 + i % no];
      }
    }
    // no block leaves, or overwrites its partials, while they may be read
    cluster_sync();
  }
}

template <int S, int MT>
__global__ void __launch_bounds__(THREADS, 1)
siren_fwd_cluster_kernel(const float* __restrict__ coords, const float* __restrict__ z,
                         const float* __restrict__ w_first, const float* __restrict__ wprep,
                         const float* __restrict__ w_head, const float* __restrict__ b_head,
                         float* __restrict__ out, int T, int M, int C_in, int n_mod, int C_out) {
  fwd_cluster<S, MT, false>(coords, z, w_first, wprep, w_head, b_head, out, T, M, C_in, n_mod,
                            C_out);
}

template <int S, int MT>
__global__ void __launch_bounds__(THREADS, 1)
siren_fwd_cluster_bf16_kernel(const float* __restrict__ coords, const float* __restrict__ z,
                              const float* __restrict__ w_first, const void* __restrict__ wprep,
                              const float* __restrict__ w_head, const float* __restrict__ b_head,
                              float* __restrict__ out, int T, int M, int C_in, int n_mod,
                              int C_out) {
  fwd_cluster<S, MT, true>(coords, z, w_first, wprep, w_head, b_head, out, T, M, C_in, n_mod,
                           C_out);
}

int run(bool bf16, const float* coords, const float* z, const float* w_first,
        const void* wprep, const float* w_head, const float* b_head, float* out, int T, int M,
        int C_in, int H, int n_mod, int C_out, cudaStream_t stream, int* max_clusters) {
  Plan plan{};
  if (!exact_plan(H, plan) || n_mod < 1 || C_in < 1 || C_out < 1 || T <= 0 || M <= 0 ||
      (long long)T * H > 2147483647LL ||
      ((long long)T * M + cluster_pairs(plan.mt) - 1) / cluster_pairs(plan.mt) * plan.cl >
          2147483647LL ||
      (n_mod > 1 && wprep == nullptr && max_clusters == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_plan(plan, [&](auto s, auto mt) {
    constexpr int S = decltype(s)::value, MT = decltype(mt)::value;
    if (bf16) {
      static unsigned long long done = 0;
      return launch_clusters<S, MT, true>(siren_fwd_cluster_bf16_kernel<S, MT>, done, plan,
                                          (long long)T * M, stream, max_clusters, coords, z,
                                          w_first, wprep, w_head, b_head, out, T, M, C_in, n_mod,
                                          C_out);
    }
    static unsigned long long done = 0;
    return launch_clusters<S, MT>(siren_fwd_cluster_kernel<S, MT>, done, plan, (long long)T * M,
                                  stream, max_clusters, coords, z, w_first,
                                  static_cast<const float*>(wprep), w_head, b_head, out, T, M,
                                  C_in, n_mod, C_out);
  });
}

}  // namespace

extern "C" {

// the plan for hidden width h, float32 or (bf16 != 0) bf16: out = {CL, S,
// MT, stages, shared bytes}
int siren_fwd_cluster_plan(int h, int bf16, int* out) {
  Plan p{};
  if (!plan_for(h, p)) return (int)cudaErrorInvalidValue;
  out[0] = p.cl;
  out[1] = p.share;
  out[2] = p.mt;
  return with_plan(p, [&](auto s, auto mt) {
    out[3] = n_stages(decltype(s)::value, decltype(mt)::value, bf16 != 0);
    out[4] = smem_bytes(decltype(s)::value, decltype(mt)::value, bf16 != 0);
    return 0;
  });
}

// clusters of the plan for H that the card holds at once, float32 or
// (bf16 != 0) bf16 (0: not admitted)
int siren_fwd_cluster_max_clusters(int H, int C_in, int C_out, int bf16, int* out) {
  *out = 0;
  return run(bf16 != 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1,
             C_in, H, 2, C_out, 0, out);
}

// the n_mid middle weights (n_mid, H, H) as the blocks' stage images: TF32
// halves (float32, 2 n_mid H^2 floats) ...
int siren_fwd_cluster_prep(const float* w_mid, float* wprep, int H, int n_mid, void* stream) {
  return launch_prep(w_mid, wprep, H, n_mid, n_mid, (cudaStream_t)stream);
}

// ... or bf16 (n_mid H^2 bf16)
int siren_fwd_cluster_prep_bf16(const float* w_mid, void* wprep, int H, int n_mid,
                                void* stream) {
  return launch_prep_bf16(w_mid, wprep, H, n_mid, (cudaStream_t)stream);
}

int siren_decode_forward_cluster(const float* coords, const float* z, const float* w_first,
                                 const float* wprep, const float* w_head, const float* b_head,
                                 float* out, int T, int M, int C_in, int H, int n_mod, int C_out,
                                 void* stream) {
  return run(false, coords, z, w_first, wprep, w_head, b_head, out, T, M, C_in, H, n_mod, C_out,
             (cudaStream_t)stream, nullptr);
}

int siren_decode_forward_cluster_bf16(const float* coords, const float* z, const float* w_first,
                                      const void* wprep, const float* w_head,
                                      const float* b_head, float* out, int T, int M, int C_in,
                                      int H, int n_mod, int C_out, void* stream) {
  return run(true, coords, z, w_first, wprep, w_head, b_head, out, T, M, C_in, H, n_mod, C_out,
             (cudaStream_t)stream, nullptr);
}

}  // extern "C"
