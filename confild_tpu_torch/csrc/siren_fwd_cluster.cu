// The float32 SIREN-FiLM decode forward, as a thread-block cluster kernel
// for Hopper (sm_90a): wgmma on the tensor cores (3xTF32), the weights
// streamed by bulk asynchronous copies into a ring of shared-memory stages,
// the activations spread over the cluster's blocks and read through
// distributed shared memory.
//
// siren_decode_forward_cluster replaces the Pallas kernel _decode_kernel
// (confild_tpu/ops/siren_decode.py:96, launched at :177 by _fused_forward)
// in float32 at every hidden width up to 3072; siren_decode.cu keeps the
// bf16 forward.  Operands as siren_decode.cu takes them, folded by the
// wrapper (confild_tpu_torch/ops/siren_decode.py): the first and middle
// weights and the FiLM table z scaled by w0 / (2 pi), so the activation is
// sin2pi(r) = sin(2 pi r), the JAX package's odd minimax polynomial.
//   coords  (M, C_in)        z (n_mod, T, H)       w_first (C_in, H)
//   wprep   the middle weights (n_mod - 1, H, H) split into TF32 halves and
//           laid out as the stages' shared-memory images (siren_fwd_cluster_prep)
//   w_head  (H, C_out)       b_head (C_out)        out (T, M, C_out)
// H is a width the cluster plan gives (plan_for): CL blocks of S columns.
//
// Bound on the H100: operations.  A (row, point) pair costs 2 H (C_in +
// (n_mod - 1) H + C_out) flops, the (n_mod - 1) H x H products on the tensor
// cores at the dense TF32 rate over three products each (495 / 3 TFLOP/s):
// 4 x 262144 pairs at 16 modulated layers of 1024 take at least 200 ms, 16 x
// 262144 at Case4 (16 of 384) 112.6 ms.  A design of blocks that each hold
// their pairs' full activation rows (16 pairs at H = 1024, 64 at Case4) is
// bound instead by its L2 weight stream: every block rereads the whole split
// stream, 8.25 TB a call at the first shape, 1.16 TB at the second (the
// mma.sync forward this kernel replaced at H <= 512 ran at that stream's
// rate, 343 ms at Case4).
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
//   * The first layer (C_in <= 16) stays on the CUDA cores in float32, each
//     block its own columns.  The head: each block forms its P x C_out
//     partial over its columns, block 0 sums the CL partials in rank order
//     through distributed shared memory and adds b_head.  No atomics: two
//     launches are bitwise equal.  The ragged last cluster is masked.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_cluster.cuh"
#include "siren_common.cuh"

namespace {

using namespace siren_cluster;
using siren::sin2pi;

// ---------------------------------------------------------------------------
// the forward
// ---------------------------------------------------------------------------

template <int S, int MT>
__global__ void __launch_bounds__(THREADS, 1)
siren_fwd_cluster_kernel(const float* __restrict__ coords,
                         const float* __restrict__ z,
                         const float* __restrict__ w_first,
                         const float* __restrict__ wprep,
                         const float* __restrict__ w_head,
                         const float* __restrict__ b_head,
                         float* __restrict__ out,
                         int T, int M, int C_in, int n_mod, int C_out) {
  using C = Consumer<S, MT>;
  constexpr int P = cluster_pairs(MT), LDS = S + A_PAD, NSUB = C::NSUB;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((ALIGN - raw % ALIGN) % ALIGN);
  unsigned char* stages = base;                                    // NS x STAGE
  float* share = reinterpret_cast<float*>(stages + C::NS * C::STAGE);   // P x LDS
  float* cs = share + P * LDS;                                     // P x C_in
  float* hpart = cs + P * MAX_C;                                   // P x C_out
  int* zrow = reinterpret_cast<int*>(hpart + P * MAX_C);           // P row offsets t H
  uint64_t* bars = reinterpret_cast<uint64_t*>(zrow + P);   // full, then release counts

  const int tid = threadIdx.x;
  const int cl = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
  const int H = cl * S;
  const long long Ptot = (long long)T * M;
  const long long p0 = (long long)cluster_id() * P;
  // block rank's columns of every middle weight stream through the ring,
  // one K-slice a stage, in one stream across the layers
  const C wg(stages, wprep, bars, share, rank, (n_mod - 1) * (H / KS));

  if (tid == 0) wg.init(bars);
  for (int i = tid; i < P * C_in; i += THREADS) {
    const long long q = p0 + i / C_in;
    cs[i] = q < Ptot ? coords[(q % M) * C_in + i % C_in] : 0.f;
  }
  for (int p = tid; p < P; p += THREADS) {
    const long long q = p0 + p < Ptot ? p0 + p : Ptot - 1;
    zrow[p] = (int)(q / M) * H;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers initialised
  wg.start();

  // first layer on the CUDA cores: share = sin2pi(coords . w_first + z_0)
  for (int i = tid; i < P * S; i += THREADS) {
    const int p = i / S, c = i % S, col = rank * S + c;
    float a = 0.f;
    for (int k = 0; k < C_in; ++k) a = fmaf(cs[p * C_in + k], __ldg(w_first + (size_t)k * H + col), a);
    share[p * LDS + c] = sin2pi(a + __ldg(z + zrow[p] + col));
  }
  cluster_sync();

  float acc[NSUB][32];
  float part[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.f;
  int u = 0;
  for (int l = 1; l < n_mod; ++l) {
    wg.product(acc, part, u, H / KS);
    // every block is done reading the shares of layer l - 1 ...
    cluster_arrive();
    const float* zl = z + (size_t)l * T * H + rank * S;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float2 zz = __ldg(reinterpret_cast<const float2*>(zl + zrow[wg.row(i)] + wg.col(j, i)));
        acc[j][i] = sin2pi(acc[j][i] + zz.x);
        acc[j][i + 1] = sin2pi(acc[j][i + 1] + zz.y);
      }
    cluster_wait();
    // ... so this block's share takes layer l's activations
    wg.store_share(share, acc);
    cluster_sync();
  }

  // head: this block's P x C_out partial over its columns, in column order
  for (int i = tid; i < P * C_out; i += THREADS) {
    const int p = i / C_out, o = i % C_out;
    const float* wh = w_head + (size_t)rank * S * C_out + o;
    float a = 0.f;
    for (int k = 0; k < S; ++k) a = fmaf(share[p * LDS + k], __ldg(wh + (size_t)k * C_out), a);
    hpart[i] = a;
  }
  cluster_sync();
  if (rank == 0) {
    // block 0 sums the partials in rank order
    const uint32_t h0 = smem_addr(hpart);
    for (int i = tid; i < P * C_out; i += THREADS) {
      const long long q = p0 + i / C_out;
      if (q >= Ptot) continue;
      float a = 0.f;
      for (int r = 0; r < cl; ++r) a += ld_cluster(map_rank(h0 + 4u * i, r));
      out[q * C_out + i % C_out] = a + b_head[i % C_out];
    }
  }
  cluster_sync();   // no block leaves while its shared memory may be read
}

int run(const float* coords, const float* z, const float* w_first, const float* wprep,
        const float* w_head, const float* b_head, float* out, int T, int M, int C_in, int H,
        int n_mod, int C_out, cudaStream_t stream, int* max_clusters) {
  Plan plan{};
  if (!exact_plan(H, plan) || n_mod < 1 || C_in < 1 || C_in > MAX_C || C_out < 1 ||
      C_out > MAX_C || T <= 0 || M <= 0 || (long long)T * H > 2147483647LL ||
      ((long long)T * M + cluster_pairs(plan.mt) - 1) / cluster_pairs(plan.mt) * plan.cl >
          2147483647LL ||
      (n_mod > 1 && wprep == nullptr && max_clusters == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_plan(plan, [&](auto s, auto mt) {
    constexpr int S = decltype(s)::value, MT = decltype(mt)::value;
    static unsigned long long done = 0;
    return launch_clusters<S, MT>(siren_fwd_cluster_kernel<S, MT>, done, plan, (long long)T * M,
                                  stream, max_clusters, coords, z, w_first, wprep, w_head,
                                  b_head, out, T, M, C_in, n_mod, C_out);
  });
}

}  // namespace

extern "C" {

// the plan for hidden width h: out = {CL, S, MT, stages, shared bytes}
int siren_fwd_cluster_plan(int h, int* out) {
  Plan p{};
  if (!plan_for(h, p)) return (int)cudaErrorInvalidValue;
  out[0] = p.cl;
  out[1] = p.share;
  out[2] = p.mt;
  return with_plan(p, [&](auto s, auto mt) {
    out[3] = n_stages(decltype(s)::value, decltype(mt)::value);
    out[4] = smem_bytes(decltype(s)::value, decltype(mt)::value);
    return 0;
  });
}

// clusters of the plan for H that the card holds at once (0: not admitted)
int siren_fwd_cluster_max_clusters(int H, int C_in, int C_out, int* out) {
  *out = 0;
  return run(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, C_in, H, 2,
             C_out, 0, out);
}

// the n_mid middle weights (n_mid, H, H) as the blocks' stage images
int siren_fwd_cluster_prep(const float* w_mid, float* wprep, int H, int n_mid, void* stream) {
  return launch_prep(w_mid, wprep, H, n_mid, n_mid, (cudaStream_t)stream);
}

int siren_decode_forward_cluster(const float* coords, const float* z, const float* w_first,
                                 const float* wprep, const float* w_head, const float* b_head,
                                 float* out, int T, int M, int C_in, int H, int n_mod, int C_out,
                                 void* stream) {
  return run(coords, z, w_first, wprep, w_head, b_head, out, T, M, C_in, H, n_mod, C_out,
             (cudaStream_t)stream, nullptr);
}

}  // extern "C"
