// The float32 SIREN-FiLM chain (a forward recompute, then the dx chain), in
// its dz mode and its training mode, as a thread-block cluster kernel for
// Hopper (sm_90a): wgmma on the tensor cores (3xTF32), the weights streamed
// by bulk asynchronous copies, the activations and dpre spread over the
// cluster's blocks and read through distributed shared memory
// (siren_cluster.cuh, shared with the cluster forward), at every hidden
// width up to 3072.
//
// siren_decode_dz_cluster replaces the Pallas kernel _decode_dz_kernel
// (confild_tpu/ops/siren_decode.py:315, launched at :393 by
// fused_siren_decode_dz): dL/dz_l for every layer, (n_mod, T, H), the sum
// over each row's points of dpre_l.  siren_bwd_chain_cluster is the chain
// part of _decode_bwd_kernel (:434, launched at :523 by
// fused_siren_decode_bwd): every pre-activation r_l and every dpre_l of a
// chunk into the workspace, which siren_decode_bwd.cu's reduction, sums and
// fold turn into dz, dW_first, dW_mid and dW_head.  With dpre_l = dx_l * 2 pi cos2pi(r_l) and
// dx_{l-1} = dpre_l . W_l^T, on the folded operands of siren_fwd_cluster.cu
// (w_first, w_mid and z scaled by w0 / (2 pi)):
//   coords (M, C_in)   z (n_mod, T, H)   g (T, M, C_out)   w_first (C_in, H)
//   wprep  the middle weights as the blocks' stage images, the forward's
//          n_mod - 1 products then the dx chain's n_mod - 1 transposed ones
//          (siren_chain_cluster_prep)
//   w_head (H, C_out)
// H is a width the cluster plan gives (plan_for): CL blocks of S columns.
// The host walks chunks of Q consecutive pairs (p = t M + m) from p0, as
// siren_decode_bwd.cu does; R and D are (n_mod, Qa, H).
//
// Bound on the H100: operations.  A pair costs 2 x 2 (n_mod - 1) H^2 flops
// of products (the forward recompute and the dx chain), at the dense TF32
// rate over three products each (495 / 3 TFLOP/s): 384 x 1000 pairs at 16
// modulated layers of 1024 take at least 146 ms, 384 x 1024 at Case4 (16 of
// 384) 21.1 ms.  A design of blocks that each hold their pairs' full
// activation rows (16 pairs at H = 1024, 64 at Case4) is bound instead by
// its L2 weight stream: every block rereads the forward's and the dx
// chain's split weights, 6.0 TB a call at the first shape (the warp-level
// HMMA chain this kernel replaced at H <= 512 ran near that stream's rate).
//
// Design.  A cluster of CL blocks owns P = 64 MT pairs (128 up to H = 2048,
// 64 above) and reads the weight stream once, 0.75 TB at the shape above.
// Block b owns columns [b S, (b + 1) S) of every layer (siren_cluster.cuh):
//   * forward recompute, as the cluster forward: the first layer on the CUDA
//     cores, then per layer the product, the FiLM add (r_l, which block b
//     writes to R for its S columns) and sin2pi into the share;
//   * dx_last = g . w_head^T on the CUDA cores in float32, straight into
//     the accumulator positions;
//   * any C_in and C_out, as the TPU kernels: the tables of coordinates and
//     g hold MAX_C = 16 features a pair, and wider ones go through them in
//     chunks of 16 (the first layer's sums carried in the share, dx_last's
//     in the accumulators), so a block's shared memory, and every plan, do
//     not depend on C; at C <= 16 there is one chunk, as before;
//   * per layer l = n_mod - 1 .. 0: dpre_l = dx_l * 2 pi cos2pi(r_l), r_l read
//     back from R where the same thread wrote it (the first layer's by
//     another thread of the block, before a barrier); training mode writes
//     dpre_l to D; the share takes dpre_l, which is the A operand of
//     dx_{l-1} = dpre_l . W_{l-1}^T (its B: block b's columns of W_{l-1}^T,
//     that is W_{l-1}'s rows, the stream's transposed images).
//   * dz mode: after each layer every thread sums one column of the block's
//     share of dpre_l over the cluster's pairs in pair order, one sum per
//     latent row they touch, into parts[cluster][l][slot][H] (slot: the row
//     less the row of the cluster's first pair; dz_slots(M, P) of them), and
//     siren_dz_fold_kernel adds each row's cluster sums in cluster order to
//     what earlier chunks left in dz.
// Ordering: the share is one buffer.  After a product every thread arrives
// at the cluster barrier and waits on it only before it overwrites its
// block's share (every block is done reading the old shares), then a full
// cluster barrier publishes the new shares before any block reads them.
// The last forward layer writes no share: its wait already orders the first
// dpre after every read of the activations.  No block reads another's share
// after its last wait, so none leaves while its shared memory may be read.
// No atomics: two launches are bitwise equal.  The ragged last cluster is
// masked (g = 0, so its dpre is 0).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_cluster.cuh"
#include "siren_common.cuh"
#include "siren_dz_fold.cuh"

namespace {

using namespace siren_cluster;
using siren::sin2pi;

template <int S, int MT, bool DZ>
__global__ void __launch_bounds__(THREADS, 1)
siren_chain_cluster_kernel(const float* __restrict__ coords,
                           const float* __restrict__ z,
                           const float* __restrict__ g,
                           const float* __restrict__ w_first,
                           const float* __restrict__ wprep,
                           const float* __restrict__ w_head,
                           float* __restrict__ R,
                           float* __restrict__ out,
                           long long p0, int Q, int Qa, int T, int M, int C_in, int n_mod,
                           int C_out, int slots) {
  using C = Consumer<S, MT>;
  constexpr int P = cluster_pairs(MT), LDS = S + A_PAD, NSUB = C::NSUB;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((ALIGN - raw % ALIGN) % ALIGN);
  unsigned char* stages = base;                                         // NS x STAGE
  float* share = reinterpret_cast<float*>(stages + C::NS * C::STAGE);   // P x LDS
  float* cs = share + P * LDS;                   // a chunk of the coordinates, P x nc
  float* gs = cs + P * MAX_C;                    // a chunk of g, P x no
  int* zrow = reinterpret_cast<int*>(gs + P * MAX_C);                   // P row offsets t H
  uint64_t* bars = reinterpret_cast<uint64_t*>(zrow + P);   // full, then release counts

  const int tid = threadIdx.x;
  const int cl = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
  const int H = cl * S, col0 = rank * S;
  const int cluster = (int)cluster_id();
  const int q0 = cluster * P;                 // the cluster's first pair in the chunk
  const size_t lstride = (size_t)Qa * H;
  // block rank's columns of the forward's products, then of the dx chain's
  const C wg(stages, wprep, bars, share, rank, 2 * (n_mod - 1) * (H / KS));

  // the chunk of MAX_C features from k0 of the coordinates, and of g
  auto stage_coords = [&](int k0) {
    const int nc = min(MAX_C, C_in - k0);
    for (int i = tid; i < P * nc; i += THREADS) {
      const int q = q0 + i / nc;
      cs[i] = q < Q ? coords[((p0 + q) % M) * C_in + k0 + i % nc] : 0.f;
    }
  };
  auto stage_g = [&](int o0) {
    const int no = min(MAX_C, C_out - o0);
    for (int i = tid; i < P * no; i += THREADS) {
      const int q = q0 + i / no;
      gs[i] = q < Q ? g[(p0 + q) * C_out + o0 + i % no] : 0.f;
    }
  };
  if (tid == 0) wg.init(bars);
  stage_coords(0);
  stage_g(0);
  for (int p = tid; p < P; p += THREADS) {
    const int q = q0 + p < Q ? q0 + p : Q - 1;
    zrow[p] = (int)((p0 + q) / M) * H;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers initialised
  wg.start();

  // first layer on the CUDA cores: r_0 = coords . w_first + z_0 into R,
  // sin2pi(r_0) into the share; chunk by chunk of the coordinates, the sums
  // carried in the share
  float* R0 = R + (size_t)q0 * H + col0;
  for (int k0 = 0; k0 < C_in; k0 += MAX_C) {
    if (k0 > 0) {
      __syncthreads();   // every thread is done with the table
      stage_coords(k0);
      __syncthreads();
    }
    const int nc = min(MAX_C, C_in - k0);
    const bool last = k0 + nc == C_in;
    for (int i = tid; i < P * S; i += THREADS) {
      const int p = i / S, c = i % S;
      float a = k0 > 0 ? share[p * LDS + c] : 0.f;
      for (int k = 0; k < nc; ++k)
        a = fmaf(cs[p * nc + k], __ldg(w_first + (size_t)(k0 + k) * H + col0 + c), a);
      if (last) {
        const float r = a + __ldg(z + zrow[p] + col0 + c);
        R0[(size_t)p * H + c] = r;
        share[p * LDS + c] = sin2pi(r);
      } else {
        share[p * LDS + c] = a;
      }
    }
  }
  cluster_sync();

  float acc[NSUB][32];
  float part[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[0][i] = part[1][i] = 0.f;
  const int chunks = H / KS;
  int u = 0;
  // forward recompute: r_l into R, sin2pi(r_l) into the share
  for (int l = 1; l < n_mod; ++l) {
    wg.product(acc, part, u, chunks);
    // every block is done reading the shares of layer l - 1 ...
    cluster_arrive();
    const float* zl = z + (size_t)l * T * H + col0;
    float* Rl = R + l * lstride + (size_t)q0 * H + col0;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = wg.row(i), col = wg.col(j, i);
        const float2 zz = __ldg(reinterpret_cast<const float2*>(zl + zrow[row] + col));
        const float2 r = make_float2(acc[j][i] + zz.x, acc[j][i + 1] + zz.y);
        *reinterpret_cast<float2*>(Rl + (size_t)row * H + col) = r;
        acc[j][i] = sin2pi(r.x);
        acc[j][i + 1] = sin2pi(r.y);
      }
    cluster_wait();
    // ... so this block's share takes layer l's activations (the last
    // layer's are not needed)
    if (l + 1 < n_mod) {
      wg.store_share(share, acc);
      cluster_sync();
    }
  }

  // the head's cotangent on the CUDA cores: dx = g . w_head^T, chunk by
  // chunk of g, the sums carried in the accumulators
  for (int o0 = 0; o0 < C_out; o0 += MAX_C) {
    if (o0 > 0) {
      __syncthreads();   // every thread is done with the table
      stage_g(o0);
      __syncthreads();
    }
    const int no = min(MAX_C, C_out - o0);
    const float* wh = w_head + (size_t)col0 * C_out + o0;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = wg.row(i), col = wg.col(j, i) + (i & 1);
        float a = o0 > 0 ? acc[j][i] : 0.f;
        for (int o = 0; o < no; ++o)
          a = fmaf(gs[row * no + o], __ldg(wh + (size_t)col * C_out + o), a);
        acc[j][i] = a;
      }
  }

  // per layer dpre = dx * 2 pi cos2pi(r), then dx = dpre . W_l^T
  const int n = min(P, Q - q0);   // the cluster's pairs in the chunk
  for (int l = n_mod - 1; l >= 0; --l) {
    const float* Rl = R + l * lstride + (size_t)q0 * H + col0;
    float* Dl = out + l * lstride + (size_t)q0 * H + col0;   // training mode
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = wg.row(i), col = wg.col(j, i);
        const float2 r = *reinterpret_cast<const float2*>(Rl + (size_t)row * H + col);
        acc[j][i] *= siren::TWO_PI * sin2pi(r.x + 0.25f);   // d sin2pi / dr
        acc[j][i + 1] *= siren::TWO_PI * sin2pi(r.y + 0.25f);
        if constexpr (!DZ)
          *reinterpret_cast<float2*>(Dl + (size_t)row * H + col) =
              make_float2(acc[j][i], acc[j][i + 1]);
      }
    // every block is done reading the shares of dpre_{l + 1}
    if (l + 1 < n_mod) cluster_wait();
    if (DZ || l > 0) wg.store_share(share, acc);
    if (l > 0) {
      cluster_sync();   // every share holds dpre_l
    } else if (DZ) {
      __syncthreads();  // this block's share holds dpre_0
    }
    if constexpr (DZ) {
      // column j of the share in pair order, one sum per latent row
      float* pl = out + ((size_t)cluster * n_mod + l) * slots * H + col0;
      for (int j = tid; j < S; j += THREADS) {
        int slot = 0;
        float s = 0.f;
        for (int r = 0; r < n; ++r) {
          const int rs = (zrow[r] - zrow[0]) / H;
          if (rs != slot) {
            pl[(size_t)slot * H + j] = s;
            s = 0.f;
            slot = rs;
          }
          s += share[r * LDS + j];
        }
        pl[(size_t)slot * H + j] = s;
      }
    }
    if (l > 0) {
      wg.product(acc, part, u, chunks);
      cluster_arrive();
    }
  }
}

int chain(bool dz_mode, const float* coords, const float* z, const float* g,
          const float* w_first, const float* wprep, const float* w_head, float* R, float* out,
          long long p0, int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
          cudaStream_t stream, int* max_clusters) {
  Plan plan{};
  if (!exact_plan(H, plan) || n_mod < 1 || C_in < 1 || C_out < 1 || T <= 0 || M <= 0 ||
      Q <= 0 || Qa < Q ||
      Qa % cluster_pairs(plan.mt) != 0 || p0 < 0 || p0 + Q > (long long)T * M ||
      (long long)T * H > 2147483647LL ||
      (n_mod > 1 && wprep == nullptr && max_clusters == nullptr))
    return (int)cudaErrorInvalidValue;
  const int slots = siren::dz_slots(M, cluster_pairs(plan.mt));
  return with_plan(plan, [&](auto s, auto mt) {
    constexpr int S = decltype(s)::value, MT = decltype(mt)::value;
    if (dz_mode) {
      static unsigned long long done = 0;
      return launch_clusters<S, MT>(siren_chain_cluster_kernel<S, MT, true>, done, plan, Q,
                                    stream, max_clusters, coords, z, g, w_first, wprep, w_head,
                                    R, out, p0, Q, Qa, T, M, C_in, n_mod, C_out, slots);
    }
    static unsigned long long done = 0;
    return launch_clusters<S, MT>(siren_chain_cluster_kernel<S, MT, false>, done, plan, Q,
                                  stream, max_clusters, coords, z, g, w_first, wprep, w_head, R,
                                  out, p0, Q, Qa, T, M, C_in, n_mod, C_out, slots);
  });
}

}  // namespace

extern "C" {

// pairs a cluster owns at hidden width H (a chunk's workspace is padded to
// a multiple of it), 0 when H is not a plan's width
int siren_chain_cluster_pairs(int H) {
  Plan p{};
  return exact_plan(H, p) ? cluster_pairs(p.mt) : 0;
}

// clusters of the plan for H that the card holds at once, in the mode
// (0: not admitted)
int siren_chain_cluster_max_clusters(int dz_mode, int H, int C_in, int C_out, int* out) {
  *out = 0;
  const int qa = siren_chain_cluster_pairs(H);
  if (qa == 0) return (int)cudaErrorInvalidValue;
  return chain(dz_mode != 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, 0, 1, qa, 1, 1, C_in, H, 2, C_out, 0, out);
}

// the n_mid middle weights (n_mid, H, H) as the blocks' stage images: the
// forward's n_mid products, then the dx chain's n_mid transposed ones
int siren_chain_cluster_prep(const float* w_mid, float* wprep, int H, int n_mid, void* stream) {
  return launch_prep(w_mid, wprep, H, n_mid, 2 * n_mid, (cudaStream_t)stream);
}

// slots of a cluster's dz partial at M points a row
int siren_dz_cluster_slots(int M, int H) {
  Plan p{};
  return M > 0 && exact_plan(H, p) ? siren::dz_slots(M, cluster_pairs(p.mt)) : 0;
}

// The training mode over the chunk's pairs p0 .. p0 + Q - 1: R and D
// (n_mod, Qa, H), every r_l and dpre_l.
int siren_bwd_chain_cluster(const float* coords, const float* z, const float* g,
                            const float* w_first, const float* wprep, const float* w_head,
                            float* R, float* D, long long p0, int Q, int Qa, int T, int M,
                            int C_in, int H, int n_mod, int C_out, void* stream) {
  return chain(false, coords, z, g, w_first, wprep, w_head, R, D, p0, Q, Qa, T, M, C_in, H,
               n_mod, C_out, (cudaStream_t)stream, nullptr);
}

// One chunk of dz: the pairs p0 .. p0 + Q - 1, with R (n_mod, Qa, H) and
// parts (Qa / siren_chain_cluster_pairs(H), n_mod, siren_dz_cluster_slots(M,
// H), H) its workspace; the chain in its dz mode, then the fold into dz
// (zeroed before the first chunk).
int siren_decode_dz_cluster(const float* coords, const float* z, const float* g,
                            const float* w_first, const float* wprep, const float* w_head,
                            float* R, float* parts, float* dz, long long p0, int Q, int Qa,
                            int T, int M, int C_in, int H, int n_mod, int C_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = chain(true, coords, z, g, w_first, wprep, w_head, R, parts, p0, Q, Qa, T, M,
                        C_in, H, n_mod, C_out, s, nullptr);
  if (err != 0) return err;
  return siren::launch_dz_fold(parts, dz, p0, Q, T, M, H, n_mod,
                               siren_chain_cluster_pairs(H), s);
}

}  // extern "C"
