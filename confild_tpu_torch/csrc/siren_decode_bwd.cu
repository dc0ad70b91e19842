// The SIREN-FiLM training backward's reduction, sums and fold for Hopper
// (sm_90a): float32 results, the hidden-by-hidden matrix products on the
// tensor cores as 3xTF32.
//
// The training backward (ops/siren_decode.py::decode_bwd: the cluster
// chain of siren_chain_cluster.cu, then the kernels here) replaces the
// Pallas kernel _decode_bwd_kernel
// (confild_tpu/ops/siren_decode.py:434, launched at :523 by
// fused_siren_decode_bwd): every training cotangent of the decode on the
// folded operands of siren_decode.cu (w_first, w_mid and z scaled by
// w0 / (2*pi)):
//
//   dz      (n_mod, T, H)      dL/dz_l, summed over the points of each row
//   dw_first(C_in, H)          coords^T . dpre_0, over every pair
//   dw_mid  (n_mod - 1, H, H)  sin2pi(r_{l-1})^T . dpre_l
//   dw_head (H, C_out)         sin2pi(r_last)^T . g
//
// with dpre_l = dx_l * 2*pi*cos2pi(r_l) and dx_{l-1} = dpre_l . W_l^T.
//
// Bound on the H100: operations.  A pair costs the forward recompute, the
// dx chain and the dW products, 3 x 2 (n_mod - 1) H^2 flops of matrix
// products (13.3 MFLOP at Case4), against 24 bytes of coordinates and
// cotangent.  With the products at the tensor cores' dense TF32 rate and
// three products each (495 / 3 TFLOP/s), 4 x 262144 pairs at Case4 take at
// least 84.4 ms; on the CUDA cores' float32 rate 211.0 ms.
//
// Design.  The TPU kernel keeps the 8.8 MB dW_mid accumulator in VMEM across
// a sequential grid.  Hopper blocks run in no order, so the host walks
// chunks of Q consecutive (row, point) pairs (p = t * M + m) and runs per
// chunk the chain, which writes every pre-activation r_l and every dpre_l of
// the chunk to a global workspace, then the kernels here, which reduce that
// workspace over the pair axis.  Every product of two hidden-wide operands
// is 3xTF32 on the tensor cores (tf32_mma.cuh): each f32 operand is split
// into big and small TF32 halves and a product is small*big + big*small +
// big*big.  The tensor cores truncate their own f32 sums, so a fragment's
// products of two k8 steps go into a zeroed partial that a float32 add
// carries into the running sum.  Per call:
//
// * the chain, siren_chain_cluster.cu's training mode (a thread-block
//   cluster kernel on wgmma at every width, with its weight preparation):
//   R[l][q][j] and D[l][q][j], layer stride Qa * H;
// * siren_bwd_reduce_kernel: dW_mid[l-1] = sin2pi(R_{l-1})^T . D_l as a
//   3xTF32 GEMM over the pair axis on mma.sync.m16n8k8.  A block owns a
//   128 x 128 output tile of one layer and one of BWD_SLICES fixed slices of
//   the chunk's pairs (so each workspace element is read three times at
//   H = 384, and 15 layers x 9 tiles x 16 slices is 16.4 waves of one block
//   an SM on 132 SMs rather than 1.02).  Steps of 32 pairs arrive by
//   cp.async; each thread applies sin2pi to its own chunks of R once and
//   splits them.  The partials are added into a segment sum, zeroed every
//   RSEG steps (512 pairs) and added by its owner thread to the slice's
//   partial in global memory.
// * siren_bwd_sums_kernel (CUDA cores, float32: these products have C_in,
//   C_out or one row as their second dimension, almost no flops): dz row
//   sums, dW_first and dW_head, per slice, in segments of SSEG pairs within
//   each row's run of pairs; a pass over the workspace, bound by bytes.
//   Its per-feature sums sit in registers, sized 4 when C_in and C_out are
//   at most 4 and MAX_C = 16 otherwise.
// * siren_bwd_fold_kernel: the slices' partials added in slice order into
//   the outputs.
// The reduction, the sums and the fold take every H up to WORKSPACE_MAX_H.
//
// Every partial element has one owner thread, which adds the chunks in
// order: no atomics, a fixed summation order, bitwise the same result from
// run to run.
//
// What holds the reduction back (tools/siren_bwd_ablation.py, on an H100,
// cutting one cost at a time): it spends about 56% of its time in
// mma.sync.  wgmma (asynchronous, operands from shared memory) is the way
// past it; TF32 wgmma wants both operands K-major, which the pair-major
// workspace is not.
//
// dz (siren_decode_dz_cluster, the DPS guidance gradient) is the cluster
// chain's dz mode with its fold (siren_chain_cluster.cu,
// siren_dz_fold.cuh); it needs none of the kernels here.
// ---------------------------------------------------------------------------

#include <stdint.h>

#include "siren_common.cuh"
#include "siren_tc.cuh"

namespace {

using siren::sin2pi;
using namespace siren_tc;  // THREADS (every kernel but the sums), MAX_C

// the widest H of the workspace that the reduction, the sums and the fold
// take (the cluster chain's, siren_chain_cluster.cu)
constexpr int WORKSPACE_MAX_H = 3072;

// reduction
constexpr int RT = 128;          // output tile
constexpr int RK = 32;           // pairs a step
constexpr int RSEG = 16;         // steps summed apart before joining the slice's partial
constexpr int R_LD = RT + 8;     // split-tile row stride: fragments hit 32 banks
constexpr int R_CHUNKS = RK * RT / 4 / THREADS;   // 16-byte chunks a thread copies, per operand

// sums
constexpr int STHREADS = 128;
constexpr int SSEG = 512;        // pairs summed apart before joining a total
constexpr int SBATCH = 32;       // loads a thread keeps in flight (8 took 2.5x the time)
constexpr int NARROW_C = 4;      // the sums' per-feature registers when C_in, C_out <= 4

__host__ __device__ inline int slice_len(int Q, int slices) {
  const int per = (Q + slices - 1) / slices;
  return (per + RK - 1) / RK * RK;
}

// H a multiple of 64 up to WORKSPACE_MAX_H, C_in and C_out up to MAX_C
inline bool workspace_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= WORKSPACE_MAX_H && n_mod >= 1 && C_in >= 1 &&
         C_in <= MAX_C && C_out >= 1 && C_out <= MAX_C;
}

// ---------------------------------------------------------------------------
// reduction: dW_mid on the tensor cores
// ---------------------------------------------------------------------------

constexpr size_t REDUCE_SMEM = sizeof(float) * (2 * RK * RT + 4 * RK * R_LD);

// the thread's chunk i of a RK x RT step: pair row k, column c
__device__ __forceinline__ void r_chunk(int i, int& k, int& c) {
  const int e = threadIdx.x + i * THREADS;
  k = e / (RT / 4);
  c = (e % (RT / 4)) * 4;
}

__device__ __forceinline__ void r_issue(float* raw, const float* src, int q, int hi, int col0,
                                        int H) {
#pragma unroll
  for (int i = 0; i < R_CHUNKS; ++i) {
    int k, c;
    r_chunk(i, k, c);
    const bool valid = q + k < hi && col0 + c < H;
    cp_async16(raw + 4 * (threadIdx.x + i * THREADS),
               src + (valid ? (size_t)(q + k) * H + col0 + c : 0), valid);
  }
}

// the thread's own raw chunks into split tiles [RK][R_LD], through sin2pi
// for the A operand
template <bool SIN>
__device__ __forceinline__ void r_split(const float* raw, float* big, float* small) {
#pragma unroll
  for (int i = 0; i < R_CHUNKS; ++i) {
    int k, c;
    r_chunk(i, k, c);
    float4 x = *reinterpret_cast<const float4*>(raw + 4 * (threadIdx.x + i * THREADS));
    if constexpr (SIN) x = make_float4(sin2pi(x.x), sin2pi(x.y), sin2pi(x.z), sin2pi(x.w));
    uint32_t b[4], s[4];
    split<false>(x.x, b[0], s[0]);
    split<false>(x.y, b[1], s[1]);
    split<false>(x.z, b[2], s[2]);
    split<false>(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(big + k * R_LD + c) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + k * R_LD + c) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// blockIdx.x = (slice * n_mid + layer) * tiles + tile: the tiles of one
// layer and slice are neighbours, so they run together and share its
// workspace reads in L2.  Warp (wa, wb) = (w / 4, w % 4) owns rows
// 64 wa .. + 63 and columns 32 wb .. + 31 of the tile.
__global__ void __launch_bounds__(THREADS, 1)
siren_bwd_reduce_kernel(const float* __restrict__ R,
                        const float* __restrict__ D,
                        float* __restrict__ parts,
                        long long E, long long dwmid_off, int Q, int Qa, int H, int n_mod,
                        int slices) {
  extern __shared__ __align__(16) float smem[];
  float* rawA = smem;
  float* rawB = rawA + RK * RT;
  float* Ab = rawB + RK * RT;
  float* As = Ab + RK * R_LD;
  float* Bb = As + RK * R_LD;
  float* Bs = Bb + RK * R_LD;

  const int n_mid = n_mod - 1;
  const int tb = (H + RT - 1) / RT;
  const int tiles = tb * tb;
  const int tile = blockIdx.x % tiles;
  const int layer = (blockIdx.x / tiles) % n_mid;
  const int slice = blockIdx.x / tiles / n_mid;
  const int a0 = (tile / tb) * RT, b0 = (tile % tb) * RT;
  const int len = slice_len(Q, slices);
  const int lo = slice * len;
  const int hi = min(Q, lo + len);
  if (lo >= hi) return;

  const size_t lstride = (size_t)Qa * H;
  const float* A = R + layer * lstride;
  const float* B = D + (layer + 1) * lstride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wa = warp / 4, wb = warp % 4;

  float seg[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) seg[mt][nt][e] = 0.f;

  float* out = parts + (size_t)slice * E + dwmid_off + (size_t)layer * H * H;
  const int steps = (hi - lo + RK - 1) / RK;
  r_issue(rawA, A, lo, hi, a0, H);
  r_issue(rawB, B, lo, hi, b0, H);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // every warp is done with the split tiles of the step before
    r_split<true>(rawA, Ab, As);
    r_split<false>(rawB, Bb, Bs);
    if (step + 1 < steps) {  // the raw chunks are the thread's own: reuse at once
      r_issue(rawA, A, lo + (step + 1) * RK, hi, a0, H);
      r_issue(rawB, B, lo + (step + 1) * RK, hi, b0, H);
    }
    cp_async_commit();
    __syncthreads();
    // two k8 steps (16 pairs) a zeroed partial per fragment
#pragma unroll
    for (int k16 = 0; k16 < RK / 16; ++k16) {
      // A (16 x 8) = sin2pi(R)^T: element (a, q) at split tile [q][a]
      uint32_t ab[2][4][4], as[2][4][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int o = (k16 * 16 + kk * 8 + t) * R_LD + wa * 64 + mt * 16 + g;
          ab[kk][mt][0] = __float_as_uint(Ab[o]);
          ab[kk][mt][1] = __float_as_uint(Ab[o + 8]);
          ab[kk][mt][2] = __float_as_uint(Ab[o + 4 * R_LD]);
          ab[kk][mt][3] = __float_as_uint(Ab[o + 4 * R_LD + 8]);
          as[kk][mt][0] = __float_as_uint(As[o]);
          as[kk][mt][1] = __float_as_uint(As[o + 8]);
          as[kk][mt][2] = __float_as_uint(As[o + 4 * R_LD]);
          as[kk][mt][3] = __float_as_uint(As[o + 4 * R_LD + 8]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // B (8 x 8) = D: element (q, b) at split tile [q][b]
        uint32_t bb[2][2], bs[2][2];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int o = (k16 * 16 + kk * 8 + t) * R_LD + wb * 32 + nt * 8 + g;
          bb[kk][0] = __float_as_uint(Bb[o]);
          bb[kk][1] = __float_as_uint(Bb[o + 4 * R_LD]);
          bs[kk][0] = __float_as_uint(Bs[o]);
          bs[kk][1] = __float_as_uint(Bs[o + 4 * R_LD]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma3_into<false, false>(part, ab[0][mt], as[0][mt], bb[0], bs[0]);
          mma3_into<false, false>(part, ab[1][mt], as[1][mt], bb[1], bs[1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) seg[mt][nt][e] += part[e];
        }
      }
    }
    if ((step + 1) % RSEG == 0 || step + 1 == steps) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int a = a0 + wa * 64 + mt * 16 + g + 8 * h;
            const int b = b0 + wb * 32 + nt * 8 + 2 * t;
            if (a < H && b < H) {
              float2* p = reinterpret_cast<float2*>(out + (size_t)a * H + b);
              const float2 v = *p;
              *p = make_float2(v.x + seg[mt][nt][2 * h], v.y + seg[mt][nt][2 * h + 1]);
            }
            seg[mt][nt][2 * h] = seg[mt][nt][2 * h + 1] = 0.f;
          }
    }
  }
}

// ---------------------------------------------------------------------------
// sums on the CUDA cores: dz, dW_first, dW_head
// ---------------------------------------------------------------------------

enum SumKind { DZ = 0, DZ_FIRST = 1, HEAD = 2 };

// One pair's terms: dz and, for DZ_FIRST, dW_first += coords (x);
// for HEAD, dW_head += sin2pi(x) g; nc <= NC features.
template <int KIND, int NC>
__device__ __forceinline__ void sum_pair(float x, const float* __restrict__ cq,
                                         const float* __restrict__ gq, int nc, float& seg,
                                         float (&seg_c)[NC]) {
  if constexpr (KIND == HEAD) {
    const float s = sin2pi(x);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) seg_c[c] = fmaf(s, __ldg(gq + c), seg_c[c]);
  } else {
    seg += x;
    if constexpr (KIND == DZ_FIRST) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (c < nc) seg_c[c] = fmaf(__ldg(cq + c), x, seg_c[c]);
    }
  }
}

// Thread j owns column j of X (D_l, or R_last for HEAD) over the pairs
// [lo, hi) of one slice: each row's run of pairs in segments of SSEG; dz
// row totals go to the slice's partial as each run ends, the dW totals at
// the end.
template <int KIND, int NC>
__device__ __forceinline__ void sums_body(const float* __restrict__ X,
                                          const float* __restrict__ coords,
                                          const float* __restrict__ g,
                                          float* __restrict__ dz_row0, float* __restrict__ dw,
                                          long long p0, int lo, int hi, int M, int C_in, int H,
                                          int C_out, int j) {
  const int nc = KIND == HEAD ? C_out : C_in;
  float tot_c[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) tot_c[c] = 0.f;
  for (int a = lo; a < hi;) {  // one row's run of pairs
    const long long t = (p0 + a) / M;
    const int b = (int)min((long long)hi, (t + 1) * M - p0);
    const long long m0 = p0 - t * M;  // point of pair q is q + m0
    float tot = 0.f;
    for (int s0 = a; s0 < b; s0 += SSEG) {
      const int s1 = min(b, s0 + SSEG);
      float seg = 0.f, seg_c[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) seg_c[c] = 0.f;
      int q = s0;
      for (; q + SBATCH <= s1; q += SBATCH) {
        float x[SBATCH];
#pragma unroll
        for (int i = 0; i < SBATCH; ++i) x[i] = X[(size_t)(q + i) * H + j];
#pragma unroll
        for (int i = 0; i < SBATCH; ++i)
          sum_pair<KIND, NC>(x[i], coords + (q + i + m0) * C_in, g + (p0 + q + i) * C_out, nc,
                             seg, seg_c);
      }
      for (; q < s1; ++q)
        sum_pair<KIND, NC>(X[(size_t)q * H + j], coords + (q + m0) * C_in,
                           g + (p0 + q) * C_out, nc, seg, seg_c);
      tot += seg;
#pragma unroll
      for (int c = 0; c < NC; ++c) tot_c[c] += seg_c[c];
    }
    if constexpr (KIND != HEAD) dz_row0[(size_t)t * H + j] += tot;
    a = b;
  }
  if constexpr (KIND == HEAD) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) dw[(size_t)j * C_out + c] += tot_c[c];
  } else if constexpr (KIND == DZ_FIRST) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) dw[(size_t)c * H + j] += tot_c[c];
  }
}

// grid (column tiles of STHREADS, n_mod + 1 jobs, slices).  Job l < n_mod:
// dz_l row sums of D_l (and for l = 0 dW_first = coords^T D_0); job n_mod:
// dW_head = sin2pi(R_last)^T g.  C_in, C_out <= NC.
template <int NC>
__global__ void __launch_bounds__(STHREADS)
siren_bwd_sums_kernel(const float* __restrict__ R,
                      const float* __restrict__ D,
                      const float* __restrict__ coords,
                      const float* __restrict__ g,
                      float* __restrict__ parts,
                      long long E, long long dwf_off, long long dwh_off, long long p0,
                      int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
                      int slices) {
  const int j = blockIdx.x * STHREADS + threadIdx.x;
  const int job = blockIdx.y, slice = blockIdx.z;
  const int len = slice_len(Q, slices);
  const int lo = slice * len;
  const int hi = min(Q, lo + len);
  if (j >= H || lo >= hi) return;
  float* ps = parts + (size_t)slice * E;
  const size_t lstride = (size_t)Qa * H;
  float* dz_l = ps + (size_t)job * T * H;  // dz is the partial's first block
  if (job == n_mod)
    sums_body<HEAD, NC>(R + (n_mod - 1) * lstride, coords, g, nullptr, ps + dwh_off, p0, lo,
                        hi, M, C_in, H, C_out, j);
  else if (job == 0)
    sums_body<DZ_FIRST, NC>(D, coords, g, dz_l, ps + dwf_off, p0, lo, hi, M, C_in, H, C_out, j);
  else
    sums_body<DZ, NC>(D + job * lstride, coords, g, dz_l, nullptr, p0, lo, hi, M, C_in, H,
                      C_out, j);
}

// out[e] = parts[0][e] + parts[1][e] + ... in slice order
__global__ void __launch_bounds__(THREADS)
siren_bwd_fold_kernel(const float* __restrict__ parts, float* __restrict__ out, long long E,
                      int slices) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = parts[e];
    for (int s = 1; s < slices; ++s) acc += parts[(size_t)s * E + e];
    out[e] = acc;
  }
}

}  // namespace

extern "C" {

int siren_bwd_reduce(const float* R, const float* D, float* parts, long long E,
                     long long dwmid_off, int Q, int Qa, int H, int n_mod, int slices,
                     void* stream) {
  if (!workspace_ok(H, n_mod, 1, 1) || n_mod < 2 || Q <= 0 || Qa < Q || slices < 1)
    return (int)cudaErrorInvalidValue;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(siren_bwd_reduce_kernel, REDUCE_SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const int tb = (H + RT - 1) / RT;
  const unsigned int blocks = (unsigned int)(tb * tb * (n_mod - 1) * slices);
  siren_bwd_reduce_kernel<<<blocks, THREADS, REDUCE_SMEM, (cudaStream_t)stream>>>(
      R, D, parts, E, dwmid_off, Q, Qa, H, n_mod, slices);
  return (int)cudaGetLastError();
}

int siren_bwd_sums(const float* R, const float* D, const float* coords, const float* g,
                   float* parts, long long E, long long dwf_off, long long dwh_off, long long p0,
                   int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
                   int slices, void* stream) {
  if (!workspace_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q ||
      slices < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((H + STHREADS - 1) / STHREADS), (unsigned int)(n_mod + 1),
                  (unsigned int)slices);
  const auto kernel = C_in <= NARROW_C && C_out <= NARROW_C ? siren_bwd_sums_kernel<NARROW_C>
                                                            : siren_bwd_sums_kernel<MAX_C>;
  kernel<<<grid, STHREADS, 0, (cudaStream_t)stream>>>(R, D, coords, g, parts, E, dwf_off,
                                                      dwh_off, p0, Q, Qa, T, M, C_in, H, n_mod,
                                                      C_out, slices);
  return (int)cudaGetLastError();
}

int siren_bwd_fold(const float* parts, float* out, long long E, int slices, void* stream) {
  if (E <= 0 || slices < 1) return (int)cudaErrorInvalidValue;
  const long long want = (E + THREADS - 1) / THREADS;
  const unsigned int blocks = (unsigned int)(want < 4096 ? want : 4096);
  siren_bwd_fold_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(parts, out, E, slices);
  return (int)cudaGetLastError();
}

}  // extern "C"
