// SIREN-FiLM training backward for Hopper (sm_90a): float32 results, the
// hidden-by-hidden matrix products on the tensor cores as 3xTF32.
//
// Replaces the Pallas kernel _decode_bwd_kernel
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
// chunk a chain kernel, which writes every pre-activation r_l and every
// dpre_l of the chunk to a global workspace, then the kernels that reduce
// that workspace over the pair axis.  Every product of two hidden-wide
// operands is a 3xTF32 mma.sync.m16n8k8 (tf32_mma.cuh): each f32 operand is
// split into big and small TF32 halves and a product is small*big +
// big*small + big*big.  The tensor cores truncate their own f32 sums, so a
// fragment's products of two k8 steps go into a zeroed partial that a
// float32 add carries into the running sum.  Per call:
//
// * siren_bwd_split_kernel: the middle weights in the order the chain
//   consumes them (W_1 .. W_{n-1} for the forward, W_{n-1}^T .. W_1^T for
//   the dx chain), split once into their halves and laid out as mma.sync B
//   fragments: a lane's four values (big and small of its two k rows) are
//   one 16-byte load.  35 MB at Case4, read by every chain block from L2.
// * siren_bwd_chain_kernel: a block owns CP = 64 pairs (the M dimension of
//   every product) and keeps their 64 x H activations in shared memory.
//   Eight warps each own H / 8 output columns for all 64 rows, 96
//   accumulators a thread at H = 384.  The weights stream as 16-row
//   K-slices through a two-stage cp.async buffer, one continuous stream
//   across all 2 (n_mod - 1) products, so the next product's first slice
//   loads while a layer's epilogue runs.  The activations are split as
//   their A fragments are loaded.
//   sin2pi, its derivative, the first layer (C_in columns) and the head
//   (C_out columns) stay on the CUDA cores in float32.
// * siren_bwd_reduce_kernel: dW_mid[l-1] = sin2pi(R_{l-1})^T . D_l as a
//   3xTF32 GEMM over the pair axis.  A block owns a 128 x 128 output tile of
//   one layer and one of BWD_SLICES fixed slices of the chunk's pairs (so
//   each workspace element is read three times at H = 384, and 15 layers x
//   9 tiles x 16 slices is 16.4 waves of one block an SM on 132 SMs rather
//   than 1.02).  Steps of 32 pairs arrive by cp.async; each thread applies
//   sin2pi to its own chunks of R once and splits them.  The partials are
//   added into a segment sum, zeroed every RSEG steps (512 pairs) and added
//   by its owner thread to the slice's partial in global memory.
// * siren_bwd_sums_kernel (CUDA cores, float32: these products have C_in,
//   C_out or one row as their second dimension, almost no flops): dz row
//   sums, dW_first and dW_head, per slice, in segments of SSEG pairs within
//   each row's run of pairs; a pass over the workspace, bound by bytes.
// * siren_bwd_fold_kernel: the slices' partials added in slice order into
//   the outputs.
//
// Every partial element has one owner thread, which adds the chunks in
// order: no atomics, a fixed summation order, bitwise the same result from
// run to run.
//
// What holds it back (tools/siren_bwd_ablation.py, on an H100, cutting one
// cost at a time): in
// the chain the mma.sync work is about 40% of the time and the split of A
// about 11%; the rest is shared-memory fragment loads, the barrier of each
// K-slice and the layer epilogues, which an mma.sync kernel with one block
// of eight warps an SM does not overlap.  The reduction spends about 56% in
// mma.sync.  wgmma (asynchronous, operands from shared memory) is the way
// past both; TF32 wgmma wants both operands K-major, which the pair-major
// workspace and the activation tile are not.
// ---------------------------------------------------------------------------

#include <stdint.h>

#include "siren_common.cuh"
#include "tf32_mma.cuh"

namespace {

using siren::TWO_PI;
using siren::sin2pi;
using namespace tf32mma;

constexpr int MAX_H = 384;       // widest hidden layer the chain's registers hold
constexpr int MAX_C = 4;         // widest C_in and C_out
constexpr int THREADS = 256;     // 8 warps, every kernel but the sums

// chain
constexpr int CP = 64;           // pairs a block owns
constexpr int KS = 16;           // weight rows a streamed K-slice holds (two k8 steps)
constexpr int A_PAD = 4;         // activation row stride H + 4: A fragments hit 32 banks

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

__host__ __device__ inline int slice_len(int Q, int slices) {
  const int per = (Q + slices - 1) / slices;
  return (per + RK - 1) / RK * RK;
}

// floats of one streamed K-slice: KS rows x H columns, big and small
__host__ __device__ inline int kslice_floats(int H) { return KS * H * 2; }

// ---------------------------------------------------------------------------
// weights: big and small halves in B-fragment order
// ---------------------------------------------------------------------------

// wsplit[i] for product i < n_mid is B = w_mid[i] ([k][n]); for i >= n_mid
// it is B = w_mid[n_mid - 1 - (i - n_mid)]^T.  Within a product:
// [k8 block][n8 block][lane][big(t, g), big(t + 4, g), small(t, g),
// small(t + 4, g)], g = lane / 4, t = lane % 4 (the m16n8k8 B fragment).
__global__ void __launch_bounds__(THREADS)
siren_bwd_split_kernel(const float* __restrict__ w_mid, float* __restrict__ wsplit, int H,
                       int n_mid) {
  const int nb8 = H / 8;
  const long long per = (long long)nb8 * nb8 * 32;
  const long long total = 2LL * n_mid * per;
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

// ---------------------------------------------------------------------------
// chain
// ---------------------------------------------------------------------------

size_t chain_smem_bytes(int H) {
  return sizeof(float) * ((size_t)CP * (H + A_PAD) + 2 * (size_t)kslice_floats(H) +
                          2 * (size_t)CP * MAX_C) + sizeof(int) * CP;
}

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

// Workspace: R[l][q][j] and D[l][q][j], layer stride Qa * H.
template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
siren_bwd_chain_kernel(const float* __restrict__ coords,
                       const float* __restrict__ z,
                       const float* __restrict__ g,
                       const float* __restrict__ w_first,
                       const float* __restrict__ wstream,
                       const float* __restrict__ w_head,
                       float* __restrict__ R,
                       float* __restrict__ D,
                       long long p0, int Q, int Qa, int T, int M, int C_in,
                       int n_mod, int C_out) {
  constexpr int H = NT * 64;
  constexpr int lda = H + A_PAD;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                              // CP x (H + A_PAD): activations, then dpre
  float* stage = As + CP * lda;                  // two K-slices
  float* cs = stage + 2 * kslice_floats(H);      // CP x C_in
  float* gs = cs + CP * MAX_C;                   // CP x C_out
  int* zrow = reinterpret_cast<int*>(gs + CP * MAX_C);  // CP row offsets t * H

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * CP;
  const size_t lstride = (size_t)Qa * H;
  const int u_total = 2 * (n_mod - 1) * (H / KS);
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

  float acc[4][NT][4];
  // first layer on the CUDA cores: r_0 = coords . w_first + z_0
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

  // forward recompute: store r_l, keep sin2pi(r_l) as the next A
  for (int l = 0; l < n_mod; ++l) {
    if (l > 0) {
      chain_product<NT>(As, stage, wstream, u, u_total, H, acc);
      __syncthreads();  // every warp is done reading As
    }
    const float* zl = z + (size_t)l * T * H;
    float* Rl = R + l * lstride + (size_t)q0 * H;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
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
  for (int mt = 0; mt < 4; ++mt)
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
    float* Dl = D + l * lstride + (size_t)q0 * H;
    if (l > 0) __syncthreads();  // every warp is done reading As
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
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
          *reinterpret_cast<float2*>(Dl + (size_t)row * H + col) = d;
          if (l > 0) *reinterpret_cast<float2*>(As + row * lda + col) = d;
        }
    if (l > 0) chain_product<NT>(As, stage, wstream, u, u_total, H, acc);
  }
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
// for HEAD, dW_head += sin2pi(x) g.
template <int KIND>
__device__ __forceinline__ void sum_pair(float x, const float* __restrict__ cq,
                                         const float* __restrict__ gq, int nc, float& seg,
                                         float (&seg_c)[MAX_C]) {
  if constexpr (KIND == HEAD) {
    const float s = sin2pi(x);
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < nc) seg_c[c] = fmaf(s, __ldg(gq + c), seg_c[c]);
  } else {
    seg += x;
    if constexpr (KIND == DZ_FIRST) {
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < nc) seg_c[c] = fmaf(__ldg(cq + c), x, seg_c[c]);
    }
  }
}

// Thread j owns column j of X (D_l, or R_last for HEAD) over the pairs
// [lo, hi) of one slice: each row's run of pairs in segments of SSEG; dz
// row totals go to the slice's partial as each run ends, the dW totals at
// the end.
template <int KIND>
__device__ __forceinline__ void sums_body(const float* __restrict__ X,
                                          const float* __restrict__ coords,
                                          const float* __restrict__ g,
                                          float* __restrict__ dz_row0, float* __restrict__ dw,
                                          long long p0, int lo, int hi, int M, int C_in, int H,
                                          int C_out, int j) {
  const int nc = KIND == HEAD ? C_out : C_in;
  float tot_c[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) tot_c[c] = 0.f;
  for (int a = lo; a < hi;) {  // one row's run of pairs
    const long long t = (p0 + a) / M;
    const int b = (int)min((long long)hi, (t + 1) * M - p0);
    const long long m0 = p0 - t * M;  // point of pair q is q + m0
    float tot = 0.f;
    for (int s0 = a; s0 < b; s0 += SSEG) {
      const int s1 = min(b, s0 + SSEG);
      float seg = 0.f, seg_c[MAX_C];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) seg_c[c] = 0.f;
      int q = s0;
      for (; q + SBATCH <= s1; q += SBATCH) {
        float x[SBATCH];
#pragma unroll
        for (int i = 0; i < SBATCH; ++i) x[i] = X[(size_t)(q + i) * H + j];
#pragma unroll
        for (int i = 0; i < SBATCH; ++i)
          sum_pair<KIND>(x[i], coords + (q + i + m0) * C_in, g + (p0 + q + i) * C_out, nc, seg,
                         seg_c);
      }
      for (; q < s1; ++q)
        sum_pair<KIND>(X[(size_t)q * H + j], coords + (q + m0) * C_in, g + (p0 + q) * C_out,
                       nc, seg, seg_c);
      tot += seg;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) tot_c[c] += seg_c[c];
    }
    if constexpr (KIND != HEAD) dz_row0[(size_t)t * H + j] += tot;
    a = b;
  }
  if constexpr (KIND == HEAD) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < nc) dw[(size_t)j * C_out + c] += tot_c[c];
  } else if constexpr (KIND == DZ_FIRST) {
#pragma unroll
    for (int c = 0; c < MAX_C; ++c)
      if (c < nc) dw[(size_t)c * H + j] += tot_c[c];
  }
}

// grid (column tiles of STHREADS, n_mod + 1 jobs, slices).  Job l < n_mod:
// dz_l row sums of D_l (and for l = 0 dW_first = coords^T D_0); job n_mod:
// dW_head = sin2pi(R_last)^T g.
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
    sums_body<HEAD>(R + (n_mod - 1) * lstride, coords, g, nullptr, ps + dwh_off, p0, lo, hi, M,
                    C_in, H, C_out, j);
  else if (job == 0)
    sums_body<DZ_FIRST>(D, coords, g, dz_l, ps + dwf_off, p0, lo, hi, M, C_in, H, C_out, j);
  else
    sums_body<DZ>(D + job * lstride, coords, g, dz_l, nullptr, p0, lo, hi, M, C_in, H, C_out, j);
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

bool shape_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= MAX_H && n_mod >= 1 && C_in >= 1 && C_in <= MAX_C &&
         C_out >= 1 && C_out <= MAX_C;
}

// the dynamic shared-memory attribute, set once per kernel and device
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return err;
}

template <int NT>
int launch_chain(const float* coords, const float* z, const float* g, const float* w_first,
                 const float* wsplit, const float* w_head, float* R, float* D, long long p0,
                 int Q, int Qa, int T, int M, int C_in, int n_mod, int C_out,
                 cudaStream_t stream) {
  static unsigned long long done = 0;
  const size_t smem = chain_smem_bytes(NT * 64);
  cudaError_t err = allow_smem(siren_bwd_chain_kernel<NT>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const unsigned int blocks = (unsigned int)((Q + CP - 1) / CP);
  siren_bwd_chain_kernel<NT><<<blocks, THREADS, smem, stream>>>(
      coords, z, g, w_first, wsplit, w_head, R, D, p0, Q, Qa, T, M, C_in, n_mod, C_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int siren_bwd_tile_pairs() { return CP; }

int siren_bwd_shape_ok(int H, int n_mod, int C_in, int C_out) {
  return shape_ok(H, n_mod, C_in, C_out) ? 1 : 0;
}

int siren_bwd_split(const float* w_mid, float* wsplit, int H, int n_mid, void* stream) {
  if (H <= 0 || H % 64 != 0 || n_mid < 1) return (int)cudaErrorInvalidValue;
  const long long items = 2LL * n_mid * (H / 8) * (H / 8) * 32;
  const unsigned int blocks = (unsigned int)((items + THREADS - 1) / THREADS);
  siren_bwd_split_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(w_mid, wsplit, H, n_mid);
  return (int)cudaGetLastError();
}

int siren_bwd_chain(const float* coords, const float* z, const float* g, const float* w_first,
                    const float* wsplit, const float* w_head, float* R, float* D, long long p0,
                    int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
                    void* stream) {
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q ||
      Qa % CP != 0 || (n_mod > 1 && wsplit == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SIREN_CHAIN(NT)                                                                     \
  case NT:                                                                                  \
    return launch_chain<NT>(coords, z, g, w_first, wsplit, w_head, R, D, p0, Q, Qa, T, M, \
                            C_in, n_mod, C_out, s);
  switch (H / 64) {
    SIREN_CHAIN(1)
    SIREN_CHAIN(2)
    SIREN_CHAIN(3)
    SIREN_CHAIN(4)
    SIREN_CHAIN(5)
    SIREN_CHAIN(6)
  }
#undef SIREN_CHAIN
  return (int)cudaErrorInvalidValue;
}

int siren_bwd_reduce(const float* R, const float* D, float* parts, long long E,
                     long long dwmid_off, int Q, int Qa, int H, int n_mod, int slices,
                     void* stream) {
  if (!shape_ok(H, n_mod, 1, 1) || n_mod < 2 || Q <= 0 || Qa < Q || slices < 1)
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
  if (!shape_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q || slices < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)((H + STHREADS - 1) / STHREADS), (unsigned int)(n_mod + 1),
                  (unsigned int)slices);
  siren_bwd_sums_kernel<<<grid, STHREADS, 0, (cudaStream_t)stream>>>(
      R, D, coords, g, parts, E, dwf_off, dwh_off, p0, Q, Qa, T, M, C_in, H, n_mod, C_out,
      slices);
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
