// The SIREN-FiLM training backward's reduction, sums and fold for Hopper
// (sm_90a): float32 results, the hidden-by-hidden matrix products on the
// tensor cores as 3xTF32 on wgmma.
//
// The training backward (ops/siren_decode.py::decode_bwd: the cluster
// chain of siren_chain_cluster.cu, then the kernels here) replaces the
// Pallas kernel _decode_bwd_kernel
// (confild_tpu/ops/siren_decode.py:434, launched at :523 by
// fused_siren_decode_bwd): every training cotangent of the decode on the
// folded operands of siren_fwd_cluster.cu (w_first, w_mid and z scaled by
// w0 / (2*pi)):
//
//   dz      (n_mod, T, H)      dL/dz_l, summed over the points of each row
//   dw_first(C_in, H)          coords^T . dpre_0, over every pair
//   dw_mid  (n_mod - 1, H, H)  sin2pi(r_{l-1})^T . dpre_l
//   dw_head (H, C_out)         sin2pi(r_last)^T . g
//
// with dpre_l = dx_l * 2*pi*cos2pi(r_l) and dx_{l-1} = dpre_l . W_l^T.
//
// Design.  The TPU kernel keeps the 8.8 MB dW_mid accumulator in VMEM across
// a sequential grid.  Hopper blocks run in no order, so the host walks
// chunks of Q consecutive (row, point) pairs (p = t * M + m) and runs per
// chunk the chain, which writes every pre-activation r_l and every dpre_l of
// the chunk to a global workspace, then the kernels here, which reduce that
// workspace over the pair axis in BWD_SLICES fixed slices of the chunk, each
// into its own partial of every cotangent.  Per call:
//
// * the chain, siren_chain_cluster.cu's training mode (a thread-block
//   cluster kernel on wgmma at every width, with its weight preparation):
//   R[l][q][j] and D[l][q][j], layer stride Qa * H, pair-major;
// * siren_bwd_reduce_kernel: dW_mid[l-1] = sin2pi(R_{l-1})^T . D_l, a GEMM
//   over the pair axis (K) on wgmma in 3xTF32 (tf32_mma.cuh: each f32
//   operand split into TF32 big and small halves, a product is small*big +
//   big*small + big*big).  A block owns a 128 x BN output tile (BN = 192
//   where it divides H, else 128) of one layer and one slice; its two
//   warpgroups each own 64 rows and all BN columns, as m64n64 subtiles at
//   BN = 192 (two partials taking turns) and one m64n128 at BN = 128.  TF32
//   wgmma reads shared-memory operands only K-major, and the workspace is
//   pair-major, so neither operand arrives as it wants: sin2pi(R)^T is the
//   register A operand, each thread loading its fragments straight from the
//   raw pair-major rows, applying sin2pi and splitting them in registers; D
//   is the B operand, which every thread helps transpose once a step from
//   its raw rows into the no-swizzle K-major core-matrix image of both
//   halves (reduce_image).  The raw rows of a step of 32 pairs arrive as
//   two 2-D bulk tensor copies (TMA, a tensor map per operand; one bulk
//   copy a row was 1.5x slower: the copy engine's rate for 512-byte copies)
//   into a ring of 3 or 4 stages, two steps ahead.  The products of a
//   K-slice of 16 pairs go into a zeroed partial that a float32 add carries
//   into the running sum (the tensor cores truncate their own sums), and
//   the running sum joins the slice's partial in global memory every RSEG
//   steps (512 pairs) by a reduction instruction of its owner thread (red,
//   no read back: a load and a store there took a quarter of the time).  A
//   workspace element crosses L2 -> SM H / BN times as R and H / 128 times
//   as D: at H = 384, 2 and 3 (the HMMA kernel this replaced took 128 x
//   128 tiles, 3 and 3).
// * siren_bwd_sums_kernel (CUDA cores, float32: these products have C_in,
//   C_out or one row as their second dimension, almost no flops): dz row
//   sums, dW_first and dW_head, per slice, in segments of SSEG pairs within
//   each row's run of pairs; a pass over the workspace, bound by bytes.
//   Its per-feature sums sit in registers, sized 4 when C_in and C_out are
//   at most 4 and MAX_C = 16 otherwise; wider C_in and C_out (any, as the
//   TPU kernel) take one more job each chunk of MAX_C features past the
//   first, which sums only dW_first's or dW_head's columns of its chunk, so
//   the registers do not depend on C.
// * siren_bwd_fold_kernel: the slices' partials added in slice order into
//   the outputs.
// The reduction, the sums and the fold take every H that is a multiple of
// 64 up to WORKSPACE_MAX_H, a ragged last tile and a ragged last step.
//
// Every partial element has one owner thread, which adds the chunks in
// order (the reduction's adds are reductions to an element no other thread
// touches): a fixed summation order, bitwise the same result from run to
// run.
//
// Bound on the H100 of the reduction: operations.  At Case4 (15 middle
// layers of 384, 4 x 262144 pairs a CNF batch step) it computes 4.64 TFLOP
// of products, three times over for 3xTF32 at the dense TF32 rate of 495
// TFLOP/s: 28.1 ms; it reads 48.3 GB of workspace, 14.4 ms at 3.35 TB/s.
// It takes 59.5 ms there (2.1x; the HMMA kernel 104.9), 112 ms at
// 3 -> 1024 x 16 -> 5 on 4 x 65536 (tools/siren_bwd_ablation.py, an
// H100).  What still holds it back, cutting one cost at a time: the step's
// B image through the threads (a load, a split and two 16-byte stores an
// element; 12 ms at Case4), two of the three products (14 ms: not the
// tensor rate itself, the waits of a warpgroup on its own subtiles), the
// sines (5 ms, once for each column tile of the same R element) and the
// flush (4 ms).  Wider subtiles (one m64n192), partials of 32 pairs and a
// ring of two stages measured slower or the same.
//
// dz (siren_decode_dz_cluster, the DPS guidance gradient) is the cluster
// chain's dz mode with its fold (siren_chain_cluster.cu,
// siren_dz_fold.cuh); it needs none of the kernels here.
// ---------------------------------------------------------------------------

#include <stdint.h>

#include "siren_cluster.cuh"
#include "siren_common.cuh"

namespace {

using siren::sin2pi;
using namespace siren_cluster;  // THREADS, MAX_C, the mbarriers and the wgmma product
using tf32mma::smem_addr;

// the widest H of the workspace that the reduction, the sums and the fold
// take (the cluster chain's, siren_chain_cluster.cu)
constexpr int WORKSPACE_MAX_H = 3072;

// reduction
constexpr int RM = 128;          // output rows a block (sin2pi(R)'s columns): 64 a warpgroup
constexpr int RK = 32;           // pairs a step: two K-slices of 16, a tensor copy's rows
constexpr int RSEG = 16;         // steps summed apart before joining the slice's partial
// raw R row stride, the width of R's tensor copy (its last 8 columns are
// never read): a warp's A fragment loads hit 32 banks
constexpr int RA_LD = RM + 8;

// the output tile's columns (D's) at width H: 192 where they divide H,
// else 128 (a ragged last tile is masked)
__host__ __device__ constexpr int reduce_cols(int H) { return H % 192 == 0 ? 192 : 128; }
// the columns of a wgmma subtile at each tile width (at tiles of 192, one
// subtile of 96 or 192 measured slower than three of 64)
constexpr int SUBN_192 = 64, SUBN_128 = 128;
// bytes of one raw stage: RK rows of R's RM columns, then RK rows of D's BN
__host__ __device__ constexpr int raw_bytes(int BN) { return RK * (RA_LD + BN) * 4; }
// bytes of one step's B image: two K-slices x two k8 steps x big, small
__host__ __device__ constexpr int image_bytes(int BN) { return RK * BN * 2 * 4; }
// raw stages in the ring: as many as fit, 2 to 4
__host__ __device__ constexpr int reduce_stages(int BN) {
  int ns = 4;
  while (ns > 2 && ALIGN + ns * raw_bytes(BN) + 2 * image_bytes(BN) + ns * 8 > SMEM_MAX) --ns;
  return ns;
}
__host__ __device__ constexpr int reduce_smem(int BN) {
  return ALIGN + reduce_stages(BN) * raw_bytes(BN) + 2 * image_bytes(BN) +
         reduce_stages(BN) * 8;
}

// sums
constexpr int STHREADS = 128;
constexpr int SSEG = 512;        // pairs summed apart before joining a total
constexpr int SBATCH = 32;       // loads a thread keeps in flight (8 took 2.5x the time)
constexpr int NARROW_C = 4;      // the sums' per-feature registers when C_in, C_out <= 4

__host__ __device__ inline int slice_len(int Q, int slices) {
  const int per = (Q + slices - 1) / slices;
  return (per + RK - 1) / RK * RK;
}

// H a multiple of 64 up to WORKSPACE_MAX_H, any C_in and C_out
inline bool workspace_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= WORKSPACE_MAX_H && n_mod >= 1 && C_in >= 1 &&
         C_out >= 1;
}
// chunks of MAX_C features
inline int feature_chunks(int c) { return (c + MAX_C - 1) / MAX_C; }

// ---------------------------------------------------------------------------
// reduction: dW_mid on wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The step from pair q0 into a raw stage, by one thread: a box of RK
// workspace rows (row_a = layer * Qa + q0 of R, row_b of D) by RA_LD
// columns of R from a0 and one by BN columns of D from b0, each one bulk
// tensor copy (columns past H and rows past the workspace come as zeros);
// the stage's barrier expects both boxes.
template <int BN>
__device__ __forceinline__ void reduce_fill(uint32_t stage, uint32_t bar, const CUtensorMap* map_r,
                                            const CUtensorMap* map_d, int row_a, int row_b,
                                            int a0, int b0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(raw_bytes(BN))
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(stage),
      "l"(reinterpret_cast<uint64_t>(map_r)), "r"(a0), "r"(row_a), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(stage + 4u * RK * RA_LD),
      "l"(reinterpret_cast<uint64_t>(map_d)), "r"(b0), "r"(row_b), "r"(bar)
      : "memory");
}

// A step's B image from its raw D rows (every thread its share; valid: the
// step's pairs before hi): for each K-slice c, k8 step kk and half, the
// no-swizzle K-major core matrices the wgmma descriptor reads (b_desc),
// [n / 8][k / 4][n % 8][4 k], small BN x 32 bytes after big, the k8 steps
// 2 BN x 32 apart, the K-slices 4 BN x 32.  A thread writes one 16-byte
// row at a time: pairs 4 r .. 4 r + 3 of column n, zero from valid on.
// (Mirrored by ops/siren_decode.py::reduce_operand_layout.)
template <int BN>
__device__ __forceinline__ void reduce_image(const float* rawB, unsigned char* img, int valid) {
#pragma unroll
  for (int i = 0; i < RK * BN / 4 / THREADS; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = u / BN, n = u % BN;
    uint32_t big[4], small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = 4 * r + e < valid ? rawB[(4 * r + e) * BN + n] : 0.f;
      tf32mma::split<false>(x, big[e], small[e]);
    }
    const int off = (r >> 2) * (128 * BN) + ((r >> 1) & 1) * (64 * BN) + (n >> 3) * 256 +
                    (r & 1) * 128 + (n & 7) * 16;
    *reinterpret_cast<uint4*>(img + off) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(img + off + 32 * BN) =
        make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// The A fragments of K-slice c (16 pairs) straight from a step's raw R
// rows: A(m, k) = sin2pi(R[q0 + 16 c + k][a0 + m]), zero from valid on;
// lane (g, t) of warp w of a warpgroup holds rows 16 w + g (+ 8) and
// columns t (+ 4) of each k8 step (wgmma_tf32).  arow: the block's row
// 64 wg + 16 w + g.
__device__ __forceinline__ void reduce_load_a(float (&ar)[2][4], const float* rawA, int arow,
                                              int t, int c, int valid) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 16 * c + 8 * kk + t + 4 * (e >> 1);
      const float x = rawA[k * RA_LD + arow + 8 * (e & 1)];
      ar[kk][e] = k < valid ? sin2pi(x) : 0.f;
    }
}

// d (m64 x nN, f32) = a (m64 x k8, TF32 in registers) . b (k8 x nN, TF32
// in shared memory, K-major, b_desc) + (scale_d ? d : 0), as
// siren_cluster.cuh::wgmma_tf32 at N = 64; d[4j + e]: row 16 w + g +
// 8 (e / 2), column 8 j + 2 t + e % 2.
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                        int scale_d);

template <>
__device__ __forceinline__ void wgmma_n<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                            int scale_d) {
  wgmma_tf32(d, a, desc, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_n<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// One K-slice's six products for one m64 x SUBN subtile into the partial
// d, committed as one group (siren_cluster.cuh::issue_slice at any width):
// for each k8 step small . big (zeroing d at the first), big . small,
// big . big; b is the subtile's first column in the step's image.
template <int BN, int SUBN>
__device__ __forceinline__ void reduce_slice(float (&d)[SUBN / 2], const uint32_t (&ab)[2][4],
                                             const uint32_t (&as)[2][4], uint32_t b) {
#pragma unroll
  for (int i = 0; i < SUBN / 2; ++i) fence_reg(d[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t img = b + kk * (2 * BN * 32);
    const uint64_t big = b_desc(img), small = b_desc(img + BN * 32);
    wgmma_n<SUBN>(d, as[kk], big, kk);
    wgmma_n<SUBN>(d, ab[kk], small, 1);
    wgmma_n<SUBN>(d, ab[kk], big, 1);
  }
  wgmma_commit();
}

// acc += a finished partial, in float32 (round to nearest)
template <int R>
__device__ __forceinline__ void carry_n(float (&acc)[R], float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    fence_reg(part[i]);
    acc[i] += part[i];
  }
}

// blockIdx.x = (slice * n_mid + layer) * tiles + tile: the tiles of one
// layer and slice are neighbours, so they run together and share its
// workspace reads in L2.  A block owns rows a0 .. + RM - 1 (sin2pi(R)'s
// columns) and columns b0 .. + BN - 1 (D's) of one layer's dW_mid over one
// slice of the chunk's pairs; warpgroup wg owns rows 64 wg .. + 63 and all
// BN columns as BN / SUBN m64 x SUBN subtiles.
//
// A step of RK pairs: its raw rows come by two tensor copies into stage
// s % NS of the ring; every thread writes its share of the step's B image
// (two images take turns) and fences it for the async proxy.  At the
// step's block barrier the image is whole and every thread is done with
// step s - 1 (its raw stage, its image, its products), so thread 0 refills
// that stage with step s - 1 + NS.  The products of each K-slice run
// subtile by subtile; while the first subtile's run, the thread loads the
// next K-slice's A fragments, or in the step's last K-slice waits for step
// s + 1's raw rows and writes its image and first A fragments.  The running
// sum joins the slice's partial every RSEG steps.
template <int BN, int SUBN>
__global__ void __launch_bounds__(THREADS, 1)
siren_bwd_reduce_kernel(const __grid_constant__ CUtensorMap map_r,
                        const __grid_constant__ CUtensorMap map_d,
                        float* __restrict__ parts,
                        long long E, long long dwmid_off, int Q, int Qa, int H, int n_mod,
                        int slices) {
  constexpr int NS = reduce_stages(BN);
  constexpr int NSUB = BN / SUBN, NP = NSUB > 1 ? 2 : 1;   // subtiles, partials
  static_assert(BN % SUBN == 0 && SUBN % 32 == 0, "whole subtiles");
  constexpr int RAW = raw_bytes(BN), IMG = image_bytes(BN);
  static_assert(RK == 32 && RK * BN / 4 % THREADS == 0, "a step's image splits over the block");
  static_assert(reduce_smem(BN) <= SMEM_MAX, "the tile exceeds a block's shared memory");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* img = base + NS * RAW;
  const uint32_t raw0 = smem_addr(base), full0 = smem_addr(img + 2 * IMG);

  const int n_mid = n_mod - 1;
  const int tn = (H + BN - 1) / BN;
  const int tiles = (H + RM - 1) / RM * tn;
  const int tile = blockIdx.x % tiles;
  const int layer = (blockIdx.x / tiles) % n_mid;
  const int slice = blockIdx.x / tiles / n_mid;
  const int a0 = (tile / tn) * RM, b0 = (tile % tn) * BN;
  const int len = slice_len(Q, slices);
  const int lo = slice * len;
  const int hi = min(Q, lo + len);
  if (lo >= hi) return;

  const int row_a = layer * Qa + lo, row_b = (layer + 1) * Qa + lo;
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int arow = (tid >> 7) * 64 + 16 * ((tid & 127) >> 5) + (lane >> 2);
  const int steps = (hi - lo + RK - 1) / RK;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int u = 0; u < NS && u < steps; ++u)
      reduce_fill<BN>(raw0 + u * RAW, full0 + 8 * u, &map_r, &map_d, row_a + u * RK,
                      row_b + u * RK, a0, b0);

  float acc[NSUB][SUBN / 2], part[NP][SUBN / 2];
#pragma unroll
  for (int j = 0; j < NSUB; ++j)
#pragma unroll
    for (int i = 0; i < SUBN / 2; ++i) acc[j][i] = 0.f;
  float ar[2][4];
  // step 0's image and first A fragments
  mbar_wait(full0, 0);
  reduce_image<BN>(reinterpret_cast<const float*>(base + RK * RA_LD * 4), img, hi - lo);
  fence_proxy_async();
  reduce_load_a(ar, reinterpret_cast<const float*>(base), arow, t, 0, hi - lo);

  float* out = parts + (size_t)slice * E + dwmid_off + (size_t)layer * H * H;
  for (int s = 0; s < steps; ++s) {
    const int q0 = lo + s * RK;
    const float* rawA = reinterpret_cast<const float*>(base + (s % NS) * RAW);
    const uint32_t ib = smem_addr(img + (s & 1) * IMG);
    __syncthreads();  // the step's image is whole; every thread is done with step s - 1
    if (tid == 0 && s > 0 && s - 1 + NS < steps) {
      const int u = s - 1 + NS;
      fence_proxy_async();  // the stage's generic reads before the async proxy's refill
      reduce_fill<BN>(raw0 + (u % NS) * RAW, full0 + 8 * (u % NS), &map_r, &map_d,
                      row_a + u * RK, row_b + u * RK, a0, b0);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32mma::split<false>(ar[kk][e], ab[kk][e], as[kk][e]);
      // subtile j's products go into partial j % 2 while the sum of
      // subtile j - 1's is carried into its accumulators
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        reduce_slice<BN, SUBN>(part[j % NP], ab, as, ib + c * (128 * BN) + j * (SUBN * 32));
        if (j > 0) {
          wgmma_wait<1>();
          carry_n(acc[j - 1], part[(j - 1) % NP]);
        } else if (c == 0) {  // the thread's other work while the products run
          reduce_load_a(ar, rawA, arow, t, 1, hi - q0);
        } else if (s + 1 < steps) {
          const int sn = s + 1;
          const unsigned char* raw_n = base + (sn % NS) * RAW;
          mbar_wait(full0 + 8 * (sn % NS), (sn / NS) & 1);
          reduce_image<BN>(reinterpret_cast<const float*>(raw_n + RK * RA_LD * 4),
                           img + (sn & 1) * IMG, hi - q0 - RK);
          fence_proxy_async();
          reduce_load_a(ar, reinterpret_cast<const float*>(raw_n), arow, t, 0, hi - q0 - RK);
        }
      }
      wgmma_wait<0>();
      carry_n(acc[NSUB - 1], part[(NSUB - 1) % NP]);
    }
    if ((s + 1) % RSEG == 0 || s + 1 == steps) {
#pragma unroll
      for (int j = 0; j < NSUB; ++j)
#pragma unroll
        for (int i = 0; i < SUBN / 2; i += 2) {
          const int a = a0 + arow + 8 * ((i >> 1) & 1);
          const int b = b0 + SUBN * j + (i >> 2) * 8 + 2 * t;
          if (a < H && b < H)   // a reduction, no read back: the owner's adds in order
            atomicAdd(reinterpret_cast<float2*>(out + (size_t)a * H + b),
                      make_float2(acc[j][i], acc[j][i + 1]));
          acc[j][i] = acc[j][i + 1] = 0.f;
        }
    }
  }
}

// ---------------------------------------------------------------------------
// sums on the CUDA cores: dz, dW_first, dW_head
// ---------------------------------------------------------------------------

enum SumKind { DZ = 0, DZ_FIRST = 1, HEAD = 2 };

// One pair's terms: dz and, for DZ_FIRST, dW_first += coords (x);
// for HEAD, dW_head += sin2pi(x) g; nc <= NC features from cq, gq on.
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
// row totals go to the slice's partial as each run ends (unless dz_row0 is
// null: a later chunk of dW_first's features), the dW totals of the
// features c0 .. c0 + NC - 1 at the end.
template <int KIND, int NC>
__device__ __forceinline__ void sums_body(const float* __restrict__ X,
                                          const float* __restrict__ coords,
                                          const float* __restrict__ g,
                                          float* __restrict__ dz_row0, float* __restrict__ dw,
                                          long long p0, int lo, int hi, int M, int C_in, int H,
                                          int C_out, int j, int c0) {
  const int nc = min(NC, (KIND == HEAD ? C_out : C_in) - c0);
  coords += c0;
  g += c0;
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
    if (KIND != HEAD && dz_row0 != nullptr) dz_row0[(size_t)t * H + j] += tot;
    a = b;
  }
  if constexpr (KIND == HEAD) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) dw[(size_t)j * C_out + c0 + c] += tot_c[c];
  } else if constexpr (KIND == DZ_FIRST) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (c < nc) dw[(size_t)(c0 + c) * H + j] += tot_c[c];
  }
}

// grid (column tiles of STHREADS, jobs, slices).  Job l < n_mod: dz_l row
// sums of D_l (and for l = 0 dW_first = coords^T D_0, its first NC
// features); job n_mod: dW_head = sin2pi(R_last)^T g, its first NC
// features; then a job for each further chunk of NC features of dW_first
// (no dz), then of dW_head.
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
  const int more_in = (C_in + NC - 1) / NC - 1;   // dW_first's chunks past the first
  const float* r_last = R + (n_mod - 1) * lstride;
  if (job == n_mod)
    sums_body<HEAD, NC>(r_last, coords, g, nullptr, ps + dwh_off, p0, lo, hi, M, C_in, H, C_out,
                        j, 0);
  else if (job == 0)
    sums_body<DZ_FIRST, NC>(D, coords, g, dz_l, ps + dwf_off, p0, lo, hi, M, C_in, H, C_out, j,
                            0);
  else if (job < n_mod)
    sums_body<DZ, NC>(D + job * lstride, coords, g, dz_l, nullptr, p0, lo, hi, M, C_in, H,
                      C_out, j, 0);
  else if (job <= n_mod + more_in)
    sums_body<DZ_FIRST, NC>(D, coords, g, nullptr, ps + dwf_off, p0, lo, hi, M, C_in, H, C_out,
                            j, NC * (job - n_mod));
  else
    sums_body<HEAD, NC>(r_last, coords, g, nullptr, ps + dwh_off, p0, lo, hi, M, C_in, H, C_out,
                        j, NC * (job - n_mod - more_in));
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

// A workspace (rows x H floats, row-major) as boxes of RK rows by cols
// columns, no swizzle, zeros outside it (hopper.cuh::encode_tiled)
inline int workspace_map(CUtensorMap* map, const float* base, long long rows, int H, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)H, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)H * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)RK};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
                            dim, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int SUBN>
int launch_reduce(const float* R, const float* D, float* parts, long long E, long long dwmid_off,
                  int Q, int Qa, int H, int n_mod, int slices, cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err =
      tf32mma::allow_smem(siren_bwd_reduce_kernel<BN, SUBN>, reduce_smem(BN), done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_r, map_d;
  int bad = workspace_map(&map_r, R, (long long)n_mod * Qa, H, RA_LD);
  if (bad == 0) bad = workspace_map(&map_d, D, (long long)n_mod * Qa, H, BN);
  if (bad != 0) return bad;
  const long long tiles = (long long)((H + RM - 1) / RM) * ((H + BN - 1) / BN);
  const unsigned int blocks = (unsigned int)(tiles * (n_mod - 1) * slices);
  siren_bwd_reduce_kernel<BN, SUBN><<<blocks, THREADS, reduce_smem(BN), stream>>>(
      map_r, map_d, parts, E, dwmid_off, Q, Qa, H, n_mod, slices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the columns of the reduction's output tile at width H (128 or 192)
int siren_bwd_reduce_cols(int H) { return reduce_cols(H); }

int siren_bwd_reduce(const float* R, const float* D, float* parts, long long E,
                     long long dwmid_off, int Q, int Qa, int H, int n_mod, int slices,
                     void* stream) {
  if (!workspace_ok(H, n_mod, 1, 1) || n_mod < 2 || Q <= 0 || Qa < Q || slices < 1)
    return (int)cudaErrorInvalidValue;
  const auto launch = reduce_cols(H) == 192 ? launch_reduce<192, SUBN_192>
                                             : launch_reduce<128, SUBN_128>;
  return launch(R, D, parts, E, dwmid_off, Q, Qa, H, n_mod, slices, (cudaStream_t)stream);
}

int siren_bwd_sums(const float* R, const float* D, const float* coords, const float* g,
                   float* parts, long long E, long long dwf_off, long long dwh_off, long long p0,
                   int Q, int Qa, int T, int M, int C_in, int H, int n_mod, int C_out,
                   int slices, void* stream) {
  if (!workspace_ok(H, n_mod, C_in, C_out) || T <= 0 || M <= 0 || Q <= 0 || Qa < Q ||
      slices < 1)
    return (int)cudaErrorInvalidValue;
  // a job a layer's dz, dW_head's first chunk, and every further chunk of
  // MAX_C features of dW_first and dW_head
  const int jobs = n_mod + feature_chunks(C_in) + feature_chunks(C_out) - 1;
  const dim3 grid((unsigned int)((H + STHREADS - 1) / STHREADS), (unsigned int)jobs,
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
