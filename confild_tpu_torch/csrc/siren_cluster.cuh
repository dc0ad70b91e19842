// The thread-block cluster machinery shared by the SIREN-FiLM cluster
// kernels for Hopper (sm_90a): the float32 forward (siren_fwd_cluster.cu)
// and the chain, dz and the training backward (siren_chain_cluster.cu), at
// every hidden width up to 3072.  The training backward's reduction
// (siren_decode_bwd.cu, one block, no cluster) takes its mbarriers and its
// K-slice product (issue_slice, carry, b_desc) from here too.
//
// A cluster of CL blocks owns P = 64 MT consecutive (row, point) pairs;
// block b owns columns [b S, (b + 1) S) of every layer's output and keeps
// only that share of the P x H activations (or of dpre, in the chain's dx
// chain) in shared memory, row stride S + A_PAD.  One H x H product of a
// layer (Consumer::product below):
//   * B, the weights: a preparation kernel writes each block's columns of
//     every product's weight once a call, split into TF32 big and small
//     halves, K-major and in the exact no-swizzle core-matrix image the
//     wgmma descriptor reads: [block][product][16-row K-slice][k8][big,
//     small][n / 8][k / 4 within the k8][n % 8][4 k], K permuted within a
//     slice as load_a reads A.  Product i < n_mid is w_mid[i] (the forward),
//     product n_mid + i is w_mid[n_mid - 1 - i]^T (the dx chain; the
//     forward alone has n_mid products).  Each stage of the ring is then one
//     contiguous 1-D bulk copy (cp.async.bulk ... complete_tx), no tensor
//     map.  The warpgroup that releases a stage second refills it (a full
//     mbarrier a stage, a shared release counter in place of an empty one,
//     so that neither warpgroup waits for the other), in one stream across
//     every product of the call, so the next product's first slices load
//     while a layer's epilogue runs.
//   * A, the shares: each consumer thread loads its m64n64k8 A fragments
//     straight from the owner block's share (mapa + ld.shared::cluster, two
//     16-byte loads a K-slice), splits them into TF32 big and small in
//     registers and uses the register-A form of wgmma; the next K-slice's A
//     loads while the current one computes.
//   * Two consumer warpgroups: with two m64 tiles each owns one and all S
//     columns, with one they split the columns.  A warpgroup's columns are
//     m64n64 subtiles; each K-slice of 16 (two k8 steps, six products:
//     small big + big small + big big) goes into a zeroed partial that a
//     float32 add carries into the running sum (tf32_mma.cuh: the tensor
//     cores truncate their own sums); two partials take turns, so one
//     subtile's products run while the one before is carried.
//   * A cluster may be one block (H up to 256): its reads of "another
//     block's" share and its cluster barriers then address the block
//     itself.
//   * A block is two warpgroups and no producer warpgroup, so that a thread
//     may take up to 255 registers (three warpgroups would cap it at 168).
// Between products the kernels publish the new shares with two cluster
// barriers: every block done reading the shares (arrive after the product,
// wait before the share is written), then every share written.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace siren_cluster {

using tf32mma::rna_tf32;
using tf32mma::smem_addr;

constexpr int KS = 16;           // weight rows (K) a stage holds: one partial
constexpr int A_PAD = 16;        // share row stride S + 16: a quarter warp's A loads hit 32 banks
constexpr int MAX_C = 16;        // widest C_in and C_out
constexpr int MAX_CL = 8;        // largest portable cluster
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * CONSUMERS;
constexpr int SMEM_MAX = 232448;                // what a block may take
constexpr int ALIGN = 128;                      // the stages' alignment

// (S, MT) of each instantiation: S columns a block, MT m64 tiles a cluster.
// Up to 512 a width pads to 128, 192, 256, 384 or 512 (one block of 128,
// 192 or 256 columns, two of 192 or 256).  An instantiation of 64 columns
// would pad only to the next multiple of 64, but measured slower than the
// padding in the forward (320 as five blocks of 64: 24.6 ms against 21.9
// padded to 384; 448 as seven: 52.8 against 33.1 padded to 512, 4 x 262144
// on an H100, tools/siren_narrow_plans.py).
constexpr int CONFIGS[][2] = {{128, 2}, {192, 2}, {256, 2}, {384, 1}};

__host__ __device__ constexpr int cluster_pairs(int MT) { return 64 * MT; }
__host__ __device__ constexpr int stage_bytes(int S) { return KS * S * 2 * 4; }
__host__ __device__ constexpr int share_bytes(int S, int MT) {
  return cluster_pairs(MT) * (S + A_PAD) * 4;
}
// coordinates and a second P x MAX_C table (the forward's head partials,
// the chain's cotangent g), row offsets, the stages' mbarriers and release
// counters
__host__ __device__ constexpr int tail_bytes(int MT, int NS) {
  return 2 * cluster_pairs(MT) * MAX_C * 4 + cluster_pairs(MT) * 4 + 2 * NS * 8;
}
// stages of the ring: as many as fit, 2 to 4
__host__ __device__ constexpr int n_stages(int S, int MT) {
  int ns = 4;
  while (ns > 2 &&
         ALIGN + ns * stage_bytes(S) + share_bytes(S, MT) + tail_bytes(MT, ns) > SMEM_MAX)
    --ns;
  return ns;
}
__host__ __device__ constexpr int smem_bytes(int S, int MT) {
  return ALIGN + n_stages(S, MT) * stage_bytes(S) + share_bytes(S, MT) +
         tail_bytes(MT, n_stages(S, MT));
}

struct Plan {
  int cl, share, mt;
};

// The cluster for a hidden width h: the smallest padded width CL * S >= h
// over the instantiations with CL <= MAX_CL; ties go to more pairs a
// cluster, then to fewer blocks.  A plan's own width plans to itself.
// (Mirrored by ops/siren_decode.py::cluster_plan.)
inline bool plan_for(int h, Plan& best) {
  bool found = false;
  for (const auto& c : CONFIGS) {
    const int cl = (h + c[0] - 1) / c[0];
    if (h < 1 || cl > MAX_CL) continue;
    const Plan p{cl, c[0], c[1]};
    const int w = p.cl * p.share, bw = best.cl * best.share;
    if (!found || w < bw || (w == bw && (p.mt > best.mt || (p.mt == best.mt && p.cl < best.cl)))) {
      best = p;
      found = true;
    }
  }
  return found;
}

// f(S, MT) as integral constants for the plan's instantiation
template <typename F>
int with_plan(const Plan& p, F&& f) {
  if (p.share == 128 && p.mt == 2) return f(std::integral_constant<int, 128>(), std::integral_constant<int, 2>());
  if (p.share == 192 && p.mt == 2) return f(std::integral_constant<int, 192>(), std::integral_constant<int, 2>());
  if (p.share == 256 && p.mt == 2) return f(std::integral_constant<int, 256>(), std::integral_constant<int, 2>());
  if (p.share == 384 && p.mt == 1) return f(std::integral_constant<int, 384>(), std::integral_constant<int, 1>());
  return (int)cudaErrorInvalidValue;
}

// the plan of a width that is its own plan's width, or false
inline bool exact_plan(int H, Plan& p) { return plan_for(H, p) && p.cl * p.share == H; }

// ---------------------------------------------------------------------------
// PTX: cluster, mbarriers, bulk copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
// the cluster barrier, every thread of the cluster: arrive (release) ...
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
// ... and wait (acquire)
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// the address of the same shared-memory byte in block rank of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// wait for the completion of the phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the old value of a shared counter that the leader thread increments (0
// for the others), as a predicated instruction: no branch around wgmma
__device__ __forceinline__ uint32_t leader_count(bool leader, uint32_t counter) {
  uint32_t old = 0;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p atom.shared.add.u32 %0, [%1], 1;\n}\n"
      : "+r"(old)
      : "r"(counter), "r"((int)leader)
      : "memory");
  return old;
}
// bytes global -> this block's shared memory, completing on bar, which
// expects them; issued by the leader thread alone, as predicated
// instructions, so that the caller's warpgroup does not diverge around its
// wgmma
__device__ __forceinline__ void bulk_fill(bool leader, uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      "}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "r"((int)leader)
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of x across the asyncronous product
__device__ __forceinline__ void fence_reg(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// K-major B operand without swizzle: 8 x 16-byte core matrices, the two of
// a k8 step 128 bytes apart (leading byte offset), successive 8-row groups
// of N 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (m64 x n64, f32) = a (m64 x k8, TF32 in registers) . b (k8 x n64, TF32
// in shared memory) + (scale_d ? d : 0).  a: rows 16 w + g (+ 8), columns t
// (+ 4) of warp w; d[4j + e]: row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the weights' preparation
// ---------------------------------------------------------------------------

// One thread a 16-byte row of a core matrix: 4 consecutive k of one column
// n of one product's weight, big or small half (the layout at the top):
// product l < n_mid is w_mid[l] ([k][n]), product n_mid + i is
// w_mid[n_mid - 1 - i]^T.
__global__ void __launch_bounds__(256)
siren_cluster_prep_kernel(const float* __restrict__ w_mid, float4* __restrict__ wprep,
                          int H, int S, int n_mid, int n_prod) {
  const int slices = H / KS;
  const long long img = (long long)S * 2;            // float4s of one (k8, half) image
  const long long stage = 4 * img;                    // two k8 steps x two halves
  const long long per_rank = (long long)n_prod * slices * stage;
  const long long total = per_rank * (H / S);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int rank = (int)(e / per_rank);
    long long rem = e % per_rank;
    const int u = (int)(rem / stage);
    const int w = (int)(rem % stage);
    const int l = u / slices, c = u % slices;
    const int kk = w / (2 * (int)img), half = (w / (int)img) % 2, x = w % (int)img;
    const int g8 = x / 16, kc = (x / 8) % 2, r = x % 8;
    // fragment column kc * 4 + i of step kk is slice row 4 i + 2 kk + kc (load_a)
    const int n = rank * S + g8 * 8 + r, k0 = c * KS + 2 * kk + kc;
    // element (k0 + 4 i, n) of the product's weight: k strides H, or 1
    // for a transposed one
    const bool tr = l >= n_mid;
    const float* src = tr ? w_mid + ((size_t)(2 * n_mid - 1 - l) * H + n) * H + k0
                          : w_mid + ((size_t)l * H + k0) * H + n;
    const size_t kstride = tr ? 1 : (size_t)H;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t bits = __float_as_uint(src[4 * i * kstride]);
      const uint32_t big = rna_tf32(bits);
      v[i] = half == 0 ? big : rna_tf32(__float_as_uint(__uint_as_float(bits) - __uint_as_float(big)));
    }
    wprep[e] = make_float4(__uint_as_float(v[0]), __uint_as_float(v[1]), __uint_as_float(v[2]),
                           __uint_as_float(v[3]));
  }
}

// the n_prod products of the n_mid middle weights (n_mid, H, H) as the
// blocks' stage images, on the stream
inline int launch_prep(const float* w_mid, float* wprep, int H, int n_mid, int n_prod,
                       cudaStream_t stream) {
  Plan p{};
  if (!exact_plan(H, p) || n_mid < 1 || n_prod < n_mid || n_prod > 2 * n_mid)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_prod * H * H * 2 / 4;
  const unsigned int blocks = (unsigned int)((items + 255) / 256);
  siren_cluster_prep_kernel<<<blocks, 256, 0, stream>>>(w_mid, reinterpret_cast<float4*>(wprep),
                                                        H, p.share, n_mid, n_prod);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// one product of a layer
// ---------------------------------------------------------------------------

// One K-slice's six products for one m64n64 subtile into the partial d,
// committed as one group: for each k8 step small . big (zeroing d at the
// first), big . small, big . big; b is the subtile's first column in the
// stage (the two steps' images 2 S x 32 bytes apart, small S x 32 after big)
template <int S>
__device__ __forceinline__ void issue_slice(float (&d)[32], const uint32_t (&ab)[2][4],
                                            const uint32_t (&as)[2][4], uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(d[i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t img = b + kk * (2 * S * 32);
    const uint64_t big = b_desc(img), small = b_desc(img + S * 32);
    wgmma_tf32(d, as[kk], big, kk);
    wgmma_tf32(d, ab[kk], small, 1);
    wgmma_tf32(d, ab[kk], big, 1);
  }
  wgmma_commit();
}

// acc += a finished partial, in float32 (round to nearest)
__device__ __forceinline__ void carry(float (&acc)[32], float (&part)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    fence_reg(part[i]);
    acc[i] += part[i];
  }
}

// The A fragments of K-slice c, from the block of the cluster that owns its
// columns.  Within a slice the K order is permuted, in A and B alike: the
// fragment's column j of k8 step kk (j = t, t + 4 for lane t) is column
// 4 (j % 4) + 2 kk + j / 4 of the slice, so that lane t's four columns of a
// row are 4t .. 4t + 3, one 16-byte load (rows arow and arow + 8).
template <int S>
__device__ __forceinline__ void load_a(float (&ar)[2][4], uint32_t share0, int arow, int t, int c) {
  constexpr int LDS = S + A_PAD;
  const int k0 = c * KS;
  const uint32_t src = map_rank(share0, k0 / S) + 4u * (arow * LDS + k0 % S + 4 * t);
  const float4 r0 = ld_cluster4(src), r8 = ld_cluster4(src + 4u * 8 * LDS);
  ar[0][0] = r0.x;
  ar[0][1] = r8.x;
  ar[0][2] = r0.y;
  ar[0][3] = r8.y;
  ar[1][0] = r0.z;
  ar[1][1] = r8.z;
  ar[1][2] = r0.w;
  ar[1][3] = r8.w;
}

// The consumer thread's place in the cluster's tile and its weight stream.
template <int S, int MT>
struct Consumer {
  static constexpr int NS = n_stages(S, MT);
  static constexpr int N_WG = S * MT / CONSUMERS;   // columns a consumer warpgroup owns
  static constexpr int NSUB = N_WG / 64;            // its m64n64 subtiles
  static constexpr int STAGE = stage_bytes(S);
  static_assert(N_WG % 64 == 0 && S % KS == 0, "a warpgroup owns whole n64 subtiles");
  static_assert(smem_bytes(S, MT) <= SMEM_MAX, "the plan exceeds a block's shared memory");

  unsigned char* stages;          // NS x STAGE
  const unsigned char* wsrc;      // this block's stream of stage images
  uint32_t full0, released0;      // the stages' mbarriers, then their release counters
  uint32_t share0;                // this block's share (the same offset in every block)
  int u_total;                    // K-slices of the stream
  int tid, t, arow, n_off;

  __device__ Consumer(unsigned char* stages_, const float* wprep, uint64_t* bars,
                      const float* share, int rank, int u_total_)
      : stages(stages_),
        wsrc(reinterpret_cast<const unsigned char*>(wprep) + (size_t)rank * u_total_ * STAGE),
        full0(smem_addr(bars)),
        released0(smem_addr(bars) + 8 * NS),
        share0(smem_addr(share)),
        u_total(u_total_) {
    tid = threadIdx.x;
    const int wg = tid / 128, wwarp = tid % 128 / 32, lane = tid % 32;
    t = lane % 4;
    const int m_off = (wg % MT) * 64;   // two tiles: a warpgroup each
    n_off = (wg / MT) * N_WG;           // one tile: the columns split
    arow = m_off + 16 * wwarp + lane / 4;   // the A fragment's first row
  }

  // K-slice u of the stream into its stage, by the leader thread
  __device__ __forceinline__ void fill(bool leader, int u) const {
    const int s = u % NS;
    bulk_fill(leader, smem_addr(stages + s * STAGE), wsrc + (size_t)u * STAGE, STAGE,
              full0 + 8 * s);
  }
  // the barriers (thread 0, before the first cluster barrier)
  __device__ __forceinline__ void init(uint64_t* bars) const {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      bars[NS + s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the first NS K-slices, by thread 0 (after the barriers' initialisation
  // is visible)
  __device__ __forceinline__ void start() const {
    for (int u = 0; u < NS && u < u_total; ++u) fill(tid == 0, u);
  }

  // The position of accumulator i of subtile j: row, and the first of two
  // adjacent columns within the block's share (i and i + 1 for even i)
  __device__ __forceinline__ int row(int i) const { return arow + 8 * ((i >> 1) & 1); }
  __device__ __forceinline__ int col(int j, int i) const {
    return n_off + 64 * j + (i >> 2) * 8 + 2 * t;
  }

  // acc = (the cluster's shares, P x H) . (the next H / KS K-slices of the
  // stream, H x this block's S columns); u moves past them.  part: the two
  // partials, whose values on entry do not matter
  __device__ __forceinline__ void product(float (&acc)[NSUB][32], float (&part)[2][32], int& u,
                                          int chunks) const {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    float ar[2][4];
    load_a<S>(ar, share0, arow, t, 0);
    for (int c = 0; c < chunks; ++c, ++u) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) tf32mma::split<false>(ar[kk][e], ab[kk][e], as[kk][e]);
      if (c + 1 < chunks) load_a<S>(ar, share0, arow, t, c + 1);   // in flight meanwhile
      const int s = u % NS;
      mbar_wait(full0 + 8 * s, (u / NS) & 1);
      const uint32_t sb = smem_addr(stages + s * STAGE);
      // subtile j's products go into partial j % 2 while the sum of
      // subtile j - 1's is carried into its accumulators
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
        issue_slice<S>(part[j & 1], ab, as, sb + (n_off + 64 * j) * 32);
        if (j > 0) {
          wgmma_wait<1>();
          carry(acc[j - 1], part[(j - 1) & 1]);
        }
      }
      wgmma_wait<0>();
      carry(acc[NSUB - 1], part[(NSUB - 1) & 1]);
      // this warpgroup is done with stage s: its first thread counts the
      // release, and the second release refills the stage
      const bool second = leader_count(tid % 128 == 0, released0 + 8 * s) & 1;
      if (u + NS < u_total) fill(second, u + NS);
    }
  }

  // the accumulators (pairs of adjacent columns) into the share
  __device__ __forceinline__ void store_share(float* share, const float (&acc)[NSUB][32]) const {
    constexpr int LDS = S + A_PAD;
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<float2*>(share + row(i) * LDS + col(j, i)) =
            make_float2(acc[j][i], acc[j][i + 1]);
  }
};

// Launches kernel over ceil(pairs / P) clusters of the plan's CL blocks
// (or, with max_clusters, only asks how many such clusters the card holds
// at once).
template <int S, int MT, typename K, typename... Args>
int launch_clusters(K kernel, unsigned long long& done, const Plan& plan, long long pairs,
                    cudaStream_t stream, int* max_clusters, Args... args) {
  cudaError_t err = tf32mma::allow_smem(kernel, smem_bytes(S, MT), done);
  if (err != cudaSuccess) return (int)err;
  const long long clusters = (pairs + cluster_pairs(MT) - 1) / cluster_pairs(MT);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)(clusters * plan.cl), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(S, MT);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace siren_cluster
