// The thread-block cluster machinery shared by the SIREN-FiLM cluster
// kernels for Hopper (sm_90a): the float32 and bf16 forwards
// (siren_fwd_cluster.cu) and the chain, dz and the training backward
// (siren_chain_cluster.cu), at every hidden width up to 3072.  The training
// backward's reduction (siren_decode_bwd.cu, one block, no cluster) takes
// its mbarriers and its K-slice product (issue_slice, carry, b_desc) from
// here too.
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
// The bf16 mode (Consumer<S, MT, true>, the bf16 forward) keeps the plan,
// the ring and the cluster barriers and changes what a stage and a share
// hold: the shares are bf16, a stage is one k16 step of bf16 weights (16 x
// S x 2 bytes, a quarter of a float32 stage) in the no-swizzle K-major
// image [n / 8][k / 8][n % 8][8 k] with K permuted within each pair of
// slices as load_a16 reads A, and a K-slice is one m64nNk16 bf16 wgmma (N
// the warpgroup's columns) straight into the accumulators, which carry the
// sum over the whole K (no partials: the tensor cores' truncation of their
// sums, 2^-23 relative, is far below the operands' bf16 rounding, 2^-9).
// The ring is deeper (as many stages as fit, up to 16), A is loaded a batch
// of four K-slices at a time, one batch ahead (a block's own columns by
// ld.shared), and each batch takes one wgmma.fence.  The bf16 forward keeps
// two share buffers, so that a layer needs one cluster barrier, not the two
// below.
// Between products the kernels publish the new shares with two cluster
// barriers: every block done reading the shares (arrive after the product,
// wait before the share is written), then every share written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace siren_cluster {

using namespace hopper;   // mbarriers, bulk copies, wgmma
using tf32mma::rna_tf32;
using tf32mma::smem_addr;

constexpr int KS = 16;           // weight rows (K) a stage holds: one partial, or one k16 step
constexpr int A_PAD = 16;        // share row stride S + 16: a quarter warp's A loads hit 32 banks
constexpr int A_PAD16 = 32;      // bf16 share row stride S + 32: the same for 16-byte loads
constexpr int MAX_C = 16;        // features a table holds: C_in and C_out go in chunks of it
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
// bytes of a stage and of a share: float32 (TF32 halves), or bf16
__host__ __device__ constexpr int stage_bytes(int S, bool bf16 = false) {
  return bf16 ? KS * S * 2 : KS * S * 2 * 4;
}
__host__ __device__ constexpr int share_stride(int S, bool bf16 = false) {
  return S + (bf16 ? A_PAD16 : A_PAD);
}
// the shares: float32, or two bf16 buffers that the layers take in turns
__host__ __device__ constexpr int share_bytes(int S, int MT, bool bf16 = false) {
  return cluster_pairs(MT) * share_stride(S, bf16) * (bf16 ? 2 * 2 : 4);
}
// coordinates and a second P x MAX_C table (the forward's head partials,
// the chain's cotangent g), each one chunk of MAX_C features at a time,
// row offsets, the stages' mbarriers and release counters; the bf16
// forward keeps its coordinates in the second share buffer and its head
// partials in the ring, both idle when it needs them
__host__ __device__ constexpr int tail_bytes(int MT, int NS, bool bf16 = false) {
  return (bf16 ? 0 : 2 * cluster_pairs(MT) * MAX_C * 4) + cluster_pairs(MT) * 4 + 2 * NS * 8;
}
// stages of the ring: as many as fit, 2 to 4 (float32) or 16 (bf16)
__host__ __device__ constexpr int n_stages(int S, int MT, bool bf16 = false) {
  int ns = bf16 ? 16 : 4;
  while (ns > 2 && ALIGN + ns * stage_bytes(S, bf16) + share_bytes(S, MT, bf16) +
                           tail_bytes(MT, ns, bf16) > SMEM_MAX)
    --ns;
  return ns;
}
__host__ __device__ constexpr int smem_bytes(int S, int MT, bool bf16 = false) {
  return ALIGN + n_stages(S, MT, bf16) * stage_bytes(S, bf16) + share_bytes(S, MT, bf16) +
         tail_bytes(MT, n_stages(S, MT, bf16), bf16);
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

// d (m64 x n64, f32) = a (m64 x k16, bf16 pairs in registers) . b (k16 x
// n64, bf16 in shared memory, K-major) + (scale_d ? d : 0).  a: rows 16 w + g
// (+ 8), columns 2 t, 2 t + 1 (+ 8) of warp w, the smaller column in the low
// half; d as wgmma_tf32's.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (m64 x nN, f32) = a (m64 x k16, bf16 pairs in registers, as
// wgmma_bf16's) . b (k16 x nN, bf16 in shared memory, K-major) + (scale_d ?
// d : 0), for the widths N a bf16 consumer warpgroup owns: d is the n64
// blocks' accumulators side by side (d[32 j + i] is block j's d[i] of
// wgmma_bf16), one instruction where n64 blocks would take N / 64.
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_n192(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <int N>
__device__ __forceinline__ void wgmma_bf16_wide(float (&d)[N / 2], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  static_assert(N == 64 || N == 128 || N == 192 || N == 256, "a bf16 warpgroup's width");
  if constexpr (N == 64) wgmma_bf16(d, a, desc, scale_d);
  if constexpr (N == 128) wgmma_bf16_n128(d, a, desc, scale_d);
  if constexpr (N == 192) wgmma_bf16_n192(d, a, desc, scale_d);
  if constexpr (N == 256) wgmma_bf16_n256(d, a, desc, scale_d);
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

// The bf16 stage images: one thread a 16-byte row of a core matrix, 8 k of
// one column n of w_mid[l] ([k][n]) rounded to bf16 (to nearest even).  A
// K-slice's image is [n / 8][k / 8][n % 8][8 k] in the fragments' k order:
// fragment k 8 h + 2 q + e of slice 2 g + s is row 32 g + 8 q + 4 s + 2 h + e
// of the weight (load_a16).
__global__ void __launch_bounds__(256)
siren_cluster_prep_bf16_kernel(const float* __restrict__ w_mid, uint4* __restrict__ wprep, int H,
                               int S, int n_mid) {
  const int slices = H / KS;
  const long long stage = (long long)S * 2;           // uint4s of a stage
  const long long per_rank = (long long)n_mid * slices * stage;
  const long long total = per_rank * (H / S);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int rank = (int)(e / per_rank);
    const long long rem = e % per_rank;
    const int u = (int)(rem / stage), x = (int)(rem % stage);
    const int l = u / slices, c = u % slices;
    const int g8 = x / 16, h = (x / 8) % 2, r = x % 8;
    const int k0 = (c / 2) * 2 * KS + 4 * (c % 2) + 2 * h;
    const float* src = w_mid + ((size_t)l * H + k0) * H + rank * S + g8 * 8 + r;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = pack_bf16(src[(size_t)(8 * q) * H], src[(size_t)(8 * q + 1) * H]);
    wprep[e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the n_mid middle weights (n_mid, H, H) as the blocks' bf16 stage images,
// on the stream
inline int launch_prep_bf16(const float* w_mid, void* wprep, int H, int n_mid,
                            cudaStream_t stream) {
  Plan p{};
  if (!exact_plan(H, p) || n_mid < 1) return (int)cudaErrorInvalidValue;
  const long long items = (long long)n_mid * H * H / 8;
  const unsigned int blocks = (unsigned int)((items + 255) / 256);
  siren_cluster_prep_bf16_kernel<<<blocks, 256, 0, stream>>>(
      w_mid, reinterpret_cast<uint4*>(wprep), H, p.share, n_mid);
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

// The bf16 A fragments of the K-slices 2 g and 2 g + 1 (two k16 steps), from
// the block of the cluster that owns their columns: r[0] row arow, r[1]
// row arow + 8.  Within each pair of slices the K order is permuted, in A
// and B alike: fragment column 8 h + 2 t + e of slice 2 g + s (lane t's pair
// e of half h) is column 8 t + 4 s + 2 h + e of the 32, so that lane t's
// eight columns of a row are 8t .. 8t + 7, one 16-byte load.  The block's
// own columns are read from its shared memory directly, not through the
// cluster's network (ld.shared, not ld.shared::cluster).
template <int S>
__device__ __forceinline__ void load_a16(uint4 (&r)[2], uint32_t share0, int arow, int t, int g,
                                         int rank) {
  constexpr int LDS = share_stride(S, true);
  const int k0 = g * 2 * KS, owner = k0 / S;
  const uint32_t off = 2u * (arow * LDS + k0 % S + 8 * t);
  if (owner == rank) {
    r[0] = ld_shared4(share0 + off);
    r[1] = ld_shared4(share0 + off + 2u * 8 * LDS);
    return;
  }
  const uint32_t src = map_rank(share0, owner) + off;
  const float4 r0 = ld_cluster4(src), r8 = ld_cluster4(src + 2u * 8 * LDS);
  r[0] = make_uint4(__float_as_uint(r0.x), __float_as_uint(r0.y), __float_as_uint(r0.z),
                    __float_as_uint(r0.w));
  r[1] = make_uint4(__float_as_uint(r8.x), __float_as_uint(r8.y), __float_as_uint(r8.z),
                    __float_as_uint(r8.w));
}
// slice s (0, 1) of a pair's loaded fragments as wgmma's four A registers
__device__ __forceinline__ void frag16(uint32_t (&a)[4], const uint4 (&r)[2], int s) {
  a[0] = s ? r[0].z : r[0].x;
  a[1] = s ? r[1].z : r[1].x;
  a[2] = s ? r[0].w : r[0].y;
  a[3] = s ? r[1].w : r[1].y;
}

// The consumer thread's place in the cluster's tile and its weight stream:
// float32 (product, store_share), or with BF16 bf16 (product16,
// store_share16).
template <int S, int MT, bool BF16 = false>
struct Consumer {
  static constexpr int NS = n_stages(S, MT, BF16);
  static constexpr int N_WG = S * MT / CONSUMERS;   // columns a consumer warpgroup owns
  static constexpr int NSUB = N_WG / 64;            // its m64n64 subtiles
  static constexpr int STAGE = stage_bytes(S, BF16);
  static constexpr int LDS = share_stride(S, BF16);   // a share's row stride
  static_assert(N_WG % 64 == 0 && S % KS == 0, "a warpgroup owns whole n64 subtiles");
  static_assert(smem_bytes(S, MT, BF16) <= SMEM_MAX,
                "the plan exceeds a block's shared memory");

  unsigned char* stages;          // NS x STAGE
  const unsigned char* wsrc;      // this block's stream of stage images
  uint32_t full0, released0;      // the stages' mbarriers, then their release counters
  uint32_t share0;                // this block's share (the same offset in every block)
  int u_total;                    // K-slices of the stream
  int rank;                       // this block's rank in the cluster
  int tid, t, arow, n_off;

  __device__ Consumer(unsigned char* stages_, const void* wprep, uint64_t* bars,
                      const void* share, int rank_, int u_total_)
      : stages(stages_),
        wsrc(static_cast<const unsigned char*>(wprep) + (size_t)rank_ * u_total_ * STAGE),
        full0(smem_addr(bars)),
        released0(smem_addr(bars) + 8 * NS),
        share0(smem_addr(share)),
        u_total(u_total_),
        rank(rank_) {
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

  // bf16: acc = (the cluster's bf16 shares at src, P x H) . (the next H /
  // KS K-slices of the bf16 stream); u moves past them.  One k16 wgmma a
  // subtile and K-slice, accumulated in acc over the whole K (the first
  // K-slice's zeroes it), in batches of BATCH K-slices, one wgmma.fence a
  // batch.  A batch's groups are waited for one batch later, which frees
  // its stages and its set of A registers, into which the next batch's A
  // then loads (batch16's B, a constant in each unrolled call).  (Waiting
  // after every K-slice for the one two before it, to refill the ring
  // sooner, measured slower on an H100: 92.4 against 88.6 ms at Case4's
  // 16 x 262144.)
  // K-slices a batch (H is a multiple of 64: chunks of BATCH).  Batches of
  // 2 where the ring is short (10 stages at 256 and 384 columns), to load
  // slices further ahead, measured slower on an H100: 127.7 against 121.8
  // ms at 1024 x 16 -> 5 on 4 x 262144, the A loads then further behind.
  static constexpr int BATCH = 4;
  // a batch's stages are released only after the next batch is issued, so
  // the ring holds two batches and the next one's slices in flight
  static_assert(!BF16 || NS >= 2 * BATCH, "the bf16 ring needs two batches of stages");
  __device__ __forceinline__ void product16(float (&acc)[NSUB][32], int& u, int chunks,
                                            uint32_t src) const {
    uint4 a[2][BATCH / 2][2];   // [set][pair of slices][row arow, arow + 8]
    const int nb = chunks / BATCH;
    load_batch(a[0], 0, src);
    for (int b = 0; b < nb; b += 2) {
      batch16<0>(acc, a, b, u, nb, src);
      if (b + 1 < nb) batch16<1>(acc, a, b + 1, u, nb, src);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
#pragma unroll
    for (int k = BATCH; k > 0; --k) release(u - k);
  }

  // the A fragments of batch b (its pairs of K-slices) of the shares at src
  __device__ __forceinline__ void load_batch(uint4 (&a)[BATCH / 2][2], int b,
                                             uint32_t src) const {
#pragma unroll
    for (int q = 0; q < BATCH / 2; ++q) load_a16<S>(a[q], src, arow, t, BATCH / 2 * b + q, rank);
  }

  // batch b of product16 (stream slices u .. u + BATCH - 1; u moves past
  // them), its A in a[B]
  template <int B>
  __device__ __forceinline__ void batch16(float (&acc)[NSUB][32], uint4 (&a)[2][BATCH / 2][2],
                                          int b, int& u, int nb, uint32_t src) const {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(acc[j][i]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int v = u + k, s = v % NS;
      mbar_wait(full0 + 8 * s, (v / NS) & 1);
      const uint32_t sb = smem_addr(stages + s * STAGE);
      uint32_t f[4];
      frag16(f, a[B][k / 2], k % 2);
      wgmma_bf16_wide<N_WG>(*reinterpret_cast<float(*)[NSUB * 32]>(&acc[0][0]), f,
                            b_desc(sb + n_off * 32), b > 0 || k > 0);
      wgmma_commit();
    }
    u += BATCH;
    if (b > 0) {
      wgmma_wait<BATCH>();   // batch b - 1 is done: its stages and A set are free
#pragma unroll
      for (int k = 2 * BATCH; k > BATCH; --k) release(u - k);
    }
    if (b + 1 < nb) load_batch(a[B ^ 1], b + 1, src);
  }

  // this warpgroup is done with stream slice v's stage: its first thread
  // counts the release, and the second release refills the stage
  __device__ __forceinline__ void release(int v) const {
    const int s = v % NS;
    const bool second = leader_count(tid % 128 == 0, released0 + 8 * s) & 1;
    if (v + NS < u_total) fill(second, v + NS);
  }

  // bf16: the accumulators (pairs of adjacent columns) into the share,
  // rounded to bf16 (to nearest even)
  __device__ __forceinline__ void store_share16(__nv_bfloat16* share,
                                                const float (&acc)[NSUB][32]) const {
#pragma unroll
    for (int j = 0; j < NSUB; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 2)
        *reinterpret_cast<uint32_t*>(share + row(i) * LDS + col(j, i)) =
            pack_bf16(acc[j][i], acc[j][i + 1]);
  }
};

// Launches kernel over ceil(pairs / P) clusters of the plan's CL blocks
// (or, with max_clusters, only asks how many such clusters the card holds
// at once).
template <int S, int MT, bool BF16 = false, typename K, typename... Args>
int launch_clusters(K kernel, unsigned long long& done, const Plan& plan, long long pairs,
                    cudaStream_t stream, int* max_clusters, Args... args) {
  cudaError_t err = tf32mma::allow_smem(kernel, smem_bytes(S, MT, BF16), done);
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
  cfg.dynamicSmemBytes = smem_bytes(S, MT, BF16);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace siren_cluster
