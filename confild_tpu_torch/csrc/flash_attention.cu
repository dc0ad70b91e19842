// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two-pass backward, float32 arithmetic for float32 and bfloat16 inputs.
//
// Layouts (row-major, contiguous): q, k, v, dO, out, dq, dk, dv are
// (BH, N, D); lse and delta are (BH, N) float32.  D is 32, 64 or 128.
// Logits are scaled by 1 / sqrt(D); the softmax runs in float32.
//
// ---------------------------------------------------------------------------
// flash_forward replaces the Pallas kernel _flash_kernel
// (confild_tpu/ops/flash_attention.py:56, launched at :118 by _flash_forward).
// flash_bwd_dq replaces _bwd_dq_kernel (:158, launched at :257) and
// flash_bwd_dkv replaces _bwd_dkv_kernel (:188, launched at :282), both of
// _flash_backward.
//
// Bound on the H100: operations.  The forward does 4*N*N*D flops per head
// (two products) and the backward 14*N*N*D over its two passes (dq: S, dP,
// dQ; dk/dv: S, dP, dV, dK) against O(N*D) bytes, so at N >= 144 the
// arithmetic bounds all three.
//
// Design common to all three.  The TPU kernels carry the running max,
// denominator and output accumulator in VMEM across a sequential kv grid
// axis; Hopper blocks run in no order, so here each block loops over the
// other axis itself:
//   * forward: one block per (head, 128 query rows), looping over 64-key
//     tiles; dq: one block per (head, 64 query rows), the same loop;
//   * dk/dv: one block per (head, 64 keys), looping over 64-query tiles.
// Every output element has one owner thread, so there are no atomics and two
// launches give bitwise-equal results.  Ragged edges are masked in the
// kernels, with no padded copy: keys past N get probability 0 (the tile of a
// forward block always holds a real key, so the running max is finite and
// exp never sees -inf - -inf), and query rows past N add nothing to dK and
// dV.  The (N, N) matrices never leave shared memory: memory is O(N).
//
// All three run their products on the tensor cores with a 3xTF32 split.
// Every product goes through
// mma.sync.m16n8k8 (tf32 in, f32 accumulate).  A plain TF32 product keeps 11
// significant bits and misses the float32 criterion the kernels are held to
// (|kernel - f64| <= 2 |plain f32 - f64| + 1e-6 max|f64|) by some 300x, so
// each f32 operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big), and each product accumulates small*big + big*small
// (first) + big*big: about 22 significant bits per operand.  The tensor
// cores truncate their f32 sums, so the products go into short zeroed
// partials that float32 adds carry into the running sums (see mma3).  bf16
// inputs are exact in TF32 (small = 0), so Q.K^T and dO.V^T take one
// product and the products with P or dS two.  mma.sync, not wgmma: wgmma
// takes TF32 only with both operands K-major in shared memory, but P.V and
// three of the backward's products (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO)
// reduce along the row axis of row-major tiles and would need transposed
// copies written by threads; mma.sync fragments are ordinary shared loads
// in either direction.
//
// Forward (replaces _flash_kernel, confild_tpu/ops/flash_attention.py:56).
//   * Bound: 3 x 4 N^2 D tensor-core flops at 495 TFLOP/s dense TF32 (165
//     TFLOP/s of attention arithmetic) and N^2 exponentials at the
//     special-function units' rate; the first is 6.5x the second at D = 64.
//     Beside the products the loop splits K, V and P (two integer
//     operations and a subtract a value), adds the partials, rescales the
//     output, and waits on mma chains and two barriers a key tile.
//   * Eight warps over 128 query rows (four warps over 64 rows, the
//     alternative, was slower at every shape timed): warp w owns rows
//     16 w .. 16 w + 15 and all 64 keys of each tile, so a row's max and
//     sum stay in one quad of lanes (two shuffles) and the softmax needs no
//     barrier between warps.  The warp's 16 x D output block stays in
//     registers across the loop, rescaled by alpha = 2^(m_old - m_new)
//     before each tile's P.V; the running sum is kept per thread, a tile's
//     16 values summed before they join it (a sequential float32 sum of
//     every value read lse at 0.20 of the limit at 16384 tokens), and
//     summed over the quad once at the end.  Logits are scaled by
//     scale * log2 e, so P = exp2(s - m) and lse = m ln 2 + ln l.
//   * P never leaves registers.  The accumulator of S gives a thread keys
//     2t, 2t + 1 of each k8 step where the A fragment of P.V wants keys t,
//     t + 4; a product's sum does not depend on the order of its k index,
//     so P.V takes key 2t as index t and key 2t + 1 as index t + 4, and V's
//     B fragment reads its rows in the same order (frag_b_pairs; V's tile
//     has its own swizzle, swz_pairs, under which those reads hit 32 banks).
//     That replaces a trip through shared memory (a store, a warp barrier
//     and four loads each k8 step) and the quad shuffles that were the
//     other way.
//   * Q (float32, or bf16 widened) is resident in shared memory and split
//     when its A fragments are loaded; K and V stream through the cp.async
//     stage and are split once a tile, as in the backward (below).  S builds
//     up in partials zeroed every k8 step (abt_step, two steps an
//     iteration: unrolled in full the loop spilled at D = 64) and P.V in
//     partials zeroed every second step, each carried by float32 adds.
//   * Shared memory (f32): Q, K and V in two halves each, and the stage:
//     64 KB at D = 32, 128 KB at D = 64, 192 KB at D = 128 with no stage
//     (float32) or 224 KB with it (bf16).  One block an SM.
//   * bf16: JAX rounds P to bf16 before P.V (flash_attention.py:80-81);
//     this kernel, like the port's plain version, keeps P in float32.
//
// Backward (3xTF32 as above).
//   * Bound: 3 x 14 N^2 D tensor-core flops at 495 TFLOP/s dense TF32, i.e.
//     165 TFLOP/s of backward arithmetic, 2.5x the CUDA-core f32 rate.
//     Beside each product the loop loads and splits its operands (two
//     integer operations and a subtract each) and adds its partial, and it
//     waits on dependent mma chains and on the barriers between products;
//     chip_smoke.py phase 10 times the pair against this bound.
//   * Eight warps: warp (wm, wn) = (w % 4, w / 4) owns rows 16 wm .. 16 wm
//     + 15 of the block's 64 (query rows in dq, keys in dk/dv); it computes
//     S and dP for the 32 columns of half wn as four n8 fragments, and dQ
//     (or dK and dV) for the D / 2 output columns of half wn, kept in
//     registers across the loop.  The backward needs no row max, so P and
//     dS are formed in the accumulator registers; they reach the next
//     product (whose A layout differs) through one 64 x 64 tile in shared
//     memory.  A block runs at up to 255 registers a thread, one an SM
//     (dq at 128 spills, and ran slower on the card); dk/dv at D = 32 fits
//     two an SM and runs at 128.
//   * The streamed tiles (K, V for dq; Q, dO, lse and delta for dk/dv)
//     arrive by 16-byte cp.async in a raw stage while the tile before them
//     computes.  After the barrier that ends that tile, each thread splits
//     its own chunks of the stage into big and small halves in shared
//     memory (once, rather than by every warp at every use, four times
//     over) and then issues the copies of the next tile.  Where the stage
//     does not fit (D = 128), each thread loads its chunks into registers
//     at the top of the tile instead, which overlaps only the barrier.
//     The resident tiles (Q, dO for dq; K, V for dk/dv) arrive by cp.async
//     and are split when their A fragments are loaded, as are P and dS.
//     bf16 tiles are widened to f32 (exact in TF32: no small half).
//   * Shared tiles have a row stride of D with an XOR swizzle of the column
//     (c ^ swz(r), swz(r) = 8 (r & 3) + (r & 4)): fragments read along
//     rows (A, and B of S) and along columns (B of dQ, dK, dV) both hit 32
//     distinct banks, and a 16-byte chunk stays contiguous.
//   * Shared memory (f32): the resident pair, the streamed pair's two
//     halves, the P / dS tile (+ lse and delta) and the stage: 80 KB at
//     D = 32, 144 KB at D = 64, and 208 KB at D = 128, with no stage.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int TILE = 64;       // keys (and backward rows) per tile
constexpr int THREADS = 256;   // 8 warps
// forward: query rows a block, 16 a warp, each warp over all 64 keys of a tile
constexpr int FWD_ROWS = 128;

// ---------------------------------------------------------------------------
// helpers: swizzled tiles, cp.async, 3xTF32 mma.sync fragments
// ---------------------------------------------------------------------------
// backward, eight warps: warp w owns rows 16 (w % 4) .. + 15 of the block's
// 64 and half of each product's columns, (w / 4) of two
constexpr int KEYS_HALF = TILE / 2;   // S / dP columns a warp computes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t SMEM_MAX = 227 * 1024;   // shared memory a block may take
constexpr size_t SMEM_SM = 228 * 1024;    // an SM's, 1 KB of it reserved per block

// floats one raw (unconverted) 64 x D tile of T takes in the stage
template <int D, typename T>
constexpr int RAW = TILE * D * (int)sizeof(T) / 4;

// The streamed pair (K, V for dq; Q, dO for dk/dv) goes through a raw stage
// in shared memory where it fits: 16-byte cp.async copies of the next tile
// run while the current one computes.  dq: the resident pair, the streamed
// pair's big and small halves, the dS tile, then the stage.  dk/dv: the same
// with P / dS, lse and delta of the query tile, then the stage with its
// lse and delta.
template <int D>
__host__ __device__ constexpr size_t dq_base() {
  return sizeof(float) * (6 * TILE * D + TILE * TILE);
}
template <int D, typename T>
__host__ __device__ constexpr bool dq_staged() {
  return dq_base<D>() + sizeof(float) * 2 * RAW<D, T> <= SMEM_MAX;
}
template <int D, typename T>
__host__ __device__ constexpr size_t dq_smem() {
  return dq_base<D>() + (dq_staged<D, T>() ? sizeof(float) * 2 * RAW<D, T> : 0);
}
template <int D>
__host__ __device__ constexpr size_t dkv_base() {
  return sizeof(float) * (6 * TILE * D + TILE * TILE + 2 * TILE);
}
template <int D, typename T>
__host__ __device__ constexpr bool dkv_staged() {
  return dkv_base<D>() + sizeof(float) * (2 * RAW<D, T> + 2 * TILE) <= SMEM_MAX;
}
template <int D, typename T>
__host__ __device__ constexpr size_t dkv_smem() {
  return dkv_base<D>() + (dkv_staged<D, T>() ? sizeof(float) * (2 * RAW<D, T> + 2 * TILE) : 0);
}
// blocks an SM holds at this much shared memory, as a launch bound (1 or 2)
constexpr int blocks_for(size_t smem) { return 2 * (smem + 1024) <= SMEM_SM ? 2 : 1; }
// forward: Q, the streamed K and V in big and small halves, then the stage
template <int D>
__host__ __device__ constexpr size_t fwd_base() {
  return sizeof(float) * (FWD_ROWS * D + 4 * TILE * D);
}
template <int D, typename T>
__host__ __device__ constexpr bool fwd_staged() {
  return fwd_base<D>() + sizeof(float) * 2 * RAW<D, T> <= SMEM_MAX;
}
template <int D, typename T>
__host__ __device__ constexpr size_t fwd_smem() {
  return fwd_base<D>() + (fwd_staged<D, T>() ? sizeof(float) * 2 * RAW<D, T> : 0);
}

// column swizzle of row r: fragment walks along rows and along columns both
// conflict-free; bits 0-1 stay 0, so a 4-float chunk stays contiguous
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
// the forward's V tile, read in row pairs (2t, 2t + 1) by frag_b_pairs:
// rows 2t and rows 2t + 1 each land on four distinct 8-bank groups
__device__ __forceinline__ int swz_pairs(int r) { return (r & 7) << 2; }

template <int LD>
__device__ __forceinline__ float ld_sw(const float* tile, int r, int c) {
  return tile[r * LD + (c ^ swz(r))];
}

// 4 bytes (rows of lse and delta need not be 16-byte aligned)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// A 64 x D tile moves as 16-byte chunks (4 float32 or 8 bfloat16 values),
// CHUNKS a thread; chunk i of this thread sits at row r, column c.
template <int D, typename T>
constexpr int CHUNKS = RAW<D, T> / 4 / THREADS;

template <int D, typename T>
__device__ __forceinline__ void chunk_at(int i, int& r, int& c) {
  constexpr int PER = 16 / (int)sizeof(T);
  const int e = threadIdx.x + i * THREADS;
  r = e / (D / PER);
  c = (e % (D / PER)) * PER;
}

// this thread's chunks of rows row0 .. row0 + TILE - 1 of a (N, D) matrix,
// unconverted (zeros past n): into registers, or by cp.async into the raw
// stage, where chunk i of thread t sits at float 4 (t + i THREADS)
template <int D, typename T>
__device__ __forceinline__ void fetch_rows(float4 x[CHUNKS<D, T>], const T* src, int row0,
                                           int n) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i) {
    int r, c;
    chunk_at<D, T>(i, r, c);
    x[i] = row0 + r < n
               ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
template <int D, typename T>
__device__ __forceinline__ void stage_rows(float* raw, const T* src, int row0, int n) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i) {
    int r, c;
    chunk_at<D, T>(i, r, c);
    const int gr = row0 + r;
    cp_async16(raw + 4 * (threadIdx.x + i * THREADS), src + (size_t)(gr < n ? gr : 0) * D + c,
               gr < n);
  }
}

// chunk i, as loaded, into swizzled tiles of row stride D (swz, or
// swz_pairs when PAIRED): float32 split into its big and small halves,
// bfloat16 widened (exact in TF32: big only)
template <int D, typename T, bool PAIRED = false>
__device__ __forceinline__ void put_chunk(float4 x, int i, float* big, float* small) {
  int r, c;
  chunk_at<D, T>(i, r, c);
  const int sw = PAIRED ? swz_pairs(r) : swz(r);
  if constexpr (sizeof(T) == 2) {
    const uint32_t u[4] = {__float_as_uint(x.x), __float_as_uint(x.y), __float_as_uint(x.z),
                           __float_as_uint(x.w)};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(big + r * D + ((c + 4 * h) ^ sw)) = make_float4(
          __uint_as_float(u[2 * h] << 16), __uint_as_float(u[2 * h] & 0xffff0000u),
          __uint_as_float(u[2 * h + 1] << 16), __uint_as_float(u[2 * h + 1] & 0xffff0000u));
  } else {
    uint32_t b[4], sm[4];
    split<false>(x.x, b[0], sm[0]);
    split<false>(x.y, b[1], sm[1]);
    split<false>(x.z, b[2], sm[2]);
    split<false>(x.w, b[3], sm[3]);
    const int o = r * D + (c ^ sw);
    *reinterpret_cast<uint4*>(big + o) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + o) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}
template <int D, typename T, bool PAIRED = false>
__device__ __forceinline__ void put_rows(const float4 x[CHUNKS<D, T>], float* big,
                                         float* small) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i) put_chunk<D, T, PAIRED>(x[i], i, big, small);
}
// the thread's own chunks of the raw stage (its cp.async copies, visible to
// it after cp_async_wait_all) into split tiles
template <int D, typename T, bool PAIRED = false>
__device__ __forceinline__ void put_staged(const float* raw, float* big, float* small) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i)
    put_chunk<D, T, PAIRED>(
        *reinterpret_cast<const float4*>(raw + 4 * (threadIdx.x + i * THREADS)), i, big, small);
}

// a resident tile (Q, dO for dq; K, V for dk/dv; Q for the forward):
// float32 by cp.async straight into the swizzled tile (split later, at
// fragment load; waited for with cp_async_wait_all), bfloat16 through
// registers, widened
template <int D, typename T>
__device__ __forceinline__ void load_resident(float* tile, const T* src, int row0, int n) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < CHUNKS<D, T>; ++i) {
      int r, c;
      chunk_at<D, T>(i, r, c);
      const int gr = row0 + r;
      cp_async16(tile + r * D + (c ^ swz(r)), src + (size_t)(gr < n ? gr : 0) * D + c, gr < n);
    }
  } else {
    float4 x[CHUNKS<D, T>];
    fetch_rows<D, T>(x, src, row0, n);
    put_rows<D, T>(x, tile, nullptr);
  }
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4).  A, 16 x 8 at (r0, c0):
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
template <int LD, bool EXACT>
__device__ __forceinline__ void frag_a(uint32_t big[4], uint32_t small[4], const float* tile,
                                       int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split<EXACT>(ld_sw<LD>(tile, r0 + g, c0 + t), big[0], small[0]);
  split<EXACT>(ld_sw<LD>(tile, r0 + g + 8, c0 + t), big[1], small[1]);
  split<EXACT>(ld_sw<LD>(tile, r0 + g, c0 + t + 4), big[2], small[2]);
  split<EXACT>(ld_sw<LD>(tile, r0 + g + 8, c0 + t + 4), big[3], small[3]);
}
// B, 8 x 8, B[k][j] = tile[n0 + j][c0 + k] (a product with the tile's
// transpose): (k, j) = (t, g), (t + 4, g); from a tile's split halves
template <int LD, bool EXACT>
__device__ __forceinline__ void frag_b_rows(uint32_t big[2], uint32_t small[2], const float* tb,
                                            const float* ts, int n0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, r = n0 + g;
  const int o0 = r * LD + ((c0 + t) ^ swz(r)), o1 = r * LD + ((c0 + t + 4) ^ swz(r));
  big[0] = __float_as_uint(tb[o0]);
  big[1] = __float_as_uint(tb[o1]);
  if constexpr (!EXACT) {
    small[0] = __float_as_uint(ts[o0]);
    small[1] = __float_as_uint(ts[o1]);
  }
}
// B, 8 x 8, B[k][j] = tile[k0 + k][n0 + j] (a product with the tile)
template <int LD, bool EXACT>
__device__ __forceinline__ void frag_b_cols(uint32_t big[2], uint32_t small[2], const float* tb,
                                            const float* ts, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int o0 = (k0 + t) * LD + ((n0 + g) ^ swz(k0 + t));
  const int o1 = (k0 + t + 4) * LD + ((n0 + g) ^ swz(k0 + t + 4));
  big[0] = __float_as_uint(tb[o0]);
  big[1] = __float_as_uint(tb[o1]);
  if constexpr (!EXACT) {
    small[0] = __float_as_uint(ts[o0]);
    small[1] = __float_as_uint(ts[o1]);
  }
}

// B, 8 x 8, of a product with the tile whose k8 step takes its rows in
// the order k0, k0 + 2, k0 + 4, k0 + 6, k0 + 1, k0 + 3, k0 + 5, k0 + 7
// (B[k][j] = tile[k0 + 2k][n0 + j] and B[k + 4][j] = tile[k0 + 2k + 1][n0 + j],
// k < 4): the order of an A fragment taken straight from an accumulator,
// whose thread holds columns 2t and 2t + 1 (see the forward); a tile
// swizzled by swz_pairs
template <int LD, bool EXACT>
__device__ __forceinline__ void frag_b_pairs(uint32_t big[2], uint32_t small[2], const float* tb,
                                             const float* ts, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3, r = k0 + 2 * t;
  const int o0 = r * LD + ((n0 + g) ^ swz_pairs(r));
  const int o1 = (r + 1) * LD + ((n0 + g) ^ swz_pairs(r + 1));
  big[0] = __float_as_uint(tb[o0]);
  big[1] = __float_as_uint(tb[o1]);
  if constexpr (!EXACT) {
    small[0] = __float_as_uint(ts[o0]);
    small[1] = __float_as_uint(ts[o1]);
  }
}

// c[j] = rows r0 .. r0 + 15 of a times rows n0 + 8j .. n0 + 8j + 7 of b
// (given as its split halves), transposed, j < NT: a warp's 16 x 8NT block
// of a . b^T over D (accumulator layout: c[j][2h + e] is row r0 + g + 8h,
// column n0 + 8j + 2t + e); abt_step is its k8 step kk
template <int D, bool EXACT, int NT>
__device__ __forceinline__ void abt_step(float c[NT][4], const float* a, const float* bb_tile,
                                         const float* bs_tile, int r0, int n0, int kk) {
  uint32_t ab[4], as[4];
  frag_a<D, EXACT>(ab, as, a, r0, 8 * kk);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bb[2], bs[2];
    frag_b_rows<D, EXACT>(bb, bs, bb_tile, bs_tile, n0 + 8 * j, 8 * kk);
    mma3<EXACT, EXACT>(c[j], ab, as, bb, bs);
  }
}
template <int D, bool EXACT, int NT>
__device__ __forceinline__ void strip_abt(float c[NT][4], const float* a, const float* bb_tile,
                                          const float* bs_tile, int r0, int n0) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) abt_step<D, EXACT, NT>(c, a, bb_tile, bs_tile, r0, n0, kk);
}

// acc[nd] += rows r0 .. r0 + 15 of the block's 64 x 64 P or dS tile
// (float32, split here) times columns c0 + 8nd .. of a 64 x D tile (given
// as its split halves; exact in TF32 when EXACT), nd < NT
template <int D, bool EXACT, int NT>
__device__ __forceinline__ void strip_pm(float acc[NT][4], const float* p, const float* mb,
                                         const float* ms, int r0, int c0) {
#pragma unroll
  for (int k2 = 0; k2 < TILE / 8; k2 += 2) {
    float part[NT][4];
#pragma unroll
    for (int nd = 0; nd < NT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nd][e] = 0.f;
#pragma unroll
    for (int kc = k2; kc < k2 + 2; ++kc) {
      uint32_t ab[4], as[4];
      frag_a<TILE, false>(ab, as, p, r0, 8 * kc);
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        uint32_t bb[2], bs[2];
        frag_b_cols<D, EXACT>(bb, bs, mb, ms, 8 * kc, c0 + 8 * nd);
        mma3_into<false, EXACT>(part[nd], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nd = 0; nd < NT; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] += part[nd][e];
  }
}

// the accumulator pair (row, col) and (row, col + 1), col even, into the
// block's swizzled 64 x 64 P / dS tile
__device__ __forceinline__ void store_pair(float* tile, int row, int col, float x, float y) {
  *reinterpret_cast<float2*>(tile + row * TILE + (col ^ swz(row))) = make_float2(x, y);
}

template <typename T> __device__ __forceinline__ void store2(T* dst, float x, float y);
template <> __device__ __forceinline__ void store2<float>(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float x,
                                                                 float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// forward: out = softmax(q k^T * scale) v, lse = logsumexp of each row.
// Block: 128 query rows (FWD_ROWS), resident; K and V streamed (through the stage
// where it fits) and split.  Warp w computes S, P and the output of rows
// 16w .. 16w + 15 over all 64 keys of a tile and all D columns.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int n, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;   // bfloat16 operands are exact in TF32
  constexpr bool STAGED = fwd_staged<D, T>();
  constexpr int NS = TILE / 8, ND = D / 8;
  const float scale2 = scale * LOG2E;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // FWD_ROWS x D
  float* sKb = sQ + FWD_ROWS * D;      // K and V, big and small halves
  float* sKs = sKb + TILE * D;
  float* sVb = sKs + TILE * D;         // (swizzled by swz_pairs)
  float* sVs = sVb + TILE * D;
  float* sRaw = sVs + TILE * D;        // stage: raw K, V of the next tile
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = 16 * warp;
  const int q0 = blockIdx.x * FWD_ROWS;
  const size_t base = (size_t)blockIdx.y * n * D;

#pragma unroll
  for (int h = 0; h < FWD_ROWS / TILE; ++h)   // swz(r) depends on r % 8 only
    load_resident<D, T>(sQ + h * TILE * D, q + base, q0 + h * TILE, n);
  if constexpr (STAGED) {
    stage_rows<D, T>(sRaw, k + base, 0, n);
    stage_rows<D, T>(sRaw + RAW<D, T>, v + base, 0, n);
  }
  cp_async_commit();

  // rows r0 + g + 8h: running max of the logits (log2 units), this thread's
  // share of the running sum, and the output in accumulator layout
  // (acc[nd][2h + e] is column 8nd + 2t + e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int tiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TILE;
    if constexpr (STAGED) {
      cp_async_wait_all();
      __syncthreads();   // every warp is done with tile it - 1; Q is in
      put_staged<D, T>(sRaw, sKb, sKs);
      put_staged<D, T, true>(sRaw + RAW<D, T>, sVb, sVs);
      __syncthreads();
      if (it + 1 < tiles) {   // tile it + 1 streams in while tile it computes
        stage_rows<D, T>(sRaw, k + base, k0 + TILE, n);
        stage_rows<D, T>(sRaw + RAW<D, T>, v + base, k0 + TILE, n);
        cp_async_commit();
      }
    } else {
      float4 xk[CHUNKS<D, T>], xv[CHUNKS<D, T>];
      fetch_rows<D, T>(xk, k + base, k0, n);
      fetch_rows<D, T>(xv, v + base, k0, n);
      __syncthreads();   // every warp is done with tile it - 1
      put_rows<D, T>(xk, sKb, sKs);
      put_rows<D, T, true>(xv, sVb, sVs);
      cp_async_wait_all();
      __syncthreads();
    }

    // S: s[j][2h + e] is row r0 + g + 8h, key k0 + 8j + 2t + e; scaled to
    // log2 units, keys past n at -inf
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // two k8 steps an iteration: unrolled in full, the fragment loads run
    // ahead and push the kernel past 255 registers at D = 64
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) abt_step<D, EXACT, NS>(s, sQ, sKb, sKs, r0, 0, kk);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < n ? s[j][e] * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // a row lives in one quad of lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);   // finite: the tile holds a key
      alpha[h] = exp2f(m[h] - m_new);           // 0 on the first tile
      m[h] = m_new;
    }
    float tile_sum[2] = {0.f, 0.f};   // summed a tile at a time: a shorter chain
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);   // P; 0 for keys past n
        tile_sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + tile_sum[h];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

    // acc += P V, two k8 steps a partial.  P's A fragment of step j is
    // s[j] as it stands, its keys taken in the order frag_b_pairs reads V.
#pragma unroll
    for (int j2 = 0; j2 < NS; j2 += 2) {
      uint32_t pb[2][4], ps[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        split<false>(s[j2 + c][0], pb[c][0], ps[c][0]);   // (g, key 2t)
        split<false>(s[j2 + c][2], pb[c][1], ps[c][1]);   // (g + 8, key 2t)
        split<false>(s[j2 + c][1], pb[c][2], ps[c][2]);   // (g, key 2t + 1)
        split<false>(s[j2 + c][3], pb[c][3], ps[c][3]);   // (g + 8, key 2t + 1)
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t bb[2], bs[2];
          frag_b_pairs<D, EXACT>(bb, bs, sVb, sVs, 8 * (j2 + c), 8 * nd);
          mma3_into<false, EXACT>(part, pb[c], ps[c], bb, bs);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] += part[e];
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the quad's shares of the sum
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2<T>(out + base + (size_t)r * D + 8 * nd + 2 * t, acc[nd][2 * h] * inv,
                acc[nd][2 * h + 1] * inv);
    if (t == 0) lse[(size_t)blockIdx.y * n + r] = m[h] * LN2 + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 1: dQ = scale * sum_j dS_ij K_j,
//   P = exp(S - lse), dS = P * (dO V^T - delta).
// Block: 64 query rows; K and V streamed (through the stage where it fits)
// and split.  Warp (wm, wn) = (w % 4, w / 4) computes S, dP and dS of rows
// 16wm .. 16wm + 15 and keys 32wn .. 32wn + 31, and dQ of the same rows and
// columns (D / 2) wn .. (D / 2) wn + D / 2 - 1.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int n, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;   // bfloat16 operands are exact in TF32
  constexpr bool STAGED = dq_staged<D, T>();
  constexpr int NS = KEYS_HALF / 8, ND = D / 16;
  const float scale2 = scale * LOG2E;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sO = sQ + TILE * D;           // dO tile
  float* sKb = sO + TILE * D;          // K and V, big and small halves
  float* sKs = sKb + TILE * D;
  float* sVb = sKs + TILE * D;
  float* sVs = sVb + TILE * D;
  float* sS = sVs + TILE * D;          // dS tile
  float* sRaw = sS + TILE * TILE;      // stage: raw K, V of the next tile
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = 16 * (warp & 3), n0 = KEYS_HALF * (warp >> 2), c0 = (D / 2) * (warp >> 2);
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;

  load_resident<D, T>(sQ, q + base, q0, n);
  load_resident<D, T>(sO, dout + base, q0, n);
  if constexpr (STAGED) {
    stage_rows<D, T>(sRaw, k + base, 0, n);
    stage_rows<D, T>(sRaw + RAW<D, T>, v + base, 0, n);
  }
  cp_async_commit();

  float lr[2], dr[2], acc[ND][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + 8 * h;
    lr[h] = r < n ? lse[rbase + r] * LOG2E : 0.f;   // P = 2^(S scale log2 e - lse log2 e)
    dr[h] = r < n ? delta[rbase + r] : 0.f;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

  const int tiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * TILE;
    if constexpr (STAGED) {
      cp_async_wait_all();
      __syncthreads();   // every warp is done with tile it - 1; the resident tiles are in
      put_staged<D, T>(sRaw, sKb, sKs);
      put_staged<D, T>(sRaw + RAW<D, T>, sVb, sVs);
      __syncthreads();
      if (it + 1 < tiles) {   // tile it + 1 streams in while tile it computes
        stage_rows<D, T>(sRaw, k + base, k0 + TILE, n);
        stage_rows<D, T>(sRaw + RAW<D, T>, v + base, k0 + TILE, n);
        cp_async_commit();
      }
    } else {
      float4 xk[CHUNKS<D, T>], xv[CHUNKS<D, T>];
      fetch_rows<D, T>(xk, k + base, k0, n);
      fetch_rows<D, T>(xv, v + base, k0, n);
      __syncthreads();   // every warp is done with tile it - 1
      put_rows<D, T>(xk, sKb, sKs);
      put_rows<D, T>(xv, sVb, sVs);
      cp_async_wait_all();
      __syncthreads();
    }
    float s[NS][4], dp[NS][4];
    strip_abt<D, EXACT, NS>(s, sQ, sKb, sKs, r0, n0);
    strip_abt<D, EXACT, NS>(dp, sO, sVb, sVs, r0, n0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = q0 + r0 + g + 8 * h < n && k0 + n0 + 8 * j + 2 * t + e < n;
          const float p = ok ? exp2f(s[j][2 * h + e] * scale2 - lr[h]) : 0.f;
          ds[e] = p * (dp[j][2 * h + e] - dr[h]);
        }
        store_pair(sS, r0 + g + 8 * h, n0 + 8 * j + 2 * t, ds[0], ds[1]);
      }
    __syncthreads();   // both halves of every dS row are in
    strip_pm<D, EXACT, ND>(acc, sS, sKb, sKs, r0, c0);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + g + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      store2<T>(dq + base + (size_t)r * D + c0 + 8 * nd + 2 * t, acc[nd][2 * h] * scale,
                acc[nd][2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij Q_i.
// Block: 64 keys; Q and dO streamed (through the stage where it fits) and
// split, lse and delta streamed.  The products are transposed (rows are
// keys, columns queries); warp (wm, wn) computes P^T, dP^T and dS^T of keys
// 16wm .. 16wm + 15 and queries 32wn .. 32wn + 31, and dK, dV of the same
// keys and columns (D / 2) wn .. (D / 2) wn + D / 2 - 1.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(THREADS, blocks_for(dkv_smem<D, T>()))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int n, float scale) {
  constexpr bool EXACT = sizeof(T) == 2;
  constexpr bool STAGED = dkv_staged<D, T>();
  constexpr int NS = KEYS_HALF / 8, ND = D / 16;
  const float scale2 = scale * LOG2E;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE * D;
  float* sQb = sV + TILE * D;          // Q and dO, big and small halves
  float* sQs = sQb + TILE * D;
  float* sOb = sQs + TILE * D;
  float* sOs = sOb + TILE * D;
  float* sP = sOs + TILE * D;          // P^T, then dS^T
  float* sL = sP + TILE * TILE;        // lse and delta of the query tile
  float* sD = sL + TILE;
  float* sRaw = sD + TILE;             // stage: raw Q, dO, lse, delta of the next tile
  float* sRawL = sRaw + 2 * RAW<D, T>;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = 16 * (warp & 3), n0 = KEYS_HALF * (warp >> 2), c0 = (D / 2) * (warp >> 2);
  const int k0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  // lse (threads 0 .. 63) and delta (64 .. 127) of a query tile
  const int vi = threadIdx.x % TILE;
  const float* vsrc = (threadIdx.x < TILE ? lse : delta) + rbase;

  load_resident<D, T>(sK, k + base, k0, n);
  load_resident<D, T>(sV, v + base, k0, n);
  if constexpr (STAGED) {
    stage_rows<D, T>(sRaw, q + base, 0, n);
    stage_rows<D, T>(sRaw + RAW<D, T>, dout + base, 0, n);
    if (threadIdx.x < 2 * TILE) cp_async4(sRawL + threadIdx.x, vsrc + (vi < n ? vi : 0), vi < n);
  }
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.f;

  const int tiles = (n + TILE - 1) / TILE;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = it * TILE;
    if constexpr (STAGED) {
      cp_async_wait_all();
      __syncthreads();   // every warp is done with tile it - 1; the resident tiles are in
      put_staged<D, T>(sRaw, sQb, sQs);
      put_staged<D, T>(sRaw + RAW<D, T>, sOb, sOs);
      if (threadIdx.x < 2 * TILE) sL[threadIdx.x] = sRawL[threadIdx.x];
      __syncthreads();
      if (it + 1 < tiles) {   // tile it + 1 streams in while tile it computes
        const int q1 = q0 + TILE;
        stage_rows<D, T>(sRaw, q + base, q1, n);
        stage_rows<D, T>(sRaw + RAW<D, T>, dout + base, q1, n);
        if (threadIdx.x < 2 * TILE)
          cp_async4(sRawL + threadIdx.x, vsrc + (q1 + vi < n ? q1 + vi : 0), q1 + vi < n);
        cp_async_commit();
      }
    } else {
      float4 xq[CHUNKS<D, T>], xo[CHUNKS<D, T>];
      fetch_rows<D, T>(xq, q + base, q0, n);
      fetch_rows<D, T>(xo, dout + base, q0, n);
      const float ld = threadIdx.x < 2 * TILE && q0 + vi < n ? vsrc[q0 + vi] : 0.f;
      __syncthreads();   // every warp is done with tile it - 1
      put_rows<D, T>(xq, sQb, sQs);
      put_rows<D, T>(xo, sOb, sOs);
      if (threadIdx.x < 2 * TILE) sL[threadIdx.x] = ld;
      cp_async_wait_all();
      __syncthreads();
    }

    // P^T: s[j][2h + e] is key r0 + g + 8h, query n0 + 8j + 2t + e
    float s[NS][4];
    strip_abt<D, EXACT, NS>(s, sK, sQb, sQs, r0, n0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qc = n0 + 8 * j + 2 * t + e;   // query rows past N add nothing
          p[e] = q0 + qc < n ? exp2f(s[j][2 * h + e] * scale2 - sL[qc] * LOG2E) : 0.f;
        }
        store_pair(sP, r0 + g + 8 * h, n0 + 8 * j + 2 * t, p[0], p[1]);
      }
    __syncthreads();
    strip_pm<D, EXACT, ND>(acc_v, sP, sOb, sOs, r0, c0);

    // dS^T = P^T * (dP^T - delta), P^T read back from this thread's own slots
    float dp[NS][4];
    strip_abt<D, EXACT, NS>(dp, sV, sOb, sOs, r0, n0);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h, col = n0 + 8 * j + 2 * t;
        const float2 p = *reinterpret_cast<const float2*>(sP + row * TILE + (col ^ swz(row)));
        dp[j][2 * h] = p.x * (dp[j][2 * h] - sD[col]);
        dp[j][2 * h + 1] = p.y * (dp[j][2 * h + 1] - sD[col + 1]);
      }
    __syncthreads();   // every warp has read P^T as fragments
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(sP, r0 + g + 8 * h, n0 + 8 * j + 2 * t, dp[j][2 * h], dp[j][2 * h + 1]);
    __syncthreads();
    strip_pm<D, EXACT, ND>(acc_k, sP, sQb, sQs, r0, c0);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + r0 + g + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const size_t o = base + (size_t)r * D + c0 + 8 * nd + 2 * t;
      store2<T>(dk + o, acc_k[nd][2 * h] * scale, acc_k[nd][2 * h + 1] * scale);
      store2<T>(dv + o, acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers: one instantiation per (D, type)
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the backward: one block per (head, 64 rows)
dim3 grid_for(int bh, int n) { return dim3((unsigned)((n + TILE - 1) / TILE), (unsigned)bh); }

// the tile copies move 16 bytes a thread
bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15u) == 0;
}

template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int n, cudaStream_t stream) {
  if (!aligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = fwd_smem<D, T>();
  cudaError_t err = prepare(flash_fwd_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + FWD_ROWS - 1) / FWD_ROWS), (unsigned)bh);
  flash_fwd_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, n, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int n, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = dq_smem<D, T>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, n,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int n, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = dkv_smem<D, T>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D, T>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, n,
      1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16
bool args_ok(int bh, int n, int d, int dtype) {
  return bh > 0 && bh <= 65535 && n > 0 && (d == 32 || d == 64 || d == 128) &&
         (dtype == 0 || dtype == 1);
}

#define FLASH_DISPATCH(LAUNCH, ...)                                         \
  switch (d * 2 + dtype) {                                                  \
    case 64: return LAUNCH<32, float>(__VA_ARGS__);                         \
    case 65: return LAUNCH<32, __nv_bfloat16>(__VA_ARGS__);                 \
    case 128: return LAUNCH<64, float>(__VA_ARGS__);                        \
    case 129: return LAUNCH<64, __nv_bfloat16>(__VA_ARGS__);                \
    case 256: return LAUNCH<128, float>(__VA_ARGS__);                       \
    case 257: return LAUNCH<128, __nv_bfloat16>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;                             \
  }

}  // namespace

extern "C" {

int flash_forward(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int n, int d, int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, n, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int bh, int n, int d,
                 int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, n, (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                  int d, int dtype, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, n, (cudaStream_t)stream)
}

}  // extern "C"
