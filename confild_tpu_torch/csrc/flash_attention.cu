// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two-pass backward, float32 arithmetic for float32 and bfloat16 inputs.
//
// Layouts (row-major, contiguous): q, k, v, dO, out, dq, dk, dv are
// (BH, N, D); lse and delta are (BH, N) float32.  D is 32, 64 or 128 (the
// wrapper zero-pads a narrower head to the next of these).  Logits are
// scaled by the caller's scale (1 / sqrt of the unpadded width); the softmax
// runs in float32.
//
// ---------------------------------------------------------------------------
// flash_forward replaces the Pallas kernel _flash_kernel
// (confild_tpu/ops/flash_attention.py:56, launched at :118 by _flash_forward).
// flash_bwd_dq replaces _bwd_dq_kernel (:158, launched at :257) and
// flash_bwd_dkv replaces _bwd_dkv_kernel (:188, launched at :282), both of
// _flash_backward.
//
// Bound on the H100: operations.  The forward does 4 N^2 D flops per head
// (two products) and N^2 exponentials, the backward 14 N^2 D over its two
// passes (dq: S, dP, dQ; dk/dv: S, dP, dV, dK), against O(N D) bytes, so at
// N >= 144 the arithmetic bounds all three.  For float32 inputs every
// product is 3xTF32 (below): three TF32 products at the dense 495 TFLOP/s,
// 165 TFLOP/s of attention arithmetic; bf16 products run at 989 TFLOP/s,
// where the forward's exponentials (4.18e12 a second on the special-function
// units) bound it about as much as its products.
//
// Common to all three.  The TPU kernels carry the running max, denominator
// and output accumulator in VMEM across a sequential kv grid axis; Hopper
// blocks run in no order, so each block loops over the other axis itself:
// the forward one block per (head, 128 query rows) over tiles of keys; dq
// one block per (head, 64 query rows), the same loop; dk/dv one block per
// (head, 64 keys) over 64-query tiles.  Every output element has one owner
// thread, so there are no atomics and two launches give bitwise-equal
// results.  Ragged edges are masked in the kernels, with no padded copy:
// keys past N get probability 0 (a forward tile always holds a real key, so
// the running max is finite and exp never sees -inf - -inf), and query rows
// past N add nothing to dK and dV.  The (N, N) matrices never leave shared
// memory or registers: memory is O(N).
//
// 3xTF32.  A plain TF32 product keeps 11 significant bits and misses the
// float32 criterion the kernels are held to (|kernel - f64| <= 2 |plain f32
// - f64| + 1e-6 max|f64|) by some 300x, so each f32 operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and each product
// accumulates small*big + big*small (first) + big*big: about 22 significant
// bits per operand.  The tensor cores truncate their f32 sums, so the
// products go into short zeroed partials that float32 adds carry into the
// running sums.  bf16 inputs are exact in TF32 (no small half), and for them
// P and dS are rounded to bf16 before their products, as the JAX kernels
// round them (flash_attention.py:80-81, 180, 210, 214).
//
// Forward (replaces _flash_kernel, confild_tpu/ops/flash_attention.py:56):
// every product on wgmma, for both types and every D.
//   * Bound: float32, 3 x 4 N^2 D flops at 495 TFLOP/s; bf16, 4 N^2 D at
//     989 TFLOP/s and N^2 exponentials at 4.18e12 a second, about equal at
//     D = 64.  Beside the products the loop splits K and V (float32) or
//     transposes V (bf16), rounds or splits P, takes the row max (two
//     shuffles), rescales and carries.  On an H100 (NVIDIA H100 80GB HBM3,
//     700.00 W, tools/flash_fwd_compare.py) at (16, 9216, 64) it takes 3.80
//     ms in float32 (bound 2.11; the mma.sync kernel it replaced 4.17-6.35)
//     and 1.10 ms in bf16 (bound 0.35; 1.55-3.5); the producer's images
//     are what is left in its way (a variant that writes none: 2.71 and 0.93
//     ms), then the consumers' waits on their own products.
//   * Warp specialisation: a block is 128 query rows and three warpgroups.
//     The producer (setmaxnreg down to 56 registers) keeps the key tiles
//     coming: one thread issues each tile's K and V rows (contiguous in
//     global memory) as two 1-D bulk async copies into a ring of NR raw
//     stages, completing on the stage's mbarrier; its 128 threads then
//     write the tile's wgmma operand images into one of two image stages
//     (full and empty mbarriers), each thread loading four 16-byte chunks
//     before it writes any, and the thread refills the raw stage.  Two
//     consumer warpgroups (setmaxnreg up to 224) own 64 query rows each and
//     wait only on the image stages.  TF32 wgmma reads its shared-memory
//     operands only K-major, and P.V reduces along V's rows, so V's image is
//     written transposed (keys along K) in any case, and for float32 both K
//     and V need their TF32 halves: every streamed element passes through the
//     producer's threads once, which is also what lets the bf16 path share
//     the no-swizzle core-matrix layout (b_desc) with no tensor map.
//   * S = Q.K^T: both operands from shared memory (Q's image is written once
//     by the consumers, split for float32).  float32: the three products of
//     a k8 step go into a zeroed partial a k16 step, two partials taking
//     turns so that one is carried while the next runs; bf16: one m64n64k16
//     a k16 step into S.
//   * P.V: P never leaves registers.  bf16: the S accumulator's layout is the
//     A fragment's, so P is rounded to bf16 and packed in place.  float32:
//     the accumulator gives a thread keys 2t, 2t + 1 of each k8 step where
//     the A fragment wants t, t + 4; a product's sum does not depend on the
//     order of its k index, so P's fragment takes key 2t as index t and key
//     2t + 1 as t + 4, and V's image holds its keys in that order.  The tile's
//     products (24 for float32) go into one zeroed partial, carried as
//     acc = fma(acc, alpha, partial) with alpha = 2^(m_old - m_new).
//   * Softmax: a row lives in one quad of lanes; the running max m (log2
//     units) is the largest raw logit times scale * log2 e, and P =
//     2^(s scale log2 e - m) is one fma into ex2.approx; the running sum is
//     kept per thread, a tile's values summed before they join it, and
//     summed over the quad at the end; lse = m ln 2 + ln l.  bf16: P is
//     rounded relative to the running max; the sum adds the unrounded
//     float32 values.  (Issuing the next tile's S before this tile's softmax
//     measured slower in bf16, 1.64 against 1.58 ms, and spilled at D = 128.)
//   * Plans (fwd::Plan; keys a tile, raw stages, bytes of shared memory):
//     float32 D = 32: 64 keys, 4 raw stages, 160 KB; D = 64: 64 keys, one
//     raw stage, 224 KB; D = 128: 16 keys, 2 raw stages, 224 KB (Q's two
//     halves alone take 128 KB); bf16: 64 keys and 4 raw stages at every D
//     (56, 112 and 224 KB).  One block an SM.

// Why the backward stays on mma.sync.  Its three products with P and dS
// (dQ = dS.K, dK = dS^T.Q, dV = P^T.dO) reduce along the rows of row-major
// tiles, so on TF32 wgmma each needs a transposed image (Kt for dq, Qt and
// dOt for dk/dv) written by threads, and P and dS reach their products in a
// different layout than they leave S and dP; mma.sync fragments are
// ordinary shared loads in either direction.  Its redesign is its own PR.
//
// Backward.
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
//     and are split when their A fragments are loaded, as are P and dS
//     (rounded to bf16 instead for bf16 inputs: P for dV, dS for dQ and dK;
//     dS itself is formed from the float32 P, as in JAX).  bf16 tiles are
//     widened to f32 (exact in TF32: no small half).
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

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace hopper;    // mbarriers, bulk copies, wgmma (the forward)
using namespace tf32mma;   // cp.async and 3xTF32 mma.sync (the backward)

constexpr int TILE = 64;       // the backward's rows a tile and keys (or queries) a tile
constexpr int THREADS = 256;   // the backward: 8 warps

// ---------------------------------------------------------------------------
// the backward's helpers: swizzled tiles, cp.async, 3xTF32 mma.sync fragments
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
// column swizzle of row r: fragment walks along rows and along columns both
// conflict-free; bits 0-1 stay 0, so a 4-float chunk stays contiguous
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
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

// chunk i, as loaded, into swizzled tiles of row stride D: float32 split
// into its big and small halves, bfloat16 widened (exact in TF32: big only)
template <int D, typename T>
__device__ __forceinline__ void put_chunk(float4 x, int i, float* big, float* small) {
  int r, c;
  chunk_at<D, T>(i, r, c);
  const int sw = swz(r);
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
template <int D, typename T>
__device__ __forceinline__ void put_rows(const float4 x[CHUNKS<D, T>], float* big,
                                         float* small) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i) put_chunk<D, T>(x[i], i, big, small);
}
// the thread's own chunks of the raw stage (its cp.async copies, visible to
// it after cp_async_wait_all) into split tiles
template <int D, typename T>
__device__ __forceinline__ void put_staged(const float* raw, float* big, float* small) {
#pragma unroll
  for (int i = 0; i < CHUNKS<D, T>; ++i)
    put_chunk<D, T>(
        *reinterpret_cast<const float4*>(raw + 4 * (threadIdx.x + i * THREADS)), i, big, small);
}

// a resident tile (Q, dO for dq; K, V for dk/dv):
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

// An operand of the backward's products with P and dS: split into TF32 halves, or for bf16 inputs (ROUND) rounded to bf16 as
// the JAX kernels round P and dS, which is exact in TF32 (no small half).
template <bool ROUND>
__device__ __forceinline__ void split_p(float x, uint32_t& big, uint32_t& small) {
  if constexpr (ROUND) {
    big = __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
    small = 0u;
  } else {
    split<false>(x, big, small);
  }
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4).  A, 16 x 8 at (r0, c0):
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); split<EXACT>, or rounded to
// bf16 when ROUND (split_p)
template <int LD, bool EXACT, bool ROUND = false>
__device__ __forceinline__ void frag_a(uint32_t big[4], uint32_t small[4], const float* tile,
                                       int r0, int c0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float x[4] = {ld_sw<LD>(tile, r0 + g, c0 + t), ld_sw<LD>(tile, r0 + g + 8, c0 + t),
                      ld_sw<LD>(tile, r0 + g, c0 + t + 4),
                      ld_sw<LD>(tile, r0 + g + 8, c0 + t + 4)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (ROUND)
      split_p<true>(x[i], big[i], small[i]);
    else
      split<EXACT>(x[i], big[i], small[i]);
  }
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
// (float32, split here; for bf16 inputs, EXACT, rounded to bf16 here, as
// JAX rounds P and dS) times columns c0 + 8nd .. of a 64 x D tile (given
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
      frag_a<TILE, false, EXACT>(ab, as, p, r0, 8 * kc);
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        uint32_t bb[2], bs[2];
        frag_b_cols<D, EXACT>(bb, bs, mb, ms, 8 * kc, c0 + 8 * nd);
        mma3_into<EXACT, EXACT>(part[nd], ab, as, bb, bs);
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
// the forward's wgmma products, m64nNk8 (TF32) and m64nNk16 (bf16), float32
// accumulators d (d[4j + e]: row 16 w + g + 8 (e / 2), column 8 j + 2 t +
// e % 2 of warp w of the warpgroup; g = lane / 4, t = lane % 4) + (scale_d ?
// d : 0).  mma_ss: A and B K-major in shared memory (descriptors, b_desc);
// mma_rs: A in registers (TF32: rows g, g + 8, columns t, t + 4; bf16: rows
// g, g + 8, column pairs 2t, 2t + 8, the smaller column in the low half),
// B K-major in shared memory.
// ---------------------------------------------------------------------------
namespace fwd {

template <int N, typename T>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <int N, typename T>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d);

template <>
__device__ __forceinline__ void mma_ss<16, float>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<32, float>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<64, float>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<32, float>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64, float>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<128, float>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<64, __nv_bfloat16>(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<32, __nv_bfloat16>(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<64, __nv_bfloat16>(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs<128, __nv_bfloat16>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace fwd

// ---------------------------------------------------------------------------
// forward: out = softmax(q k^T * scale) v, lse = logsumexp of each row, on
// wgmma (the plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace fwd {

constexpr int CONSUMERS = 2;                      // consumer warpgroups, 64 query rows each
constexpr int ROWS = 64 * CONSUMERS;              // query rows a block
constexpr int THREADS = 128 * (CONSUMERS + 1);    // and the producer warpgroup
// setmaxnreg: a thread starts at 65536 / 384 = 168 registers; the producer
// gives 112 of them to each consumer thread
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
constexpr int MAX_NR = 4;                         // raw stages, at most
constexpr int ALIGN = 128;
constexpr int SMEM_LIMIT = 232448;                // what a block may take

// The plan of one instantiation: KT keys a tile; Q's image; NI stages of K
// and V images; NR raw stages (as many as fit, up to MAX_NR).  float32
// tiles are 16 keys at D = 128, where Q's two halves take 128 KB (tiles of
// 32 keys at D = 64, for a ring of four raw stages in place of one, ran
// slower: a tile's fixed cost is the consumers' waits on their products).
// Mirrored by ops/flash_attention.py::forward_plan.
template <int D, typename T>
struct Plan {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int HALVES = F32 ? 2 : 1;            // TF32 big and small, or bf16
  static constexpr int EPC = 16 / (int)sizeof(T);       // elements a 16-byte chunk
  static constexpr int CPR = D / EPC;                   // chunks a row of q, k, v
  static constexpr int KT = F32 && D == 128 ? 16 : 64;   // keys a tile
  static constexpr int NI = 2;                                 // image stages
  static constexpr int Q_IMG = ROWS * D * (int)sizeof(T) * HALVES;
  static constexpr int KV_IMG = KT * D * (int)sizeof(T) * HALVES;   // K's image; V's
  static constexpr int RAW = KT * D * (int)sizeof(T);                // one raw tile
  static constexpr int FIXED = ALIGN + Q_IMG + NI * 2 * KV_IMG + 8 * (MAX_NR + 2 * NI);
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (2 * RAW);
  static constexpr int NR = FIT < MAX_NR ? FIT : MAX_NR;
  static constexpr int SMEM = FIXED + NR * 2 * RAW;
  static_assert(NR >= 1 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
  static_assert(D % 16 == 0 && KT % 16 == 0 && (KT * CPR) % 128 == 0, "whole chunks a thread");
};

// Byte offset of 16-byte chunk ck (along K) of row r (along M or N) in the
// image of an operand of R rows: the no-swizzle K-major core matrices that
// b_desc reads, one k-step (two chunks: k8 of TF32, k16 of bf16) a block of
// R x 32 bytes a half, the small half after the big one.  (Mirrored by
// ops/flash_attention.py::image_offset.)
template <int R, int HALVES>
__device__ __forceinline__ int img_off(int r, int ck) {
  return (ck >> 1) * (R * 32 * HALVES) + (r >> 3) * 256 + (ck & 1) * 128 + (r & 7) * 16;
}

// a chunk of q or k into its image: float32 split into TF32 halves, bf16
// as it is
template <int R, typename T>
__device__ __forceinline__ void put16(unsigned char* img, int r, int ck, uint4 x) {
  const int o = img_off<R, Plan<32, T>::HALVES>(r, ck);
  if constexpr (sizeof(T) == 4) {
    uint32_t b[4], s[4];
    split<false>(__uint_as_float(x.x), b[0], s[0]);
    split<false>(__uint_as_float(x.y), b[1], s[1]);
    split<false>(__uint_as_float(x.z), b[2], s[2]);
    split<false>(__uint_as_float(x.w), b[3], s[3]);
    *reinterpret_cast<uint4*>(img + o) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(img + o + R * 32) = make_uint4(s[0], s[1], s[2], s[3]);
  } else {
    *reinterpret_cast<uint4*>(img + o) = x;
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// this thread's generic shared-memory accesses before the async proxy's
// (wgmma reads, bulk copies)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// the 128 threads of one warpgroup (named barrier id, 1 ..)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void fence_u32(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// Key tile `tile` of k and v (rows k0 .. k0 + valid - 1, contiguous in
// global memory) into a raw stage, K then V, by one thread: two 1-D bulk
// copies completing on the stage's barrier, which expects both.
template <int D, typename T>
__device__ __forceinline__ void fill_tile(uint32_t stage, uint32_t bar, const T* k, const T* v,
                                          int k0, int valid) {
  using P = Plan<D, T>;
  const uint32_t bytes = (uint32_t)(valid * D * (int)sizeof(T));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(2 * bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(stage), "l"(k + (size_t)k0 * D), "r"(bytes), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(stage + (uint32_t)P::RAW), "l"(v + (size_t)k0 * D), "r"(bytes), "r"(bar)
      : "memory");
}

// The producer warpgroup's images of one tile from its raw stage (ptid:
// the thread's rank among the 128; rows from valid on are zeros):
// K as the B operand of S = Q K^T (KT rows, K along D), V as the B operand
// of P V (D rows, K along the keys).  float32: each element split into its
// TF32 halves, and V's keys within each k8 step taken in the order of P's
// register fragment (index t is key 2t, index t + 4 key 2t + 1): chunk
// (d, ck) holds keys 8 (ck / 2) + ck % 2 + 2e, e < 4.  bf16: V's chunk
// (d, ck) holds keys 8 ck .. 8 ck + 7 (P's fragment takes them in order).
// A phase of eight lanes reads and writes eight distinct 16-byte bank
// groups: K's chunks run diagonally (eight consecutive rows, eight chunk
// columns), V's one column a lane.
template <int D, typename T>
__device__ __forceinline__ void build_images(const unsigned char* raw, unsigned char* kimg,
                                             unsigned char* vimg, int valid, int ptid) {
  using P = Plan<D, T>;
  constexpr int KT = P::KT, KU = KT * P::CPR / 128;   // K's chunks a thread
  constexpr int B = KU < 4 ? KU : 4;   // chunks a thread loads before it writes any
  static_assert(KU % B == 0 && (D * (KT / 4) / 128) % 4 == 0, "whole batches a thread");
#pragma unroll 1
  for (int j0 = 0; j0 < KU; j0 += B) {
    uint4 x[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int u = ptid + 128 * (j0 + j), r = u % KT, ck = (u / KT + r) % P::CPR;
      x[j] = r < valid ? *reinterpret_cast<const uint4*>(raw + (r * P::CPR + ck) * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int u = ptid + 128 * (j0 + j), r = u % KT, ck = (u / KT + r) % P::CPR;
      put16<KT, T>(kimg, r, ck, x[j]);
    }
  }
  const unsigned char* rawv = raw + P::RAW;
  if constexpr (P::F32) {
    const float* rv = reinterpret_cast<const float*>(rawv);
    constexpr int VU = D * (KT / 4) / 128;
#pragma unroll 1
    for (int j0 = 0; j0 < VU; j0 += 4) {
      float x[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = ptid + 128 * (j0 + j), d = u % D, ck = u / D;
        const int key0 = 8 * (ck >> 1) + (ck & 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 2 * e;
          x[j][e] = key < valid ? rv[key * D + d] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = ptid + 128 * (j0 + j), d = u % D, ck = u / D;
        uint32_t b[4], sm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split<false>(x[j][e], b[e], sm[e]);
        const int o = img_off<D, 2>(d, ck);
        *reinterpret_cast<uint4*>(vimg + o) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(vimg + o + D * 32) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
      }
    }
  } else {
    // columns 2 dp, 2 dp + 1 of keys 8 ck .. 8 ck + 7: eight 32-bit words,
    // their low halves one chunk and their high halves the next
    const uint32_t* rv = reinterpret_cast<const uint32_t*>(rawv);
    constexpr int VU = (D / 2) * (KT / 8) / 128;
#pragma unroll
    for (int j = 0; j < VU; ++j) {
      const int u = ptid + 128 * j, dp = u % (D / 2), ck = u / (D / 2);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int key = 8 * ck + e;
        w[e] = key < valid ? rv[key * (D / 2) + dp] : 0u;
      }
      *reinterpret_cast<uint4*>(vimg + img_off<D, 1>(2 * dp, ck)) =
          make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                     __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
      *reinterpret_cast<uint4*>(vimg + img_off<D, 1>(2 * dp + 1, ck)) =
          make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                     __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
    }
  }
}

// One consumer warpgroup's 64 rows of Q (block rows 64 wg ..) into Q's
// image, read straight from global memory (zeros past n).
template <int D, typename T>
__device__ __forceinline__ void q_image(unsigned char* qimg, const T* q, int q0, int n, int wg,
                                        int ctid) {
  using P = Plan<D, T>;
#pragma unroll 2
  for (int u = ctid; u < 64 * P::CPR; u += 128) {
    const int r = u % 64, ck = (u / 64 + r) % P::CPR;
    const int row = 64 * wg + r;
    const uint4 x = q0 + row < n
                        ? __ldg(reinterpret_cast<const uint4*>(q + (size_t)(q0 + row) * D) + ck)
                        : make_uint4(0u, 0u, 0u, 0u);
    put16<ROWS, T>(qimg, row, ck, x);
  }
}

template <int R>
__device__ __forceinline__ void carry(float (&acc)[R], float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    fence_reg(part[i]);
    acc[i] += part[i];
  }
}

// s = this warpgroup's 64 rows of Q times the stage's KT keys, transposed
// (accumulator layout: s[4j + e] is row 16 w + g + 8 (e / 2), key 8 j + 2 t +
// e % 2).  float32: three TF32 products a k8 step into a zeroed partial a
// k16 step (two partials taking turns, one carried while the next runs);
// bf16: one k16 product a step into s.
template <int D, typename T>
__device__ __forceinline__ void qk_product(float (&s)[Plan<D, T>::KT / 2], uint32_t qa,
                                           uint32_t kb) {
  using P = Plan<D, T>;
  constexpr int KT = P::KT;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
  if constexpr (P::F32) {
    constexpr int QB = ROWS * 32 * 2, KB = KT * 32 * 2;   // bytes of a k8 step's images
    float part[2][KT / 2];
#pragma unroll
    for (int c2 = 0; c2 < D / 16; ++c2) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) fence_reg(part[c2 & 1][i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a = qa + (2 * c2 + kk) * QB, b = kb + (2 * c2 + kk) * KB;
        mma_ss<KT, float>(part[c2 & 1], b_desc(a + ROWS * 32), b_desc(b), kk);
        mma_ss<KT, float>(part[c2 & 1], b_desc(a), b_desc(b + KT * 32), 1);
        mma_ss<KT, float>(part[c2 & 1], b_desc(a), b_desc(b), 1);
      }
      wgmma_commit();
      if (c2 > 0) {
        wgmma_wait<1>();
        carry(s, part[(c2 - 1) & 1]);
      }
    }
    wgmma_wait<0>();
    carry(s, part[(D / 16 - 1) & 1]);
  } else {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) fence_reg(s[i]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      mma_ss<KT, __nv_bfloat16>(s, b_desc(qa + c * ROWS * 32), b_desc(kb + c * KT * 32), c > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) fence_reg(s[i]);
  }
}

// pv = P (in s, accumulator layout) times the stage's V, over the tile's
// keys into a zeroed partial.  float32: P's TF32 halves as register A, key
// 2t of a k8 step as index t, 2t + 1 as t + 4 (V's image takes them so),
// three products a step; bf16: P rounded to bf16 (to nearest even, as JAX
// rounds it: relative to the running max), one k16 product a step.
template <int D, typename T>
__device__ __forceinline__ void pv_product(float (&pv)[D / 2], const float (&s)[Plan<D, T>::KT / 2],
                                           uint32_t vb) {
  using P = Plan<D, T>;
  constexpr int KT = P::KT;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) fence_reg(pv[i]);
  if constexpr (P::F32) {
    constexpr int VB = D * 32 * 2;   // bytes of a k8 step's images
    uint32_t pb[KT / 8][4], ps[KT / 8][4];
#pragma unroll
    for (int c = 0; c < KT / 8; ++c) {
      split<false>(s[4 * c], pb[c][0], ps[c][0]);       // (g, key 2t)
      split<false>(s[4 * c + 2], pb[c][1], ps[c][1]);   // (g + 8, key 2t)
      split<false>(s[4 * c + 1], pb[c][2], ps[c][2]);   // (g, key 2t + 1)
      split<false>(s[4 * c + 3], pb[c][3], ps[c][3]);   // (g + 8, key 2t + 1)
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KT / 8; ++c) {
      const uint32_t b = vb + c * VB;
      mma_rs<D, float>(pv, ps[c], b_desc(b), c > 0);
      mma_rs<D, float>(pv, pb[c], b_desc(b + D * 32), 1);
      mma_rs<D, float>(pv, pb[c], b_desc(b), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // P's registers stay untouched until the products end
        fence_u32(pb[c][e]);
        fence_u32(ps[c][e]);
      }
  } else {
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int c = 0; c < KT / 16; ++c) {
      pa[c][0] = pack_bf16(s[8 * c], s[8 * c + 1]);       // (g, keys 2t, 2t + 1)
      pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);   // (g + 8, the same)
      pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);   // (g, keys 2t + 8, 2t + 9)
      pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);   // (g + 8, the same)
    }
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KT / 16; ++c)
      mma_rs<D, __nv_bfloat16>(pv, pa[c], b_desc(vb + c * D * 32), c > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < KT / 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_u32(pa[c][e]);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) fence_reg(pv[i]);
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile's logits s (accumulator layout), in
// place: P = 2^(s scale2 - m) with m the running max in log2 units (keys
// past n at 0: in a ragged last tile they are -inf first; a tile holds a
// key, so m stays finite), one fma into the exponential; the thread's share
// l of the running sum, and alpha = 2^(m_old - m_new), the rescale of the
// tiles before (0 at the first).  A row lives in one quad of lanes.
template <int KT>
__device__ __forceinline__ void softmax_tile(float (&s)[KT / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int n, int t,
                                             float scale2) {
  if (k0 + KT > n) {
#pragma unroll
    for (int i = 0; i < KT / 2; ++i)
      if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale2);   // scale2 > 0: the max commutes
    alpha[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    neg[h] = -m_new;
  }
  float tile_sum[2] = {0.f, 0.f};   // summed a tile at a time: a shorter chain
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    s[i] = ex2(fmaf(s[i], scale2, neg[(i >> 1) & 1]));
    tile_sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = fmaf(alpha[h], l[h], tile_sum[h]);
}

}  // namespace fwd

// Block: ROWS query rows of one head; warpgroups 0 and 1 consume (64 rows
// each), warpgroup 2 produces.  Barriers: raw_full[NR] (the bulk copies),
// img_full[NI] (the producer's 128 threads), img_empty[NI] (the consumers'
// eight warps).
template <int D, typename T>
__global__ void __launch_bounds__(fwd::THREADS, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int n, float scale) {
  using namespace fwd;
  using P = Plan<D, T>;
  constexpr int KT = P::KT, NR = P::NR, NI = P::NI;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qimg = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* img0 = qimg + P::Q_IMG;                // NI stages: K's image, V's image
  unsigned char* raw0 = img0 + NI * 2 * P::KV_IMG;      // NR stages: raw K, raw V
  const uint32_t raw_full = smem_addr(raw0 + NR * 2 * P::RAW);
  const uint32_t img_full = raw_full + 8 * NR, img_empty = img_full + 8 * NI;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * ROWS;
  const size_t base = (size_t)blockIdx.y * n * D;
  const int tiles = (n + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < NR; ++s) mbar_init(raw_full + 8 * s, 1);
    for (int s = 0; s < NI; ++s) {
      mbar_init(img_full + 8 * s, 128);
      mbar_init(img_empty + 8 * s, 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = tid - 128 * CONSUMERS;
    if (ptid == 0)
      for (int u = 0; u < NR && u < tiles; ++u)
        fill_tile<D, T>(smem_addr(raw0 + u * 2 * P::RAW), raw_full + 8 * u, k + base, v + base,
                        u * KT, min(KT, n - u * KT));
    for (int it = 0; it < tiles; ++it) {
      const int sr = it % NR, si = it % NI;
      const unsigned char* raw = raw0 + sr * 2 * P::RAW;
      unsigned char* kimg = img0 + si * 2 * P::KV_IMG;
      mbar_wait(raw_full + 8 * sr, (it / NR) & 1);
      if (it >= NI) mbar_wait(img_empty + 8 * si, ((it / NI) + 1) & 1);
      build_images<D, T>(raw, kimg, kimg + P::KV_IMG, min(KT, n - it * KT), ptid);
      fence_async();
      mbar_arrive(img_full + 8 * si);
      if (it + NR < tiles) {   // every producer thread is done with the raw stage: refill it
        wg_sync(1);
        if (ptid == 0) {
          fence_async();
          const int u = it + NR;
          fill_tile<D, T>(smem_addr(raw), raw_full + 8 * sr, k + base, v + base, u * KT,
                          min(KT, n - u * KT));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  q_image<D, T>(qimg, q + base, q0, n, wg, ctid);
  fence_async();
  wg_sync(2 + wg);
  const uint32_t qa = smem_addr(qimg) + wg * 2048;   // the warpgroup's 64 rows: 8 row groups
  const float scale2 = scale * LOG2E;

  // rows 16 warp + g + 8h of the warpgroup's: running max of the logits
  // (log2 units), this thread's share of the running sum, and the output in
  // accumulator layout (acc[4j + 2h + e] is column 8j + 2t + e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // the stage's tile done: this warp's release, then the output's update
  auto finish = [&](int it, const float (&alpha)[2], const float (&pv)[D / 2]) {
    __syncwarp();
    if (lane == 0) mbar_arrive(img_empty + 8 * (it % NI));   // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  };
  auto stage = [&](int it) { return img0 + (it % NI) * 2 * P::KV_IMG; };
  auto wait_full = [&](int it) { mbar_wait(img_full + 8 * (it % NI), (it / NI) & 1); };

  for (int it = 0; it < tiles; ++it) {
    wait_full(it);
    float s[KT / 2], alpha[2], pv[D / 2];
    qk_product<D, T>(s, qa, smem_addr(stage(it)));
    softmax_tile<KT>(s, m, l, alpha, it * KT, n, t, scale2);
    pv_product<D, T>(pv, s, smem_addr(stage(it) + P::KV_IMG));
    finish(it, alpha, pv);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {   // the quad's shares of the sum
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * wg + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(out + base + (size_t)r * D + 8 * j + 2 * t, acc[4 * j + 2 * h] * inv,
                acc[4 * j + 2 * h + 1] * inv);
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
// the backward: one block per (head, 64 rows)
dim3 grid_for(int bh, int n) { return dim3((unsigned)((n + TILE - 1) / TILE), (unsigned)bh); }

// the tile copies move 16 bytes a thread
bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) & 15u) == 0;
}

// the forward: one block per (head, 128 query rows)
template <int D, typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
               int n, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
  constexpr int smem = fwd::Plan<D, T>::SMEM;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_kernel<D, T>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + fwd::ROWS - 1) / fwd::ROWS), (unsigned)bh);
  flash_fwd_kernel<D, T><<<grid, fwd::THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, n, scale);
  return (int)cudaGetLastError();
}

// the forward's plan of one instantiation: {keys a tile, raw stages, image
// stages, dynamic shared-memory bytes}
template <int D, typename T>
int plan_fwd(int* plan) {
  using P = fwd::Plan<D, T>;
  plan[0] = P::KT;
  plan[1] = P::NR;
  plan[2] = fwd::Plan<D, T>::NI;
  plan[3] = P::SMEM;
  return 0;
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int n, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = dq_smem<D, T>();
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, T>, smem, done);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, n, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int n, float scale,
               cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  const size_t smem = dkv_smem<D, T>();
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, T>, smem, done);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<D, T><<<grid_for(bh, n), THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, n,
      scale);
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

// scale: the logits' factor, 1 / sqrt of the head width before padding
int flash_forward(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int n, int d, int dtype, float scale, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, n, scale, (cudaStream_t)stream)
}

// the forward's plan at head width d and dtype (0 float32, 1 bfloat16):
// plan[4] = {keys a tile, raw stages, image stages, shared-memory bytes}
int flash_forward_plan(int d, int dtype, int* plan) {
  if (!args_ok(1, 1, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(plan_fwd, plan)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int bh, int n, int d,
                 int dtype, float scale, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, n, scale, (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                  int d, int dtype, float scale, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, n, scale,
                 (cudaStream_t)stream)
}

}  // extern "C"
