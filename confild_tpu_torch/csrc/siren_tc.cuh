// The block shape of the SIREN-FiLM bf16 forward (siren_decode.cu) and its
// constants: a block of eight warps, at most MAX_C coordinates and outputs.
//
// A block of the bf16 forward owns block_pairs(H) (row, point) pairs (the M
// dimension of every product: 64 up to H = 384, 32 at 448 and 512, 16 from
// 576 to 1024) and keeps their activations in shared memory.  Eight warps
// each own H / 8 output columns for all of the block's rows, 4 * m_tiles *
// H / 64 accumulators a thread.  The float32 forward and the chain of dz and
// the training backward are the cluster kernels' (siren_cluster.cuh), the
// training backward's reduction is on wgmma too (siren_decode_bwd.cu).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "siren_common.cuh"
#include "tf32_mma.cuh"

namespace siren_tc {

using namespace tf32mma;

constexpr int MAX_H = 1024;      // widest hidden layer (the bf16 forward)
constexpr int MAX_C = 16;        // widest C_in and C_out
constexpr int THREADS = 256;     // 8 warps
constexpr int WIDE_NT = 6;       // widest H / 64 whose blocks own 64 pairs
constexpr int MID_NT = 8;        // widest H / 64 whose blocks own 32 pairs

// m16 tiles of pairs a block owns at H = 64 NT: four (64 pairs) up to
// H = 384; two (32 pairs) at H = 448 and 512, where 64 pairs would need
// 112 and 128 accumulators a thread; one (16 pairs) from H = 576 to 1024,
// where 32 pairs would need 72 to 128 accumulators
__host__ __device__ constexpr int m_tiles(int NT) {
  return NT <= WIDE_NT ? 4 : NT <= MID_NT ? 2 : 1;
}
// pairs a block owns at hidden width H
__host__ __device__ constexpr int block_pairs(int H) { return 16 * m_tiles(H / 64); }

// H a multiple of 64 up to MAX_H, C_in and C_out up to MAX_C
inline bool shape_ok(int H, int n_mod, int C_in, int C_out) {
  return H > 0 && H % 64 == 0 && H <= MAX_H && n_mod >= 1 && C_in >= 1 && C_in <= MAX_C &&
         C_out >= 1 && C_out <= MAX_C;
}

// f(std::integral_constant<int, H / 64>()) for the instantiation of width
// H up to WIDEST, or cudaErrorInvalidValue when there is none
template <int WIDEST, int NT = 1, typename F>
int with_width(int H, F&& f) {
  if (H == NT * 64) return f(std::integral_constant<int, NT>());
  if constexpr (NT < WIDEST / 64) {
    return with_width<WIDEST, NT + 1>(H, f);
  } else {
    return (int)cudaErrorInvalidValue;
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

}  // namespace siren_tc
