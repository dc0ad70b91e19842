// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two-pass backward, float32 arithmetic for float32 and bfloat16 inputs,
// every product on wgmma.
//
// Layouts (row-major, contiguous): q, k, v, dO, out, dq, dk, dv are
// (BH, N, D); lse and delta are (BH, N) float32.  D is 32, 64 or 128, or a
// multiple of 128 above that (the wrapper zero-pads any other head to the
// next of these); above 128 each pass has a kernel of its own (the last
// section of this note).  Logits are scaled by the caller's scale (1 / sqrt
// of the unpadded width); the softmax runs in float32.
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
// passes (dq: S, dP, dQ; dk/dv: S, dP, dV, dK) and 2 N^2 exponentials,
// against O(N D) bytes, so at N >= 144 the arithmetic bounds all three.
// For float32 inputs every product is 3xTF32 (below): three TF32 products
// at the dense 495 TFLOP/s, 165 TFLOP/s of attention arithmetic; bf16
// products run at 989 TFLOP/s, where the exponentials (4.18e12 a second on
// the special-function units) bound the forward about as much as its
// products.
//
// Common to all three.  The TPU kernels carry their sums in VMEM across a
// sequential grid axis; Hopper blocks run in no order, so each block loops
// over the other axis itself: the forward and dq over tiles of keys for a
// block of query rows, dk/dv over tiles of queries for a block of keys.
// Every output element has one owner thread, so there are no atomics and
// two launches give bitwise-equal results.  Ragged edges are masked in the
// kernels, with no padded copy: keys past N get probability 0 (a forward
// tile always holds a real key, so the running max is finite and exp never
// sees -inf - -inf), and query rows past N add nothing to dK and dV.  The
// (N, N) matrices never leave shared memory or registers: memory is O(N).
//
// 3xTF32.  A plain TF32 product keeps 11 significant bits and misses the
// float32 criterion the kernels are held to (|kernel - f64| <= 2 |plain f32
// - f64| + 1e-6 max|f64|) by some 300x, so each f32 operand x is split into
// big = rna_tf32(x) and small = rna_tf32(x - big), and each product
// accumulates small*big + big*small (first) + big*big: about 22 significant
// bits per operand.  The tensor cores truncate their f32 sums, so the
// products go into short zeroed partials that float32 adds carry into the
// running sums.  bf16 operands take one bf16 product a k16 step; P and dS
// are rounded to bf16 before their products, as the JAX kernels round them
// (flash_attention.py:80-81, 180, 210, 214).
//
// The pieces both passes share (namespace tc): the wgmma products, mma_ss
// (A and B K-major in shared memory) and mma_ss's register-A sibling
// mma_rs; the operand images, no-swizzle K-major core matrices that b_desc
// reads (img_off), written by threads: a row-major tile as it is (K-major
// along D) or transposed (K along the tile's rows, in the register A
// operand's order); the S-like product of two images with its partials
// (ss_product) and the products with a register A operand formed in an
// accumulator (tf32_frags / bf16_frags, rs_tf32 / rs_bf16); the producer
// warpgroup's ring (a raw stage of 1-D bulk async copies on an mbarrier,
// image stages with full and empty mbarriers).
//
// Forward (replaces _flash_kernel, confild_tpu/ops/flash_attention.py:56):
//   * Bound: float32, 3 x 4 N^2 D flops at 495 TFLOP/s; bf16, 4 N^2 D at
//     989 TFLOP/s and N^2 exponentials at 4.18e12 a second, about equal at
//     D = 64.  Beside the products the loop splits K and V (float32) or
//     transposes V (bf16), rounds or splits P, takes the row max (two
//     shuffles), rescales and carries.  On an H100 (NVIDIA H100 80GB HBM3,
//     700.00 W, tools/flash_fwd_compare.py) at (16, 9216, 64) it takes 3.80
//     ms in float32 (bound 2.11; the warp-level HMMA kernel it replaced 4.17-6.35)
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
//
// Backward (replaces _bwd_dq_kernel and _bwd_dkv_kernel): the forward's
// design, with the roles of the operands as the two passes need them.
//   * Bound: 3 x 6 N^2 D (dq) and 3 x 8 N^2 D (dk/dv) flops at 495 TFLOP/s
//     for float32, 6 and 8 N^2 D at 989 TFLOP/s for bf16; N^2 exponentials
//     each.  Beside the products: the producer's images, P's exponential,
//     dS's multiply-add, the register operands' split (float32) or rounding
//     (bf16), the partials' carries.  On an H100 (NVIDIA H100 80GB HBM3,
//     700.00 W, tools/flash_fwd_compare.py --backward) at (16, 9216, 64) the
//     float32 pair takes 17.5 ms (bound 7.38; the HMMA pair it replaced
//     25.0-25.4), dq 7.0 and dk/dv 10.5; bf16 3.7 ms (bound 1.23; 15.0
//     before, SDPA's bf16 backward 2.05-2.34).  A variant whose producers
//     write no images takes 13.8 and 2.5 ms: in float32 the consumer's
//     waits on its own products come first (one consumer warpgroup a
//     block), in bf16 dk/dv's producer (four images, two transposed).
//   * dq, a block of query rows over tiles of keys.  Resident (written by
//     the consumers, each its own 64 rows): the images of Q and dO, the A
//     operands of S = Q.K^T and dP = dO.V^T.  Streamed (the producer's three
//     images a tile): K and V as they are (the B operands of S and dP,
//     K-major along D, as the forward's K) and K^T (the B operand of dQ +=
//     dS.K, keys along K, as the forward's V).  P = 2^(S scale log2 e - lse
//     log2 e) is one fma into ex2.approx, dS = P (dP - delta) is formed in
//     the dP accumulator (lse and delta of the thread's two rows are in
//     registers for the whole loop), and dS goes to dQ's product as register
//     A (split into TF32 halves, or rounded to bf16), with no trip through
//     shared memory.
//   * dk/dv, a block of keys over tiles of queries.  The products are
//     transposed: S^T = K.Q^T and dP^T = V.dO^T with K and V resident and
//     Q and dO streamed as they are; then dV += P^T.dO and dK += dS^T.Q with
//     P^T and dS^T as register A and dO^T and Q^T streamed (four images a
//     tile).  lse and delta are per query, so they run along the
//     accumulator's columns: the producer puts the tile's lse log2 e (+inf
//     past N, which makes P 0 there with no mask) and delta beside its
//     images, and a thread reads a float2 of each a column pair.
//   * float32 partials: S and dP as in the forward (a zeroed partial a k16
//     step, two taking turns); the products with P and dS one zeroed partial
//     a tile (its ST / 8 k8 steps, three products each) carried by a float32
//     add, of 64 output columns at a time (at D = 128, two in turn, which
//     halves the partial's registers).  bf16: every product straight into
//     its sum (the truncation's bias, about 2^-23 a step, is far below the
//     bf16 outputs' rounding).  Each partial is zeroed where it is declared,
//     though its first product ignores it: with undefined inputs to the asm
//     the compiler folded dk/dv's two S-like products into one (S^T took
//     dP^T's values, 20 of 60 HGMMA went, every dK and dV was wrong).
//   * The transposed images are written by the producer's threads from the
//     raw rows, for bf16 too.  wgmma could read a bf16 B operand MN-major
//     through the descriptor's transpose bit, but the no-swizzle MN-major
//     layout's strides could not be probed without the card, and the
//     written image is the forward's, tried on it.  Tried and dropped:
//     bf16 transposes by ldmatrix / stmatrix.trans from the K-major image
//     just written (4.1-4.8 ms against 3.7: the barrier between the two
//     passes serialises the producer, which then spilled); S and dP in
//     common commit groups (17.9 against 17.7 ms in float32, 3.9 against
//     3.7 in bf16); dV's and dK's products in one group with both register
//     operands formed first (444 bytes of spill, dk/dv 16.6 ms against
//     10.9); two consumer warpgroups in float32 (16-row tiles at D = 64,
//     where 128 resident rows of Q and dO with both halves take 128 KB:
//     19.0 ms against 17.6, and twice as slow at (32, 256, 64), whose 64
//     blocks of 128 rows left half the card idle).
//   * Plans (bwd::Plan; per (D, type, pass): consumer warpgroups C, rows a
//     block 64 C, the streamed tile ST, image stages NI, raw stages NR as
//     many as fit up to four, bytes): float32 has one consumer warpgroup
//     (resident images of 64 rows, 64 KB at D = 64) and ST = 2048 / D
//     (dq and dk/dv at D = 64: 32-row tiles, two image stages, four and two
//     raw stages, 224 KB); at D = 128 dq has no raw stage (its producer
//     reads the rows from global memory) and dk/dv one image stage.  bf16 has
//     two consumer warpgroups and 64-row tiles (32 for dk/dv at D = 128, whose
//     two accumulators of 64 registers leave no room for more).  The
//     producer is at setmaxnreg 56 and the consumers at 224 with two consumer
//     warpgroups; with one, no setmaxnreg (up to 255 registers).  One block an
//     SM.
//
// Heads wider than 128 (flash_fwd_wide_kernel, flash_bwd_dq_wide_kernel,
// flash_bwd_dkv_wide_kernel; namespace wide): the same three functions of
// the same three TPU kernels, which block on the whole head (a (1, block,
// D) BlockSpec under a 100 MiB VMEM limit) and so take any width.
//   * Why not the plans above at D = 256: Q's 128-row image in TF32 halves
//     alone is 256 KB, over a block's 227 KB, and a warpgroup's float32
//     output accumulator of 64 rows takes D / 2 registers a thread (256 at
//     D = 512, against 255).  So the head is split.
//   * Design: a block owns 64 rows (one consumer warpgroup) and one group
//     of G = 128 output columns (the wrapper pads D to a multiple of 128; a
//     grid index runs over (row tile, group), heads on the other axis).
//     The products that reduce over D (S, and in the backward dP) loop over
//     the head in chunks of GC columns (64 in float32, 128 in bf16, where a
//     tile's time follows its count of items): each chunk is one ss_product
//     into the same sum (its ACC mode), so S over the chunks is S over D,
//     the same partials carried every k16 step.  The products over the
//     streamed rows take only the group's columns: O_g += P V_g, dQ_g +=
//     dS K_g, dV_g += P^T dO_g, dK_g += dS^T Q_g, each bwd::rs_accumulate
//     on a transposed image of the group (G rows, tc::transposed_image), P
//     and dS as register A as above.  Every group recomputes S (and dP):
//     the products are (D / G + 1) / 2 times the least in the forward and
//     (8 D / G + 6) / 14 in the backward pair, 1.5x and 1.57x at D = 256,
//     2.5x and 2.71x at 512.  On an H100 (NVIDIA H100 80GB HBM3, 700.00 W,
//     chip_smoke.py phase 10) at (8, 9216, 256): the forward 22.65 ms in
//     float32 (bound 4.22) and 6.86 in bf16 (0.70), the pair 96.1 and 26.0
//     (14.8 and 2.46).  Every group computes the same m, l and lse,
//     bitwise; group 0 writes lse.  Every output element still has one
//     owner: no atomics, bitwise repeats.
//   * The ring: the producer warpgroup writes a sequence of items, each
//     into one of NI image stages (full and empty mbarriers, as above, no
//     raw stage: it reads global memory): per streamed tile, the chunks of
//     S (resident rows A and the tile's rows B, both K-major, the A chunk
//     written again every tile), the chunks of dP (backward), then the
//     group images (dk/dv: dO^T with the tile's lse log2 e and delta, then
//     Q^T).  Each producer thread loads all of an item's 16-byte chunks (or
//     elements, for a transposed image) before it writes any: one round
//     trip to memory an item.
//   * Plans (wide::Plan, one a type and pass, whatever D; the stage the
//     larger of a chunk item and a group item): float32 forward and dq
//     64-row tiles, three stages of 64 KB (196784 bytes); dk/dv 32-row
//     tiles (its two accumulators of the group's columns take 128
//     registers), four of 48.25 KB (197824); bf16 64-row tiles, four stages
//     of 32 KB (131264; dk/dv 133312).  One block an SM (up to 255
//     registers a thread, no setmaxnreg).  The backward at 256, 384 and
//     512 runs on its own pairs below instead (bf16 on TMA, float32 with
//     the resident rows), as the forward does; these serve every width
//     above 512.
//
// The float32 forward at D = 256, 384 and 512 (flash_fwd_wq_kernel<GW>;
// namespace wq) replaces the column-group forward there, whose producer
// bounded it: at (8, 9216, 256), with groups of 256 columns, it took 23.5
// ms, and 8.8 with its producer's items cut out (tools/flash_fwd_compare.py
// on an H100, its mbarrier waits bounded); that producer split and wrote
// Q's chunk images again for every key tile and group, half of all it
// wrote.
//   * Q stays resident as raw rows: the consumer warpgroup loads its 64
//     rows once (row stride D + 4 floats, so a warp's loads hit 32 banks)
//     and S = Q K^T takes Q as the register A operand, each thread loading
//     its fragments of a k16 step from the rows and splitting them into
//     TF32 halves while the step before runs (two sets of registers, the
//     older freed by the wait on its products).  TF32 wgmma reads a shared
//     operand K-major only and needs both halves, so K's chunks and V's
//     columns still pass through the producer's threads as images.
//   * A block owns GW output columns, 256 where they divide D (the whole
//     head at 256; the recompute 1.5x at 512, where groups of 128 took
//     2.5x), else 128 (384), over 32-key tiles (the accumulator takes 128
//     registers a thread); its items are 16 KB each, a chunk of 64 columns
//     of K or a sub-group of 64 columns of V transposed, in six stages; the
//     products with P run a sub-group at a time into one partial.  The
//     producer keeps the next item's loads in flight while it writes the
//     current one (produce_ahead), each item released as soon as written.
//   * On an H100 (tools/flash_fwd_compare.py, mbarrier waits bounded) at
//     (8, 9216, 256): 15.8 ms against the column-group forward's 22.4 and
//     SDPA's 17.7 (bound 4.22); at (4, 9216, 512) 23.5 against 37.1 and
//     17.0.  The producer still bounds it: with its items cut out it takes
//     12.2 and 20.0; its loads two or three items ahead, 16.0 and 16.4.
//   * Not taken: K's and V's halves written once to global memory and
//     bulk-copied (twice the bytes through L2 that the producer's loads
//     move now, every group and tile); two consumer warpgroups (a block of
//     three warpgroups caps a thread at 168 registers, under the
//     accumulator and its partials).  Above 512 Q's rows no longer fit
//     beside the stages, and the column-group forward stays.
//
// The bf16 forward at D = 256, 384 and 512 (flash_fwd_tma_kernel<D, bf16>;
// namespace tma) replaces the column-group forward there.  What held that
// one back (6.86 ms at (8, 9216, 256) against SDPA's 1.10 on an H100): every
// group recomputed S over the head, Q's chunk images were written again
// every key tile, the producer's threads read global memory one round trip
// an item and wrote every image, V's transposed image included, and one
// consumer warpgroup a block.
//   * A block is 128 query rows, two consumer warpgroups of 64, and owns
//     GW output columns: the whole head at 256 (the output accumulator is
//     128 float32 registers a thread), groups of 256 at 512 (1.5x the
//     least products), of 128 at 384 (2x).  Eight warps and no producer
//     warpgroup: a ninth warp would cap a thread at 168 registers (two
//     warps a register file at most), and the copies take no thread's
//     time.
//   * Q's 128 rows are loaded once, by TMA tensor copies
//     (cp.async.bulk.tensor on a 3-D map (column, row, head), so rows past
//     N arrive as zeros), as D / 64 slabs of 128 rows x 128 bytes in the
//     128-byte swizzle; each key tile's K (D / 64 slabs) and V's group
//     (GW / 64 slabs) stream through a ring of NS stages by the same
//     copies, a stage's full barrier armed with its bytes (expect-tx).
//     Thread 0 issues Q and the first NS tiles; a stage is refilled with
//     the tile NS on by the warpgroup that releases it second (a release
//     count a stage), so neither warpgroup waits for the other.
//   * No thread writes an operand image: S = Q K^T reads both operands
//     K-major from the swizzled slabs (a k16 step is the next 32 bytes of
//     a row, sbo 1024), P V reads V MN-major through the descriptor's
//     transpose bit (lbo the slab stride KT x 128, sbo 1024), P in
//     registers as in the narrow forward.  64 keys a tile where two stages
//     fit beside Q (256: 197672 bytes; 384: 230440), else 32 (512: 230440).
//   * Above 512 a resident Q of 128 rows no longer fits beside two stages,
//     and the column-group forward stays.  P is rounded to bf16 relative to
//     the running max as before; every group the same m, l and lse (group
//     0 writes lse); every output element one owner; bitwise repeats.
//   * On an H100 (tools/flash_fwd_compare.py, mbarrier waits bounded) at
//     (8, 9216, 256): 1.29-1.33 ms against the column-group forward's 6.8
//     and SDPA's 1.12-1.26 (bound 0.70); at (4, 9216, 512) 2.86-2.95
//     against 12.5 and SDPA's 6.4.  Without S = Q K^T it takes 0.92-0.98,
//     without P V 1.15-1.26: S's products of 64 keys (m64n64k16, 16 of them
//     a tile at 256) cost more than P V's four m64n256k16, and each
//     warpgroup runs S, the softmax and P V one after another.
//
// The bf16 backward at D = 256, 384 and 512 (flash_bwd_dq_tma_kernel<D,
// bf16>, flash_bwd_dkv_tma_kernel<D, bf16>; namespace tmab) replaces the
// column-group pair there, on the TMA forward's pattern.  What held that
// pair back (26.0 ms at (8, 9216, 256) against SDPA's backward 5.35 on an
// H100): every 128-column group recomputed S and dP over the head (1.57x
// the least products at 256, 2.71x at 512), its producer read global
// memory an item at a time and wrote every operand image (the resident
// rows' chunks again every tile, the transposed groups), and a block was
// one consumer warpgroup of 64 rows.
//   * Block: two consumer warpgroups and no producer (a ninth warp would cap
//     a thread at 168 registers; the copies take no thread's time).  At 256
//     each warpgroup owns 64 rows of the block's 128 and the whole head (the
//     output accumulator, 128 float32 registers a thread); at 384 and 512
//     both resident operands' 128 rows no longer fit beside two stages, so
//     a block is 64 rows and its two warpgroups own two groups of them, of
//     192 (384) or 256 (512) columns, sharing the resident rows and the
//     stream.  A thread may keep 255 registers (at 256: dq 242, dk/dv 201;
//     none spills).
//   * Resident (loaded once by TMA tensor copies, 3-D maps (column, row,
//     head), D / 64 slabs in the 128-byte swizzle): dq's Q and dO, dk/dv's
//     K and V (the dV blocks K alone).  Streamed through NS stages by the
//     same copies, a stage's full barrier armed with its whole box (rows
//     past N arrive as zeros and count): dq's key tiles of K and V, dk/dv's
//     query tiles of Q and dO.  No thread writes an operand image.
//   * Products: S = Q K^T and dP = dO V^T (dk/dv: S^T = K Q^T, dP^T = V
//     dO^T) read both operands K-major from the slabs (a k16 step is the
//     next 32 bytes of a row, sbo 1024); the products over the streamed
//     rows, dQ_g += dS K_g, dV_g += P^T dO_g, dK_g += dS^T Q_g, take P or
//     dS rounded to bf16 as register A in the accumulator's layout and read
//     the stage's group slabs MN-major through the descriptor's transpose
//     bit (lbo the slab stride ST x 128, sbo 1024), as the TMA forward
//     reads V.  S and dP go in two commit groups: P's exponentials run
//     between the two waits, while dP's products do; a tile's product into
//     the output is left running while the next tile's S and dP are issued
//     (AHEAD).  Only wgmma writes an accumulator while a product is in
//     flight (a tile's first step has scale-d 0, P has registers of its
//     own), and dk/dv runs one loop for each output: a register of S or dP
//     zeroed or overwritten there, or the dV path's values laid over dP^T's
//     accumulator in one loop with a branch, made ptxas serialise every
//     wgmma (C7515: 8.6-9.6 ms against 6.4 at (8, 9216, 256)).
//   * dk/dv split by output: each (key block, groups) has a dV block, which
//     computes S^T and dV_g += P^T dO_g, and a dK block, which computes S^T,
//     dP^T and dK_g += dS^T Q_g, so no block holds two output accumulators.
//     With g groups the pair does (5 g + 3) / 7 of the least products: 1.14x
//     at 256 (the column-group pair 1.57x), 1.86x at 384 and 512 (2.14x,
//     2.71x; groups of 128 at 384 would make it 2.57x).  Every output
//     element has one owner: no atomics, bitwise repeats.
//   * Ragged edges: TMA's zeros mask nothing (a zero key gives S = 0 and P
//     = 2^-lse), so dq sets S to -inf for keys past N by index, and dk/dv
//     reads lse as +inf (P^T = 0) and delta as 0 for queries past N,
//     loading a tile's lse log2 e and delta with its own threads (a 2-D map
//     needs 16-byte row strides, and N = 301 has none), before it waits on
//     the stage so the loads run under the wait.
//   * The release handoff: a warpgroup's wgmma wait covers its own warp's
//     share only, so its four warps join on a named barrier (bar.sync 1 +
//     wg, 128) before its first thread counts the release; the second
//     release refills the stage with the tile NS on, by TMA.
//   * Plans (tmab::Plan, one for both passes): 256: 128 rows a block, 32
//     rows a tile, 3 stages (230456 bytes); 384: 64 rows, 32, 2 (197672);
//     512: 64 rows, 16, 3 (230456).  Above 512 the column-group pair stays.
//   * On an H100 (tools/flash_fwd_compare.py --backward --wide-only, waits
//     bounded) at (8, 9216, 256): 6.36 ms (dq 2.32, dk/dv 4.03) against the
//     column-group pair's 25.6 and SDPA's backward 5.13 (bound 2.46); at
//     (4, 9216, 512) 18.1 against 52.4 and SDPA's 31.4.  Without the
//     products into the outputs it takes 2.45-2.51, without S 4.60: the
//     products over the streamed rows, each a k16 step or two of
//     m64n256k16 on a 32-row tile, and the shared-memory reads of S's and
//     dP's operands (a 64-row A operand read again for every 32 keys) hold
//     it back.  Tiles of 64 rows would halve those reads, but beside 128
//     resident rows at 256 they leave one stage.
//
// The float32 backward at D = 256, 384 and 512 (flash_bwd_dq_wq_kernel<D>,
// flash_bwd_dkv_wq_kernel<D>; namespace wqb) replaces the column-group pair
// there.  What held that pair back (96.1 ms at (8, 9216, 256) against SDPA's
// backward 35.3 on an H100): every 128-column group recomputed S and dP
// over the head (1.57x the least products at 256, 2.71x at 512); its
// producer wrote the resident rows' chunks again every tile, half of what
// dq's wrote, and loaded each item whole before writing any; dk/dv held two
// accumulators (32-row tiles, groups of 128); one consumer warpgroup ran S,
// dP and the products into the output one after another.
//   * Block: 64 rows (query rows in dq, keys in dk/dv) and GW output
//     columns (the whole head at 256, groups of 256 at 512, of 192 at 384,
//     as the bf16 pair), the streamed axis in 32-row tiles, three
//     warpgroups: S's, the output's and a producer (setmaxnreg from 168 to
//     136, 240 and 128 registers a thread).  dk/dv is split by output as the
//     bf16 pair: a dV block (S^T, P^T, dV_g) and a dK block (S^T, P^T,
//     dP^T, dS^T, dK_g) a (key block, group), one accumulator each; the pair
//     does (5 g + 3) / 7 of the least products, 8/7 at 256, 13/7 at 384 and
//     512.
//   * The S warpgroup loads the first operand's 64 rows once, raw, at a
//     stride of D + 4 floats (dq's Q; dk/dv's K) and computes S = Q K^T (S^T
//     = K Q^T) with them as register A, as the float32 forward (a k16
//     step's fragments loaded and split while the step before runs), then
//     P = 2^(S scale log2 e - lse log2 e), which it hands to the output
//     warpgroup through two slots of 8 KB (thread i of either warpgroup
//     holds the same places of its accumulator; full and empty mbarriers).
//     It writes the chunks of K (Q) it reads itself, into two stages of
//     its own, its loads a chunk ahead: it does half the output warpgroup's
//     products and has the time, and a ring fed by the producer made it
//     wait for the output's items (the producer writes in one order).
//   * The output warpgroup holds the second operand (dq's dO, the dK
//     block's V) as raw rows where both fit (256: 133 KB of the block's
//     shared memory); at 384 and 512 it takes it as raw items, 64 rows x
//     64 columns that the producer copies by cp.async (no register holds
//     them; column c of row r at r 64 + (c ^ 4 (r % 8)), so a warp's A loads
//     hit 32 banks).  It computes dP = dO V^T (dP^T = V dO^T), then, P
//     taken, dS = P (dP - delta) and dQ_g += dS K_g (dK_g += dS^T Q_g; the
//     dV block dV_g += P^T dO_g), dS or P split as register A, the group's
//     rows transposed in sub-groups of 64 columns as B.
//   * Items (16 KB: 32 rows x 64 columns in both TF32 halves, K-major for a
//     product over the head, transposed in register A's key order for a
//     product into the output; or a raw item): the producer writes the
//     output warpgroup's in its order, a tile's chunks of dP, then its GW /
//     64 sub-groups, into the stages after the S warpgroup's two, one
//     item's loads in flight while it writes the one before, each released
//     as soon as written (a raw item once its copies land,
//     cp.async.mbarrier.arrive).  A 32-row tile: dq 12 items at 256 (384
//     KB of images per 64 keys, against the column-group dq's 1152), 21 at
//     384, 28 at 512 (8 of them raw); the dV block 8, 9 and 12.
//   * Plans (wqb::Plan, one for both passes; rows a block, consumer
//     warpgroups, tile, item stages, bytes): 256: 64, 2, 32, 5, 231664
//     (both resident operands, 133120 bytes); 384: 64, 2, 32, 7, 230672;
//     512: 64, 2, 32, 5, 230640 (P's slots 16 KB each time).  Every output
//     element has one owner: no atomics, bitwise repeats.  The numerics are
//     the float32 kernels': 3xTF32, S and dP with a zeroed partial a k16
//     step, the products into the output one a tile and sub-group, carried
//     by float32 adds; keys past N get S = -inf by index in dq, queries past
//     N lse +inf and delta 0 in dk/dv.
//   * Tried (tools/flash_fwd_compare.py --backward --wide-only on an H100;
//     at (8, 9216, 256) / (4, 9216, 512) ms, and the pair's device time at
//     (8, 144, 512)): one consumer warpgroup for everything beside a
//     producer, 61.3 / 137.7 / 0.2285; its first build, whose k16 steps ran
//     from one chunk into the next without a wait, made ptxas serialise
//     every wgmma (C7514: 87.4 / 150.8 / 0.261) and, unrolled, spilled;
//     the S and output warpgroups fed by one producer, 54.2 / 136.3 /
//     0.232; by two producers on half of every item, 54.2; by a producer
//     each, 51.4 / 118.9 / 0.1995; the S warpgroup writing its own chunks
//     with the producer two items ahead, 47.8 / 108.8 / 0.176 (one ahead,
//     kept: 45.2 / 94.4 / 0.163).  Two consumer warpgroups need a ring
//     each: an mbarrier's parity tells only its last two phases apart, and
//     the S warpgroup runs a tile ahead.
//   * On an H100 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 10,
//     medians of 7): at (8, 9216, 256) 47.1 ms (dq 16.9, dk/dv 30.1)
//     against the column-group pair's 96.1, SDPA's backward 35.3 and the
//     plain backward 47.7 (bound 14.8); at (4, 9216, 512) 96.0 against
//     SDPA's 32.6 and the plain 42.7; at (8, 144, 512) 0.167 ms of device
//     time a call against 0.184.  In one tools/flash_fwd_compare.py call
//     (waits bounded: 48.9 / 108.7 / 0.179): with no item written 36.7 /
//     72.6 / 0.134, so the items hold it back first; without the products
//     into the outputs 42.7 / 101.0 / 0.159; the output's sub-group
//     products two in flight (OUT_AHEAD) 48.6 / 109.2 / 0.181, left off;
//     the producer two items ahead 52.3 / 117.6 / 0.188; the S
//     warpgroup's next tile held until the output warpgroup has taken P,
//     49.0 / 108.3 / 0.182 (another call); at 384 and 512
//     the second operand's A fragments loaded from global memory each k16
//     step (A_GLOBAL, no raw items) 114.1 / 0.193, so the raw items stay.
//   * Not taken: the B operands' TF32 halves split once into global scratch
//     and streamed by TMA (14 scratch tensors, and twice the bytes through
//     L2 on every tile and group, as the float32 forward's note weighs it).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace hopper;    // mbarriers, bulk copies, wgmma fences, b_desc
using namespace tf32mma;   // the TF32 split, allow_smem

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int ALIGN = 128;
constexpr int SMEM_LIMIT = 232448;   // what a block may take
constexpr int MAX_NR = 4;            // raw stages, at most
// setmaxnreg with three warpgroups: a thread starts at 65536 / 384 = 168
// registers; the producer gives 112 of them to each consumer thread
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

template <typename T> __device__ __forceinline__ void store2(T* dst, float x, float y);
template <> __device__ __forceinline__ void store2<float>(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* dst, float x,
                                                                 float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// wgmma products, m64nNk8 (TF32) and m64nNk16 (bf16), float32 accumulators
// d (d[4j + e]: row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 of warp w
// of the warpgroup; g = lane / 4, t = lane % 4) + (scale_d ? d : 0).
// mma_ss: A and B K-major in shared memory (descriptors, b_desc); mma_rs: A
// in registers (TF32: rows g, g + 8, columns t, t + 4; bf16: rows g, g + 8,
// column pairs 2t, 2t + 8, the smaller column in the low half), B K-major
// in shared memory.
// ---------------------------------------------------------------------------
namespace tc {

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

template <>
__device__ __forceinline__ void mma_ss<16, __nv_bfloat16>(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_ss<32, __nv_bfloat16>(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Byte offset of 16-byte chunk ck (along K) of row r (along M or N) in the
// image of an operand of R rows: the no-swizzle K-major core matrices that
// b_desc reads, one k-step (two chunks: k8 of TF32, k16 of bf16) a block of
// R x 32 bytes a half, the small half after the big one.  (Mirrored by
// ops/flash_attention.py::image_offset.)
template <int R, int HALVES>
__device__ __forceinline__ int img_off(int r, int ck) {
  return (ck >> 1) * (R * 32 * HALVES) + (r >> 3) * 256 + (ck & 1) * 128 + (r & 7) * 16;
}

// a chunk of a row into an image of R rows: float32 split into TF32
// halves, bf16 as it is
template <int R, typename T>
__device__ __forceinline__ void put16(unsigned char* img, int r, int ck, uint4 x) {
  const int o = img_off<R, sizeof(T) == 4 ? 2 : 1>(r, ck);
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

// 2^x on the special-function unit (flushes results below 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int R>
__device__ __forceinline__ void carry(float (&acc)[R], float (&part)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    fence_reg(part[i]);
    acc[i] += part[i];
  }
}

// Rows row0 .. row0 + valid - 1 of a row-major (., D) matrix (contiguous:
// a raw stage, or global memory) into a ring's stage by one thread: one 1-D
// bulk copy completing on bar, which the caller armed for the stage.
template <int D, typename T>
__device__ __forceinline__ void bulk_rows(uint32_t dst, uint32_t bar, const T* src, int row0,
                                          int valid) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src + (size_t)row0 * D), "r"((uint32_t)(valid * D * (int)sizeof(T))),
      "r"(bar)
      : "memory");
}
// arm bar for the bytes of two tiles of valid rows each
template <int D, typename T>
__device__ __forceinline__ void expect_rows(uint32_t bar, int valid) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"((uint32_t)(2 * valid * D * (int)sizeof(T)))
               : "memory");
}

// The producer's image of R rows of a (., D) matrix as they are, K-major
// along D (the B operand of a product over D: the forward's K; the
// backward's K, V, Q, dO), from the rows at src (a raw stage or global
// memory; generic loads) by the producer's 128 threads (ptid); rows from
// valid on are zeros.  float32 split into its TF32 halves.  Each thread
// loads up to four 16-byte chunks before it writes any; a phase of eight
// lanes reads and writes eight distinct 16-byte bank groups (the chunks
// run diagonally: eight consecutive rows, eight chunk columns).
template <int R, int D, typename T>
__device__ __forceinline__ void kmajor_image(const unsigned char* src, unsigned char* img,
                                             int valid, int ptid) {
  constexpr int CPR = D * (int)sizeof(T) / 16;   // chunks a row
  constexpr int KU = R * CPR / 128;              // chunks a thread
  constexpr int B = KU < 4 ? KU : 4;
  static_assert(KU >= 1 && KU % B == 0 && (R * CPR) % 128 == 0, "whole batches a thread");
#pragma unroll 1
  for (int j0 = 0; j0 < KU; j0 += B) {
    uint4 x[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int u = ptid + 128 * (j0 + j), r = u % R, ck = (u / R + r) % CPR;
      x[j] = r < valid ? *reinterpret_cast<const uint4*>(src + (r * CPR + ck) * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const int u = ptid + 128 * (j0 + j), r = u % R, ck = (u / R + r) % CPR;
      put16<R, T>(img, r, ck, x[j]);
    }
  }
}

// The producer's image of R rows of a (., D) matrix transposed: D rows, K
// along the R rows (the B operand of a product over those rows with a
// register A operand: the forward's V; the backward's K^T, Q^T, dO^T; ld
// elements from one source row to the next: D, or the head's width where
// the image is one column group of a wider head; MAXB chunks a thread
// loaded before any is written).  float32: each element split into its
// TF32 halves, and the rows within
// each k8 step taken in the order of the register fragment that the
// accumulator gives (index t is row 2t, index t + 4 row 2t + 1): chunk
// (d, ck) holds rows 8 (ck / 2) + ck % 2 + 2e, e < 4.  bf16: chunk (d, ck)
// holds rows 8 ck .. 8 ck + 7 (the fragment takes them in order).  A phase
// of eight lanes reads eight consecutive columns and writes one chunk
// column each.
template <int R, int D, typename T, int MAXB = 4>
__device__ __forceinline__ void transposed_image(const unsigned char* src, unsigned char* img,
                                                 int valid, int ptid, int ld = D) {
  if constexpr (sizeof(T) == 4) {
    const float* rv = reinterpret_cast<const float*>(src);
    constexpr int VU = D * (R / 4) / 128;   // chunks a thread
    constexpr int B = VU < MAXB ? VU : MAXB;
    static_assert(VU >= 1 && VU % B == 0 && (D * (R / 4)) % 128 == 0, "whole batches a thread");
#pragma unroll 1
    for (int j0 = 0; j0 < VU; j0 += B) {
      float x[B][4];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int u = ptid + 128 * (j0 + j), d = u % D, ck = u / D;
        const int row0 = 8 * (ck >> 1) + (ck & 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 2 * e;
          x[j][e] = row < valid ? rv[row * ld + d] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
        const int u = ptid + 128 * (j0 + j), d = u % D, ck = u / D;
        uint32_t b[4], sm[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split<false>(x[j][e], b[e], sm[e]);
        const int o = img_off<D, 2>(d, ck);
        *reinterpret_cast<uint4*>(img + o) = make_uint4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint4*>(img + o + D * 32) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
      }
    }
  } else {
    // columns 2 dp, 2 dp + 1 of rows 8 ck .. 8 ck + 7: eight 32-bit words,
    // their low halves one chunk and their high halves the next
    const uint32_t* rv = reinterpret_cast<const uint32_t*>(src);
    constexpr int VU = (D / 2) * (R / 8) / 128;
    static_assert(VU >= 1 && ((D / 2) * (R / 8)) % 128 == 0, "whole chunks a thread");
#pragma unroll
    for (int j = 0; j < VU; ++j) {
      const int u = ptid + 128 * j, dp = u % (D / 2), ck = u / (D / 2);
      uint32_t w[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int row = 8 * ck + e;
        w[e] = row < valid ? rv[row * (ld / 2) + dp] : 0u;
      }
      *reinterpret_cast<uint4*>(img + img_off<D, 1>(2 * dp, ck)) =
          make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                     __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
      *reinterpret_cast<uint4*>(img + img_off<D, 1>(2 * dp + 1, ck)) =
          make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                     __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
    }
  }
}

// One consumer warpgroup's 64 rows (image rows 64 wg ..) of a resident A
// operand of R rows (the forward's Q; the backward's Q, dO or K, V), read
// straight from global memory rows row0 .. (zeros past n).
template <int R, int D, typename T>
__device__ __forceinline__ void a_image(unsigned char* img, const T* src, int row0, int n,
                                        int wg, int ctid) {
  constexpr int CPR = D * (int)sizeof(T) / 16;
#pragma unroll 2
  for (int u = ctid; u < 64 * CPR; u += 128) {
    const int r = u % 64, ck = (u / 64 + r) % CPR;
    const int row = 64 * wg + r;
    const uint4 x = row0 + row < n
                        ? __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * D) + ck)
                        : make_uint4(0u, 0u, 0u, 0u);
    put16<R, T>(img, row, ck, x);
  }
}

// s = a warpgroup's 64 rows of an A image of AR rows (at a, its first row
// group) times the N rows of a B image (at b), transposed, over D
// (accumulator layout: s[4j + e] is row 16 w + g + 8 (e / 2), column 8 j +
// 2 t + e % 2); with ACC, s += the same (the wide kernels' chunks of a
// product over a head wider than 128).  float32: three TF32 products a k8
// step into a zeroed partial a k16 step (two partials taking turns, one
// carried while the next runs); bf16: one k16 product a step into s.
template <int N, int AR, int D, typename T, bool ACC = false>
__device__ __forceinline__ void ss_product(float (&s)[N / 2], uint32_t a, uint32_t b) {
  if constexpr (!ACC) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  }
  if constexpr (sizeof(T) == 4) {
    constexpr int AB = AR * 32 * 2, BB = N * 32 * 2;   // bytes of a k8 step's images
    // zeroed, though the first product of each ignores them: with undefined
    // inputs to its asm the compiler may fold two such products into one
    // (dk/dv's S^T and dP^T became one, and its results were wrong)
    float part[2][N / 2] = {};
#pragma unroll
    for (int c2 = 0; c2 < D / 16; ++c2) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) fence_reg(part[c2 & 1][i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t ak = a + (2 * c2 + kk) * AB, bk = b + (2 * c2 + kk) * BB;
        mma_ss<N, float>(part[c2 & 1], b_desc(ak + AR * 32), b_desc(bk), kk);
        mma_ss<N, float>(part[c2 & 1], b_desc(ak), b_desc(bk + N * 32), 1);
        mma_ss<N, float>(part[c2 & 1], b_desc(ak), b_desc(bk), 1);
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
    for (int i = 0; i < N / 2; ++i) fence_reg(s[i]);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      mma_ss<N, __nv_bfloat16>(s, b_desc(a + c * AR * 32), b_desc(b + c * N * 32), ACC || c > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(s[i]);
  }
}

// The register A operand of a product over ST columns of an accumulator x
// (64 rows of a warpgroup): float32, its TF32 halves, column 2t of a k8
// step as index t and 2t + 1 as t + 4 (the transposed images hold their
// rows in that order); bf16, rounded to bf16 (to nearest even) and packed
// in place.
template <int ST>
__device__ __forceinline__ void tf32_frags(const float (&x)[ST / 2], uint32_t (&big)[ST / 8][4],
                                           uint32_t (&sm)[ST / 8][4]) {
#pragma unroll
  for (int c = 0; c < ST / 8; ++c) {
    split<false>(x[4 * c], big[c][0], sm[c][0]);       // (g, column 2t)
    split<false>(x[4 * c + 2], big[c][1], sm[c][1]);   // (g + 8, column 2t)
    split<false>(x[4 * c + 1], big[c][2], sm[c][2]);   // (g, column 2t + 1)
    split<false>(x[4 * c + 3], big[c][3], sm[c][3]);   // (g + 8, column 2t + 1)
  }
}
template <int ST>
__device__ __forceinline__ void bf16_frags(const float (&x)[ST / 2], uint32_t (&a)[ST / 16][4]) {
#pragma unroll
  for (int c = 0; c < ST / 16; ++c) {
    a[c][0] = pack_bf16(x[8 * c], x[8 * c + 1]);       // (g, columns 2t, 2t + 1)
    a[c][1] = pack_bf16(x[8 * c + 2], x[8 * c + 3]);   // (g + 8, the same)
    a[c][2] = pack_bf16(x[8 * c + 4], x[8 * c + 5]);   // (g, columns 2t + 8, 2t + 9)
    a[c][3] = pack_bf16(x[8 * c + 6], x[8 * c + 7]);   // (g + 8, the same)
  }
}
template <int ST>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[ST][4]) {
#pragma unroll
  for (int c = 0; c < ST; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_u32(a[c][e]);
}

// d (N columns) += the register A operand (ST columns) times N rows of a
// transposed image of BR rows at b (its k-step blocks BR x 32 bytes a
// half), issued only (the caller fences, commits and waits): float32, three
// TF32 products a k8 step; bf16, one k16 product a step.  The first step
// scales d by first (0: d starts from zero).
template <int N, int ST, int BR>
__device__ __forceinline__ void rs_tf32(float (&d)[N / 2], const uint32_t (&big)[ST / 8][4],
                                        const uint32_t (&sm)[ST / 8][4], uint32_t b, int first) {
#pragma unroll
  for (int c = 0; c < ST / 8; ++c) {
    const uint32_t bk = b + c * BR * 32 * 2;
    mma_rs<N, float>(d, sm[c], b_desc(bk), c > 0 ? 1 : first);
    mma_rs<N, float>(d, big[c], b_desc(bk + BR * 32), 1);
    mma_rs<N, float>(d, big[c], b_desc(bk), 1);
  }
}
template <int N, int ST, int BR>
__device__ __forceinline__ void rs_bf16(float (&d)[N / 2], const uint32_t (&a)[ST / 16][4],
                                        uint32_t b, int first) {
#pragma unroll
  for (int c = 0; c < ST / 16; ++c)
    mma_rs<N, __nv_bfloat16>(d, a[c], b_desc(b + c * BR * 32), c > 0 ? 1 : first);
}

// The producer warpgroup (ptid: its thread's rank) of a plan P (ST rows a
// tile of the streamed axis, NR raw and NI image stages, RAW bytes a raw
// tile, STAGE an image stage): for every tile, the rows of its two
// matrices a and b (the forward's and dq's K, V; dk/dv's Q, dO) into a raw
// stage by two bulk copies, issued by thread 0 (NR > 0; else read from
// global memory), then the tile's images into an image stage by all 128
// threads (images(ra, rb, stage, valid, row0)), then the raw stage
// refilled.
template <class P, int D, typename T, class Images>
__device__ __forceinline__ void produce(unsigned char* raw0, uint32_t raw_full,
                                        unsigned char* img0, uint32_t img_full,
                                        uint32_t img_empty, const T* a, const T* b, int n,
                                        int ptid, Images images) {
  constexpr int ST = P::ST, NR = P::NR, NI = P::NI;
  const int tiles = (n + ST - 1) / ST;
  auto fill = [&](int u, uint32_t stage, uint32_t bar) {
    const int valid = min(ST, n - u * ST);
    expect_rows<D, T>(bar, valid);
    bulk_rows<D, T>(stage, bar, a, u * ST, valid);
    bulk_rows<D, T>(stage + (uint32_t)P::RAW, bar, b, u * ST, valid);
  };
  if constexpr (NR > 0) {
    if (ptid == 0)
      for (int u = 0; u < NR && u < tiles; ++u)
        fill(u, smem_addr(raw0 + u * 2 * P::RAW), raw_full + 8 * u);
  }
  for (int it = 0; it < tiles; ++it) {
    const int si = it % NI, row0 = it * ST;
    const unsigned char *ra, *rb;
    if constexpr (NR > 0) {
      ra = raw0 + (it % NR) * 2 * P::RAW;
      rb = ra + P::RAW;
      mbar_wait(raw_full + 8 * (it % NR), (it / NR) & 1);
    } else {
      ra = reinterpret_cast<const unsigned char*>(a + (size_t)row0 * D);
      rb = reinterpret_cast<const unsigned char*>(b + (size_t)row0 * D);
    }
    if (it >= NI) mbar_wait(img_empty + 8 * si, ((it / NI) + 1) & 1);
    images(ra, rb, img0 + si * P::STAGE, min(ST, n - row0), row0);
    fence_async();
    mbar_arrive(img_full + 8 * si);
    if constexpr (NR > 0) {
      if (it + NR < tiles) {   // every producer thread is done with the raw stage: refill it
        wg_sync(1);
        if (ptid == 0) {
          fence_async();
          fill(it + NR, smem_addr(ra), raw_full + 8 * (it % NR));
        }
      }
    }
  }
}

// a plan's barriers, after its raw stages: raw_full[NR] (the bulk copies),
// img_full[NI] (the producer's 128 threads), img_empty[NI] (the C
// consumer warpgroups' warps)
template <class P>
__device__ __forceinline__ void init_barriers(uint32_t raw_full) {
  const uint32_t img_full = raw_full + 8 * P::NR, img_empty = img_full + 8 * P::NI;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::NR; ++s) mbar_init(raw_full + 8 * s, 1);
    for (int s = 0; s < P::NI; ++s) {
      mbar_init(img_full + 8 * s, 128);
      mbar_init(img_empty + 8 * s, 4 * P::C);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// forward: out = softmax(q k^T * scale) v, lse = logsumexp of each row, on
// wgmma (the plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace fwd {

using namespace tc;

constexpr int CONSUMERS = 2;                      // consumer warpgroups, 64 query rows each
constexpr int ROWS = 64 * CONSUMERS;              // query rows a block
constexpr int THREADS = 128 * (CONSUMERS + 1);    // and the producer warpgroup

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
  static constexpr int C = CONSUMERS, ST = KT, STAGE = 2 * KV_IMG;   // as tc::produce takes them
  static_assert(NR >= 1 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
  static_assert(D % 16 == 0 && KT % 16 == 0 && (KT * CPR) % 128 == 0, "whole chunks a thread");
};

// The producer warpgroup's images of one key tile from its raw rows (ptid:
// the thread's rank among the 128; rows from valid on are zeros): K as the
// B operand of S = Q K^T (KT rows, K along D), V transposed as the B
// operand of P V (D rows, K along the keys, in P's fragment order).
template <int D, typename T>
__device__ __forceinline__ void build_images(const unsigned char* rk, const unsigned char* rv,
                                             unsigned char* stage, int valid, int ptid) {
  using P = Plan<D, T>;
  kmajor_image<P::KT, D, T>(rk, stage, valid, ptid);
  transposed_image<P::KT, D, T>(rv, stage + P::KV_IMG, valid, ptid);
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
    uint32_t pb[KT / 8][4], ps[KT / 8][4];
    tf32_frags<KT>(s, pb, ps);
    wgmma_fence();
    rs_tf32<D, KT, D>(pv, pb, ps, vb, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(pb);   // P's registers stay untouched until the products end
    fence_frags(ps);
  } else {
    uint32_t pa[KT / 16][4];
    bf16_frags<KT>(s, pa);
    wgmma_fence();
    rs_bf16<D, KT, D>(pv, pa, vb, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(pa);
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) fence_reg(pv[i]);
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

  init_barriers<P>(raw_full);

  if (wg == CONSUMERS) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = tid - 128 * CONSUMERS;
    produce<P, D, T>(raw0, raw_full, img0, img_full, img_empty, k + base, v + base, n, ptid,
                     [&](const unsigned char* rk, const unsigned char* rv, unsigned char* stage,
                         int valid, int) { build_images<D, T>(rk, rv, stage, valid, ptid); });
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  a_image<ROWS, D, T>(qimg, q + base, q0, n, wg, ctid);
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
    float s[KT / 2], alpha[2], pv[D / 2] = {};   // pv zeroed: as ss_product's partials
    ss_product<KT, ROWS, D, T>(s, qa, smem_addr(stage(it)));
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
// backward: the two passes on wgmma (the plans and the roles: the note at
// the top)
// ---------------------------------------------------------------------------
namespace bwd {

using namespace tc;

// The plan of one instantiation of a pass (DKV: dk/dv, else dq): C consumer
// warpgroups of 64 rows (query rows in dq, keys in dk/dv), ST rows of the
// streamed axis a tile (keys in dq, queries in dk/dv), NI image stages, NR
// raw stages (as many as fit, up to MAX_NR; 0: the producer reads the rows
// from global memory).  Resident: the two A images (Q, dO; K, V).  A stage:
// the streamed images (dq: K, V, K^T; dk/dv: Q, dO, Q^T, dO^T) and for
// dk/dv the tile's lse log2 e and delta.  Mirrored by
// ops/flash_attention.py::backward_plan.
template <int D, typename T, bool DKV>
struct Plan {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int HALVES = F32 ? 2 : 1;
  static constexpr int C = F32 ? 1 : 2;
  static constexpr int ST = F32 ? 2048 / D : (DKV && D == 128 ? 32 : 64);
  static constexpr int NI = F32 && D == 128 && DKV ? 1 : 2;
  static constexpr int ROWS = 64 * C;
  static constexpr int THREADS = 128 * (C + 1);
  static constexpr int RES_IMG = ROWS * D * (int)sizeof(T) * HALVES;   // one resident image
  static constexpr int ST_IMG = ST * D * (int)sizeof(T) * HALVES;      // one streamed image
  static constexpr int VEC = DKV ? 2 * ST * 4 : 0;                      // lse log2 e, delta
  static constexpr int STAGE = (DKV ? 4 : 3) * ST_IMG + VEC;
  static constexpr int RAW = ST * D * (int)sizeof(T);                   // one raw tile
  static constexpr int FIXED = ALIGN + 2 * RES_IMG + NI * STAGE + 8 * (MAX_NR + 2 * NI);
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (2 * RAW);
  static constexpr int NR = FIT < MAX_NR ? FIT : MAX_NR;
  static constexpr int SMEM = FIXED + NR * 2 * RAW;
  static_assert(NR >= 0 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
  static_assert(ST % 16 == 0 && D % 16 == 0, "whole k16 steps");
};

// dq's images of a key tile: K and V as they are, K transposed
template <class P, int D, typename T>
__device__ __forceinline__ void dq_images(const unsigned char* rk, const unsigned char* rv,
                                          unsigned char* stage, int valid, int ptid) {
  kmajor_image<P::ST, D, T>(rk, stage, valid, ptid);
  kmajor_image<P::ST, D, T>(rv, stage + P::ST_IMG, valid, ptid);
  transposed_image<P::ST, D, T>(rk, stage + 2 * P::ST_IMG, valid, ptid);
}

// dk/dv's images of a query tile: Q and dO as they are, Q and dO
// transposed
template <class P, int D, typename T>
__device__ __forceinline__ void dkv_images(const unsigned char* rq, const unsigned char* ro,
                                           unsigned char* stage, int valid, int ptid) {
  kmajor_image<P::ST, D, T>(rq, stage, valid, ptid);
  kmajor_image<P::ST, D, T>(ro, stage + P::ST_IMG, valid, ptid);
  transposed_image<P::ST, D, T>(rq, stage + 2 * P::ST_IMG, valid, ptid);
  transposed_image<P::ST, D, T>(ro, stage + 3 * P::ST_IMG, valid, ptid);
}

// d += the register operand x (64 rows x ST columns, accumulator layout:
// P or dS, or their transposes) times the transposed image at b (D rows,
// ST along K): float32, TF32 halves into a zeroed partial carried by a
// float32 add, 64 output columns at a time; bf16, rounded to bf16, straight
// into d.
template <int D, int ST, typename T>
__device__ __forceinline__ void rs_accumulate(float (&d)[D / 2], const float (&x)[ST / 2],
                                              uint32_t b) {
  if constexpr (sizeof(T) == 4) {
    constexpr int NH = D < 64 ? D : 64;
    uint32_t big[ST / 8][4], sm[ST / 8][4];
    tf32_frags<ST>(x, big, sm);
#pragma unroll
    for (int h = 0; h < D / NH; ++h) {
      float part[NH / 2] = {};   // zeroed: as ss_product's partials
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) fence_reg(part[i]);
      wgmma_fence();
      rs_tf32<NH, ST, D>(part, big, sm, b + h * (NH / 8) * 256, 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NH / 2; ++i) {
        fence_reg(part[i]);
        d[h * (NH / 2) + i] += part[i];
      }
    }
    fence_frags(big);
    fence_frags(sm);
  } else {
    uint32_t a[ST / 16][4];
    bf16_frags<ST>(x, a);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(d[i]);
    wgmma_fence();
    rs_bf16<D, ST, D>(d, a, b, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_frags(a);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(d[i]);
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// backward, pass 1: dQ = scale * sum_j dS_ij K_j, P = exp(S - lse),
// dS = P * (dO V^T - delta).  Block: ROWS query rows of one head;
// warpgroups 0 .. C - 1 consume (64 rows each), warpgroup C produces.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(bwd::Plan<D, T, false>::THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int n, float scale) {
  using namespace bwd;
  using P = Plan<D, T, false>;
  constexpr int ST = P::ST, NR = P::NR, NI = P::NI, C = P::C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qimg = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* oimg = qimg + P::RES_IMG;
  unsigned char* img0 = oimg + P::RES_IMG;      // NI stages: K, V, K^T images
  unsigned char* raw0 = img0 + NI * P::STAGE;   // NR stages: raw K, raw V
  const uint32_t raw_full = smem_addr(raw0 + NR * 2 * P::RAW);
  const uint32_t img_full = raw_full + 8 * NR, img_empty = img_full + 8 * NI;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = blockIdx.x * P::ROWS;
  const size_t base = (size_t)blockIdx.y * n * D, rbase = (size_t)blockIdx.y * n;
  init_barriers<P>(raw_full);

  if (wg == C) {   // the producer
    if constexpr (C > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = tid - 128 * C;
    produce<P, D, T>(raw0, raw_full, img0, img_full, img_empty, k + base, v + base, n, ptid,
                     [&](const unsigned char* rk, const unsigned char* rv, unsigned char* stage,
                         int valid, int) { dq_images<P, D, T>(rk, rv, stage, valid, ptid); });
    return;
  }

  if constexpr (C > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  a_image<P::ROWS, D, T>(qimg, q + base, q0, n, wg, ctid);
  a_image<P::ROWS, D, T>(oimg, dout + base, q0, n, wg, ctid);
  fence_async();
  wg_sync(2 + wg);
  const uint32_t qa = smem_addr(qimg) + wg * 2048, oa = smem_addr(oimg) + wg * 2048;
  const float scale2 = scale * LOG2E;

  // rows 16 warp + g + 8h of the warpgroup's: lse log2 e and delta, and dQ
  // in accumulator layout (acc[4j + 2h + e] is column 8j + 2t + e)
  float lse2[2], dlt[2], acc[D / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * wg + 16 * warp + g + 8 * h;
    lse2[h] = r < n ? lse[rbase + r] * LOG2E : 0.f;
    dlt[h] = r < n ? delta[rbase + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  const int tiles = (n + ST - 1) / ST;
  for (int it = 0; it < tiles; ++it) {
    const int si = it % NI, k0 = it * ST;
    mbar_wait(img_full + 8 * si, (it / NI) & 1);
    const uint32_t stage = smem_addr(img0 + si * P::STAGE);
    float s[ST / 2], dp[ST / 2];
    ss_product<ST, P::ROWS, D, T>(s, qa, stage);                 // S = Q K^T
    ss_product<ST, P::ROWS, D, T>(dp, oa, stage + P::ST_IMG);    // dP = dO V^T
    if (k0 + ST > n) {   // keys past n: P = 0
#pragma unroll
      for (int i = 0; i < ST / 2; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < ST / 2; ++i) {   // dS = P (dP - delta), in dp
      const int h = (i >> 1) & 1;
      dp[i] = ex2(fmaf(s[i], scale2, -lse2[h])) * (dp[i] - dlt[h]);
    }
    rs_accumulate<D, ST, T>(acc, dp, stage + 2 * P::ST_IMG);    // dQ += dS K
    __syncwarp();
    if (lane == 0) mbar_arrive(img_empty + 8 * si);   // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * wg + 16 * warp + g + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(dq + base + (size_t)r * D + 8 * j + 2 * t, acc[4 * j + 2 * h] * scale,
                acc[4 * j + 2 * h + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij Q_i.
// Block: ROWS keys of one head; the products transposed (rows are keys,
// columns queries); warpgroups 0 .. C - 1 consume, warpgroup C produces.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(bwd::Plan<D, T, true>::THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int n, float scale) {
  using namespace bwd;
  using P = Plan<D, T, true>;
  constexpr int ST = P::ST, NR = P::NR, NI = P::NI, C = P::C;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kimg = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~(uintptr_t)(ALIGN - 1));
  unsigned char* vimg = kimg + P::RES_IMG;
  unsigned char* img0 = vimg + P::RES_IMG;      // NI stages: Q, dO, Q^T, dO^T, lse, delta
  unsigned char* raw0 = img0 + NI * P::STAGE;   // NR stages: raw Q, raw dO
  const uint32_t raw_full = smem_addr(raw0 + NR * 2 * P::RAW);
  const uint32_t img_full = raw_full + 8 * NR, img_empty = img_full + 8 * NI;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int k0 = blockIdx.x * P::ROWS;
  const size_t base = (size_t)blockIdx.y * n * D, rbase = (size_t)blockIdx.y * n;
  init_barriers<P>(raw_full);

  if (wg == C) {   // the producer
    if constexpr (C > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ptid = tid - 128 * C;
    produce<P, D, T>(
        raw0, raw_full, img0, img_full, img_empty, q + base, dout + base, n, ptid,
        [&](const unsigned char* rq, const unsigned char* ro, unsigned char* stage, int valid,
            int row0) {
          dkv_images<P, D, T>(rq, ro, stage, valid, ptid);
          if (ptid < ST) {
            float* vec = reinterpret_cast<float*>(stage + 4 * P::ST_IMG);
            const bool ok = ptid < valid;
            vec[ptid] = ok ? lse[rbase + row0 + ptid] * LOG2E : INFINITY;
            vec[ST + ptid] = ok ? delta[rbase + row0 + ptid] : 0.f;
          }
        });
    return;
  }

  if constexpr (C > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  a_image<P::ROWS, D, T>(kimg, k + base, k0, n, wg, ctid);
  a_image<P::ROWS, D, T>(vimg, v + base, k0, n, wg, ctid);
  fence_async();
  wg_sync(2 + wg);
  const uint32_t ka = smem_addr(kimg) + wg * 2048, va = smem_addr(vimg) + wg * 2048;
  const float scale2 = scale * LOG2E;

  // keys 16 warp + g + 8h of the warpgroup's: dK and dV in accumulator
  // layout (acc[4j + 2h + e] is column 8j + 2t + e)
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int tiles = (n + ST - 1) / ST;
  for (int it = 0; it < tiles; ++it) {
    const int si = it % NI;
    mbar_wait(img_full + 8 * si, (it / NI) & 1);
    const unsigned char* st = img0 + si * P::STAGE;
    const uint32_t stage = smem_addr(st);
    const float* vec = reinterpret_cast<const float*>(st + 4 * P::ST_IMG);
    // s[4j + 2h + e]: key 16 warp + g + 8h, query 8j + 2t + e of the tile
    float s[ST / 2], dp[ST / 2];
    ss_product<ST, P::ROWS, D, T>(s, ka, stage);                 // S^T = K Q^T
    ss_product<ST, P::ROWS, D, T>(dp, va, stage + P::ST_IMG);    // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < ST / 8; ++j) {   // P^T, and dS^T = P^T (dP^T - delta) in dp
      const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(vec + ST + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        s[i] = ex2(fmaf(s[i], scale2, -l2.x));
        s[i + 1] = ex2(fmaf(s[i + 1], scale2, -l2.y));
        dp[i] = s[i] * (dp[i] - dl.x);
        dp[i + 1] = s[i + 1] * (dp[i + 1] - dl.y);
      }
    }
    rs_accumulate<D, ST, T>(acc_v, s, stage + 3 * P::ST_IMG);    // dV += P^T dO
    rs_accumulate<D, ST, T>(acc_k, dp, stage + 2 * P::ST_IMG);   // dK += dS^T Q
    __syncwarp();
    if (lane == 0) mbar_arrive(img_empty + 8 * si);   // this warp is done with the stage
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 64 * wg + 16 * warp + g + 8 * h;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t o = base + (size_t)r * D + 8 * j + 2 * t;
      store2<T>(dk + o, acc_k[4 * j + 2 * h] * scale, acc_k[4 * j + 2 * h + 1] * scale);
      store2<T>(dv + o, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// heads wider than 128 (the plans and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace wide {

using namespace tc;

constexpr int G = 128;            // output columns a block; the wrapper pads d to a multiple
constexpr int BLOCK_ROWS = 64;    // rows a block: one consumer warpgroup
constexpr int THREADS = 256;      // and the producer warpgroup
constexpr int MAX_NI = 4;         // image stages, at most
enum Kind { FWD = 0, DQ = 1, DKV = 2 };

// The plan of one instantiation of a kind: ST rows of the streamed axis a
// tile (keys in the forward and dq, queries in dk/dv), chunks of GC
// columns of the head (64 in float32, 128 in bf16: a bf16 tile's time
// follows its count of items), NI image stages of STAGE bytes, each
// holding one item: a chunk of GC columns of the
// resident operand's BLOCK_ROWS rows (A) and of the tile's rows (B), or one
// column group of the tile's rows transposed (G rows, K along the tile),
// and for dk/dv the tile's lse log2 e and delta after the images.  No raw
// stage: the producer reads global memory.  Mirrored by
// ops/flash_attention.py::forward_plan / backward_plan above 128.
template <typename T, int KIND>
struct Plan {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int EB = (int)sizeof(T) * (F32 ? 2 : 1);   // image bytes an element
  static constexpr int C = 1, NR = 0, ROWS = BLOCK_ROWS;
  static constexpr int ST = KIND == DKV && F32 ? 32 : 64;
  static constexpr int GC = F32 ? 64 : 128;
  static constexpr int A_IMG = ROWS * GC * EB;   // a chunk of the resident rows
  static constexpr int B_IMG = ST * GC * EB;     // a chunk of the tile's rows
  static constexpr int T_IMG = G * ST * EB;      // a column group of the tile, transposed
  static constexpr int IMG = A_IMG + B_IMG > T_IMG ? A_IMG + B_IMG : T_IMG;
  static constexpr int VEC = KIND == DKV ? 2 * ST * 4 : 0;
  static constexpr int STAGE = IMG + VEC;
  static constexpr int FIT = (SMEM_LIMIT - ALIGN - 8 * 2 * MAX_NI) / STAGE;
  static constexpr int NI = FIT < MAX_NI ? FIT : MAX_NI;
  static constexpr int SMEM = ALIGN + NI * STAGE + 8 * 2 * NI;
  static_assert(NI >= 2 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
  static_assert(ST % 16 == 0 && G % GC == 0, "whole k16 steps and chunks");
};

// The producer warpgroup: items 0 .. items - 1 in order, item it into image
// stage it % NI once the consumer has released it (item(it, stage) writes
// the images), then the stage's full barrier.
template <class P, class Item>
__device__ __forceinline__ void produce_items(unsigned char* img0, uint32_t img_full,
                                              uint32_t img_empty, int items, Item item) {
#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int si = it % P::NI;
    if (it >= P::NI) mbar_wait(img_empty + 8 * si, ((it / P::NI) + 1) & 1);
    item(it, img0 + si * P::STAGE);
    fence_async();
    mbar_arrive(img_full + 8 * si);
  }
}

// The consumer warpgroup's side of the ring: the items in the producer's
// order, each waited for and released once.
template <class P>
struct Ring {
  unsigned char* img0;
  uint32_t full, empty;
  int it;
  __device__ __forceinline__ unsigned char* acquire() {
    const int si = it % P::NI;
    mbar_wait(full + 8 * si, (it / P::NI) & 1);
    return img0 + si * P::STAGE;
  }
  __device__ __forceinline__ void release(int lane) {   // this warp is done with the item
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % P::NI));
    ++it;
  }
};

// A chunk item: P::GC columns (from column a / b on, d elements a row) of
// the resident rows (a_valid of them real) and of the tile's (b_valid), as
// kmajor_image writes them, but every chunk of both loaded before any is
// written: the producer reads global memory, one round trip an item.
template <class P, typename T>
__device__ __forceinline__ void chunk_images(unsigned char* stage, const T* a, int a_valid,
                                             const T* b, int b_valid, int d, int ptid) {
  constexpr int CPR = P::GC * (int)sizeof(T) / 16;   // chunks a row
  constexpr int KA = P::ROWS * CPR / 128, KB = P::ST * CPR / 128;
  static_assert(KA >= 1 && KB >= 1 && (P::ST * CPR) % 128 == 0, "whole chunks a thread");
  const unsigned char* ra = reinterpret_cast<const unsigned char*>(a);
  const unsigned char* rb = reinterpret_cast<const unsigned char*>(b);
  const int ldb = d * (int)sizeof(T);
  uint4 xa[KA], xb[KB];
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int u = ptid + 128 * j, r = u % P::ROWS, ck = (u / P::ROWS + r) % CPR;
    xa[j] = r < a_valid ? *reinterpret_cast<const uint4*>(ra + r * ldb + ck * 16)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const int u = ptid + 128 * j, r = u % P::ST, ck = (u / P::ST + r) % CPR;
    xb[j] = r < b_valid ? *reinterpret_cast<const uint4*>(rb + r * ldb + ck * 16)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < KA; ++j) {
    const int u = ptid + 128 * j, r = u % P::ROWS, ck = (u / P::ROWS + r) % CPR;
    put16<P::ROWS, T>(stage, r, ck, xa[j]);
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const int u = ptid + 128 * j, r = u % P::ST, ck = (u / P::ST + r) % CPR;
    put16<P::ST, T>(stage + P::A_IMG, r, ck, xb[j]);
  }
}

// A column-group item: the G columns from src on of the tile's valid rows,
// transposed, as transposed_image writes them, every element loaded first.
template <class P, typename T>
__device__ __forceinline__ void group_image(unsigned char* stage, const T* src, int valid, int d,
                                            int ptid) {
  transposed_image<P::ST, G, T, 16>(reinterpret_cast<const unsigned char*>(src), stage, valid,
                                    ptid, d);
}

// s = the resident rows times the tile's rows, transposed, over the whole
// head: one chunk item after another, each one ss_product into s.
template <class P, typename T>
__device__ __forceinline__ void products_over_head(float (&s)[P::ST / 2], Ring<P>& ring, int nch,
                                                   int lane) {
#pragma unroll
  for (int i = 0; i < P::ST / 2; ++i) s[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < nch; ++c) {
    const uint32_t st = smem_addr(ring.acquire());
    ss_product<P::ST, P::ROWS, P::GC, T, true>(s, st, st + P::A_IMG);
    ring.release(lane);
  }
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + ALIGN - 1) &
                                          ~(uintptr_t)(ALIGN - 1));
}

}  // namespace wide

// Forward above 128: a block is (64 query rows, column group) of one head;
// each key tile's items are the nch = d / P::GC chunks (Q, K) of S, then V's
// group transposed.  Every group computes the same m, l and lse; group 0
// writes lse.
template <int GW, typename T>
__global__ void __launch_bounds__(wide::THREADS, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ lse, int n, int d, float scale) {
  using namespace wide;
  using P = Plan<T, FWD>;
  static_assert(GW == G, "one column-group width");
  constexpr int KT = P::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* img0 = aligned_smem(smem_raw);
  const uint32_t img_full = smem_addr(img0 + P::NI * P::STAGE), img_empty = img_full + 8 * P::NI;
  const int tid = threadIdx.x, groups = d / G;
  const int grp = blockIdx.x % groups, q0 = (blockIdx.x / groups) * P::ROWS;
  const size_t base = (size_t)blockIdx.y * n * d;
  const int nch = d / P::GC, per_tile = nch + 1, tiles = (n + KT - 1) / KT;
  init_barriers<P>(img_full);

  if (tid >= 128) {   // the producer
    const int ptid = tid - 128, qvalid = min(P::ROWS, n - q0);
    const T* qrows = q + base + (size_t)q0 * d;
    produce_items<P>(img0, img_full, img_empty, tiles * per_tile,
                     [&](int it, unsigned char* stage) {
                       const int tile = it / per_tile, j = it - tile * per_tile;
                       const int row0 = tile * KT, valid = min(KT, n - row0);
                       const size_t rows = base + (size_t)row0 * d;
                       if (j < nch)
                         chunk_images<P, T>(stage, qrows + j * P::GC, qvalid, k + rows + j * P::GC,
                                            valid, d, ptid);
                       else
                         group_image<P, T>(stage, v + rows + grp * G, valid, d, ptid);
                     });
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  Ring<P> ring{img0, img_full, img_empty, 0};
  const float scale2 = scale * LOG2E;
  // rows 16 warp + g + 8h: running max (log2 units), this thread's share of
  // the running sum, the group's output columns in accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[G / 2];
#pragma unroll
  for (int i = 0; i < G / 2; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    float s[KT / 2], alpha[2];
    products_over_head<P, T>(s, ring, nch, lane);                 // S = Q K^T
    fwd::softmax_tile<KT>(s, m, l, alpha, tile * KT, n, t, scale2);
#pragma unroll
    for (int i = 0; i < G / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const uint32_t vb = smem_addr(ring.acquire());
    bwd::rs_accumulate<G, KT, T>(acc, s, vb);                     // O_g += P V_g
    ring.release(lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / l[h];
    T* row = out + base + (size_t)r * d + grp * G;
#pragma unroll
    for (int j = 0; j < G / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (t == 0 && grp == 0) lse[(size_t)blockIdx.y * n + r] = m[h] * LN2 + logf(l[h]);
  }
}

// dq above 128: a block is (64 query rows, column group); each key tile's
// items are the chunks (Q, K) of S, the chunks (dO, V) of dP, then K's
// group transposed for dQ_g += dS K_g.
template <int GW, typename T>
__global__ void __launch_bounds__(wide::THREADS, 1)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dq, int n, int d, float scale) {
  using namespace wide;
  using P = Plan<T, DQ>;
  static_assert(GW == G, "one column-group width");
  constexpr int ST = P::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* img0 = aligned_smem(smem_raw);
  const uint32_t img_full = smem_addr(img0 + P::NI * P::STAGE), img_empty = img_full + 8 * P::NI;
  const int tid = threadIdx.x, groups = d / G;
  const int grp = blockIdx.x % groups, q0 = (blockIdx.x / groups) * P::ROWS;
  const size_t base = (size_t)blockIdx.y * n * d, rbase = (size_t)blockIdx.y * n;
  const int nch = d / P::GC, per_tile = 2 * nch + 1, tiles = (n + ST - 1) / ST;
  init_barriers<P>(img_full);

  if (tid >= 128) {   // the producer
    const int ptid = tid - 128, qvalid = min(P::ROWS, n - q0);
    const size_t qrows = base + (size_t)q0 * d;
    produce_items<P>(img0, img_full, img_empty, tiles * per_tile,
                     [&](int it, unsigned char* stage) {
                       const int tile = it / per_tile, j = it - tile * per_tile;
                       const int row0 = tile * ST, valid = min(ST, n - row0);
                       const size_t rows = base + (size_t)row0 * d;
                       if (j < nch)
                         chunk_images<P, T>(stage, q + qrows + j * P::GC, qvalid, k + rows + j * P::GC,
                                            valid, d, ptid);
                       else if (j < 2 * nch)
                         chunk_images<P, T>(stage, dout + qrows + (j - nch) * P::GC, qvalid,
                                            v + rows + (j - nch) * P::GC, valid, d, ptid);
                       else
                         group_image<P, T>(stage, k + rows + grp * G, valid, d, ptid);
                     });
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  Ring<P> ring{img0, img_full, img_empty, 0};
  const float scale2 = scale * LOG2E;
  float lse2[2], dlt[2], acc[G / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    lse2[h] = r < n ? lse[rbase + r] * LOG2E : 0.f;
    dlt[h] = r < n ? delta[rbase + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < G / 2; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * ST;
    float s[ST / 2], dp[ST / 2];
    products_over_head<P, T>(s, ring, nch, lane);    // S = Q K^T
    products_over_head<P, T>(dp, ring, nch, lane);   // dP = dO V^T
    if (k0 + ST > n) {   // keys past n: P = 0
#pragma unroll
      for (int i = 0; i < ST / 2; ++i)
        if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < ST / 2; ++i) {   // dS = P (dP - delta), in dp
      const int h = (i >> 1) & 1;
      dp[i] = ex2(fmaf(s[i], scale2, -lse2[h])) * (dp[i] - dlt[h]);
    }
    const uint32_t kb = smem_addr(ring.acquire());
    bwd::rs_accumulate<G, ST, T>(acc, dp, kb);       // dQ_g += dS K_g
    ring.release(lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    T* row = dq + base + (size_t)r * d + grp * G;
#pragma unroll
    for (int j = 0; j < G / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// dk/dv above 128: a block is (64 keys, column group); each query tile's
// items are the chunks (K, Q) of S^T, the chunks (V, dO) of dP^T, dO's
// group transposed with the tile's lse log2 e and delta (dV_g += P^T dO_g),
// then Q's group transposed (dK_g += dS^T Q_g).
template <int GW, typename T>
__global__ void __launch_bounds__(wide::THREADS, 1)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int n, int d, float scale) {
  using namespace wide;
  using P = Plan<T, DKV>;
  static_assert(GW == G, "one column-group width");
  constexpr int ST = P::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* img0 = aligned_smem(smem_raw);
  const uint32_t img_full = smem_addr(img0 + P::NI * P::STAGE), img_empty = img_full + 8 * P::NI;
  const int tid = threadIdx.x, groups = d / G;
  const int grp = blockIdx.x % groups, k0 = (blockIdx.x / groups) * P::ROWS;
  const size_t base = (size_t)blockIdx.y * n * d, rbase = (size_t)blockIdx.y * n;
  const int nch = d / P::GC, per_tile = 2 * nch + 2, tiles = (n + ST - 1) / ST;
  init_barriers<P>(img_full);

  if (tid >= 128) {   // the producer
    const int ptid = tid - 128, kvalid = min(P::ROWS, n - k0);
    const size_t krows = base + (size_t)k0 * d;
    produce_items<P>(
        img0, img_full, img_empty, tiles * per_tile, [&](int it, unsigned char* stage) {
          const int tile = it / per_tile, j = it - tile * per_tile;
          const int row0 = tile * ST, valid = min(ST, n - row0);
          const size_t rows = base + (size_t)row0 * d;
          if (j < nch) {
            chunk_images<P, T>(stage, k + krows + j * P::GC, kvalid, q + rows + j * P::GC, valid, d,
                               ptid);
          } else if (j < 2 * nch) {
            chunk_images<P, T>(stage, v + krows + (j - nch) * P::GC, kvalid,
                               dout + rows + (j - nch) * P::GC, valid, d, ptid);
          } else if (j == 2 * nch) {
            group_image<P, T>(stage, dout + rows + grp * G, valid, d, ptid);
            if (ptid < ST) {
              float* vec = reinterpret_cast<float*>(stage + P::IMG);
              const bool ok = ptid < valid;
              vec[ptid] = ok ? lse[rbase + row0 + ptid] * LOG2E : INFINITY;
              vec[ST + ptid] = ok ? delta[rbase + row0 + ptid] : 0.f;
            }
          } else {
            group_image<P, T>(stage, q + rows + grp * G, valid, d, ptid);
          }
        });
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  Ring<P> ring{img0, img_full, img_empty, 0};
  const float scale2 = scale * LOG2E;
  // keys 16 warp + g + 8h: the group's columns of dK and dV
  float acc_k[G / 2], acc_v[G / 2];
#pragma unroll
  for (int i = 0; i < G / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    // s[4j + 2h + e]: key 16 warp + g + 8h, query 8j + 2t + e of the tile
    float s[ST / 2], dp[ST / 2];
    products_over_head<P, T>(s, ring, nch, lane);    // S^T = K Q^T
    products_over_head<P, T>(dp, ring, nch, lane);   // dP^T = V dO^T
    const unsigned char* st = ring.acquire();
    const float* vec = reinterpret_cast<const float*>(st + P::IMG);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j) {   // P^T, and dS^T = P^T (dP^T - delta) in dp
      const float2 l2 = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(vec + ST + 8 * j + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        s[i] = ex2(fmaf(s[i], scale2, -l2.x));
        s[i + 1] = ex2(fmaf(s[i + 1], scale2, -l2.y));
        dp[i] = s[i] * (dp[i] - dl.x);
        dp[i + 1] = s[i + 1] * (dp[i + 1] - dl.y);
      }
    }
    bwd::rs_accumulate<G, ST, T>(acc_v, s, smem_addr(st));   // dV_g += P^T dO_g
    ring.release(lane);
    const uint32_t qb = smem_addr(ring.acquire());
    bwd::rs_accumulate<G, ST, T>(acc_k, dp, qb);             // dK_g += dS^T Q_g
    ring.release(lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    const size_t o = base + (size_t)r * d + grp * G;
#pragma unroll
    for (int j = 0; j < G / 8; ++j) {
      store2<T>(dk + o + 8 * j + 2 * t, acc_k[4 * j + 2 * h] * scale,
                acc_k[4 * j + 2 * h + 1] * scale);
      store2<T>(dv + o + 8 * j + 2 * t, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 heads of 256, 384 and 512: the forward with Q resident as raw rows
// (the plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace wq {

using namespace tc;

constexpr int ROWS = 64;        // query rows a block: one consumer warpgroup
constexpr int THREADS = 256;    // and the producer warpgroup
constexpr int KT = 32;          // keys a tile
constexpr int SUB = 64;         // columns an item: a chunk of K, or a sub-group of V
constexpr int Q_PAD = 4;        // Q's row stride d + 4: a warp's A loads hit 32 banks
constexpr int MAX_D = 512;      // the widest head whose Q fits beside the stages
constexpr int LOAD_AHEAD = 1;   // items whose loads a producer thread keeps in flight

// Items of KT x SUB floats in both TF32 halves (a K chunk K-major, or SUB
// columns of V transposed), NI stages of them, their barriers, then Q's
// rows.  Mirrored by ops/flash_attention.py::forward_plan.
struct Plan {
  static constexpr int C = 1, NR = 0, ST = KT;   // as tc::init_barriers, wide::Ring take them
  static constexpr int STAGE = KT * SUB * 8;
  static constexpr int NI = 6;
  static constexpr int FIXED = ALIGN + NI * STAGE + 8 * 2 * NI;
  __host__ __device__ static constexpr int smem(int d) { return FIXED + ROWS * (d + Q_PAD) * 4; }
};
static_assert(Plan::smem(MAX_D) <= SMEM_LIMIT, "the plan exceeds a block's shared memory");

// An item's loads into a thread's registers (16 words), then its writes:
// a chunk item, SUB columns of the tile's valid rows from src (row stride
// d), K-major in both halves (kmajor_image's layout); or a sub-group item,
// SUB columns from src of the tile's valid rows, transposed
// (transposed_image's layout and key order)
constexpr int WORDS = 16;
__device__ __forceinline__ void k_load(uint32_t (&w)[WORDS], const float* src, int valid, int d,
                                       int ptid) {
  constexpr int CPR = SUB * 4 / 16, KB = KT * CPR / 128;
  static_assert(4 * KB == WORDS && (KT * CPR) % 128 == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const int u = ptid + 128 * j, r = u % KT, ck = (u / KT + r) % CPR;
    const uint4 x = r < valid ? *reinterpret_cast<const uint4*>(src + (size_t)r * d + 4 * ck)
                              : make_uint4(0u, 0u, 0u, 0u);
    w[4 * j] = x.x;
    w[4 * j + 1] = x.y;
    w[4 * j + 2] = x.z;
    w[4 * j + 3] = x.w;
  }
}
__device__ __forceinline__ void k_store(unsigned char* stage, const uint32_t (&w)[WORDS],
                                        int ptid) {
  constexpr int CPR = SUB * 4 / 16, KB = KT * CPR / 128;
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    const int u = ptid + 128 * j, r = u % KT, ck = (u / KT + r) % CPR;
    put16<KT, float>(stage, r, ck, make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]));
  }
}
__device__ __forceinline__ void v_load(uint32_t (&w)[WORDS], const float* src, int valid, int d,
                                       int ptid) {
  constexpr int VU = SUB * (KT / 4) / 128;
  static_assert(4 * VU == WORDS, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < VU; ++j) {
    const int u = ptid + 128 * j, c = u % SUB, ck = u / SUB;
    const int row0 = 8 * (ck >> 1) + (ck & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + 2 * e;
      w[4 * j + e] = __float_as_uint(row < valid ? src[(size_t)row * d + c] : 0.f);
    }
  }
}
__device__ __forceinline__ void v_store(unsigned char* stage, const uint32_t (&w)[WORDS],
                                        int ptid) {
  constexpr int VU = SUB * (KT / 4) / 128;
#pragma unroll
  for (int j = 0; j < VU; ++j) {
    const int u = ptid + 128 * j, c = u % SUB, ck = u / SUB;
    uint32_t b[4], sm[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split<false>(__uint_as_float(w[4 * j + e]), b[e], sm[e]);
    const int o = img_off<SUB, 2>(c, ck);
    *reinterpret_cast<uint4*>(stage + o) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(stage + o + SUB * 32) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// The producer warpgroup: items 0 .. items - 1 in order, as
// wide::produce_items, with the loads of the A items after the one it
// writes in flight (A + 1 sets of WORDS registers, taken in turns by a
// loop unrolled by A + 1); each item is fenced and released as soon as it
// is written (a batch of items released at once measured slower: 19.7 and
// 21.6 ms at (8, 9216, 256) for two and four, against 15.8 for one ahead)
template <int A, class Load, class Store>
__device__ __forceinline__ void produce_ahead(unsigned char* img0, uint32_t img_full,
                                              uint32_t img_empty, int items, Load load,
                                              Store store) {
  constexpr int NB = A + 1;
  uint32_t buf[NB][WORDS];
#pragma unroll
  for (int b = 0; b < A; ++b)
    if (b < items) load(b, buf[b]);
#pragma unroll 1
  for (int it0 = 0; it0 < items; it0 += NB) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int it = it0 + b, si = it % Plan::NI;
      if (it >= items) break;
      if (it + A < items) load(it + A, buf[(b + A) % NB]);   // the set item it - 1 freed
      if (it >= Plan::NI) mbar_wait(img_empty + 8 * si, ((it / Plan::NI) + 1) & 1);
      store(it, buf[b], img0 + si * Plan::STAGE);
      fence_async();
      mbar_arrive(img_full + 8 * si);
    }
  }
}

// The TF32 A fragments of one k16 step from Q's raw rows: k8 step kk's
// columns k0 + 8 kk + t (+ 4) of rows arow (+ 8), split into halves
__device__ __forceinline__ void q_frags(uint32_t (&ab)[2][4], uint32_t (&as)[2][4],
                                        const float* qr, int ld, int k0, int arow, int t) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* p = qr + arow * ld + k0 + 8 * kk + t;
    const float x[4] = {p[0], p[8 * ld], p[4], p[8 * ld + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) split<false>(x[e], ab[kk][e], as[kk][e]);
  }
}

// s += Q's columns 64 c .. 64 c + 63 (register A: this thread's fragments
// from the raw rows, split in registers) times the chunk item's K rows at
// b, transposed: three TF32 products a k8 step into a zeroed partial a k16
// step, carried into s (two partials taking turns); the next k16 step's A
// loads and splits while the current one's products run, into the other
// set of registers, whose products the wait before has finished
__device__ __forceinline__ void s_chunk(float (&s)[KT / 2], const float* qr, int ld, int c,
                                        uint32_t b, int arow, int t) {
  constexpr int STEPS = SUB / 16;
  uint32_t ab[2][2][4], as[2][2][4];
  float part[2][KT / 2] = {};   // zeroed: as ss_product's partials
  q_frags(ab[0], as[0], qr, ld, c * SUB, arow, t);
#pragma unroll
  for (int c2 = 0; c2 < STEPS; ++c2) {
    const int x = c2 & 1;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) fence_reg(part[x][i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t bk = b + (2 * c2 + kk) * (KT * 32 * 2);
      mma_rs<KT, float>(part[x], as[x][kk], b_desc(bk), kk);
      mma_rs<KT, float>(part[x], ab[x][kk], b_desc(bk + KT * 32), 1);
      mma_rs<KT, float>(part[x], ab[x][kk], b_desc(bk), 1);
    }
    wgmma_commit();
    if (c2 > 0) {
      wgmma_wait<1>();   // step c2 - 1 done: its partial and its A registers
      fence_frags(ab[x ^ 1]);
      fence_frags(as[x ^ 1]);
      carry(s, part[x ^ 1]);
    }
    if (c2 + 1 < STEPS) q_frags(ab[x ^ 1], as[x ^ 1], qr, ld, c * SUB + 16 * (c2 + 1), arow, t);
  }
  wgmma_wait<0>();
  fence_frags(ab[(STEPS - 1) & 1]);
  fence_frags(as[(STEPS - 1) & 1]);
  carry(s, part[(STEPS - 1) & 1]);
}

// acc (GW columns) += P (s's TF32 halves as register A) times the tile's V,
// one sub-group item of SUB columns after another, each into the one
// partial (its first product ignores it), carried into its columns
template <int GW>
__device__ __forceinline__ void pv_subgroups(float (&acc)[GW / 2], const float (&s)[KT / 2],
                                             wide::Ring<Plan>& ring, int lane) {
  uint32_t big[KT / 8][4], sm[KT / 8][4];
  tf32_frags<KT>(s, big, sm);
  float part[SUB / 2] = {};
#pragma unroll
  for (int h = 0; h < GW / SUB; ++h) {
    const uint32_t vb = smem_addr(ring.acquire());
#pragma unroll
    for (int i = 0; i < SUB / 2; ++i) fence_reg(part[i]);
    wgmma_fence();
    rs_tf32<SUB, KT, SUB>(part, big, sm, vb, 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < SUB / 2; ++i) {
      fence_reg(part[i]);
      acc[h * (SUB / 2) + i] += part[i];
    }
    ring.release(lane);
  }
  fence_frags(big);
  fence_frags(sm);
}

}  // namespace wq

// Forward, float32, D = 256, 384, 512: a block is (64 query rows, group of
// GW output columns) of one head; the consumer warpgroup loads the rows of
// Q once, the producer warpgroup writes each key tile's items: the d / 64
// chunks of K, then the GW / 64 sub-groups of V transposed.  Every group
// computes the same m, l and lse; group 0 writes lse.
template <int GW>
__global__ void __launch_bounds__(wq::THREADS, 1)
flash_fwd_wq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int n, int d, float scale) {
  using namespace wq;
  using P = Plan;
  static_assert(GW % SUB == 0, "whole sub-groups");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* img0 = wide::aligned_smem(smem_raw);
  const uint32_t img_full = smem_addr(img0 + P::NI * P::STAGE), img_empty = img_full + 8 * P::NI;
  float* qr = reinterpret_cast<float*>(img0 + P::NI * P::STAGE + 16 * P::NI);   // ROWS x ld
  const int tid = threadIdx.x, groups = d / GW, ld = d + Q_PAD;
  const int grp = blockIdx.x % groups, q0 = (blockIdx.x / groups) * ROWS;
  const size_t base = (size_t)blockIdx.y * n * d;
  const int nch = d / SUB, per_tile = nch + GW / SUB, tiles = (n + KT - 1) / KT;
  init_barriers<P>(img_full);

  if (tid >= 128) {   // the producer, its loads LOAD_AHEAD items ahead
    const int ptid = tid - 128;
    produce_ahead<LOAD_AHEAD>(
        img0, img_full, img_empty, tiles * per_tile,
        [&](int it, uint32_t (&w)[WORDS]) {
          const int tile = it / per_tile, j = it - tile * per_tile;
          const int row0 = tile * KT, valid = min(KT, n - row0);
          const size_t rows = base + (size_t)row0 * d;
          if (j < nch)
            k_load(w, k + rows + j * SUB, valid, d, ptid);
          else
            v_load(w, v + rows + grp * GW + (j - nch) * SUB, valid, d, ptid);
        },
        [&](int it, const uint32_t (&w)[WORDS], unsigned char* stage) {
          if (it % per_tile < nch)
            k_store(stage, w, ptid);
          else
            v_store(stage, w, ptid);
        });
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int arow = 16 * warp + g;
  // Q's rows once (zeros past n), read by this warpgroup alone
  for (int u = tid; u < ROWS * (d / 4); u += 128) {
    const int r = u / (d / 4), c4 = u % (d / 4);
    const float4 x = q0 + r < n
                         ? __ldg(reinterpret_cast<const float4*>(q + base + (size_t)(q0 + r) * d) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(qr + r * ld + 4 * c4) = x;
  }
  wg_sync(2);
  wide::Ring<P> ring{img0, img_full, img_empty, 0};
  const float scale2 = scale * LOG2E;
  // rows 16 warp + g + 8h: running max (log2 units), this thread's share of
  // the running sum, the group's output columns in accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    float s[KT / 2], alpha[2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {                                   // S = Q K^T
      const uint32_t kb = smem_addr(ring.acquire());
      s_chunk(s, qr, ld, c, kb, arow, t);
      ring.release(lane);
    }
    fwd::softmax_tile<KT>(s, m, l, alpha, tile * KT, n, t, scale2);
#pragma unroll
    for (int i = 0; i < GW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pv_subgroups<GW>(acc, s, ring, lane);                             // O_g += P V_g
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / l[h];
    float* row = out + base + (size_t)r * d + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<float>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (t == 0 && grp == 0) lse[(size_t)blockIdx.y * n + r] = m[h] * LN2 + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// bf16 heads of 256, 384 and 512: the forward on TMA tensor copies (the
// plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace tma {

using namespace tc;

constexpr int CONSUMERS = 2;                      // consumer warpgroups, 64 query rows each
constexpr int ROWS = 64 * CONSUMERS;              // query rows a block
// and no producer: one thread of each warpgroup issues copies (the copies
// take no thread's time), so a block is eight warps, two on each of the
// SM's four register files, and a thread may take 255 registers (a ninth
// warp, or a producer warpgroup, caps them at 168, under the consumers'
// output accumulator of 128 at 256 columns and its operands)
constexpr int THREADS = 128 * CONSUMERS;
constexpr int SLAB = 64;                          // bf16 columns of a 128-byte swizzled row
constexpr int SLAB_ROW = 128;                     // its bytes
constexpr int ATOM = 1024;                        // the swizzle's atom: 8 rows of 128 bytes
constexpr int MAX_NS = 4;                         // stages, at most

// The plan at head width D (256, 384 or 512): each block owns GW output
// columns (the whole head where D is a multiple of 256 up to 256, groups
// of 256 at 512, of 128 at 384); Q's 128 rows stay resident (D / 64
// slabs of 128 rows x 128 bytes); a stage holds one key tile of KT keys:
// K's D / 64 slabs then V's group, GW / 64 slabs, each KT rows x 128
// bytes; KT = 64 where two stages fit beside Q, else 32; as many stages as
// fit, up to MAX_NS.  Mirrored by ops/flash_attention.py::forward_plan.
template <int D>
struct Plan {
  static constexpr int GW = D % 256 == 0 ? 256 : 128;
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int FIXED = ATOM + Q_BYTES + 8;             // alignment slack, Q, q_full
  static constexpr int KT = (SMEM_LIMIT - FIXED) / (64 * (D + GW) * 2 + 16) >= 2 ? 64 : 32;
  static constexpr int STAGE = KT * (D + GW) * 2;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (STAGE + 16);   // a stage, its barrier and count
  static constexpr int NS = FIT < MAX_NS ? FIT : MAX_NS;
  static constexpr int SMEM = FIXED + NS * (STAGE + 16);
  static constexpr int SLABS = D / SLAB;
  static_assert(D % 128 == 0 && D > 128 && D % GW == 0, "a head of whole groups");
  static_assert(NS >= 2 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
};

// The descriptor of a wgmma operand in the 128-byte swizzle TMA writes
// (rows of 128 bytes, a row's 16-byte chunks permuted by the row's index
// within its 8-row atom, atoms 1024-byte aligned): lbo and sbo in bytes.
// K-major (Q, K: a k16 step is the next 32 bytes of a row, lbo unused),
// sbo the 1024 bytes between 8-row groups; MN-major (V, read through the
// transpose bit: K along the rows), lbo between the 64-column slabs, sbo
// between 8-row groups of K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// arm bar for bytes
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// a box of a (D, N, BH) tensor map at (column, row, head) into dst,
// completing on bar; rows past N (and the tensor) come as zeros
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int col, int row,
                                        int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head), "r"(bar)
      : "memory");
}

// d (m64 x nN, f32) += a (m64 x k16, bf16 pairs in registers, as mma_rs's)
// . b (k16 x nN, bf16 in shared memory, MN-major: the transpose bit)
template <int N>
__device__ __forceinline__ void mma_rs_t(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);
template <>
__device__ __forceinline__ void mma_rs_t<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
__device__ __forceinline__ void mma_rs_t<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_rs_t<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// acc = the warpgroup's 64 rows of a (slabs of AR rows) times the tile's KT
// rows of b, transposed, over the head: D / 64 slabs of four k16 steps,
// each step the next 32 bytes of the swizzled rows, the first with scale-d
// 0 (acc's old values ignored: the backward lets no instruction but the
// wgmma write an accumulator while a product is in flight, or ptxas
// serialises them), issued and committed as one group; the caller waits
template <int D, int KT, int AR>
__device__ __forceinline__ void issue_s(float (&acc)[KT / 2], uint32_t a, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < D / SLAB; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mma_ss<KT, __nv_bfloat16>(acc, sw128_desc(a + c * AR * SLAB_ROW + 32 * j, 16, ATOM),
                                sw128_desc(b + c * KT * SLAB_ROW + 32 * j, 16, ATOM),
                                c > 0 || j > 0);
  wgmma_commit();
}

// acc (GW columns) += the register operand pa (ST columns of P or dS, rounded
// to bf16 by tc::bf16_frags) times the ST rows of the group's slabs at b,
// read MN-major through the transpose bit (lbo the slab stride, sbo 1024;
// a k16 step 16 rows on), issued and committed as one group; the caller
// waits, and keeps pa until then
template <int GW, int ST>
__device__ __forceinline__ void issue_pv(float (&acc)[GW / 2], const uint32_t (&pa)[ST / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) fence_reg(acc[i]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < ST / 16; ++c)
    mma_rs_t<GW>(acc, pa[c], sw128_desc(b + c * 16 * SLAB_ROW, ST * SLAB_ROW, ATOM), 1);
  wgmma_commit();
}

// sc = the warpgroup's 64 rows of Q (qa) times the tile's KT keys (kb),
// transposed, over the head (issue_s), waited for
template <int D, int KT>
__device__ __forceinline__ void s_product(float (&sc)[KT / 2], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    sc[i] = 0.f;
    fence_reg(sc[i]);
  }
  issue_s<D, KT, ROWS>(sc, qa, kb);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) fence_reg(sc[i]);
}

// acc (the group's GW columns) += P (sc rounded to bf16 as register A) times
// the stage's V group (vb, KT rows of GW / 64 slabs, MN-major) (issue_pv),
// waited for
template <int GW, int KT>
__device__ __forceinline__ void pv_product(float (&acc)[GW / 2], const float (&sc)[KT / 2],
                                           uint32_t vb) {
  uint32_t pa[KT / 16][4];
  bf16_frags<KT>(sc, pa);
  issue_pv<GW, KT>(acc, pa, vb);
  wgmma_wait<0>();
  fence_frags(pa);
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) fence_reg(acc[i]);
}

}  // namespace tma

// Forward, bf16, D = 256, 384, 512: a block is (128 query rows, group of
// GW output columns) of one head, two warpgroups of 64 rows.  Thread 0
// issues Q's copies and the first NS tiles'; a stage is refilled with the
// tile NS on by the warpgroup that releases it second (a release count a
// stage, counted by each warpgroup's first thread after its products
// end), so neither warpgroup waits for the other.  Barriers: q_full (Q's
// tensor copies), full[NS] (a tile's K and V copies).  Every group
// computes the same m, l and lse; group 0 writes lse.
template <int D, typename T>
__global__ void __launch_bounds__(tma::THREADS, 1)
flash_fwd_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, T* __restrict__ out,
                     float* __restrict__ lse, int n, float scale) {
  using namespace tma;
  using P = Plan<D>;
  constexpr int GW = P::GW, KT = P::KT, NS = P::NS;
  static_assert(sizeof(T) == 2, "bf16 operands");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ATOM - 1) & ~(uintptr_t)(ATOM - 1));
  unsigned char* st0 = qs + P::Q_BYTES;             // NS stages: K's slabs, then V's
  const uint32_t q_full = smem_addr(st0 + NS * P::STAGE), full = q_full + 8;
  // the stages' release counts, 8 bytes apart after the full barriers
  unsigned int* released = reinterpret_cast<unsigned int*>(st0 + NS * P::STAGE + 8 + 8 * NS);
  const int tid = threadIdx.x, wg = tid >> 7;
  constexpr int groups = D / GW;
  const int grp = blockIdx.x % groups, q0 = (blockIdx.x / groups) * ROWS;
  const int head = blockIdx.y;
  const int tiles = (n + KT - 1) / KT;
  // tile u's K slabs and V's group slabs into stage u % NS, by one thread
  auto fill = [&](int u) {
    const int s = u % NS;
    const uint32_t kb = smem_addr(st0 + s * P::STAGE), vb = kb + KT * D * 2;
    mbar_expect(full + 8 * s, P::STAGE);
#pragma unroll 1
    for (int c = 0; c < P::SLABS; ++c)
      tma_box(kb + c * KT * SLAB_ROW, &map_k, c * SLAB, u * KT, head, full + 8 * s);
#pragma unroll 1
    for (int c = 0; c < GW / SLAB; ++c)
      tma_box(vb + c * KT * SLAB_ROW, &map_v, grp * GW + c * SLAB, u * KT, head, full + 8 * s);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      released[2 * s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(q_full, P::Q_BYTES);
#pragma unroll 1
    for (int c = 0; c < P::SLABS; ++c)
      tma_box(smem_addr(qs + c * ROWS * SLAB_ROW), &map_q, c * SLAB, q0, head, q_full);
    for (int u = 0; u < NS && u < tiles; ++u) fill(u);
  }

  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t qa = smem_addr(qs) + wg * 64 * SLAB_ROW;   // the warpgroup's 64 rows
  const float scale2 = scale * LOG2E;
  // rows 16 warp + g + 8h of the warpgroup's: running max (log2 units),
  // this thread's share of the running sum, the group's output columns in
  // accumulator layout
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int s = it % NS;
    mbar_wait(full + 8 * s, (it / NS) & 1);
    const uint32_t kb = smem_addr(st0 + s * P::STAGE), vb = kb + KT * D * 2;
    float sc[KT / 2], alpha[2];
    s_product<D, KT>(sc, qa, kb);                                       // S = Q K^T
    fwd::softmax_tile<KT>(sc, m, l, alpha, it * KT, n, t, scale2);
#pragma unroll
    for (int i = 0; i < GW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pv_product<GW, KT>(acc, sc, vb);                                   // O_g += P V_g
    // this warpgroup is done with the stage: its first thread counts the
    // release, and the second release refills the stage
    if (ctid == 0 && (atomicAdd(released + 2 * s, 1u) & 1u) && it + NS < tiles) fill(it + NS);
    __syncwarp();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * wg + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    const float inv = 1.f / l[h];
    T* row = out + ((size_t)head * n + r) * D + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    if (t == 0 && grp == 0) lse[(size_t)head * n + r] = m[h] * LN2 + logf(l[h]);
  }
}

// ---------------------------------------------------------------------------
// bf16 heads of 256, 384 and 512: the backward on TMA tensor copies (the
// plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace tmab {

using namespace tc;
using tma::ATOM;
using tma::SLAB;
using tma::SLAB_ROW;

constexpr int MAX_NS = 4;   // stages, at most

// stages of st streamed rows (of row bytes each, with a barrier and a
// release count) that fit beside fixed bytes
constexpr int stages_fit(int fixed, int st, int row) {
  return (SMEM_LIMIT - fixed) / (st * row + 16);
}

// The plan at head width D, one for both passes (dq: Q and dO resident, K
// and V streamed; dk/dv: K and V resident, Q and dO streamed).  A warpgroup
// owns 64 rows and GW output columns (the whole head at 256, groups of 256
// at 512, of 192 at 384: groups of 128 would make the split dk/dv dearer
// than the column-group kernel's).  A block is C = 2 consumer warpgroups:
// RC = 2 of 64 rows each and one group where both resident operands' 128
// rows fit beside two stages of 32 rows (256), else RC = 1 block of 64 rows
// whose two warpgroups own GB = 2 groups of the same rows (384, 512).  ST
// streamed rows a tile, the most of 64, 32 and 16 that leaves two stages;
// as many stages as fit, up to MAX_NS.  The resident operands are D / 64
// slabs of ROWS rows x 128 bytes each, a stage D / 64 slabs of ST rows each
// of its two operands, all in the 128-byte swizzle TMA writes.  Mirrored by
// ops/flash_attention.py::backward_plan.
template <int D>
struct Plan {
  static constexpr int GW = D % 256 == 0 ? 256 : 192;
  static constexpr int GROUPS = D / GW;
  static constexpr int ROW = 2 * D * 2;   // bytes of a row of both operands
  static constexpr int RC = ATOM + 8 + 128 * ROW + 2 * (32 * ROW + 16) <= SMEM_LIMIT ? 2 : 1;
  static constexpr int GB = RC == 2 ? 1 : 2;   // groups a block
  static constexpr int C = RC * GB;
  static constexpr int ROWS = 64 * RC;
  static constexpr int THREADS = 128 * C;
  static constexpr int RES = ROWS * ROW;                        // both resident operands
  static constexpr int FIXED = ATOM + RES + 8;                  // alignment slack, res_full
  static constexpr int ST = stages_fit(FIXED, 64, ROW) >= 2   ? 64
                            : stages_fit(FIXED, 32, ROW) >= 2 ? 32
                                                              : 16;
  static constexpr int STAGE = ST * ROW;
  static constexpr int FIT = stages_fit(FIXED, ST, ROW);
  static constexpr int NS = FIT < MAX_NS ? FIT : MAX_NS;
  static constexpr int SMEM = FIXED + NS * (STAGE + 16);   // a stage, its barrier and count
  static constexpr int SLABS = D / SLAB;
  static_assert(D % 128 == 0 && D > 128 && D % GW == 0 && GROUPS % GB == 0,
                "a head of whole groups, a block of whole groups");
  static_assert(NS >= 2 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
};

// A tile's product into the output is left running while the next tile's
// S and dP (or S^T and dP^T) are issued behind it; false: it is waited for
// at once
constexpr bool AHEAD = true;

// dk/dv's output as a type: dK (true) or dV (false)
template <bool DK>
struct Output {
  static constexpr bool value = DK;
};

template <int N>
__device__ __forceinline__ void fence_all(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}

// A block's shared memory: the resident operands' slabs (1024-byte aligned,
// the first operand's then the second's), NS stages (the first streamed
// operand's slabs then the second's), res_full, full[NS], the release counts.
template <int D>
struct Smem {
  using P = Plan<D>;
  unsigned char* res;
  unsigned char* st0;
  uint32_t res_full, full;
  unsigned int* released;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    res = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + ATOM - 1) &
                                           ~(uintptr_t)(ATOM - 1));
    st0 = res + P::RES;
    res_full = smem_addr(st0 + P::NS * P::STAGE);
    full = res_full + 8;
    released = reinterpret_cast<unsigned int*>(st0 + P::NS * P::STAGE + 8 + 8 * P::NS);
  }
  __device__ __forceinline__ void init() const {   // by thread 0, before a __syncthreads
    mbar_init(res_full, 1);
    for (int s = 0; s < P::NS; ++s) {
      mbar_init(full + 8 * s, 1);
      released[2 * s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the resident rows row0 .. row0 + ROWS - 1 of a (and of b, unless null)
  // by one thread, on res_full
  __device__ __forceinline__ void load_resident(const CUtensorMap* a, const CUtensorMap* b,
                                                int row0, int head) const {
    tma::mbar_expect(res_full, b != nullptr ? P::RES : P::RES / 2);
#pragma unroll 1
    for (int c = 0; c < P::SLABS; ++c)
      tma::tma_box(smem_addr(res + c * P::ROWS * SLAB_ROW), a, c * SLAB, row0, head, res_full);
    if (b != nullptr)
#pragma unroll 1
      for (int c = 0; c < P::SLABS; ++c)
        tma::tma_box(smem_addr(res + P::RES / 2 + c * P::ROWS * SLAB_ROW), b, c * SLAB, row0,
                     head, res_full);
  }
  // tile u of the streamed operands (rows u ST ..) into stage u % NS by one
  // thread, on its full barrier (armed with the whole box: rows past N
  // arrive as zeros and count)
  __device__ __forceinline__ void fill(const CUtensorMap* a, const CUtensorMap* b, int u,
                                       int head) const {
    const int s = u % P::NS;
    const uint32_t sa = smem_addr(st0 + s * P::STAGE), sb = sa + P::ST * D * 2;
    tma::mbar_expect(full + 8 * s, P::STAGE);
#pragma unroll 1
    for (int c = 0; c < P::SLABS; ++c)
      tma::tma_box(sa + c * P::ST * SLAB_ROW, a, c * SLAB, u * P::ST, head, full + 8 * s);
#pragma unroll 1
    for (int c = 0; c < P::SLABS; ++c)
      tma::tma_box(sb + c * P::ST * SLAB_ROW, b, c * SLAB, u * P::ST, head, full + 8 * s);
  }
  __device__ __forceinline__ uint32_t stage(int it) const {
    return smem_addr(st0 + (it % P::NS) * P::STAGE);
  }
  // warpgroup wg is done with tile it's stage: its four warps join on a named
  // barrier (each warp's wgmma wait covers its own warp only), then its first
  // thread counts the release; the block's last release refills the stage
  // with the tile NS on
  __device__ __forceinline__ void release(int it, int tiles, int wg, int ctid,
                                          const CUtensorMap* a, const CUtensorMap* b,
                                          int head) const {
    wg_sync(1 + wg);
    const int s = it % P::NS;
    if (ctid == 0 && (P::C == 1 || (atomicAdd(released + 2 * s, 1u) & 1u)) && it + P::NS < tiles)
      fill(a, b, it + P::NS, head);
    __syncwarp();
  }
};

}  // namespace tmab

// dq, bf16, D = 256, 384, 512: a block is (ROWS query rows, GB groups of GW
// output columns) of one head, warpgroup wg its rows 64 (wg % RC) .. and
// group wg / RC of the block's.  Q's and dO's rows
// resident; each key tile's K and V slabs streamed: S = Q K^T, dP = dO V^T
// (both K-major), dS = P (dP - delta) in registers, dQ_g += dS K_g with K's
// group slabs read MN-major (the transpose bit).  Keys past n: S = -inf.
template <int D, typename T>
__global__ void __launch_bounds__(tmab::Plan<D>::THREADS, 1)
flash_bwd_dq_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int n, float scale) {
  using namespace tmab;
  using P = Plan<D>;
  constexpr int GW = P::GW, ST = P::ST;
  static_assert(sizeof(T) == 2, "bf16 operands");
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, rw = wg % P::RC;
  constexpr int blocks = P::GROUPS / P::GB;   // blocks across the head
  const int grp = (blockIdx.x % blocks) * P::GB + wg / P::RC;
  const int q0 = (blockIdx.x / blocks) * P::ROWS;
  const int head = blockIdx.y, tiles = (n + ST - 1) / ST;
  const size_t rbase = (size_t)head * n;
  if (tid == 0) sm.init();
  __syncthreads();
  if (tid == 0) {
    sm.load_resident(&map_q, &map_o, q0, head);
    for (int u = 0; u < P::NS && u < tiles; ++u) sm.fill(&map_k, &map_v, u, head);
  }

  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t qa = smem_addr(sm.res) + rw * 64 * SLAB_ROW, oa = qa + P::RES / 2;
  const float scale2 = scale * LOG2E;
  // rows 16 warp + g + 8h of the warpgroup's: lse log2 e and delta, and
  // the group's columns of dQ in accumulator layout
  float lse2[2], dlt[2], acc[GW / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * rw + 16 * warp + g + 8 * h;
    lse2[h] = r < n ? lse[rbase + r] * LOG2E : 0.f;
    dlt[h] = r < n ? delta[rbase + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  // the tile's S and dP (zeroed here, then written by wgmma alone: the
  // first product of each tile ignores them), and dS rounded to bf16 as
  // register A of dQ's product (kept until that product has landed)
  float s[ST / 2] = {}, dp[ST / 2] = {};
  uint32_t pa[ST / 16][4] = {};
  mbar_wait(sm.res_full, 0);
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * ST;
    const uint32_t kb = sm.stage(it);
    mbar_wait(sm.full + 8 * (it % P::NS), (it / P::NS) & 1);
    tma::issue_s<D, ST, P::ROWS>(s, qa, kb);                  // S = Q K^T
    tma::issue_s<D, ST, P::ROWS>(dp, oa, kb + ST * D * 2);    // dP = dO V^T
    wgmma_wait<1>();   // the tile before's dQ product and this tile's S
    fence_frags(pa);
    fence_all(s);
    if (it > 0) sm.release(it - 1, tiles, wg, ctid, &map_k, &map_v, head);
    float p[ST / 2];   // P, while dP's products run; 0 at keys past n (zeros from TMA)
#pragma unroll
    for (int i = 0; i < ST / 2; ++i)
      p[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) < n
                 ? ex2(fmaf(s[i], scale2, -lse2[(i >> 1) & 1])) : 0.f;
    wgmma_wait<0>();
    fence_all(dp);
#pragma unroll
    for (int i = 0; i < ST / 2; ++i)   // dS = P (dP - delta)
      dp[i] = p[i] * (dp[i] - dlt[(i >> 1) & 1]);
    bf16_frags<ST>(dp, pa);
    tma::issue_pv<GW, ST>(acc, pa, kb + grp * (GW / SLAB) * ST * SLAB_ROW);   // dQ_g += dS K_g
    if constexpr (!AHEAD) wgmma_wait<0>();
  }
  wgmma_wait<0>();
  fence_frags(pa);
  fence_all(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 64 * rw + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    T* row = dq + (rbase + r) * D + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// dk/dv, bf16, D = 256, 384, 512: a block is (ROWS keys, GB groups of GW
// output columns, one output) of one head, warpgroup wg its keys 64 (wg %
// RC) .. and group wg / RC of the block's; blockIdx.x runs over (key block,
// groups, output), the output innermost.  K's (and for dK V's) rows
// resident; each query tile's Q and dO slabs streamed.  Both outputs
// compute S^T = K Q^T and P^T = 2^(S^T scale log2 e - lse log2 e);
// the dV block then dV_g += P^T dO_g, the dK block dP^T = V dO^T, dS^T =
// P^T (dP^T - delta) and dK_g += dS^T Q_g, dO's and Q's group slabs read
// MN-major.  Queries past n: lse +inf, so P^T = 0 (their Q and dO rows are
// zeros from TMA, and lse is not read there).
template <int D, typename T>
__global__ void __launch_bounds__(tmab::Plan<D>::THREADS, 1)
flash_bwd_dkv_tma_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int n, float scale) {
  using namespace tmab;
  using P = Plan<D>;
  constexpr int GW = P::GW, ST = P::ST;
  static_assert(sizeof(T) == 2, "bf16 operands");
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, rw = wg % P::RC;
  constexpr int blocks = P::GROUPS / P::GB;   // blocks across the head, an output
  const bool is_dk = blockIdx.x & 1;
  const int grp = ((blockIdx.x >> 1) % blocks) * P::GB + wg / P::RC;
  const int k0 = ((blockIdx.x >> 1) / blocks) * P::ROWS;
  const int head = blockIdx.y, tiles = (n + ST - 1) / ST;
  const size_t rbase = (size_t)head * n;
  if (tid == 0) sm.init();
  __syncthreads();
  if (tid == 0) {
    sm.load_resident(&map_k, is_dk ? &map_v : nullptr, k0, head);
    for (int u = 0; u < P::NS && u < tiles; ++u) sm.fill(&map_q, &map_o, u, head);
  }

  const int ctid = tid & 127, warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const uint32_t ka = smem_addr(sm.res) + rw * 64 * SLAB_ROW, va = ka + P::RES / 2;
  const float scale2 = scale * LOG2E;
  // keys 16 warp + g + 8h of the warpgroup's: the group's columns of dK or
  // dV in accumulator layout
  float acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  // the block's loop over the query tiles, one for each output (a loop of
  // its own: in one loop with a branch ptxas may lay the dV path's values
  // over dP^T's accumulator and serialise every wgmma)
  auto tiles_loop = [&](auto output) {
    constexpr bool DK = decltype(output)::value;
    // the tile's S^T and dP^T (zeroed here, then written by wgmma alone);
    // P^T (dV) or dS^T (dK) rounded to bf16 as register A of the output's
    // product (kept until that product has landed); lse log2 e and delta of
    // the tile's queries 8j + 2t + e, this thread's columns
    float s[ST / 2] = {}, dp[ST / 2] = {}, l2[ST / 4], dl[ST / 4];
    uint32_t pa[ST / 16][4] = {};
    mbar_wait(sm.res_full, 0);
    for (int it = 0; it < tiles; ++it) {
      const uint32_t qb = sm.stage(it), ob = qb + ST * D * 2;
      const uint32_t group = grp * (GW / SLAB) * ST * SLAB_ROW;   // the group's first slab
#pragma unroll
      for (int j = 0; j < ST / 8; ++j)   // loaded first: they run under the wait
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = it * ST + 8 * j + 2 * t + e;
          l2[2 * j + e] = c < n ? lse[rbase + c] * LOG2E : INFINITY;
          if constexpr (DK) dl[2 * j + e] = c < n ? delta[rbase + c] : 0.f;
        }
      mbar_wait(sm.full + 8 * (it % P::NS), (it / P::NS) & 1);
      // s[4j + 2h + e]: key 16 warp + g + 8h, query 8j + 2t + e of the tile
      tma::issue_s<D, ST, P::ROWS>(s, ka, qb);                   // S^T = K Q^T
      if constexpr (DK) {
        tma::issue_s<D, ST, P::ROWS>(dp, va, ob);                // dP^T = V dO^T
        wgmma_wait<1>();   // the tile before's dK product and this tile's S^T
      } else {
        wgmma_wait<0>();   // the tile before's dV product and this tile's S^T
      }
      fence_frags(pa);
      fence_all(s);
      if (it > 0) sm.release(it - 1, tiles, wg, ctid, &map_q, &map_o, head);
      float p[ST / 2];   // P^T, while dP^T's products run
#pragma unroll
      for (int i = 0; i < ST / 2; ++i) p[i] = ex2(fmaf(s[i], scale2, -l2[2 * (i >> 2) + (i & 1)]));
      if constexpr (DK) {
        wgmma_wait<0>();
        fence_all(dp);
#pragma unroll
        for (int i = 0; i < ST / 2; ++i)   // dS^T = P^T (dP^T - delta)
          dp[i] = p[i] * (dp[i] - dl[2 * (i >> 2) + (i & 1)]);
        bf16_frags<ST>(dp, pa);
        tma::issue_pv<GW, ST>(acc, pa, qb + group);   // dK_g += dS^T Q_g
      } else {
        bf16_frags<ST>(p, pa);
        tma::issue_pv<GW, ST>(acc, pa, ob + group);   // dV_g += P^T dO_g
      }
      if constexpr (!AHEAD) wgmma_wait<0>();
    }
    wgmma_wait<0>();
    fence_frags(pa);
  };
  if (is_dk)
    tiles_loop(Output<true>{});
  else
    tiles_loop(Output<false>{});
  fence_all(acc);
  T* out = is_dk ? dk : dv;
  const float f = is_dk ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 64 * rw + 16 * warp + g + 8 * h;
    if (r >= n) continue;
    T* row = out + (rbase + r) * D + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<T>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * f, acc[4 * j + 2 * h + 1] * f);
  }
}

// ---------------------------------------------------------------------------
// float32 heads of 256, 384 and 512: the backward with the resident operands
// as raw rows (the plan and the roles: the note at the top)
// ---------------------------------------------------------------------------
namespace wqb {

using namespace tc;
using wq::KT;    // streamed rows a tile: keys in dq, queries in dk/dv
using wq::SUB;   // columns an item

constexpr int ROWS = 64;        // rows a block (query rows in dq, keys in dk/dv)
// three warpgroups: S (0), which writes its own items, the output's (1),
// and the producer of the output warpgroup's items (2)
constexpr int THREADS = 384;
constexpr int S_WG = 0, PRODUCER_WG = 2;
// setmaxnreg: a thread starts at 65536 / 384 = 168 registers; the output
// warpgroup (its accumulator of GW / 2) takes what the others give up
constexpr int S_REGS = 136, OUT_REGS = 240, ITEM_REGS = 128;
constexpr int LOAD_AHEAD = 1;   // items a producer keeps loading ahead of the one it writes
constexpr int PAD = 4;          // the resident rows' stride d + 4: a warp's A loads hit 32 banks
constexpr int MAX_NI = 8;       // item stages, at most
// A group's next output product is issued before the one before it is
// waited for (two partials); false: each waited for at once
constexpr bool OUT_AHEAD = false;
// The second operand of dP (dq's dO, dk/dv's V) where it is not resident
// (384, 512): raw items the producer copies (false), or its A fragments
// loaded by the output warpgroup straight from global memory (true)
constexpr bool A_GLOBAL = false;

// The plan at head width D, one for both passes: GW output columns a
// block (the whole head at 256, groups of 256 at 512, of 192 at 384); RES
// resident operands of 64 raw rows at a stride of D + 4 floats (both at
// 256: dq's Q and dO, dk/dv's K and V; at 384 and 512 the first alone);
// two tiles of P handed from the S warpgroup to the output warpgroup (PX
// bytes, four barriers); NI item stages of 16 KB (as many as fit, up to
// MAX_NI: the S warpgroup's own NS, then the output warpgroup's ring) and
// their barriers.  Mirrored by ops/flash_attention.py::backward_plan.
template <int D>
struct Plan {
  static constexpr int C = 2;   // consumer warpgroups: S's and the output's
  static constexpr int GW = D % 256 == 0 ? 256 : 192;
  static constexpr int GROUPS = D / GW;
  static constexpr int NCH = D / SUB;              // chunks of the head
  static constexpr int RES = D == 256 ? 2 : 1;
  static constexpr int LD = D + PAD;
  static constexpr int RES_BYTES = RES * ROWS * LD * 4;
  static constexpr int PX = 2 * ROWS * KT * 4;
  static constexpr int STAGE = KT * SUB * 8;
  static constexpr int FIXED = ALIGN + RES_BYTES + PX + 8 * 4;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (STAGE + 16);
  static constexpr int NI = FIT < MAX_NI ? FIT : MAX_NI;
  static constexpr int NS = 2;   // the S warpgroup's own stages; the output's ring the rest
  static constexpr int SMEM = FIXED + NI * (STAGE + 16);
  // the second operand of dP: resident rows (0), raw items (1), global memory (2)
  static constexpr int MODE = RES == 2 ? 0 : A_GLOBAL ? 2 : 1;
  static constexpr int DP_ITEMS = MODE == 1 ? 2 * NCH : NCH;   // dP's items a tile
  static constexpr int OUT_ITEMS = GW / SUB;                  // the output product's
  static_assert(D % 128 == 0 && D % GW == 0 && GW % SUB == 0, "whole groups and sub-groups");
  static_assert(NI >= 4 && SMEM <= SMEM_LIMIT, "the plan exceeds a block's shared memory");
};

// A block's shared memory: NI item stages, their full and empty barriers,
// P's two slots' full and empty barriers, the slots, then the resident
// rows (the first operand's, then the second's)
template <int D>
struct Smem {
  using P = Plan<D>;
  unsigned char* img0;
  uint32_t full, empty, p_full, p_empty;
  float4* px;
  float* res;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    img0 = wide::aligned_smem(raw);
    full = smem_addr(img0 + P::NI * P::STAGE);
    empty = full + 8 * P::NI;
    p_full = empty + 8 * P::NI;
    p_empty = p_full + 16;
    px = reinterpret_cast<float4*>(img0 + P::NI * (P::STAGE + 16) + 32);
    res = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(px) + P::PX);
  }
  __device__ __forceinline__ void init() const {   // by thread 0, before a __syncthreads
    for (int s = 0; s < P::NI; ++s) {
      mbar_init(full + 8 * s, 128);   // its producer's threads
      mbar_init(empty + 8 * s, 4);    // the warps of the warpgroup that takes the item
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(p_full + 8 * s, 128);
      mbar_init(p_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
};

// A consumer warpgroup's ring: count stages from stage base, its items by
// their place in its order
template <class P>
struct Items {
  unsigned char* img0;
  uint32_t full, empty;
  int base, count;
  __device__ __forceinline__ unsigned char* acquire(int i) const {
    const int si = base + i % count;
    mbar_wait(full + 8 * si, (i / count) & 1);
    return img0 + si * P::STAGE;
  }
  __device__ __forceinline__ void release(int i, int lane) const {   // this warp is done with it
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (base + i % count));
  }
};

// The S warpgroup's items, written by its own threads (no producer, no
// mbarrier): chunk i of its order (tile i / NCH, chunk i % NCH of the
// head's columns of src's tile rows) into stage i % 2, its loads issued a
// chunk ahead, so they run under the chunk before's products; a named
// barrier of the warpgroup (id) orders the writes before wgmma reads them,
// and no warp writes a stage before every warp's products from it, two
// chunks back, have landed (each warp waited for them before it joined the
// barrier of the chunk between)
template <int D>
struct OwnChunks {
  using P = Plan<D>;
  unsigned char* img0;
  const float* src;
  int n, total, ptid, id;
  uint32_t w[wq::WORDS];
  __device__ __forceinline__ void load(int i) {
    if (i >= total) return;
    const int tile = i / P::NCH;
    wq::k_load(w, src + (size_t)tile * KT * D + (i - tile * P::NCH) * SUB, min(KT, n - tile * KT),
               D, ptid);
  }
  __device__ __forceinline__ unsigned char* acquire(int i) {
    unsigned char* stage = img0 + (i & 1) * P::STAGE;
    wq::k_store(stage, w, ptid);
    fence_async();
    wg_sync(id);
    load(i + 1);
    return stage;
  }
  __device__ __forceinline__ void release(int, int) const {}
};

// P's hand-off from the S warpgroup to the output warpgroup, a tile at a
// time in two slots: thread i of either warpgroup holds the same (row,
// column) places of its accumulator, so a slot is 4 float4 a thread
template <int D>
__device__ __forceinline__ void hand_p(const Smem<D>& sm, const float (&p)[KT / 2], int tile,
                                       int ctid) {
  const int slot = tile & 1;
  if (tile >= 2) mbar_wait(sm.p_empty + 8 * slot, ((tile >> 1) + 1) & 1);
  float4* dst = sm.px + slot * (ROWS * KT / 4);
#pragma unroll
  for (int j = 0; j < KT / 8; ++j)
    dst[j * 128 + ctid] = make_float4(p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3]);
  mbar_arrive(sm.p_full + 8 * slot);
}
template <int D>
__device__ __forceinline__ void take_p(const Smem<D>& sm, float (&p)[KT / 2], int tile,
                                       int ctid) {
  const int slot = tile & 1;
  mbar_wait(sm.p_full + 8 * slot, (tile >> 1) & 1);
  const float4* src = sm.px + slot * (ROWS * KT / 4);
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    const float4 x = src[j * 128 + ctid];
    p[4 * j] = x.x;
    p[4 * j + 1] = x.y;
    p[4 * j + 2] = x.z;
    p[4 * j + 3] = x.w;
  }
  mbar_arrive(sm.p_empty + 8 * slot);
}

// A raw item: ROWS rows x SUB columns of the block's rows at src (row
// stride D; zeros from row valid on) as they are, column c of row r at
// float r SUB + (c ^ 4 (r % 8)), so that a warp's A loads hit 32 banks;
// copied by the producer's threads as cp.async of 16 bytes each (no
// register holds them), the stage's full barrier arrived on when they land
template <int D>
__device__ __forceinline__ void a_copy(unsigned char* stage, const float* src, int valid,
                                       int ptid) {
#pragma unroll
  for (int j = 0; j < ROWS * SUB / 4 / 128; ++j) {
    const int u = ptid + 128 * j, r = u / (SUB / 4), c4 = u % (SUB / 4);
    const uint32_t dst = smem_addr(stage + 4 * (r * SUB + ((4 * c4) ^ ((r & 7) << 2))));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src + (r < valid ? (size_t)r * D + 4 * c4 : 0)), "r"(r < valid ? 16 : 0)
                 : "memory");
  }
}

// The TF32 A fragments of one k16 step of the A operand's rows arow, arow
// + 8 (columns k0 + 8 kk + t, + 4), split into halves: MODE 0 raw rows at a
// stride of LDA floats, 1 a raw item (LDA = SUB, swizzled), 2 global memory
// (LDA = D, zeros from row valid on)
template <int MODE, int LDA>
__device__ __forceinline__ void a_frags(uint32_t (&ab)[2][4], uint32_t (&as)[2][4],
                                        const float* a, int k0, int arow, int t, int valid) {
  const int sw = MODE == 1 ? (arow & 7) << 2 : 0;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int c = (k0 + 8 * kk + t) ^ sw;
    const float* p = a + arow * LDA;
    float x[4];
    if constexpr (MODE == 2) {
      x[0] = arow < valid ? __ldg(p + c) : 0.f;
      x[1] = arow + 8 < valid ? __ldg(p + 8 * LDA + c) : 0.f;
      x[2] = arow < valid ? __ldg(p + c + 4) : 0.f;
      x[3] = arow + 8 < valid ? __ldg(p + 8 * LDA + c + 4) : 0.f;
    } else {
      x[0] = p[c];
      x[1] = p[8 * LDA + c];
      x[2] = p[c ^ 4];
      x[3] = p[8 * LDA + (c ^ 4)];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) split<false>(x[e], ab[kk][e], as[kk][e]);
  }
}

// s += the A operand's 64 rows times the B rows of the chunk items (from
// item first on), transposed, over the head (NCH chunks of SUB columns):
// the products of S = Q K^T, dP = dO V^T (dk/dv: S^T = K Q^T, dP^T = V
// dO^T).  A chunk is one K-major B item, with MODE 1 a raw A item before
// it; A's fragments come from the resident rows at a (MODE 0, columns c SUB
// on), the raw item (1) or global memory at a (2).  Three TF32 products a
// k8 step into a zeroed partial a k16 step (two taking turns), carried
// into s; a step is issued before the one before is waited for, the next
// step's fragments load and split while it runs, and a chunk's items are
// released once its last step has landed.  (Its steps run one chunk at a
// time: the next chunk's first step issued before this chunk's last had
// landed made ptxas serialise every wgmma of the kernel, C7514, or, the
// chunks unrolled, spill.)
template <int NCH, int MODE, int LDA, class R>
__device__ __forceinline__ void over_head(float (&s)[KT / 2], R& items, int first,
                                          const float* a, int arow, int t, int valid, int lane) {
  constexpr int IPC = MODE == 1 ? 2 : 1;   // items a chunk
  constexpr int STEPS = SUB / 16;
#pragma unroll 1
  for (int c = 0; c < NCH; ++c) {
    const int i0 = first + c * IPC;
    float part[2][KT / 2] = {};   // zeroed: as ss_product's partials
    uint32_t ab[2][2][4], as[2][2][4];
    const float* ac = MODE == 1 ? reinterpret_cast<const float*>(items.acquire(i0)) : a;
    const uint32_t b = smem_addr(items.acquire(i0 + IPC - 1));
    const int col = MODE == 1 ? 0 : c * SUB;
    a_frags<MODE, LDA>(ab[0], as[0], ac, col, arow, t, valid);
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int x = st & 1;
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) fence_reg(part[x][i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t bk = b + (2 * st + kk) * (KT * 32 * 2);
        mma_rs<KT, float>(part[x], as[x][kk], b_desc(bk), kk);
        mma_rs<KT, float>(part[x], ab[x][kk], b_desc(bk + KT * 32), 1);
        mma_rs<KT, float>(part[x], ab[x][kk], b_desc(bk), 1);
      }
      wgmma_commit();
      if (st > 0) {
        wgmma_wait<1>();   // the step before: its partial, its A registers
        fence_frags(ab[x ^ 1]);
        fence_frags(as[x ^ 1]);
        carry(s, part[x ^ 1]);
      }
      if (st + 1 < STEPS)
        a_frags<MODE, LDA>(ab[x ^ 1], as[x ^ 1], ac, col + 16 * (st + 1), arow, t, valid);
    }
    wgmma_wait<0>();
    fence_frags(ab[(STEPS - 1) & 1]);
    fence_frags(as[(STEPS - 1) & 1]);
    carry(s, part[(STEPS - 1) & 1]);
#pragma unroll
    for (int i = 0; i < IPC; ++i) items.release(i0 + i, lane);
  }
}

// acc (GW columns) += x (P, dS or their transposes: s's TF32 halves as
// register A) times the tile's rows of the group, one transposed sub-group
// item (from item first on) of SUB columns after another, each into a
// zeroed partial carried into its columns; with OUT_AHEAD two partials
// take turns, a sub-group's products issued before the one before is
// waited for
template <int GW, class R>
__device__ __forceinline__ void out_subgroups(float (&acc)[GW / 2], const float (&x)[KT / 2],
                                              const R& items, int first, int lane) {
  constexpr int H = GW / SUB;
  uint32_t big[KT / 8][4], sm[KT / 8][4];
  tf32_frags<KT>(x, big, sm);
  float part[2][SUB / 2] = {};
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int y = OUT_AHEAD ? h & 1 : 0;
    const uint32_t b = smem_addr(items.acquire(first + h));
#pragma unroll
    for (int i = 0; i < SUB / 2; ++i) fence_reg(part[y][i]);
    wgmma_fence();
    rs_tf32<SUB, KT, SUB>(part[y], big, sm, b, 0);
    wgmma_commit();
    if (!OUT_AHEAD || h > 0) {
      const int done = OUT_AHEAD ? h - 1 : h, py = OUT_AHEAD ? done & 1 : 0;   // landed
      if constexpr (OUT_AHEAD)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < SUB / 2; ++i) {
        fence_reg(part[py][i]);
        acc[done * (SUB / 2) + i] += part[py][i];
      }
      items.release(first + done, lane);
    }
  }
  if constexpr (OUT_AHEAD) {
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < SUB / 2; ++i) {
      fence_reg(part[(H - 1) & 1][i]);
      acc[(H - 1) * (SUB / 2) + i] += part[(H - 1) & 1][i];
    }
    items.release(first + H - 1, lane);
  }
  fence_frags(big);
  fence_frags(sm);
}

// a consumer warpgroup's resident rows, once (zeros past n): rows row0 ..
// of src at res, then its named barrier id
template <int D>
__device__ __forceinline__ void load_resident(float* res, const float* src, int row0, int n,
                                              int ctid, int id) {
  constexpr int C4 = D / 4, LD = D + PAD;
#pragma unroll 1
  for (int u = ctid; u < ROWS * C4; u += 128) {
    const int r = u / C4, c4 = u % C4;
    const float4 x = row0 + r < n
                         ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D) + c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(res + r * LD + 4 * c4) = x;
  }
  wg_sync(id);
}

// A producer warpgroup's ring: count stages from stage base, items 0 ..
// items - 1 of its consumer's order; the data of the LOAD_AHEAD items
// after item i loaded into registers (load(i, w)) while item i is written
// (store(i, w, stage)), each released as soon as written, or for a raw
// item (store returns true) once its copies land
template <int D, class Load, class Store>
__device__ __forceinline__ void produce_ring(const Smem<D>& sm, int base, int count, int items,
                                             Load load, Store store) {
  constexpr int NB = LOAD_AHEAD + 1;
  uint32_t buf[NB][wq::WORDS];
#pragma unroll
  for (int x = 0; x < LOAD_AHEAD; ++x)
    if (x < items) load(x, buf[x]);
#pragma unroll 1
  for (int i0 = 0; i0 < items; i0 += NB) {
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      const int i = i0 + x;
      if (i >= items) break;
      if (i + LOAD_AHEAD < items) load(i + LOAD_AHEAD, buf[(x + LOAD_AHEAD) % NB]);
      const int si = base + i % count, round = i / count;
      if (round > 0) mbar_wait(sm.empty + 8 * si, (round + 1) & 1);
      if (store(i, buf[x], sm.img0 + si * Plan<D>::STAGE)) {
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(sm.full + 8 * si)
                     : "memory");
      } else {
        fence_async();
        mbar_arrive(sm.full + 8 * si);
      }
    }
  }
}

// The producer of the output warpgroup's items (ptid: its thread's rank):
// each tile's chunks of dp_b (each after dp_a's raw chunk where it
// streams; dp_b null: no dP), then the GW / SUB sub-groups of out_b
// transposed, into the stages after the S warpgroup's.  B rows: the
// tile's, from row base on; raw rows: the block's, from a_rows on (a_valid
// of them real).
template <int D>
__device__ __forceinline__ void produce_items(const Smem<D>& sm, int tiles, int n, size_t base,
                                              size_t a_rows, int a_valid, const float* dp_a,
                                              const float* dp_b, const float* out_b, int grp,
                                              int ptid) {
  using P = Plan<D>;
  const auto tile_rows = [&](int tile) { return base + (size_t)tile * KT * D; };
  const auto valid = [&](int tile) { return min(KT, n - tile * KT); };
  const int dp_items = dp_b != nullptr ? P::DP_ITEMS : 0, per_tile = dp_items + P::OUT_ITEMS;
  // item j of a tile: 0 a K-major chunk, 1 a raw chunk, 2 a transposed
  // sub-group; and its columns' first
  const auto kind = [&](int j, int& col) {
    if (j >= dp_items) {
      col = grp * P::GW + (j - dp_items) * SUB;
      return 2;
    }
    col = (P::MODE == 1 ? j >> 1 : j) * SUB;
    return P::MODE == 1 && (j & 1) == 0 ? 1 : 0;
  };
  produce_ring<D>(
      sm, P::NS, P::NI - P::NS, tiles * per_tile,
      [&](int i, uint32_t (&w)[wq::WORDS]) {
        const int tile = i / per_tile;
        int col;
        const int k = kind(i - tile * per_tile, col);
        if (k == 0) wq::k_load(w, dp_b + tile_rows(tile) + col, valid(tile), D, ptid);
        if (k == 2) wq::v_load(w, out_b + tile_rows(tile) + col, valid(tile), D, ptid);
      },
      [&](int i, const uint32_t (&w)[wq::WORDS], unsigned char* stage) {
        int col;
        const int k = kind(i % per_tile, col);
        if (k == 0) wq::k_store(stage, w, ptid);
        if (k == 2) wq::v_store(stage, w, ptid);
        if (k == 1) a_copy<D>(stage, dp_a + a_rows + col, a_valid, ptid);
        return k == 1;
      });
}

}  // namespace wqb

// dq, float32, D = 256, 384, 512: a block is (64 query rows, group of GW
// output columns) of one head and three warpgroups.  The S warpgroup loads
// Q's rows once, writes each key tile's D / 64 chunks of K itself and
// computes S = Q K^T and P = 2^(S scale log2 e - lse log2 e) (keys past n:
// S = -inf), handing P over; the producer writes the output warpgroup's
// items, a tile's chunks of V (each after dO's raw chunk where dO is not
// resident), then its GW / 64 sub-groups of K transposed; the output
// warpgroup loads dO's rows where both fit and computes dP = dO V^T, dS = P
// (dP - delta) and dQ_g += dS K_g, while the S warpgroup goes on to the
// next tile.
template <int D>
__global__ void __launch_bounds__(wqb::THREADS, 1)
flash_bwd_dq_wq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dq, int n, float scale) {
  using namespace wqb;
  using P = Plan<D>;
  constexpr int GW = P::GW, LD = P::LD;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, ctid = tid & 127;
  const int grp = blockIdx.x % P::GROUPS, q0 = (blockIdx.x / P::GROUPS) * ROWS;
  const size_t base = (size_t)blockIdx.y * n * D, rbase = (size_t)blockIdx.y * n;
  const int tiles = (n + KT - 1) / KT, qvalid = min(ROWS, n - q0);
  if (tid == 0) sm.init();
  __syncthreads();

  if (wg == PRODUCER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(ITEM_REGS));
    produce_items<D>(sm, tiles, n, base, base + (size_t)q0 * D, qvalid, dout, v, k, grp, ctid);
    return;
  }
  const int warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3, arow = 16 * warp + g;
  constexpr int OUT_TILE = P::DP_ITEMS + P::OUT_ITEMS;   // the output warpgroup's items a tile
  if (wg == S_WG) {   // S and P, K's chunks written by its own threads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S_REGS));
    OwnChunks<D> items{sm.img0, k + base, n, tiles * P::NCH, ctid, 2};
    items.load(0);
    load_resident<D>(sm.res, q + base, q0, n, ctid, 2);
    const float scale2 = scale * LOG2E;
    float lse2[2];   // rows 16 warp + g + 8h
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + arow + 8 * h;
      lse2[h] = r < n ? lse[rbase + r] * LOG2E : 0.f;
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * KT;
      float s[KT / 2] = {};
      over_head<P::NCH, 0, LD>(s, items, tile * P::NCH, sm.res, arow, t, ROWS, lane);   // S
      if (k0 + KT > n) {   // keys past n: P = 0
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] = ex2(fmaf(s[i], scale2, -lse2[(i >> 1) & 1]));
      hand_p<D>(sm, s, tile, ctid);
    }
    return;
  }

  // the output warpgroup: dP, dS, dQ_g
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(OUT_REGS));
  Items<P> items{sm.img0, sm.full, sm.empty, P::NS, P::NI - P::NS};
  if constexpr (P::RES == 2) load_resident<D>(sm.res + ROWS * LD, dout + base, q0, n, ctid, 3);
  // rows 16 warp + g + 8h: delta, and the group's columns of dQ in
  // accumulator layout
  float dlt[2], acc[GW / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + arow + 8 * h;
    dlt[h] = r < n ? delta[rbase + r] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  const float* dp_a = P::MODE == 0 ? sm.res + ROWS * LD : dout + base + (size_t)q0 * D;
  constexpr int DP_LD = P::MODE == 0 ? LD : P::MODE == 1 ? SUB : D;
  for (int tile = 0; tile < tiles; ++tile) {
    float dp[KT / 2] = {}, p[KT / 2];
    over_head<P::NCH, P::MODE, DP_LD>(dp, items, tile * OUT_TILE, dp_a, arow, t, qvalid,
                                      lane);                             // dP = dO V^T
    take_p<D>(sm, p, tile, ctid);
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) dp[i] = p[i] * (dp[i] - dlt[(i >> 1) & 1]);   // dS
    out_subgroups<GW>(acc, dp, items, tile * OUT_TILE + P::DP_ITEMS, lane);   // dQ_g += dS K_g
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + arow + 8 * h;
    if (r >= n) continue;
    float* row = dq + (rbase + r) * D + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<float>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
  }
}

// dk/dv, float32, D = 256, 384, 512: a block is (64 keys, group of GW
// output columns, one output) of one head and three warpgroups;
// blockIdx.x runs over (key block, group, output), the output innermost.
// The S warpgroup loads K's rows once, writes each query tile's chunks of
// Q itself and computes S^T = K Q^T and P^T = 2^(S^T scale log2 e - lse
// log2 e), handing P^T over; the producer writes the output warpgroup's
// items, for dK a tile's chunks of dO (each after V's raw chunk where V is
// not resident), then the sub-groups of dO (dV) or Q (dK) transposed; the
// output warpgroup computes dV_g += P^T dO_g, or (loading V's rows where
// both fit) dP^T = V dO^T, dS^T = P^T (dP^T - delta) and dK_g += dS^T Q_g.
// Queries past n: lse +inf (P^T = 0) and delta 0, loaded by the
// warpgroups' threads before each tile's first wait.
template <int D>
__global__ void __launch_bounds__(wqb::THREADS, 1)
flash_bwd_dkv_wq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int n, float scale) {
  using namespace wqb;
  using P = Plan<D>;
  constexpr int GW = P::GW, LD = P::LD;
  extern __shared__ unsigned char smem_raw[];
  const Smem<D> sm(smem_raw);
  const int tid = threadIdx.x, wg = tid >> 7, ctid = tid & 127;
  const bool is_dk = blockIdx.x & 1;
  const int grp = (blockIdx.x >> 1) % P::GROUPS, k0 = ((blockIdx.x >> 1) / P::GROUPS) * ROWS;
  const size_t base = (size_t)blockIdx.y * n * D, rbase = (size_t)blockIdx.y * n;
  const int tiles = (n + KT - 1) / KT, kvalid = min(ROWS, n - k0);
  const int dp_items = is_dk ? P::DP_ITEMS : 0, per_tile = P::NCH + dp_items + P::OUT_ITEMS;
  if (tid == 0) sm.init();
  __syncthreads();

  if (wg == PRODUCER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(ITEM_REGS));
    produce_items<D>(sm, tiles, n, base, base + (size_t)k0 * D, kvalid, v,
                     is_dk ? dout : nullptr, is_dk ? q : dout, grp, ctid);
    return;
  }
  const int warp = ctid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3, arow = 16 * warp + g;
  if (wg == S_WG) {   // S^T and P^T, Q's chunks written by its own threads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S_REGS));
    OwnChunks<D> items{sm.img0, q + base, n, tiles * P::NCH, ctid, 2};
    items.load(0);
    load_resident<D>(sm.res, k + base, k0, n, ctid, 2);
    const float scale2 = scale * LOG2E;
    for (int tile = 0; tile < tiles; ++tile) {
      // lse log2 e of the tile's queries 8j + 2t + e, this thread's
      // columns, loaded first: they run under the first wait
      float l2[KT / 4];
#pragma unroll
      for (int j = 0; j < KT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = tile * KT + 8 * j + 2 * t + e;
          l2[2 * j + e] = c < n ? lse[rbase + c] * LOG2E : INFINITY;
        }
      // s[4j + 2h + e]: key 16 warp + g + 8h, query 8j + 2t + e of the tile
      float s[KT / 2] = {};
      over_head<P::NCH, 0, LD>(s, items, tile * P::NCH, sm.res, arow, t, ROWS, lane);   // S^T
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] = ex2(fmaf(s[i], scale2, -l2[2 * (i >> 2) + (i & 1)]));
      hand_p<D>(sm, s, tile, ctid);
    }
    return;
  }

  // the output warpgroup: dV_g, or dP^T, dS^T and dK_g
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(OUT_REGS));
  Items<P> items{sm.img0, sm.full, sm.empty, P::NS, P::NI - P::NS};
  const int out_tile = per_tile - P::NCH;   // the output warpgroup's items a tile
  if constexpr (P::RES == 2)
    if (is_dk) load_resident<D>(sm.res + ROWS * LD, v + base, k0, n, ctid, 3);
  // keys 16 warp + g + 8h: the group's columns of dK or dV in accumulator
  // layout
  float acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  const float* dp_a = P::MODE == 0 ? sm.res + ROWS * LD : v + base + (size_t)k0 * D;
  constexpr int DP_LD = P::MODE == 0 ? LD : P::MODE == 1 ? SUB : D;
  // the block's loop over the query tiles, one for each output (a loop of
  // its own: tmab's lesson, ptxas serialises the wgmma of one loop with a
  // branch on the output)
  auto tiles_loop = [&](auto output) {
    constexpr bool DK = decltype(output)::value;
    for (int tile = 0; tile < tiles; ++tile) {
      float p[KT / 2];
      if constexpr (DK) {
        float dl[KT / 4];   // delta of the tile's queries, this thread's columns
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = tile * KT + 8 * j + 2 * t + e;
            dl[2 * j + e] = c < n ? delta[rbase + c] : 0.f;
          }
        float dp[KT / 2] = {};
        over_head<P::NCH, P::MODE, DP_LD>(dp, items, tile * out_tile, dp_a, arow, t, kvalid,
                                          lane);                         // dP^T = V dO^T
        take_p<D>(sm, p, tile, ctid);
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)   // dS^T = P^T (dP^T - delta)
          dp[i] = p[i] * (dp[i] - dl[2 * (i >> 2) + (i & 1)]);
        out_subgroups<GW>(acc, dp, items, tile * out_tile + P::DP_ITEMS, lane);   // dK_g
      } else {
        take_p<D>(sm, p, tile, ctid);
        out_subgroups<GW>(acc, p, items, tile * out_tile, lane);   // dV_g += P^T dO_g
      }
    }
  };
  if (is_dk)
    tiles_loop(tmab::Output<true>{});
  else
    tiles_loop(tmab::Output<false>{});
  float* out = is_dk ? dk : dv;
  const float f = is_dk ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + arow + 8 * h;
    if (r >= n) continue;
    float* row = out + (rbase + r) * D + grp * GW;
#pragma unroll
    for (int j = 0; j < GW / 8; ++j)
      store2<float>(row + 8 * j + 2 * t, acc[4 * j + 2 * h] * f, acc[4 * j + 2 * h + 1] * f);
  }
}

// ---------------------------------------------------------------------------
// launchers: one instantiation per (D, type), and per type above 128
// ---------------------------------------------------------------------------
// the operands' rows move as 16-byte chunks and bulk copies
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
  plan[2] = P::NI;
  plan[3] = P::SMEM;
  return 0;
}

// the backward's plans of one (D, type): dq's, then dk/dv's, each {rows a
// block, consumer warpgroups, streamed rows a tile, raw stages, image
// stages, dynamic shared-memory bytes}
template <class P>
void plan_of(int* plan) {
  plan[0] = P::ROWS;
  plan[1] = P::C;
  plan[2] = P::ST;
  plan[3] = P::NR;
  plan[4] = P::NI;
  plan[5] = P::SMEM;
}
template <int D, typename T>
int plan_bwd(int* plan) {
  plan_of<bwd::Plan<D, T, false>>(plan);
  plan_of<bwd::Plan<D, T, true>>(plan + 6);
  return 0;
}

// the backward: one block per (head, ROWS rows)
template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, int bh, int n, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = bwd::Plan<D, T, false>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D, T>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + P::ROWS - 1) / P::ROWS), (unsigned)bh);
  flash_bwd_dq_kernel<D, T><<<grid, P::THREADS, P::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, n, scale);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int bh, int n, float scale,
               cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = bwd::Plan<D, T, true>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D, T>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + P::ROWS - 1) / P::ROWS), (unsigned)bh);
  flash_bwd_dkv_kernel<D, T><<<grid, P::THREADS, P::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, n,
      scale);
  return (int)cudaGetLastError();
}

// float32 at D <= 512: one block per (head, 64 rows, group of GW), Q
// resident
template <int GW>
int launch_fwd_wq(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int n, int d, float scale, cudaStream_t stream) {
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_wq_kernel<GW>, wq::Plan::smem(wq::MAX_D), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + wq::ROWS - 1) / wq::ROWS) * (d / GW)), (unsigned)bh);
  flash_fwd_wq_kernel<GW><<<grid, wq::THREADS, wq::Plan::smem(d), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, n, d, scale);
  return (int)cudaGetLastError();
}

// above 128: one block per (head, 64 rows, column group of 128); float32
// up to 512 the forward with Q resident, in groups of 256 where they
// divide d
template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                    int n, int d, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
  if (sizeof(T) == 4 && d <= wq::MAX_D)
    return d % 256 == 0 ? launch_fwd_wq<256>(q, k, v, out, lse, bh, n, d, scale, stream)
                        : launch_fwd_wq<128>(q, k, v, out, lse, bh, n, d, scale, stream);
  using P = wide::Plan<T, wide::FWD>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_wide_kernel<wide::G, T>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + P::ROWS - 1) / P::ROWS) * (d / wide::G)), (unsigned)bh);
  flash_fwd_wide_kernel<wide::G, T><<<grid, wide::THREADS, P::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, n, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = wide::Plan<T, wide::DQ>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_wide_kernel<wide::G, T>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + P::ROWS - 1) / P::ROWS) * (d / wide::G)), (unsigned)bh);
  flash_bwd_dq_wide_kernel<wide::G, T><<<grid, wide::THREADS, P::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dq, n, d, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                    int d, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = wide::Plan<T, wide::DKV>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_wide_kernel<wide::G, T>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + P::ROWS - 1) / P::ROWS) * (d / wide::G)), (unsigned)bh);
  flash_bwd_dkv_wide_kernel<wide::G, T><<<grid, wide::THREADS, P::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, n, d,
      scale);
  return (int)cudaGetLastError();
}

// A (BH, N, D) bf16 tensor as a 3-D tensor map (columns, rows, heads) of
// boxes of 64 columns by rows of one head, in the 128-byte swizzle; rows
// past N come as zeros (hopper.cuh::encode_tiled)
inline int head_map(CUtensorMap* map, const void* base, int bh, int n, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  const cuuint64_t stride[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)tma::SLAB, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dim, stride, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// bf16 at D = 256, 384, 512: one block per (head, 128 rows, group of GW)
template <int D>
int launch_fwd_tma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int n, float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, out)) return (int)cudaErrorMisalignedAddress;
  using P = tma::Plan<D>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_fwd_tma_kernel<D, __nv_bfloat16>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_v;
  int bad = head_map(&map_q, q, bh, n, D, tma::ROWS);
  if (bad == 0) bad = head_map(&map_k, k, bh, n, D, P::KT);
  if (bad == 0) bad = head_map(&map_v, v, bh, n, D, P::KT);
  if (bad != 0) return bad;
  const dim3 grid((unsigned)(((n + tma::ROWS - 1) / tma::ROWS) * (D / P::GW)), (unsigned)bh);
  flash_fwd_tma_kernel<D, __nv_bfloat16><<<grid, tma::THREADS, P::SMEM, stream>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)out, lse, n, scale);
  return (int)cudaGetLastError();
}

// the bf16 backward at D = 256, 384, 512: dq one block per (head, ROWS
// query rows, GB groups of GW); dk/dv one per (head, ROWS keys, GB groups,
// output)
template <int D>
int launch_dq_tma(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int bh, int n, float scale,
                  cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = tmab::Plan<D>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_tma_kernel<D, __nv_bfloat16>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_v, map_o;
  int bad = head_map(&map_q, q, bh, n, D, P::ROWS);
  if (bad == 0) bad = head_map(&map_o, dout, bh, n, D, P::ROWS);
  if (bad == 0) bad = head_map(&map_k, k, bh, n, D, P::ST);
  if (bad == 0) bad = head_map(&map_v, v, bh, n, D, P::ST);
  if (bad != 0) return bad;
  const dim3 grid((unsigned)(((n + P::ROWS - 1) / P::ROWS) * (P::GROUPS / P::GB)),
                  (unsigned)bh);
  flash_bwd_dq_tma_kernel<D, __nv_bfloat16><<<grid, P::THREADS, P::SMEM, stream>>>(
      map_q, map_k, map_v, map_o, lse, delta, (__nv_bfloat16*)dq, n, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_tma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                   float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = tmab::Plan<D>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_tma_kernel<D, __nv_bfloat16>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_q, map_k, map_v, map_o;
  int bad = head_map(&map_k, k, bh, n, D, P::ROWS);
  if (bad == 0) bad = head_map(&map_v, v, bh, n, D, P::ROWS);
  if (bad == 0) bad = head_map(&map_q, q, bh, n, D, P::ST);
  if (bad == 0) bad = head_map(&map_o, dout, bh, n, D, P::ST);
  if (bad != 0) return bad;
  const dim3 grid((unsigned)(((n + P::ROWS - 1) / P::ROWS) * (P::GROUPS / P::GB) * 2),
                  (unsigned)bh);
  flash_bwd_dkv_tma_kernel<D, __nv_bfloat16><<<grid, P::THREADS, P::SMEM, stream>>>(
      map_q, map_k, map_v, map_o, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n,
      scale);
  return (int)cudaGetLastError();
}

// the float32 backward at D = 256, 384, 512: dq one block per (head, 64
// query rows, group of GW); dk/dv one per (head, 64 keys, group, output)
template <int D>
int launch_dq_wqb(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dq, int bh, int n, float scale,
                  cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = wqb::Plan<D>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dq_wq_kernel<D>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + wqb::ROWS - 1) / wqb::ROWS) * P::GROUPS), (unsigned)bh);
  flash_bwd_dq_wq_kernel<D><<<grid, wqb::THREADS, P::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, n, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wqb(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                   float scale, cudaStream_t stream) {
  if (!aligned16(q, k, v, dout)) return (int)cudaErrorMisalignedAddress;
  using P = wqb::Plan<D>;
  static unsigned long long done = 0;
  cudaError_t err = allow_smem(flash_bwd_dkv_wq_kernel<D>, P::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((n + wqb::ROWS - 1) / wqb::ROWS) * P::GROUPS * 2), (unsigned)bh);
  flash_bwd_dkv_wq_kernel<D><<<grid, wqb::THREADS, P::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, n, scale);
  return (int)cudaGetLastError();
}

// at d = 256, 384, 512 in one type (0 float32, 1 bf16): the bf16 forward
// and backward on TMA, the float32 backward with its resident rows; other
// widths go on to the column-group kernels (above 512 a resident block of
// rows no longer fits beside the stages)
#define WIDTH_DISPATCH(TYPE, LAUNCH, ...)                 \
  if (dtype == TYPE) switch (d) {                         \
      case 256: return LAUNCH<256>(__VA_ARGS__);          \
      case 384: return LAUNCH<384>(__VA_ARGS__);          \
      case 512: return LAUNCH<512>(__VA_ARGS__);          \
      default: break;                                     \
    }

// the plans above 128 (one a type: d is an argument of the kernels), as
// plan_fwd and plan_bwd give them
template <typename T>
int plan_fwd_wide(int* plan, int d) {
  using P = wide::Plan<T, wide::FWD>;
  const bool resident = sizeof(T) == 4 && d <= wq::MAX_D;   // the forward with Q resident
  plan[0] = resident ? wq::KT : P::ST;
  plan[1] = 0;
  plan[2] = resident ? wq::Plan::NI : P::NI;
  plan[3] = resident ? wq::Plan::smem(d) : P::SMEM;
  return 0;
}
// the TMA forward's: {keys a tile, stages (raw: TMA writes the operands
// wgmma reads), no image stage, shared-memory bytes}
template <int D>
int plan_fwd_tma(int* plan) {
  using P = tma::Plan<D>;
  plan[0] = P::KT;
  plan[1] = P::NS;
  plan[2] = 0;
  plan[3] = P::SMEM;
  return 0;
}
// the TMA backward's, both passes the same: {rows a block, consumer
// warpgroups, streamed rows a tile, stages (raw: TMA writes the operands
// wgmma reads), no image stage, shared-memory bytes}
template <int D>
int plan_bwd_tma(int* plan) {
  using P = tmab::Plan<D>;
  for (int i = 0; i < 12; i += 6) {
    plan[i] = P::ROWS;
    plan[i + 1] = P::C;
    plan[i + 2] = P::ST;
    plan[i + 3] = P::NS;
    plan[i + 4] = 0;
    plan[i + 5] = P::SMEM;
  }
  return 0;
}
// the float32 backward's with the resident rows, both passes the same:
// {rows a block, consumer warpgroups, streamed rows a tile, no raw stage,
// item stages, shared-memory bytes}
template <int D>
int plan_bwd_wqb(int* plan) {
  using P = wqb::Plan<D>;
  for (int i = 0; i < 12; i += 6) {
    plan[i] = wqb::ROWS;
    plan[i + 1] = P::C;
    plan[i + 2] = wqb::KT;
    plan[i + 3] = 0;
    plan[i + 4] = P::NI;
    plan[i + 5] = P::SMEM;
  }
  return 0;
}
template <typename T>
int plan_bwd_wide(int* plan) {
  plan_of<wide::Plan<T, wide::DQ>>(plan);
  plan_of<wide::Plan<T, wide::DKV>>(plan + 6);
  return 0;
}

// dtype: 0 float32, 1 bfloat16; d: 32, 64, or a multiple of 128 (above 128
// the column-group kernels)
bool args_ok(int bh, int n, int d, int dtype) {
  return bh > 0 && bh <= 65535 && n > 0 && (d == 32 || d == 64 || (d > 0 && d % 128 == 0)) &&
         (dtype == 0 || dtype == 1) && (long long)((n + 63) / 64) * (d / 128) < (1ll << 31);
}

// above 128: the column-group instantiation of the type
#define WIDE_DISPATCH(LAUNCH, ...)                                                   \
  if (d > 128)                                                                       \
    return dtype == 0 ? LAUNCH<float>(__VA_ARGS__) : LAUNCH<__nv_bfloat16>(__VA_ARGS__);

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
  WIDTH_DISPATCH(1, launch_fwd_tma, q, k, v, out, lse, bh, n, scale, (cudaStream_t)stream)
  WIDE_DISPATCH(launch_fwd_wide, q, k, v, out, lse, bh, n, d, scale, (cudaStream_t)stream)
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, n, scale, (cudaStream_t)stream)
}

// the forward's plan at head width d and dtype (0 float32, 1 bfloat16):
// plan[4] = {keys a tile, raw stages, image stages, shared-memory bytes}
int flash_forward_plan(int d, int dtype, int* plan) {
  if (!args_ok(1, 1, d, dtype)) return (int)cudaErrorInvalidValue;
  WIDTH_DISPATCH(1, plan_fwd_tma, plan)
  WIDE_DISPATCH(plan_fwd_wide, plan, d)
  FLASH_DISPATCH(plan_fwd, plan)
}

// the backward's plans at head width d and dtype: plan[12], dq's six
// numbers then dk/dv's, each {rows a block, consumer warpgroups, streamed
// rows a tile, raw stages, image stages, shared-memory bytes}
int flash_backward_plan(int d, int dtype, int* plan) {
  if (!args_ok(1, 1, d, dtype)) return (int)cudaErrorInvalidValue;
  WIDTH_DISPATCH(1, plan_bwd_tma, plan)
  WIDTH_DISPATCH(0, plan_bwd_wqb, plan)
  WIDE_DISPATCH(plan_bwd_wide, plan)
  FLASH_DISPATCH(plan_bwd, plan)
}

int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, int bh, int n, int d,
                 int dtype, float scale, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  WIDTH_DISPATCH(1, launch_dq_tma, q, k, v, dout, lse, delta, dq, bh, n, scale,
                 (cudaStream_t)stream)
  WIDTH_DISPATCH(0, launch_dq_wqb, q, k, v, dout, lse, delta, dq, bh, n, scale,
                 (cudaStream_t)stream)
  WIDE_DISPATCH(launch_dq_wide, q, k, v, dout, lse, delta, dq, bh, n, d, scale,
                (cudaStream_t)stream)
  FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, n, scale, (cudaStream_t)stream)
}

int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv, int bh, int n,
                  int d, int dtype, float scale, void* stream) {
  if (!args_ok(bh, n, d, dtype)) return (int)cudaErrorInvalidValue;
  WIDTH_DISPATCH(1, launch_dkv_tma, q, k, v, dout, lse, delta, dk, dv, bh, n, scale,
                 (cudaStream_t)stream)
  WIDTH_DISPATCH(0, launch_dkv_wqb, q, k, v, dout, lse, delta, dk, dv, bh, n, scale,
                 (cudaStream_t)stream)
  WIDE_DISPATCH(launch_dkv_wide, q, k, v, dout, lse, delta, dk, dv, bh, n, d, scale,
                (cudaStream_t)stream)
  FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, n, scale,
                 (cudaStream_t)stream)
}

}  // extern "C"
