// Fused edge-encoder tower (K7), forward and backward, for Hopper (sm_90a).
//
// For single-channel images x [B, H, W] (H, W even), filters w [5, 5, 1, C]
// (HWIO) and bias [C]:
//   z[b, y, x, c] = sum_{ky,kx} w[ky, kx, c] * x[b, y+ky-2, x+kx-2]
//                   (5x5 SAME cross-correlation, zero padding 2)
//   out[b, c]     = mean_{i < H/2, j < W/2}
//                   relu(max_{dy,dx in {0,1}} z[b, 2i+dy, 2j+dx, c] + bias[c])
// The [B, H, W, C] activation is never written: the forward pools its
// conv outputs in registers and adds the pooled values to per-channel sums.
// The backward recomputes the conv from the images and sends dout[b, c] /
// ((H/2)(W/2)) of each pooled pixel to one conv output, with the TPU kernel's tie rule:
// horizontally on the pre-bias conv value the even column wins ties
// (ze >= zo), vertically on the ReLU'd value the top row wins (top >= bot),
// and only where the winner's pre-activation is > 0.  It returns dW [25, C]
// (the HWIO layout flattened) and db [C]; the images get no gradient.
//
// Replaces the TPU kernels fashionvisualexpl_tpu/ops/edge_tower.py::
// _fwd_kernel and ::_bwd_kernel (behind edge_tower_gap); the wrappers, the
// plain PyTorch version, the autograd Function and the launch counts are in
// fashionvisualexpl_tpu_torch/ops/edge_tower.py.
//
// What bounds it: operations.  A conv output needs one FMA per tap inside
// the image, (5H-6)(5W-6) per channel and image: 2*154^2*C*B operations,
// 24.9 GFLOP at B=8192, 32x32, C=64, against ~36 MB of images and outputs
// (0.011 ms at 3.35 TB/s).  The forward runs them on the tensor cores:
// 0.025 ms at 989 TFLOP/s bf16 (0.37 ms at the 67 TFLOP/s f32 rate of the
// CUDA cores, which bounded the first design); it issues 12 k16 steps per
// 64 channels and 64 conv pixels, 206 GFLOP at that shape (0.21 ms at
// peak).  The f32 backward recomputes the conv in f32 FMAs on the CUDA cores
// (0.37 ms) and adds one FMA per valid tap of each winning conv output
// whose pre-activation is > 0 (dW), which it runs on the tensor cores as
// three exact bf16 products (0.014 ms at that shape): the recomputed conv
// bounds it.  The kernels themselves run all 25 taps on the zero halo.
//
// Forward (the conv as wgmma products; f32-accurate from exact bf16
// pieces).  The TPU kernel turned the conv into banded matmuls for the MXU
// and kept whole images in VMEM; here it is an implicit GEMM: M = the 64
// channels of a block (blockIdx.y picks the group; rows past C are zero
// weights), N = 64 conv pixels, K = the taps.
// * Arithmetic.  Weights and pixels split into their exact three bf16
//   pieces (mma.cuh::split3_bf16x2): w = wh + wm + wl, x = xh + xm + xl.
//   The six products whose piece orders sum to at most 2 are kept, each
//   exact on the tensor cores: wh.xh into one accumulator (2 k16 steps:
//   the 25 taps zero-padded to 32) and wm.xh, wl.xh, wh.xm, wm.xm, wh.xl
//   into another (10 steps), added in f32 in the epilogue, so that only
//   the large sum's own additions round at its scale.
// * Layout (the segmax arrangement).  A is the weights, in registers for
//   the block's life: each warp's 16 channels, three pieces x 2 steps, 24
//   registers a thread.  B is an im2col tile in shared memory, K-major
//   without swizzle: 8x8 core matrices, k-group kg (taps 8 (kg % 4) .. of
//   piece kg / 4: hi, mid, lo) 1024 bytes apart (LBO), pixel groups of 8
//   128 bytes apart (SBO).  K is piece-major (each image piece's 25 taps
//   padded to 32) rather than the 125 cross products packed into 128:
//   the three products that read xh and the two that read xm share its
//   columns, so the tile is 12 KB and not 20 and the weights take 24
//   registers and not 40, for 12 k16 steps instead of 10.
// * Tiles (the f32 forward's; the bf16 backward walks them too).  A block
//   (one warpgroup) takes an item: one image's tile of up to 16 pooled
//   rows by Cw pooled columns (a multiple of 16, at most 64),
//   so any even W runs.  It stages the tile's input rows with a halo of 2
//   (zero outside the image) as three bf16 planes, rows padded to 16..48
//   mod 64 entries so a warp's reads fall on distinct banks, then walks its
//   N tiles of 16 pooled columns of one pooled row: pixel n = 16j + 8r +
//   2t + e is column 2t + e of pool window 4j + t in its top (r = 0) or
//   bottom row.  Each thread writes one pixel's row of six k-groups (2-byte
//   reads of the planes, one 16-byte store each), double-buffered: the
//   warpgroup writes tile n + 1 while the tensor cores read tile n, then
//   waits for them.
// * Pooling in registers.  wgmma's accumulator gives thread (g, t) of a
//   warp columns 8i + 2t, 8i + 2t + 1 of rows g and g + 8: with that pixel
//   order, blocks 2j and 2j + 1 hold window 4j + t's top and bottom pairs,
//   so the epilogue is 3 fmaxf, + bias and a ReLU per window and channel
//   (max and the monotone f32 rounding of + bias commute), added to the
//   thread's two channel sums; windows past W/2 add 0.  At the item's end
//   two shuffles sum the 4 lanes of a channel and lane t = 0 writes the
//   item's partial; a second kernel sums the items of an image in order
//   and divides by (H/2)(W/2).  No float atomics: two runs give the same
//   bits.  No product sits under a branch (ptxas would put a
//   warpgroup.arrive before each).
// * Error bound (ops/edge_tower.py::edge_tower_fwd_error_bound, checked on
//   the CPU against edge_tower_gap_split_forward, this arithmetic in plain
//   PyTorch).  With |x - xh| <= 2^-8 |x|, |xm| <= 2^-8 (1 + 2^-8) |x|, |xl|
//   <= 2^-16 |x| (the same for w), A = sum_j |w_j x_j| and A0 its part over
//   taps 0..15, a conv output errs by at most
//     dropped wm.xl + wl.xm + wl.xl                <= 1.005 * 2^-23 A
//     wh.xh summed, every addition truncating      <= 1.01 * 2^-23 (16 A0 + 9 A)
//       (counts.cu's assumption: the rounding of the tensor cores' f32
//       sums is not documented; each addition within a k16 step errs by
//       under an ulp of a partial sum of at most A0, or A in step 2)
//     the cross sum (125 additions of <= 1.01 * 2^-7 A) <= 0.99 * 2^-23 A
//     dh + dx, then + bias (round to nearest)      <= 2^-24 (2.02 A + |b|)
//   so e_z <= 2^-23 (1.01 (16 A0 + 9 A) + 3.01 A) + 2^-24 |b|, at most
//   about 28.3 * 2^-23 A.  Max and ReLU are 1-Lipschitz: a pooled value
//   errs by at most the largest e_z of its window, whichever wins.  The
//   mean adds (L + 1) 2^-24 |out| for the L f32 additions of the longest
//   summation chain (4 windows an N tile, two shuffles, the items of an
//   image: 67 at 32x32, 272 at 224x224), as the first design's sums did.
//   Against the unchanged tolerance (1e-6 + 1e-5 |out|) this worst case
//   holds on k/255 edge maps, the model's data, and on worst-case splits,
//   whose terms share one sign (the CPU tests assert both), but not on
//   uniform images with N(0, 0.1) weights (A ~ 1, |out| ~ 0.2), where 25
//   truncations of a sum of size A would all have to err the same way.
//   The card's tensor cores (ops/tc_rounding.py::MEASURED, held against
//   wgmma on crafted operands) cut each term of a k16 step toward zero 2
//   bits below the f32 ulp of the step's largest exponent, then the exact
//   sum once, toward zero: the hh sum's 2 steps (16 terms, then the
//   running sum and 9) err by under (26 2^-25 + 2 2^-23) A = 8.5 * 2^-23
//   A, inside the assumption above.
//   chip_smoke.py holds the kernel to the plain version at that tolerance
//   on uniform, constant, k/255 and worst-case-split data.
//   The forward makes no decision that anything reads: the f32 backward
//   decides winners itself with the f32 conv2x2 chain, the bf16 one on the
//   bf16 forward's own sums.
//
// Backward (the tap sums on the tensor cores).  With g[b, c] = dout[b, c] /
// ((H/2)(W/2)), constant over an image, and M_b[c, p] = 1 where conv pixel
// p wins its pool window for channel c with pre > 0 (else 0):
//   T_b[c, j] = sum_p M_b[c, p] X_b[p, j],  X_b[p, j] = x_b[p + tap j] (j <
//               25), 1 (j = 25), 0 up to 32
//   dW[j, c] = sum_b g[b, c] T_b[c, j],  db[c] = sum_b g[b, c] T_b[c, 25]
// M is exactly 0/1 in bf16, and each image value splits exactly into three
// bf16 pieces (mma.cuh::split3_bf16x2), so every product on the tensor cores
// is exact and only their f32 sums round, as an f32 chain's would.  One
// mma.sync m16n8k16 takes 16 channels (M) x 16 conv pixels (K) x 8 columns
// (N), four n-tiles a slab and three products (the pieces) each.  A slab is
// four pool windows, one in each of 4 pooled rows at one column: lane (g, t)
// of a warp takes window t for channels g and g + 8, and K is ordered so
// that k = 2t, 2t + 1 are the window's top pair and 2t + 8, 2t + 9 its
// bottom pair, which is exactly where the A fragment holds them: the lane
// recomputes its window's four conv values with the f32 conv2x2 chain
// (decisions on f32 conv values, as the plain version's and JAX's kernel's
// are; cuDNN's f32 conv decided every window alike in chip_smoke.py's
// float64 witness), applies the tie rule and writes the mask straight
// into its A registers.  The B fragments are the
// same pixel pairs at each tap's offset, read as 16-byte entries (the three
// pieces of a pair) from the staged tile, whose rows are padded to 1 mod 4
// entries so a warp's reads fall on distinct banks.  Every 8 slabs and at an
// item's end the f32 sums are scaled by g into 16 registers (one FMA per
// item, channel and tap, not one per pixel).  A block (4 warps: up to 4
// m-tiles of 16 channels, by row groups) walks a fixed share of the (image,
// tile of up to 16 x 64 pooled pixels) items, grid-stride over a grid of the
// blocks the card holds at once; it stages each tile with a zero halo,
// reduces its row groups in order into per-block partials, and a second
// kernel sums the blocks in order.  No float atomics: two runs give the
// same bits.  Nothing of the activation's or the winners' size is written.
//
// bf16 images (the JAX kernel's bf16 mode: _weights(..., images.dtype) bands
// the weights in the images' dtype and the backward casts the routed
// gradient to it before the dW products).  The weights are rounded to bf16
// (nearest, even) and each pixel is one exact bf16 piece, so every conv
// product is exact in f32 and only the f32 sums round; + bias, ReLU, the 2x2
// max and the mean in f32 as above.
//
// bf16 forward (edge_fwd_bf16_kernel): the f32 forward's roles swapped.
// * Arithmetic: the f32 forward's hi x hi product alone, in its K order
//   (taps 0..15, then 16..24 zero-padded to 32: 2 k16 steps).  A k16
//   step's sum depends only on its 16 products and the running sum
//   (ops/tc_rounding.py::MEASURED), so every conv value has the bits that
//   the f32 design's hi x hi product gives on bf16 operands; only the mean
//   adds in another order.
// * Roles: M = 64 conv pixels, A from registers; N = the block's 64
//   channels, B = the rounded weights, 4 KB in shared memory for the
//   block's life (K-major: the f32 forward's im2col layout, channels for
//   pixels).
// * Window groups: 2 pooled rows x 16 pooled columns, 32 windows.  M tile
//   A holds their left (even) conv columns, M tile B the right ones; row g
//   of a warp is window 8 (warp % 2) + g's top pixel, row g + 8 the one
//   below.  A thread's accumulators then hold all four conv values of one
//   window for its 16 channels (8i + 2t, + 1): 3 fmaxf, + bias and a ReLU
//   each, no shuffle.
// * Operands: the item's rows stand twice in shared memory, as a plane and
//   as a copy shifted by one column, so the word (p[c], p[c + 1]) exists
//   for any column c.  Of a lane's four k pairs, one of a row is one 4-byte
//   load; taps 4, 5 and 14, 15 span two rows (two loads and a byte
//   permute); pair 24 is tap 24 masked (lane t = 0) or zero, as the f32
//   forward's padding.  Rows 12 mod 32 words apart and the copy 0 mod 32
//   words on put a warp's loads on distinct banks.  No im2col store, no
//   proxy fence and no barrier a group.
// * Schedule: a group's fragments, then its 4 products (2 k16 steps of
//   each M tile) as one commit group, its accumulators read after
//   wait_group 0.  ptxas serializes every product of the kernel when an
//   instruction writes a register that a product in flight reads (C7513),
//   or reads an accumulator while any product is in flight (C7514): so a
//   group's pooling cannot overlap the next group's products inside one
//   warpgroup; the 3 blocks of an SM overlap them.
// * Grid and items: persistent, the blocks the card holds (made coprime
//   with an image's items by the wrapper), each walking items by carries
//   (no division an item).  Items are tiles of up to 16 pooled rows x 96
//   columns (fwd_tiles_bf16): a 32x32 image is one.  An item's plane
//   arrives by cp.async copies of 16 bytes (of 4 where W % 8 or the images
//   are not on 16 bytes; zero outside the image) into one of two plane
//   sets while the block computes the item before; the threads then write
//   its shifted copy.
// * Sums: each lane adds its window's pooled values over the item's
//   groups; a butterfly over the 8 windows of a warp (14 shuffles) and the
//   4 warps in order give the item's channel sums.  One item an image:
//   the kernel writes the mean itself, no scratch, no second launch; else
//   partial [items, C] and edge_fwd_reduce_kernel.  No float atomics: two
//   runs give the same bits; nothing of the activation's size is written.
// * What bounds it: operations, the conv at the bf16 rate (0.025 ms at
//   8192 x 32x32 x 64); it issues 4 m64n64k16 products a group (0.035 ms
//   at peak).  The pooling (4 fmaxf and 2 adds a window and channel), the
//   operand loads (12 KB a group) and the products' own time each take a
//   share; no single unit bounds it (PERF.md).
//
// bf16 backward (edge_bwd_wgmma_kernel): the conv and the tap sums both on
// the tensor cores, the winners decided in registers.  With bf16 images
// the conv's products are exact, so the f32 conv2x2 chain above has no
// reason left to run on the CUDA cores (0.37 ms at 8192 x 32x32 x 64).
// * Tiles: the forward's (fwd_tiles): a block (one warpgroup, 64 channels,
//   blockIdx.y the group) walks a fixed share of the items over a grid of
//   the blocks the card holds at once (the wrapper makes it coprime with
//   the items of an image, so that every block takes ragged items too),
//   stages each item's plane, its max |x| and the group's rounded weights,
//   and walks its N tiles of 64 conv pixels as the forward does,
//   double-buffered.
// * Conv: the forward's 2 k16 steps on the forward's im2col tile, in its K
//   order and with its weights, so the conv values are the forward's own
//   sums.  One change to the tile: tap column 25 holds bf16 1.0 in every
//   pixel row (the weights are zero there, so the conv is unchanged).
// * Winners in registers: the forward's pixel order gives each thread
//   whole pool windows (z(o), z(o + 1), z(o + 4), z(o + 5), o = 8j + 2h:
//   window 4j + t of channel row g + 8h); the tie rule of window_mask
//   decides them on the wgmma sums and writes the 0/1 masks as bf16 pairs
//   straight into A fragments: accumulator block 8i + 2t (+1) of rows g,
//   g + 8 is the A layout of k16 step i / 2 of the next product, so no
//   shuffle is needed.  The wgmma sums truncate, so a window whose
//   decisions are near a tie is recomputed by the f32 chain (the band
//   below, two screens); the decisions are then the f32 chain's, as the
//   plain version's cuDNN conv makes them (one window decided otherwise
//   leaves the gradient tolerance at 8192 images).  About 0.03% of the
//   window-channels of uniform images and 0.013% of k/255 edge maps are
//   recomputed (H100).
// * Tap sums: T[c, j] = sum_p M[c, p] X[p, j] as 4 k16 steps of
//   wgmma.m64n32k16 (K the N tile's 64 pixels, N the 32 columns: 25 taps,
//   the ones column, zeros), A the masks in registers, B the same im2col
//   tile read with the transpose bit: its rows are pixels with taps
//   contiguous, MN-major for this product (tap_sums; lbo 128, sbo 1024).
//   Each N tile's sums (at most 16 winners of 0/1 x bf16) are folded into
//   16 persistent f32 sums with one FMA each: dW columns by g rounded to
//   bf16, db by the f32 g (g = dout * (1 / ((H/2)(W/2)))).
// * Per-block partials [26, C], summed in block order by
//   edge_bwd_reduce_kernel: no float atomics, two runs give the same bits;
//   nothing of the activation's or the masks' size is written.
// * What bounds it: operations, the conv and the tap sums at the bf16 rate
//   (chip_smoke.py::tower_bounds); it issues 2 k16 steps of n64 and 4 of
//   n32 a tile, twice the forward's tensor work.  The CUDA cores' share
//   (the im2col writes, the decisions and their screens) is what it waits
//   on.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kTaps = 25;
constexpr int kAcc = kTaps + 1;  // dW taps, then db
constexpr int kReduceThreads = 256;
constexpr int kStageBytesMax = 232448;  // an H100 block's dynamic shared memory

constexpr int kFwdThreads = 128;  // one warpgroup
constexpr int kFwdChannels = 64;  // channels of one forward block: the wgmma M tile
constexpr int kFwdChunk = 16;     // pooled columns of one N tile: 64 conv pixels
constexpr int kPieceK = 32;       // K of one image piece: taps 0..24, zero to 32
constexpr uint32_t kBf16One = 0x3F80u;
// the im2col tile read transposed (MN-major, a pixel row's 8 taps of a
// k-group contiguous): core matrices adjacent along K (8 pixel rows) 128
// bytes apart, along N (k-groups of 8 taps) 1024
constexpr uint32_t kTnspLbo = 128, kTnspSbo = 1024;
constexpr int kBwdWgmmaMinBlocks = 4;  // edge_bwd_wgmma_kernel's blocks an SM, at least
constexpr int kBwdBufs = 2;  // its im2col tiles: one read by the products while the other is written
constexpr int kBwdSumBytes = kBwdBufs * 128 * 4;  // their S_p halves
// its rounded weights [25, 64] and four warps' max |x|
constexpr int kBwdWeightBytes = kTaps * 64 * 4 + 16;

// f32 images split into three bf16 pieces; bf16 images are one
template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;
template <typename T>
constexpr int kPieces = kSplit<T> ? 3 : 1;
// one im2col tile: 64 pixels x 32 bf16 a piece (12 KB for f32 images, 4 KB for bf16)
template <typename T>
constexpr int kTileBytes = 64 * kPieces<T> * kPieceK * 2;

constexpr int kBwdWarps = 4;
constexpr int kBwdGroupChannels = 16 * kBwdWarps;  // channels of one backward block
constexpr int kFlushSlabs = 8;  // slabs summed on the tensor cores between two scalings by g

struct BwdLayout {
  int mt;   // warps across the block's channels (one m-tile of 16 channels each)
  int nrg;  // row groups (each takes every nrg-th slab row of 4 pooled rows)
  int threads;
};

__host__ __device__ inline BwdLayout bwd_layout(int C, int Rp) {
  BwdLayout l;
  l.mt = ((C < kBwdGroupChannels ? C : kBwdGroupChannels) + 15) / 16;
  const int nrg = kBwdWarps / l.mt;
  l.nrg = nrg < Rp / 4 ? nrg : Rp / 4;
  l.threads = 32 * l.mt * l.nrg;
  return l;
}

// entries of a staged tile row: 2 Cw + 4 or more, = 1 mod 4 so that the
// 16-byte entries of the rows that a warp's lanes read fall on distinct banks
__host__ __device__ inline int tile_stride(int Cw) {
  int ws = 2 * Cw + 4;
  while (ws % 4 != 1) ++ws;
  return ws;
}

// the 2x2 conv outputs of one pooled pixel from its 6x6 input window
__device__ __forceinline__ void conv2x2(const float (&win)[6][6], const float (&wr)[kTaps],
                                        float& z00, float& z01, float& z10, float& z11) {
  z00 = z01 = z10 = z11 = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 5; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const float wt = wr[ky * 5 + kx];
      z00 = fmaf(wt, win[ky][kx], z00);
      z01 = fmaf(wt, win[ky][kx + 1], z01);
      z10 = fmaf(wt, win[ky + 1][kx], z10);
      z11 = fmaf(wt, win[ky + 1][kx + 1], z11);
    }
  }
}

__device__ __forceinline__ void shift_window(float (&win)[6][6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) win[r][q] = win[r][q + 2];
  }
}

// Row stride, in bf16, of the forward's staged image planes: 2 Cw + 4 or
// more, = 16..48 mod 64, so that the two conv rows a warp's lanes read
// (16 pixels of each) fall on distinct banks.
__host__ __device__ inline int plane_stride(int Cw) {
  int ps = 2 * Cw + 4;
  while (ps % 64 < 16 || ps % 64 > 48) ps += 2;
  return ps;
}

// bf16 bits (the low 16 of b) as f32
__device__ __forceinline__ float bf16_bits(uint32_t b) { return __uint_as_float(b << 16); }

// The kH-th half (k-groups kG/2 kH .. of the kG) of one pixel's row of the
// im2col tile: k-group kg holds taps 8 (kg % 4) .. + 7 of piece kg / 4 (hi,
// mid, lo; kG = 12 for f32 images, 4 for bf16 ones), zero past tap 24.
// With kBwd (the bf16 backward) tap 25 holds bf16 1.0 (db's column) and the
// sum of |x| over the half's taps is returned (else 0).  `win` is the
// pixel's 5x5 window (its top-left entry) in the hi plane; `n` the pixel's
// row of the tile.
template <int kH, int kG, bool kBwd = false>
__device__ __forceinline__ float write_im2col(uint4* tile, const uint16_t* win, int plane,
                                              int ps, int n) {
  float sum = 0.0f;
#pragma unroll
  for (int q = 0; q < kG / 2; ++q) {
    const int kg = kG / 2 * kH + q;
    const uint16_t* p = win + (kg / 4) * plane;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j0 = 8 * (kg % 4) + 2 * e;
      const int j1 = j0 + 1;
      const uint32_t lo = j0 < kTaps ? p[(j0 / 5) * ps + j0 % 5] : 0u;
      const uint32_t hi = j1 < kTaps ? p[(j1 / 5) * ps + j1 % 5]
                          : kBwd && j1 == kTaps ? kBf16One : 0u;
      v[e] = lo | hi << 16;
      if constexpr (kBwd) {  // the pair's words as f32: lo shifted up, hi in place
        sum += fabsf(__uint_as_float(v[e] << 16));
        if (j1 < kTaps) sum += fabsf(__uint_as_float(v[e] & 0xFFFF0000u));
      }
    }
    tile[kg * 64 + n] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return sum;
}

// the descriptor of k16 step s of piece `piece` of an im2col tile at `base`
__device__ __forceinline__ uint64_t im2col_desc(uint32_t base, int piece, int s) {
  return fvx::wgmma_desc(base + (4 * piece + 2 * s) * 1024, 1024, 128);
}

// The weights as the conv's A operand, in registers for a block's life:
// rows g and g + 8 (channels c0, c0 + 8) of a warp's 16 channels, taps 16 st
// + 2t (+1) and + 8; each split into its three bf16 pieces (f32 images) or
// rounded to bf16, nearest even (bf16 images: ah only); and the two
// channels' bias.  Channels past C are zero.
template <typename T>
__device__ __forceinline__ void conv_weights(const float* __restrict__ w,
                                             const float* __restrict__ bias, int C, int c0,
                                             int t, uint32_t (&ah)[2][4], uint32_t (&am)[2][4],
                                             uint32_t (&al)[2][4], float (&bc)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 8 * h;
    bc[h] = c < C ? bias[c] : 0.0f;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = 16 * st + 8 * q + 2 * t;
        float2 v = make_float2(0.0f, 0.0f);
        if (c < C && k < kTaps) v.x = w[k * C + c];
        if (c < C && k + 1 < kTaps) v.y = w[(k + 1) * C + c];
        if constexpr (kSplit<T>) {
          fvx::split3_bf16x2(v, ah[st][h + 2 * q], am[st][h + 2 * q], al[st][h + 2 * q]);
        } else {  // the weights rounded to bf16, nearest even
          const __nv_bfloat162 r = __floats2bfloat162_rn(v.x, v.y);
          ah[st][h + 2 * q] = *reinterpret_cast<const uint32_t*>(&r);
        }
      }
    }
  }
}

// An item's input rows 2 r0 - 2 .. and columns 2 q0 - 2 .. of image img,
// zero outside the image, as three planes of bf16 pieces (bf16 images: one
// plane, the pixels' own bits), rows ps bf16 apart, `plane` bf16 a piece;
// all kFwdThreads threads of the block take part.
template <typename T>
__device__ __forceinline__ void stage_planes(uint32_t* planes, const T* __restrict__ img, int H,
                                             int W, int Rp, int r0, int q0, int ps, int plane) {
  const int half = ps / 2;
  const int n = (2 * Rp + 4) * half;
  for (int i = threadIdx.x; i < n; i += kFwdThreads) {
    const int ry = i / half;
    const int cx = 2 * (i - ry * half);
    const int y = 2 * r0 - 2 + ry;
    const int xx = 2 * q0 - 2 + cx;  // even, as W is: both columns in or out
    const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
    const int o = ry * half + cx / 2;
    if constexpr (kSplit<T>) {
      float2 v = make_float2(0.0f, 0.0f);
      if (in) {
        const float* row = img + static_cast<long long>(y) * W + xx;
        v = make_float2(row[0], row[1]);
      }
      uint32_t hi, mid, lo;
      fvx::split3_bf16x2(v, hi, mid, lo);
      planes[o] = hi;
      planes[plane / 2 + o] = mid;
      planes[plane + o] = lo;
    } else {
      uint32_t v = 0u;
      if (in) {
        const uint16_t* row =
            reinterpret_cast<const uint16_t*>(img) + static_cast<long long>(y) * W + xx;
        v = row[0] | static_cast<uint32_t>(row[1]) << 16;
      }
      planes[o] = v;
    }
  }
}

// This thread's row of the im2col tile of pooled row prl, chunk ch of an
// item, in buffer buf: pixel n = tid % 64 = 16 j + 8 r + 2
// t' + e is column 2 t' + e of pool window 4 j + t' (of the N tile's 16), in
// its top (r = 0) or bottom row; threads 0..63 write the first half of its
// k-groups, 64..127 the second.  With kBwd (the bf16 backward) each half's
// sum of |x| goes to sums[128 buf + 2 n + half]: a pixel's S_p is the sum
// of its two entries.
template <typename T, bool kBwd = false>
__device__ __forceinline__ void write_tile(uint4* tiles, const uint16_t* hi_plane, int plane,
                                           int ps, int prl, int ch, int buf,
                                           float* sums = nullptr) {
  const int tid = threadIdx.x;
  const int n = tid % 64;
  const int wrow = (n / 8) % 2;
  const int wcol = 8 * (n / 16) + n % 8;  // conv column in the N tile's 32
  const uint16_t* win = hi_plane + (2 * prl + wrow) * ps + 2 * kFwdChunk * ch + wcol;
  uint4* tile = tiles + buf * (kTileBytes<T> / 16);
  float s;
  if (tid < 64) s = write_im2col<0, 4 * kPieces<T>, kBwd>(tile, win, plane, ps, n);
  else s = write_im2col<1, 4 * kPieces<T>, kBwd>(tile, win, plane, ps, n);
  if constexpr (kBwd) sums[128 * buf + 2 * n + tid / 64] = s;
}

__global__ void __launch_bounds__(kFwdThreads, 3)
edge_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ partial,
                int H, int W, int C, int Rp, int Cw, int Sr, int Sc) {
  constexpr int kTile = kTileBytes<float>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* tiles = reinterpret_cast<uint4*>(smem);  // two im2col tiles
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + 2 * kTile);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int Hp = H / 2, Wp = W / 2;
  const long long item = blockIdx.x;
  const long long b = item / (Sr * Sc);
  const int s = static_cast<int>(item % (Sr * Sc));
  const int r0 = (s / Sc) * Rp, q0 = (s % Sc) * Cw;
  const int nrows = min(Rp, Hp - r0);
  const int nchunks = (min(Cw, Wp - q0) + kFwdChunk - 1) / kFwdChunk;
  const int n_tiles = nrows * nchunks;
  const int ps = plane_stride(Cw);
  const int plane = (2 * Rp + 4) * ps;  // bf16 of one piece's plane

  uint32_t ah[2][4], am[2][4], al[2][4];
  float bc[2];
  const int cw0 = blockIdx.y * kFwdChannels + warp * 16 + g;
  conv_weights<float>(w, bias, C, cw0, t, ah, am, al, bc);
  stage_planes<float>(planes, x + b * H * W, H, W, Rp, r0, q0, ps, plane);
  const uint16_t* hi_plane = reinterpret_cast<const uint16_t*>(planes);

  __syncthreads();  // the planes are staged
  write_tile<float>(tiles, hi_plane, plane, ps, 0, 0, 0);
  fvx::fence_proxy_async();
  __syncthreads();

  float sum[2] = {0.0f, 0.0f};
  for (int nt = 0; nt < n_tiles; ++nt) {
    const uint32_t base = fvx::smem_u32(tiles + (nt % 2) * (kTile / 16));
    float dh[32], dx[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dh[i] = 0.0f;
      fvx::reg_fence(dh[i]);
      dx[i] = 0.0f;
      fvx::reg_fence(dx[i]);
    }
    fvx::wgmma_fence();
    // every product unconditional: a product under a branch makes ptxas
    // put a warpgroup.arrive before each one
#pragma unroll
    for (int st = 0; st < 2; ++st) fvx::wgmma_m64n64k16_bf16(dh, ah[st], im2col_desc(base, 0, st));
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      fvx::wgmma_m64n64k16_bf16(dx, am[st], im2col_desc(base, 0, st));
      fvx::wgmma_m64n64k16_bf16(dx, al[st], im2col_desc(base, 0, st));
      fvx::wgmma_m64n64k16_bf16(dx, ah[st], im2col_desc(base, 1, st));
      fvx::wgmma_m64n64k16_bf16(dx, am[st], im2col_desc(base, 1, st));
      fvx::wgmma_m64n64k16_bf16(dx, ah[st], im2col_desc(base, 2, st));
    }
    fvx::wgmma_commit();
    // the next tile on the CUDA cores while the tensor cores take this one
    if (nt + 1 < n_tiles)
      write_tile<float>(tiles, hi_plane, plane, ps, (nt + 1) / nchunks, (nt + 1) % nchunks, (nt + 1) % 2);
    fvx::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fvx::reg_fence(dh[i]);
      fvx::reg_fence(dx[i]);
    }
    // conv output i of this thread's accumulator: hi x hi plus the cross products
    auto z = [&](int i) { return dh[i] + dx[i]; };

    // pool in registers: columns 16 j + 2t (+1) of the top row and 16 j + 8
    // + 2t (+1) of the bottom row are window 4 j + t's four conv outputs
    const int ch = nt % nchunks;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = q0 + kFwdChunk * ch + 4 * j + t < Wp;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 8 * j + 2 * h;
        const float z00 = z(o), z01 = z(o + 1);
        const float z10 = z(o + 4), z11 = z(o + 5);
        const float v = fmaxf(fmaxf(fmaxf(z00, z01), fmaxf(z10, z11)) + bc[h], 0.0f);
        sum[h] += ok ? v : 0.0f;
      }
    }
    fvx::fence_proxy_async();  // tile nt + 1 written; tile nt read
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const int c = cw0 + 8 * h;
    if (t == 0 && c < C) partial[item * C + c] = sum[h];
  }
}

// out[b, c] = sum_s partial[b, s, c] / n, tiles in order
__global__ void __launch_bounds__(kReduceThreads)
edge_fwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                       long long B, int C, int S, float n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const long long b = i / C;
  const int c = static_cast<int>(i - b * C);
  float s = 0.0f;
  for (int k = 0; k < S; ++k) s += partial[(b * S + k) * C + c];
  out[i] = s / n;
}

// --- the bf16 forward (edge_fwd_bf16_kernel; design in the header) ---------

constexpr int kBf16MinBlocks = 3;    // edge_fwd_bf16_kernel's blocks an SM, at least
constexpr int kBf16WeightBytes = 4 * 64 * 16;  // the B operand: 4 k-groups x 64 channels
constexpr int kBf16RedBytes = 2 * 4 * 64 * 4;  // two items' per-warp channel sums
constexpr int kBf16PlaneAt = kBf16WeightBytes + kBf16RedBytes;  // on 128 bytes
constexpr int kPlaneMargin = 8;  // plane columns left of an item's first conv column
constexpr int kBf16TileCols = 96;  // pooled columns of a tile at most: 3 blocks' planes an SM

// Words a row of the bf16 forward's staged planes for items of Cw pooled
// columns: the 2 Cw + 12 columns the taps read (kPlaneMargin on the left,
// 4 on the right), then to 12 mod 32: the operand loads of a warp then fall
// on distinct banks (with the shifted copy 0 mod 32 words past the plane)
__host__ __device__ inline int bf16_plane_half(int Cw) {
  int h = Cw + 6;
  while (h % 32 != 12) ++h;
  return h;
}
// rows of a plane: the item's pooled rows rounded up to even, doubled, and a halo of 2 a side
__host__ __device__ inline int bf16_plane_rows(int Rp) { return 2 * (Rp + (Rp & 1)) + 4; }
// words from a plane to its copy shifted by one column (the plane and a
// word past it, which the copy reads, rounded up to 128 bytes), and from
// one set of the two to the next
__host__ __device__ inline int bf16_plane_shift(int Rp, int Cw) {
  return (bf16_plane_rows(Rp) * bf16_plane_half(Cw) + 32) / 32 * 32;
}
__host__ __device__ inline int bf16_plane_set(int Rp, int Cw) { return 2 * bf16_plane_shift(Rp, Cw); }

// Byte offset, from the word of a pool window's top-left pixel (X = 2 cc),
// of the staged word whose low half is tap j of the window's pixel in
// column X + par: the plane's word (p[c], p[c + 1]) for an even column c,
// the shifted copy's (p[c], p[c + 1]) for an odd one.
__device__ __forceinline__ int tap_word(int par, int j, int half, int pw) {
  const int c = par + j % 5 + kPlaneMargin - 2;
  return 4 * ((c & 1 ? pw : 0) + (j / 5) * half + (c >> 1));
}

// The A fragments (2 k16 steps) of one M tile's pixels, rows g (the window's
// top pixel, whose taps are at the bytes `addr` of the planes, shifted by
// the group's `top`) and g + 8 (the row below): pair k = 2t.. of step 0
// from two staged words (taps 2t, 2t + 1 may lie on two rows), k = 2t + 8..
// likewise, k = 16 + 2t.. one word (taps of one row), k = 24 + 2t.. one
// word masked to tap 24 (lane t = 0) or to zero.
__device__ __forceinline__ void bf16_fragments(uint32_t (&f)[2][4], const unsigned char* planes,
                                               int top, int row_bytes, const int (&addr)[6],
                                               uint32_t mask) {
#pragma unroll
  for (int px = 0; px < 2; ++px) {
    const unsigned char* p = planes + top + px * row_bytes;
    auto word = [&](int o) { return *reinterpret_cast<const uint32_t*>(p + o); };
    f[0][px] = __byte_perm(word(addr[0]), word(addr[1]), 0x5410);
    f[0][2 + px] = __byte_perm(word(addr[2]), word(addr[3]), 0x5410);
    f[1][px] = word(addr[4]);
    f[1][2 + px] = word(addr[5]) & mask;
  }
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fvx::reg_fence(d[i]);
}
__device__ __forceinline__ void fence_regs(uint32_t (&f)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) fvx::reg_fence(f[s][r]);
  }
}

// One M tile's conv: 2 k16 steps of wgmma.m64n64k16, A the pixels'
// fragments, B the block's rounded weights (descriptors b0, b1).
__device__ __forceinline__ void bf16_conv(float (&d)[32], const uint32_t (&f)[2][4], uint64_t b0,
                                          uint64_t b1) {
  fvx::wgmma_m64n64k16_bf16_first(d, f[0], b0);
  fvx::wgmma_m64n64k16_bf16(d, f[1], b1);
}

// An item's plane: image rows 2 r0 - 2 .. and columns 2 q0 - kPlaneMargin ..
// of img, zero outside the image, rows half words apart, into shared memory
// at dst by cp.async copies of 8 pixels (16 bytes; `wide`) or of 2: a copy
// lies inside the image or outside it whole, since its first column and W
// are multiples of its pixels (and the images on as many bytes: the caller's).
__device__ __forceinline__ void stage_plane(uint32_t dst, const uint16_t* img, int H, int W,
                                            int r0, int q0, int prow, int half, bool wide) {
  const int px = wide ? 8 : 2;
  const int per_row = 2 * half / px;
  for (int i = threadIdx.x; i < prow * per_row; i += kFwdThreads) {
    const int r = i / per_row;
    const int y = 2 * r0 - 2 + r, xc = 2 * q0 - kPlaneMargin + px * (i - r * per_row);
    const bool in = y >= 0 && y < H && xc >= 0 && xc < W;
    const uint16_t* src = in ? img + static_cast<long long>(y) * W + xc : img;
    if (wide) fvx::cp_async16(dst + 16 * i, src, in ? 16 : 0);
    else fvx::cp_async4(dst + 4 * i, src, in ? 4 : 0);
  }
}

// The bf16 forward: persistent blocks over (image, tile) items; pixels as
// M, from registers; the 64 channels as N, from the rounded weights in
// shared memory; pooled in registers.  Each item's plane arrives by
// cp.async copies (16 bytes with `wide`, else 4) into one of two plane sets
// while the block computes the item before; the threads then write its
// copy shifted by one column.
// Writes out [B, C] (S = 1 item an image) or partial [items, C].
__global__ void __launch_bounds__(kFwdThreads, kBf16MinBlocks)
edge_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ partial,
                     float* __restrict__ out, int H, int W, int C, int Rp, int Cw, int Sr, int Sc,
                     int n_items, float n, int wide) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* wtile = reinterpret_cast<uint4*>(smem);  // k-group kg of channel n at kg * 64 + n
  float* red = reinterpret_cast<float*>(smem + kBf16WeightBytes);
  unsigned char* planes = smem + kBf16PlaneAt;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int Hp = H / 2, Wp = W / 2;
  const int half = bf16_plane_half(Cw), prow = bf16_plane_rows(Rp);
  const int pw = bf16_plane_shift(Rp, Cw), set_bytes = 4 * bf16_plane_set(Rp, Cw);
  const int cg = blockIdx.y * kFwdChannels;
  const uint16_t* images = reinterpret_cast<const uint16_t*>(x);

  // item = b S + sr Sc + sc, walked by gridDim.x with carries (no division an item)
  const int S = Sr * Sc;
  const int db_ = gridDim.x / S, ds_ = gridDim.x - db_ * S;
  const int dsr = ds_ / Sc, dsc = ds_ - dsr * Sc;
  auto step = [&](int& b, int& sr, int& sc) {
    b += db_;
    sr += dsr;
    sc += dsc;
    if (sc >= Sc) {
      sc -= Sc;
      ++sr;
    }
    if (sr >= Sr) {
      sr -= Sr;
      ++b;
    }
  };
  // item (sb, sr, sc)'s plane into plane set `set`, as one cp.async group
  auto stage = [&](int set, int sb, int sr, int sc) {
    stage_plane(fvx::smem_u32(planes + set * set_bytes), images + static_cast<long long>(sb) * H * W,
                H, W, sr * Rp, sc * Cw, prow, half, wide);
    fvx::cp_async_commit();
  };
  int ib = blockIdx.x / S, isr = (blockIdx.x - ib * S) / Sc, isc = blockIdx.x - ib * S - isr * Sc;
  stage(0, ib, isr, isc);  // the block's first item (gridDim.x <= n_items)
  // B: the group's weights rounded to bf16 (nearest even), taps 8 kg .. of
  // k-group kg, zero past tap 24 and channel C
  for (int i = tid; i < 4 * 64; i += kFwdThreads) {
    const int kg = i / 64, c = cg + i % 64;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 8 * kg + 2 * e;
      float2 f = make_float2(0.0f, 0.0f);
      if (c < C && k < kTaps) f.x = w[k * C + c];
      if (c < C && k + 1 < kTaps) f.y = w[(k + 1) * C + c];
      const __nv_bfloat162 r = __floats2bfloat162_rn(f.x, f.y);
      v[e] = *reinterpret_cast<const uint32_t*>(&r);
    }
    wtile[i] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  fvx::fence_proxy_async();  // for the tensor cores, after the first item's barrier
  const uint32_t wbase = fvx::smem_u32(wtile);
  const uint64_t b0 = fvx::wgmma_desc(wbase, 1024, 128);
  const uint64_t b1 = fvx::wgmma_desc(wbase + 2048, 1024, 128);

  // this thread's channels cg + 8i + 2t + e (k = 2i + e: accumulator
  // entries 4i + e, rows g, and 4i + 2 + e, rows g + 8) and their bias
  float bc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = cg + 8 * (k / 2) + 2 * t + k % 2;
    bc[k] = c < C ? bias[c] : 0.0f;
  }
  // window (rr, cc) of a group of 2 pooled rows x 16 pooled columns: its
  // top-left pixel is row g of both M tiles, the pixel below it row g + 8.
  // The lane's taps (pairs k = 2t and 2t + 8: two words each; 16 + 2t; 24)
  // by the M tile's column parity (its pixels at X, X + 1), as bytes of a
  // plane set from a group's first window
  const int rr = warp >> 1, cc = 8 * (warp & 1) + g;
  int addr[2][6];
#pragma unroll
  for (int par = 0; par < 2; ++par) {
    const int js[6] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9, 16 + 2 * t, 24};
#pragma unroll
    for (int q = 0; q < 6; ++q)
      addr[par][q] = 4 * (2 * rr * half + cc) + tap_word(par, js[q], half, pw);
  }
  const uint32_t mask = t == 0 ? 0xFFFFu : 0u;  // k = 24: tap 24 and a zero; else two zeros
  const int row_bytes = 4 * half;

  for (int item = blockIdx.x, k = 0; item < n_items; item += gridDim.x, ++k) {
    const int b = ib, r0 = isr * Rp, q0 = isc * Cw;
    step(ib, isr, isc);
    const int r_end = min(r0 + Rp, Hp), c_end = min(q0 + Cw, Wp);
    const int nchunks = (c_end - q0 + kFwdChunk - 1) / kFwdChunk;
    const int groups = (r_end - r0 + 1) / 2 * nchunks;
    const int set = k & 1;
    // the next item's plane into the other set (read by the item before,
    // whose last barrier has passed) while this one is computed
    if (item + static_cast<int>(gridDim.x) < n_items) stage(set ^ 1, ib, isr, isc);
    else fvx::cp_async_commit();  // an empty group
    fvx::cp_async_wait<1>();
    __syncthreads();  // this item's plane, every thread's copies
    uint32_t* p0 = reinterpret_cast<uint32_t*>(planes + set * set_bytes);
    for (int i = tid; i < prow * half / 4; i += kFwdThreads) {  // its shifted copy
      const uint4 a = reinterpret_cast<const uint4*>(p0)[i];
      const uint32_t e = p0[4 * i + 4];
      reinterpret_cast<uint4*>(p0 + pw)[i] =
          make_uint4(__byte_perm(a.x, a.y, 0x5432), __byte_perm(a.y, a.z, 0x5432),
                     __byte_perm(a.z, a.w, 0x5432), __byte_perm(a.w, e, 0x5432));
    }
    __syncthreads();
    const int base = set * set_bytes;

    float sums[16];
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) sums[k2] = 0.0f;
    // group gi: pooled rows r0 + 2 grow .., columns q0 + 16 chunk ..; M
    // tile A its windows' even conv columns, B the odd ones; the
    // accumulators are read after wait_group 0
    float da[32], db[32];
    uint32_t fa[2][4], fb[2][4];
    for (int gi = 0, grow = 0, chunk = 0; gi < groups; ++gi) {
      const int top = base + 4 * (4 * grow * half + kFwdChunk * chunk);
      const bool ok = r0 + 2 * grow + rr < r_end && q0 + kFwdChunk * chunk + cc < c_end;
      bf16_fragments(fa, planes, top, row_bytes, addr[0], mask);
      bf16_fragments(fb, planes, top, row_bytes, addr[1], mask);
      fence_regs(fa);
      fence_regs(fb);
      fvx::wgmma_fence();
      bf16_conv(da, fa, b0, b1);
      bf16_conv(db, fb, b0, b1);
      fvx::wgmma_commit();
      fvx::wgmma_wait0();
      fence_regs(da);
      fence_regs(db);
      fence_regs(fa);
      fence_regs(fb);
      if (ok) {
#pragma unroll
        for (int k2 = 0; k2 < 16; ++k2) {
          const float m = fmaxf(fmaxf(da[4 * (k2 / 2) + k2 % 2], da[4 * (k2 / 2) + 2 + k2 % 2]),
                                fmaxf(db[4 * (k2 / 2) + k2 % 2], db[4 * (k2 / 2) + 2 + k2 % 2]));
          sums[k2] += fmaxf(m + bc[k2], 0.0f);
        }
      }
      if (++chunk == nchunks) {
        chunk = 0;
        ++grow;
      }
    }

    // the item's sum of each channel: the 8 windows of a warp (lanes g) by a
    // butterfly in which each lane keeps half of its values a step (lane bit
    // 4, then 3, then 2 of g picks the half), then the 4 warps in order
#pragma unroll
    for (int h = 8; h >= 2; h /= 2) {
      const bool up = lane & (2 * h);  // lane bits 4, 3, 2 for h = 8, 4, 2
#pragma unroll
      for (int k2 = 0; k2 < h; ++k2) {
        const float give = up ? sums[k2] : sums[k2 + h];
        const float keep = up ? sums[k2 + h] : sums[k2];
        sums[k2] = keep + __shfl_xor_sync(0xffffffffu, give, 2 * h);
      }
    }
    float* r = red + 256 * set;
    {  // sums[0], sums[1]: values k = 8 b4 + 4 b3 + 2 b2 (+1) of the lane's bits
      const int kk = 8 * (lane >> 4 & 1) + 4 * (lane >> 3 & 1) + 2 * (lane >> 2 & 1);
      const int c = 8 * (kk / 2) + 2 * t;
      r[warp * 64 + c] = sums[0];
      r[warp * 64 + c + 1] = sums[1];
    }
    __syncthreads();  // the sums written; this plane set read
    if (tid < 64 && cg + tid < C) {
      const float v = r[tid] + r[64 + tid] + r[128 + tid] + r[192 + tid];
      if (S == 1) out[static_cast<long long>(b) * C + cg + tid] = v / n;
      else partial[static_cast<long long>(item) * C + cg + tid] = v;
    }
  }
}

// One entry of the f32 backward's staged tile: the three bf16 pieces of
// the pixel pair (x[cx], x[cx + 1]) as bf16x2 fragment registers, and
// x[cx].  A B fragment of the tap sums is two such pairs, the top and the
// bottom row of a pool window at the tap's offset.
__device__ __forceinline__ void stage_tile(uint4* s, const float* __restrict__ img, int H, int W,
                                           int y0, int x0, int rows, int cols, int ws) {
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ry = i / cols;
    const int cx = i - ry * cols;
    const int y = y0 + ry;
    const int xx = x0 + cx;
    uint4 e;
    float2 v = make_float2(0.0f, 0.0f);
    if (y >= 0 && y < H) {
      const float* row = img + static_cast<long long>(y) * W;
      if (xx >= 0 && xx < W) v.x = row[xx];
      if (xx + 1 >= 0 && xx + 1 < W) v.y = row[xx + 1];
    }
    fvx::split3_bf16x2(v, e.x, e.y, e.z);
    e.w = __float_as_uint(v.x);
    s[ry * ws + cx] = e;
  }
}

// two columns of the 6x6 input window from the entries' x (their last word)
__device__ __forceinline__ void load_cols_w(float (&win)[6][6], const uint4* rows, int ws,
                                            int col, int slot) {
  const float* f = reinterpret_cast<const float*>(rows) + 3;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    win[r][slot] = f[4 * (r * ws + col)];
    win[r][slot + 1] = f[4 * (r * ws + col + 1)];
  }
}

// The winner of one pool window for one channel from its four pre-bias
// conv values (z00, z01 its top row), by the tie rule, as the window's two
// rows of the 0/1 mask operand: a bf16x2 of (left, right) for the top row
// and for the bottom row; 0 unless ok.
__device__ __forceinline__ void window_mask(float z00, float z01, float z10, float z11,
                                            float bc, bool ok, uint32_t& top, uint32_t& bot) {
  const bool even_t = z00 >= z01;
  const bool even_b = z10 >= z11;
  const float pre_t = (even_t ? z00 : z01) + bc;
  const float pre_b = (even_b ? z10 : z11) + bc;
  const bool top_w = fmaxf(pre_t, 0.0f) >= fmaxf(pre_b, 0.0f);
  const bool live = ok && (top_w ? pre_t : pre_b) > 0.0f;
  const bool even = top_w ? even_t : even_b;
  const uint32_t one = live ? (even ? kBf16One : kBf16One << 16) : 0u;
  top = top_w ? one : 0u;
  bot = top_w ? 0u : one;
}

// the same, the window's conv values by the f32 conv2x2 chain
__device__ __forceinline__ void winner_mask(const float (&win)[6][6], const float (&wr)[kTaps],
                                            float bc, bool ok, uint32_t& top, uint32_t& bot) {
  float z00, z01, z10, z11;
  conv2x2(win, wr, z00, z01, z10, z11);
  window_mask(z00, z01, z10, z11, bc, ok, top, bot);
}

// acc += g * T for the two channels of this lane (rows g and g + 8 of the
// m-tile), then T = 0
__device__ __forceinline__ void flush_taps(float (&acc)[4][4], float (&tsum)[4][4], float g0,
                                           float g1) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    acc[nt][0] = fmaf(g0, tsum[nt][0], acc[nt][0]);
    acc[nt][1] = fmaf(g0, tsum[nt][1], acc[nt][1]);
    acc[nt][2] = fmaf(g1, tsum[nt][2], acc[nt][2]);
    acc[nt][3] = fmaf(g1, tsum[nt][3], acc[nt][3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) tsum[nt][i] = 0.0f;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(32 * kBwdWarps, 3)
edge_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ dout,
                float* __restrict__ partial, int H, int W, int C, int Rp, int Cw, int Sr,
                int Sc, long long n_items, float n) {
  extern __shared__ uint4 tile[];
  const BwdLayout l = bwd_layout(C, Rp);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int mt = warp % l.mt;
  const int rg = warp / l.mt;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cl = mt * 16 + g;  // this lane's first channel in the group; the second is cl + 8
  const int c0 = blockIdx.y * kBwdGroupChannels + cl;
  const int c1 = c0 + 8;
  const bool act0 = c0 < C;
  const bool act1 = c1 < C;
  float w0[kTaps], w1[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    w0[k] = act0 ? w[k * C + c0] : 0.0f;
    w1[k] = act1 ? w[k * C + c1] : 0.0f;
  }
  const float bc0 = act0 ? bias[c0] : 0.0f;
  const float bc1 = act1 ? bias[c1] : 0.0f;

  const int ws = tile_stride(Cw);
  // column j = 8 nt + g of X in n-tile nt: tap j < 25 at this offset from a
  // window's top-left entry; column 25 is all ones (db), 26..31 zero
  int boff[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = 8 * nt + g;
    boff[nt] = j < kTaps ? (j / 5) * ws + j % 5 : 1;  // 1: off the banks of tap 24
  }
  const uint32_t col3 = 8 * 3 + g == kTaps ? (kBf16One | kBf16One << 16) : 0u;

  float acc[4][4], tsum[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = tsum[nt][i] = 0.0f;
  }

  const int Hp = H / 2, Wp = W / 2;
  const int per_image = Sr * Sc;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long b = item / per_image;
    const int s = static_cast<int>(item % per_image);
    const int r0 = (s / Sc) * Rp;
    const int q0 = (s % Sc) * Cw;
    const int r1 = min(r0 + Rp, Hp);
    const int cw = min(Cw, Wp - q0);
    __syncthreads();  // every warp is done with the previous tile
    stage_tile(tile, x + b * H * W, H, W, 2 * r0 - 2, 2 * q0 - 2, 2 * Rp + 4, 2 * Cw + 4, ws);
    __syncthreads();
    const float g0 = act0 ? dout[b * C + c0] / n : 0.0f;
    const float g1 = act1 ? dout[b * C + c1] / n : 0.0f;
    int slabs = 0;
    for (int sr = rg; sr < Rp / 4; sr += l.nrg) {
      const int prl = 4 * sr + t;  // lane t takes window t of the slab: pooled row prl
      const bool ok = r0 + prl < r1;
      const uint4* rows = tile + 2 * prl * ws;
      float win[6][6];
      load_cols_w(win, rows, ws, 0, 0);
      load_cols_w(win, rows, ws, 2, 2);
      for (int pc = 0; pc < cw; ++pc) {
        load_cols_w(win, rows, ws, 2 * pc + 4, 4);
        uint32_t a[4];  // rows g, g + 8; k 2t, 2t + 1 the top pair, 2t + 8, 2t + 9 the bottom
        winner_mask(win, w0, bc0, ok, a[0], a[2]);
        winner_mask(win, w1, bc1, ok, a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint4 u = rows[2 * pc + boff[nt]];
          uint4 v = rows[2 * pc + boff[nt] + ws];
          if (nt == 3 && 8 * 3 + g >= kTaps) {
            u = v = make_uint4(col3, 0u, 0u, 0u);
          }
          const uint32_t bh[2] = {u.x, v.x};
          const uint32_t bm[2] = {u.y, v.y};
          const uint32_t bl[2] = {u.z, v.z};
          fvx::mma_bf16_16816(tsum[nt], a, bh);
          fvx::mma_bf16_16816(tsum[nt], a, bm);
          fvx::mma_bf16_16816(tsum[nt], a, bl);
        }
        shift_window(win);
        if (++slabs == kFlushSlabs) {
          flush_taps(acc, tsum, g0, g1);
          slabs = 0;
        }
      }
    }
    flush_taps(acc, tsum, g0, g1);
  }

  __syncthreads();  // the last tile is read; its memory now holds the row groups' sums
  float* red = reinterpret_cast<float*>(tile);
  const int cpad = 16 * l.mt;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * nt + 2 * t + (i & 1);
      if (j < kAcc) red[(rg * kAcc + j) * cpad + cl + (i >> 1) * 8] = acc[nt][i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kAcc * cpad; i += blockDim.x) {
    const int j = i / cpad;
    const int c = blockIdx.y * kBwdGroupChannels + i % cpad;
    if (c >= C) continue;
    float sum = 0.0f;
    for (int r = 0; r < l.nrg; ++r) sum += red[(r * kAcc + j) * cpad + i % cpad];
    partial[(static_cast<long long>(blockIdx.x) * kAcc + j) * C + c] = sum;
  }
}

// Near ties.  The wgmma sums truncate (ops/tc_rounding.py::MEASURED: each
// k16 step's terms cut toward zero 2 bits below the f32 ulp of their
// largest unnormalized exponent, the exact sum cut toward zero to f32), so
// a conv value z with A = sum_j |w_j x_j| errs by less than (26 2^-25 + 2
// 2^-23) A = 8.5 2^-23 A; the f32 conv2x2 chain (the f32 backward's) by
// at most 25 2^-24 A.  A window whose
// decisions (each row's column, the two rows' pre-activations and their
// signs) are all apart by more than the two bounds twice over, plus four
// f32 ulps of |z| + |b| for the bias add, decides as the f32 chain does; a
// window within that band is recomputed by the chain.  With A and |z| <=
// max_j |w_j| S, S the sum of |x| over a pixel's 25 taps, the band of two
// values is band(S) = (kBand + 2^-21) max|w| S + 2^-21 |b| with S the
// larger of their pixels'; kBand = 48 2^-23 > 2 (8.5 + 12.5) 2^-23.  A
// value whose S is 0 is exactly 0 both ways (every product 0), so it needs
// no band.  Two screens: every window against band(25 max|x| of the item)
// (window_mask_near), then those within it against the band of the pixels
// compared (near_tie: S_p from write_im2col).
constexpr float kBand = 0x1.8p-18f;
constexpr float kBandUlps = 0x1p-21f;

// The four conv values of the pool window whose 6x6 input window starts at
// word (row0, col0) of the staged bf16 plane (words: pixel pairs, `half`
// to a row), for the channel of rounded weights wc[64 k], by the conv2x2
// chain: fmaf over the taps in its order
__device__ __forceinline__ void chain_window(const uint32_t* words, int half, int row0, int col0,
                                             const float* wc, float& z00, float& z01,
                                             float& z10, float& z11) {
  z00 = z01 = z10 = z11 = 0.0f;
#pragma unroll 1
  for (int ky = 0; ky < 5; ++ky) {
    const uint32_t* r0 = words + (row0 + ky) * half + col0;
    const uint32_t* r1 = r0 + half;
    float a[6], b[6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[2 * i] = bf16_bits(r0[i]);
      a[2 * i + 1] = __uint_as_float(r0[i] & 0xFFFF0000u);
      b[2 * i] = bf16_bits(r1[i]);
      b[2 * i + 1] = __uint_as_float(r1[i] & 0xFFFF0000u);
    }
#pragma unroll
    for (int kx = 0; kx < 5; ++kx) {
      const float wt = wc[64 * (ky * 5 + kx)];
      z00 = fmaf(wt, a[kx], z00);
      z01 = fmaf(wt, a[kx + 1], z01);
      z10 = fmaf(wt, b[kx], z10);
      z11 = fmaf(wt, b[kx + 1], z11);
    }
  }
}

// window_mask on a window's wgmma sums (the same decisions, written for
// values and selects rather than predicates), and whether any of its
// decisions lies within `band` (the first screen)
__device__ __forceinline__ bool window_mask_near(float z00, float z01, float z10, float z11,
                                                 float bc, bool ok, float band, uint32_t& top,
                                                 uint32_t& bot) {
  const float dt = z00 - z01, db = z10 - z11;  // >= 0 exactly where z00 >= z01 (z10 >= z11)
  const uint32_t ct = dt >= 0.0f ? kBf16One : kBf16One << 16;
  const uint32_t cb = db >= 0.0f ? kBf16One : kBf16One << 16;
  const float pt = fmaxf(z00, z01) + bc, pb = fmaxf(z10, z11) + bc;
  const bool top_w = fmaxf(pt, 0.0f) >= fmaxf(pb, 0.0f);
  const uint32_t one = ok && (top_w ? pt : pb) > 0.0f ? (top_w ? ct : cb) : 0u;
  top = top_w ? one : 0u;
  bot = top_w ? 0u : one;
  return fminf(fminf(fabsf(dt), fabsf(db)), fminf(fabsf(pt - pb), fminf(fabsf(pt), fabsf(pb)))) <=
         band;
}

// Whether the wgmma sums of a window may decide otherwise than the f32
// chain (the second screen): s00 .. s11 the pixels' S, -inf where 0; the
// band of S is fmaf(wband, S, bband) (-inf or NaN for -inf: no band).
// Written with other operations than the first screen's, so that the
// compiler recomputes them here rather than keep the first screen's
// values across the branch.
__device__ __forceinline__ bool near_tie(float z00, float z01, float z10, float z11, float bc,
                                         float s00, float s01, float s10, float s11, float wband,
                                         float bband) {
  const bool even_t = z00 >= z01, even_b = z10 >= z11;
  const float pt = (even_t ? z00 : z01) + bc, pb = (even_b ? z10 : z11) + bc;
  const float swt = even_t ? s00 : s01, swb = even_b ? s10 : s11;  // the winners'
  return fabsf(z00 - z01) <= fmaf(wband, fmaxf(s00, s01), bband) ||
         fabsf(z10 - z11) <= fmaf(wband, fmaxf(s10, s11), bband) ||
         fabsf(pt - pb) <= fmaf(wband, fmaxf(swt, swb), bband) ||
         fabsf(pt) <= fmaf(wband, swt, bband) || fabsf(pb) <= fmaf(wband, swb, bband);
}

// ts = m . X over the im2col tile at `base`: 4 k16 steps of
// wgmma.m64n32k16, K the tile's 64 pixel rows (step s: pixels 16 s ..),
// N its 32 columns read transposed through descriptors of byte offsets
// lbo, sbo; m[s] the A fragment of step s (the warp's 16 rows)
__device__ __forceinline__ void tap_sums(float (&ts)[16], const uint32_t (&m)[4][4],
                                         uint32_t base, uint32_t lbo, uint32_t sbo) {
#pragma unroll
  fvx::wgmma_m64n32k16_bf16_tnsp<true>(ts, m[0], fvx::wgmma_desc(base, lbo, sbo));
#pragma unroll
  for (int s = 1; s < 4; ++s)
    fvx::wgmma_m64n32k16_bf16_tnsp<false>(ts, m[s], fvx::wgmma_desc(base + 256 * s, lbo, sbo));
}

// The bf16 backward (design in the header): the conv on the tensor cores
// over the forward's tiles, the winners decided in registers, the tap sums
// on the tensor cores from the same im2col tile; per-block partials
// [26, C] of dW (rows 0..24) and db (row 25).
__global__ void __launch_bounds__(kFwdThreads, kBwdWgmmaMinBlocks)
edge_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, const float* __restrict__ dout,
                      float* __restrict__ partial, int H, int W, int C, int Rp, int Cw, int Sr,
                      int Sc, long long n_items, float n) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* tiles = reinterpret_cast<uint4*>(smem);  // kBwdBufs im2col tiles
  float* sums = reinterpret_cast<float*>(smem + kBwdBufs * kTileBytes<T>);  // their S_p halves
  float* ws = sums + kBwdBufs * 128;  // the group's rounded weights, ws[64 k + channel]
  uint32_t* xmax_warp = reinterpret_cast<uint32_t*>(ws + kTaps * 64);  // max |x| bits a warp
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + kBwdBufs * kTileBytes<T> + kBwdSumBytes +
                                                 kBwdWeightBytes);
  const uint16_t* hi_plane = reinterpret_cast<const uint16_t*>(planes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int Hp = H / 2, Wp = W / 2;
  const int ps = plane_stride(Cw);
  const int plane = (2 * Rp + 4) * ps;

  uint32_t ah[2][4], am[2][4], al[2][4];  // am, al unused: one exact piece
  float bc[2];
  const int cw0 = blockIdx.y * kFwdChannels + warp * 16 + g;
  conv_weights<T>(w, bias, C, cw0, t, ah, am, al, bc);
  const float inv = 1.0f / n;  // dout times the f32 reciprocal, as the JAX kernel's Sel product
  for (int i = threadIdx.x; i < kTaps * 64; i += kFwdThreads) {
    const int c = blockIdx.y * kFwdChannels + i % 64;
    ws[i] = c < C ? round_bf16(w[(i / 64) * C + c]) : 0.0f;
  }
  // the near-tie band of channel cw0 + 8h is fmaf(wband[h], S, bband[h]);
  // a channel whose weights are all 0 (or past C) never is near a tie
  float wband[2], bband[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = cw0 + 8 * h;
    float wmax = 0.0f;  // max_j |w_j|, rounded to bf16
    if (c < C) {
#pragma unroll 1
      for (int k = 0; k < kTaps; ++k) wmax = fmaxf(wmax, fabsf(round_bf16(w[k * C + c])));
    }
    wband[h] = (kBand + kBandUlps) * wmax;
    bband[h] = wmax > 0.0f ? kBandUlps * fabsf(bc[h]) : -1.0f;
  }

  // dW and db of this thread's channels cw0 + 8h (h = 0, 1) and columns
  // 8i + 2t + e: acc[4i + 2h + e], the m64n32 accumulator's layout
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long b = item / (Sr * Sc);
    const int s = static_cast<int>(item % (Sr * Sc));
    const int r0 = (s / Sc) * Rp, q0 = (s % Sc) * Cw;
    const int nrows = min(Rp, Hp - r0);
    const int nchunks = (min(Cw, Wp - q0) + kFwdChunk - 1) / kFwdChunk;
    const int n_tiles = nrows * nchunks;
    float gf[2], gh[2];  // g in f32 (db) and rounded to bf16 (dW: JAX's dze.astype(bf16))
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = cw0 + 8 * h;
      gf[h] = c < C ? dout[b * C + c] * inv : 0.0f;
      gh[h] = round_bf16(gf[h]);
    }
    // the previous item's last N tile ended in __syncthreads: its planes
    // and tiles are read
    stage_planes<T>(planes, x + b * H * W, H, W, Rp, r0, q0, ps, plane);
    __syncthreads();
    write_tile<T, true>(tiles, hi_plane, plane, ps, 0, 0, 0, sums);
    {  // the item's max |x| (bf16 bits of non-negative values order as they do)
      uint32_t mx = 0u;
      for (int i = threadIdx.x; i < (2 * Rp + 4) * (ps / 2); i += kFwdThreads) {
        const uint32_t v = planes[i];
        mx = max(mx, max(v & 0x7FFFu, (v >> 16) & 0x7FFFu));
      }
      mx = __reduce_max_sync(0xffffffffu, mx);
      if (lane == 0) xmax_warp[warp] = mx;
    }
    fvx::fence_proxy_async();
    __syncthreads();
    // the first screen's band of the item: S <= 25 max|x|
    const float smax_item = kTaps * bf16_bits(max(max(xmax_warp[0], xmax_warp[1]),
                                                  max(xmax_warp[2], xmax_warp[3])));
    const float coarse[2] = {smax_item > 0.0f ? fmaf(wband[0], smax_item, bband[0]) : -1.0f,
                             smax_item > 0.0f ? fmaf(wband[1], smax_item, bband[1]) : -1.0f};

    for (int nt = 0, prl = 0, ch = 0; nt < n_tiles; ++nt) {  // tile nt: pooled row prl, chunk ch
      const int buf = nt % kBwdBufs;
      const bool wrap = ch + 1 == nchunks;  // tile nt + 1's row and chunk
      const int prl1 = wrap ? prl + 1 : prl, ch1 = wrap ? 0 : ch + 1;
      const uint32_t base = fvx::smem_u32(tiles + buf * (kTileBytes<T> / 16));
      // the conv: the forward's 2 k16 steps, unconditional (a product under
      // a branch makes ptxas put a warpgroup.arrive before each one)
      float z[32];
      fvx::wgmma_fence();
      fvx::wgmma_m64n64k16_bf16_first(z, ah[0], im2col_desc(base, 0, 0));
      fvx::wgmma_m64n64k16_bf16(z, ah[1], im2col_desc(base, 0, 1));
      fvx::wgmma_commit();
      // the next tile on the CUDA cores while the tensor cores take this one
      if (nt + 1 < n_tiles)
        write_tile<T, true>(tiles, hi_plane, plane, ps, prl1, ch1, (nt + 1) % kBwdBufs, sums);
      fvx::wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 32; ++i) fvx::reg_fence(z[i]);

      // the winners: window 4j + t of channel cw0 + 8h from z(o), z(o + 1)
      // (its top row) and z(o + 4), z(o + 5), o = 8j + 2h; its masks are the
      // A fragment of k16 step j of the tap sums (rows g: registers 0 and
      // 2, the top and bottom pairs; rows g + 8: 1 and 3).  Bit 2j + h of
      // `near`: within the first screen, then within the second; such a
      // window takes the f32 chain's values.
      uint32_t m[4][4];
      unsigned near = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = q0 + kFwdChunk * ch + 4 * j + t < Wp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 8 * j + 2 * h;
          if (window_mask_near(z[o], z[o + 1], z[o + 4], z[o + 5], bc[h], ok, coarse[h],
                               m[j][h], m[j][h + 2]) && ok)
            near |= 1u << (2 * j + h);
        }
      }
      if (near) {  // the second screen, on S_p of pixels 16j + 2t (+1) and + 8
        const float4* sp = reinterpret_cast<const float4*>(sums + 128 * buf);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!(near >> (2 * j) & 3u)) continue;
          const float4 top = sp[8 * j + t], bot = sp[8 * j + 4 + t];
          float sv[4] = {top.x + top.y, top.z + top.w, bot.x + bot.y, bot.z + bot.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = sv[i] > 0.0f ? sv[i] : -INFINITY;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = 8 * j + 2 * h;
            if ((near >> (2 * j + h) & 1u) &&
                !near_tie(z[o], z[o + 1], z[o + 4], z[o + 5], bc[h], sv[0], sv[1], sv[2], sv[3],
                          wband[h], bband[h]))
              near &= ~(1u << (2 * j + h));
          }
        }
      }
      while (near) {  // rare: the windows near a tie, by the f32 chain
        const int f = __ffs(near) - 1;
        near &= near - 1;
        float z00, z01, z10, z11;
        chain_window(planes, ps / 2, 2 * prl, kFwdChunk * ch + 4 * (f >> 1) + t,
                     ws + warp * 16 + g + 8 * (f & 1), z00, z01, z10, z11);
        uint32_t top, bot;
        window_mask(z00, z01, z10, z11, f & 1 ? bc[1] : bc[0], true, top, bot);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (f == 2 * j + h) {
              m[j][h] = top;
              m[j][h + 2] = bot;
            }
          }
        }
      }

      float ts[16];
      fvx::wgmma_fence();
      tap_sums(ts, m, base, kTnspLbo, kTnspSbo);
      fvx::wgmma_commit();
      fvx::wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 16; ++i) fvx::reg_fence(ts[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) fvx::reg_fence(m[j][r]);
      }
      // one FMA a column: the dW columns by gh; column 25 (db; i = 3, t =
      // 0, e = 1) by gf, as the zero columns 27, 29, 31 are
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 4 * i + 2 * h + e;
            acc[r] = fmaf(i == 3 && e == 1 ? gf[h] : gh[h], ts[r], acc[r]);
          }
        }
      }
      fvx::fence_proxy_async();  // tile nt + 1 written; tile nt read
      __syncthreads();
      prl = prl1;
      ch = ch1;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * i + 2 * t + e;
        const int c = cw0 + 8 * h;
        if (j < kAcc && c < C)
          partial[(static_cast<long long>(blockIdx.x) * kAcc + j) * C + c] = acc[4 * i + 2 * h + e];
      }
    }
  }
}

// dwb[t, c] = sum_k partial[k, t, c], blocks in order
__global__ void __launch_bounds__(kReduceThreads)
edge_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dwb,
                       int n_blocks, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kAcc * C) return;
  float s = 0.0f;
  for (int k = 0; k < n_blocks; ++k) s += partial[static_cast<long long>(k) * kAcc * C + i];
  dwb[i] = s;
}

// Probes of the tensor cores (card tests and chip_smoke.py; nothing on the
// main path launches them).  One block of one warpgroup each.
//
// d = c + a . b over one 64 x 64 x 16 product: a [64, 16] bf16 row-major,
// b [64, 16] bf16 (row n holds column n's 16 k), c and d [64, 64] f32
// row-major; by wgmma.m64n64k16 (A in registers, B K-major in shared memory,
// as the forward's conv) or, with use_mma, by mma.sync.m16n8k16 (warp w rows
// 16w .., eight n-tiles), so that crafted operands show how each rounds its
// f32 sums.
__global__ void __launch_bounds__(kFwdThreads)
probe_sums_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ b,
                  const float* __restrict__ c, float* __restrict__ d, int use_mma) {
  __shared__ __align__(128) uint4 tile[2 * 64];  // k-group q of row n at q * 64 + n
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  tile[threadIdx.x] = reinterpret_cast<const uint4*>(b)[2 * (threadIdx.x % 64) + threadIdx.x / 64];
  const int r0 = 16 * warp + g;
  auto pair = [](const uint16_t* m, int row, int k) {
    return *reinterpret_cast<const uint32_t*>(m + row * 16 + k);
  };
  const uint32_t af[4] = {pair(a, r0, 2 * t), pair(a, r0 + 8, 2 * t), pair(a, r0, 2 * t + 8),
                          pair(a, r0 + 8, 2 * t + 8)};
  float acc[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      acc[4 * i + r] = c[(r0 + 8 * (r / 2)) * 64 + 8 * i + 2 * t + r % 2];
  }
  fvx::fence_proxy_async();
  __syncthreads();
  if (use_mma) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t bf[2] = {pair(b, 8 * i + g, 2 * t), pair(b, 8 * i + g, 2 * t + 8)};
      float cf[4] = {acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]};
      fvx::mma_bf16_16816(cf, af, bf);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[4 * i + r] = cf[r];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) fvx::reg_fence(acc[i]);
    fvx::wgmma_fence();
    fvx::wgmma_m64n64k16_bf16(acc, af, fvx::wgmma_desc(fvx::smem_u32(tile), 1024, 128));
    fvx::wgmma_commit();
    fvx::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) fvx::reg_fence(acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      d[(r0 + 8 * (r / 2)) * 64 + 8 * i + 2 * t + r % 2] = acc[4 * i + r];
  }
}

// d = a . X as the bf16 backward takes its tap sums (tap_sums): a [64, 64]
// bf16 row-major (64 rows x 64 k), X [64, 32] bf16 row-major (64 k x 32
// columns) laid out in shared memory as the im2col tile, d [64, 32] f32
// row-major; with swap the descriptors' lbo and sbo exchanged.
__global__ void __launch_bounds__(kFwdThreads)
probe_tnsp_kernel(const uint16_t* __restrict__ a, const uint16_t* __restrict__ xs,
                  float* __restrict__ d, int swap) {
  __shared__ __align__(128) uint4 tile[4 * 64];  // k-group q (columns 8q ..) of row k at q * 64 + k
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int i = threadIdx.x; i < 4 * 64; i += kFwdThreads)
    tile[i] = reinterpret_cast<const uint4*>(xs)[4 * (i % 64) + i / 64];
  const int r0 = 16 * warp + g;
  auto pair = [&](int row, int k) { return *reinterpret_cast<const uint32_t*>(a + row * 64 + k); };
  uint32_t m[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int k = 16 * s + 2 * t;
    m[s][0] = pair(r0, k);
    m[s][1] = pair(r0 + 8, k);
    m[s][2] = pair(r0, k + 8);
    m[s][3] = pair(r0 + 8, k + 8);
  }
  fvx::fence_proxy_async();
  __syncthreads();
  float ts[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ts[i] = 0.0f;
    fvx::reg_fence(ts[i]);
  }
  fvx::wgmma_fence();
  tap_sums(ts, m, fvx::smem_u32(tile), swap ? kTnspSbo : kTnspLbo, swap ? kTnspLbo : kTnspSbo);
  fvx::wgmma_commit();
  fvx::wgmma_wait0();
#pragma unroll
  for (int i = 0; i < 16; ++i) fvx::reg_fence(ts[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) d[(r0 + 8 * (r / 2)) * 32 + 8 * i + 2 * t + r % 2] = ts[4 * i + r];
  }
}

int check_geometry(long long B, long long H, long long W, long long C, long long R) {
  if (B < 1 || H < 2 || W < 2 || (H % 2) || (W % 2) || C < 1 ||
      C > (1 << 20) || R < 1 || H > (1 << 20) || W > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int check_fwd_tile(long long Rp, long long Cw) {
  if (Rp < 1 || Rp > 64 || Cw < kFwdChunk || Cw % kFwdChunk || Cw > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the forward's bytes: two im2col tiles and the staged planes (three for
// f32 images, one for bf16)
template <typename T>
size_t fwd_smem_bytes(long long Rp, long long Cw) {
  return 2 * static_cast<size_t>(kTileBytes<T>) +
         kPieces<T> * 2 * static_cast<size_t>(2 * Rp + 4) * plane_stride(static_cast<int>(Cw));
}

int check_bwd_tile(long long Rp, long long Cw) {
  if (Rp < 4 || Rp % 4 || Rp > (1 << 20) || Cw < 1 || Cw > (1 << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the backward's bytes: the staged tile of 16-byte entries, or the row-group sums
size_t bwd_smem_bytes(long long C, long long Rp, long long Cw) {
  const BwdLayout l = bwd_layout(static_cast<int>(C), static_cast<int>(Rp));
  const size_t stage = 16 * static_cast<size_t>(2 * Rp + 4) * tile_stride(static_cast<int>(Cw));
  const size_t red = 4 * static_cast<size_t>(l.nrg) * kAcc * 16 * l.mt;
  return stage > red ? stage : red;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kStageBytesMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  return 0;
}

int tower_fwd(const void* x, const void* w, const void* bias, void* partial, void* out,
              long long B, long long H, long long W, long long C, long long Rp, long long Cw,
              void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = check_fwd_tile(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  if (B * Sr * Sc > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fwd_smem_bytes<float>(Rp, Cw);
  err = allow_smem(edge_fwd_kernel, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B * Sr * Sc),
                  static_cast<unsigned>((C + kFwdChannels - 1) / kFwdChannels));
  edge_fwd_kernel<<<grid, kFwdThreads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(partial), static_cast<int>(H),
      static_cast<int>(W), static_cast<int>(C), static_cast<int>(Rp), static_cast<int>(Cw),
      static_cast<int>(Sr), static_cast<int>(Sc));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = B * C;
  edge_fwd_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B, static_cast<int>(C),
      static_cast<int>(Sr * Sc), static_cast<float>((H / 2) * (W / 2)));
  return static_cast<int>(cudaGetLastError());
}

int check_fwd_bf16_tile(long long Rp, long long Cw) {
  if (Rp < 1 || Rp > 64 || Cw < kFwdChunk || Cw % kFwdChunk || Cw > kBf16TileCols)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the bf16 forward's bytes: the weights, the sums and two
// plane sets (a plane and its shifted copy each)
size_t fwd_bf16_smem_bytes(long long Rp, long long Cw) {
  return kBf16PlaneAt +
         8 * static_cast<size_t>(bf16_plane_set(static_cast<int>(Rp), static_cast<int>(Cw)));
}

// the blocks of edge_fwd_bf16_kernel that the card holds at once
int tower_fwd_bf16_blocks(long long Rp, long long Cw, long long* blocks) {
  int err = check_fwd_bf16_tile(Rp, Cw);
  if (err) return err;
  const size_t bytes = fwd_bf16_smem_bytes(Rp, Cw);
  err = allow_smem(edge_fwd_bf16_kernel, bytes);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_fwd_bf16_kernel, kFwdThreads,
                                                      bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return 0;
}

int tower_fwd_bf16(const void* x, const void* w, const void* bias, void* partial, void* out,
                   long long n_blocks, long long B, long long H, long long W, long long C,
                   long long Rp, long long Cw, void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = check_fwd_bf16_tile(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  const long long n_items = B * Sr * Sc;
  if (n_blocks < 1 || n_blocks > n_items || n_items > (1LL << 30) ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fwd_bf16_smem_bytes(Rp, Cw);
  err = allow_smem(edge_fwd_bf16_kernel, bytes);
  if (err) return err;
  // 16-byte copies where every image row starts on 16 bytes
  const int wide = W % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((C + kFwdChannels - 1) / kFwdChannels));
  const float n = static_cast<float>((H / 2) * (W / 2));
  edge_fwd_bf16_kernel<<<grid, kFwdThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(partial), static_cast<float*>(out),
      static_cast<int>(H), static_cast<int>(W), static_cast<int>(C), static_cast<int>(Rp),
      static_cast<int>(Cw), static_cast<int>(Sr), static_cast<int>(Sc),
      static_cast<int>(n_items), n, wide);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || Sr * Sc == 1) return static_cast<int>(e);
  const long long n_out = B * C;
  edge_fwd_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B, static_cast<int>(C),
      static_cast<int>(Sr * Sc), n);
  return static_cast<int>(cudaGetLastError());
}

// The backward of image type T: its kernel, tile check, block size and
// shared memory (f32 images: edge_bwd_kernel over bwd_tiles; bf16 ones:
// edge_bwd_wgmma_kernel over the forward's tiles)
template <typename T>
struct Bwd;
template <>
struct Bwd<float> {
  static constexpr auto kernel = edge_bwd_kernel;
  static int check(long long Rp, long long Cw) { return check_bwd_tile(Rp, Cw); }
  static int threads(long long C, long long Rp) {
    return bwd_layout(static_cast<int>(C), static_cast<int>(Rp)).threads;
  }
  static size_t bytes(long long C, long long Rp, long long Cw) { return bwd_smem_bytes(C, Rp, Cw); }
};
template <>
struct Bwd<__nv_bfloat16> {
  static constexpr auto kernel = edge_bwd_wgmma_kernel;
  static int check(long long Rp, long long Cw) { return check_fwd_tile(Rp, Cw); }
  static int threads(long long, long long) { return kFwdThreads; }
  static size_t bytes(long long, long long Rp, long long Cw) {
    return fwd_smem_bytes<__nv_bfloat16>(Rp, Cw) + kBwdSumBytes + kBwdWeightBytes;
  }
};

template <typename T>
int tower_bwd_blocks(long long C, long long Rp, long long Cw, long long* blocks) {
  int err = Bwd<T>::check(Rp, Cw);
  if (err) return err;
  const size_t bytes = Bwd<T>::bytes(C, Rp, Cw);
  err = allow_smem(Bwd<T>::kernel, bytes);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Bwd<T>::kernel,
                                                      Bwd<T>::threads(C, Rp), bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <typename T>
int tower_bwd(const void* x, const void* w, const void* bias, const void* dout, void* partial,
              long long n_blocks, void* dwb, long long B, long long H, long long W,
              long long C, long long Rp, long long Cw, void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = Bwd<T>::check(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  if (n_blocks < 1 || n_blocks > B * Sr * Sc || n_blocks > (1LL << 30) || Sr * Sc > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = Bwd<T>::bytes(C, Rp, Cw);
  err = allow_smem(Bwd<T>::kernel, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((C + kBwdGroupChannels - 1) / kBwdGroupChannels));
  const auto kernel = Bwd<T>::kernel;
  kernel<<<grid, Bwd<T>::threads(C, Rp), bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(dout),
      static_cast<float*>(partial), static_cast<int>(H), static_cast<int>(W),
      static_cast<int>(C), static_cast<int>(Rp), static_cast<int>(Cw), static_cast<int>(Sr),
      static_cast<int>(Sc), B * Sr * Sc, static_cast<float>((H / 2) * (W / 2)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kAcc * static_cast<int>(C);
  edge_bwd_reduce_kernel<<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                           st>>>(static_cast<const float*>(partial), static_cast<float*>(dwb),
                                 static_cast<int>(n_blocks), static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  Arrays contiguous, on the current device:
// x [B, H, W] f32 (the _bf16 entry points: bf16), w [25, C] f32 (HWIO [5,
// 5, 1, C]), bias [C] f32, out [B, C] f32, dout [B, C] f32, dwb [26, C] f32
// (dW rows 0..24, db row 25).  Each returns the cudaError_t of its launches
// (0 = launched).
//
// The forward over tiles of Rp pooled rows (1..64) by Cw pooled columns (a
// multiple of 16 up to 256): S = ceil((H/2) / Rp) * ceil((W/2) / Cw) tiles an
// image, grid B*S by the groups of 64 channels; `partial` is scratch of
// B*S*C floats.
extern "C" int fvx_edge_tower_fwd(const void* x, const void* w, const void* bias,
                                  void* partial, void* out, long long B, long long H,
                                  long long W, long long C, long long Rp, long long Cw,
                                  void* stream) {
  return tower_fwd(x, w, bias, partial, out, B, H, W, C, Rp, Cw, stream);
}

// The bf16 forward's grid: the blocks of one channel group that the card
// holds at once for tiles of Rp pooled rows (1..64) by Cw pooled columns (a
// multiple of 16 up to 96); written to *blocks.
extern "C" int fvx_edge_tower_fwd_blocks_bf16(long long Rp, long long Cw, long long* blocks) {
  return tower_fwd_bf16_blocks(Rp, Cw, blocks);
}

// The bf16 forward over those tiles: n_items = B * S tiles (S as above),
// grid n_blocks (1 <= n_blocks <= n_items) by the groups of 64 channels;
// with S = 1 it writes out itself, else `partial` (scratch of B*S*C floats)
// and a second kernel sums each image's tiles in order.  x on 4 bytes.
extern "C" int fvx_edge_tower_fwd_bf16(const void* x, const void* w, const void* bias,
                                       void* partial, void* out, long long n_blocks,
                                       long long B, long long H, long long W, long long C,
                                       long long Rp, long long Cw, void* stream) {
  return tower_fwd_bf16(x, w, bias, partial, out, n_blocks, B, H, W, C, Rp, Cw, stream);
}

// The backward's grid: the blocks of one channel group that the card holds
// at once (its SMs times the blocks an SM holds) for tiles of Rp pooled rows
// by Cw pooled columns (f32 images: Rp a multiple of 4; bf16 images: the
// forward's tiles); written to *blocks.
extern "C" int fvx_edge_tower_bwd_blocks(long long C, long long Rp, long long Cw,
                                         long long* blocks) {
  return tower_bwd_blocks<float>(C, Rp, Cw, blocks);
}
extern "C" int fvx_edge_tower_bwd_blocks_bf16(long long C, long long Rp, long long Cw,
                                              long long* blocks) {
  return tower_bwd_blocks<__nv_bfloat16>(C, Rp, Cw, blocks);
}

// The backward over tiles of Rp pooled rows by Cw pooled columns (f32
// images: Rp a multiple of 4; bf16 images: the forward's tiles): n_items = B
// * ceil((H/2) / Rp) * ceil((W/2) / Cw) tiles, grid n_blocks (1 <= n_blocks
// <= n_items) by the groups of 64 channels; `partial` is scratch of
// n_blocks*26*C floats.
extern "C" int fvx_edge_tower_bwd(const void* x, const void* w, const void* bias,
                                  const void* dout, void* partial, long long n_blocks,
                                  void* dwb, long long B, long long H, long long W,
                                  long long C, long long Rp, long long Cw, void* stream) {
  return tower_bwd<float>(x, w, bias, dout, partial, n_blocks, dwb, B, H, W, C, Rp, Cw, stream);
}
extern "C" int fvx_edge_tower_bwd_bf16(const void* x, const void* w, const void* bias,
                                       const void* dout, void* partial, long long n_blocks,
                                       void* dwb, long long B, long long H, long long W,
                                       long long C, long long Rp, long long Cw, void* stream) {
  return tower_bwd<__nv_bfloat16>(x, w, bias, dout, partial, n_blocks, dwb, B, H, W, C, Rp, Cw,
                                  stream);
}

// The probes (probe_sums_kernel, probe_tnsp_kernel), one block each on the
// current stream; for tests only.
extern "C" int fvx_edge_tower_probe_sums(const void* a, const void* b, const void* c, void* d,
                                         int use_mma, void* stream) {
  probe_sums_kernel<<<1, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<const float*>(c), static_cast<float*>(d), use_mma);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int fvx_edge_tower_probe_tnsp(const void* a, const void* x, void* d, int swap,
                                         void* stream) {
  probe_tnsp_kernel<<<1, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(x), static_cast<float*>(d),
      swap);
  return static_cast<int>(cudaGetLastError());
}
