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
// peak).  The backward recomputes the conv in f32 FMAs on the CUDA cores
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
// * Tiles.  A block (one warpgroup) takes an item: one image's tile of up
//   to 16 pooled rows by Cw pooled columns (a multiple of 16, at most 64),
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
//   If the tensor cores truncate once per k16 step rather than per
//   addition, the hh term falls to 2.02 * 2^-23 A.  What decides is the
//   card: chip_smoke.py holds the kernel to the plain version at that
//   tolerance on uniform, constant, k/255 and worst-case-split data.
//   The forward makes no decision that anything reads: the backward
//   decides winners itself with the f32 conv2x2 chain.
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
// gradient to it before the dW products).  Both kernels are templates on
// the image type T; T = float is the f32 tower above, unchanged.  With T =
// __nv_bfloat16 the weights are rounded to bf16 (nearest, even) and each
// pixel is one exact bf16 piece, so every conv product is exact in f32 and
// only the f32 sums round:
// * Forward: the wh.xh product alone, 2 k16 steps a tile (not 12), one
//   staged plane read from the image as 2-byte words, a 4 KB im2col tile
//   (not 12 KB); + bias, ReLU, the 2x2 max and the mean in f32 as above.
// * Backward: the conv recomputed in f32 from the rounded weights and the
//   bf16 pixels, the same tie rule; one tap-sum product a B fragment (not
//   three); dW scaled by g rounded to bf16 and db by the f32 g, with g =
//   dout * (1 / ((H/2)(W/2))) as the JAX kernel's Sel product gives it.
// Bounds at the bf16 rate with 2-byte images are in chip_smoke.py.

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
constexpr uint32_t kBf16One = 0x3F80u;

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

// The kH-th half (k-groups kG/2 kH .. of the kG) of one pixel's row of the
// im2col tile: k-group kg holds taps 8 (kg % 4) .. + 7 of piece kg / 4 (hi,
// mid, lo; kG = 12 for f32 images, 4 for bf16 ones), zero past tap 24.
// `win` is the pixel's 5x5 window (its top-left entry) in the hi plane; `n`
// the pixel's row of the tile.
template <int kH, int kG>
__device__ __forceinline__ void write_im2col(uint4* tile, const uint16_t* win, int plane,
                                             int ps, int n) {
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
      const uint32_t hi = j1 < kTaps ? p[(j1 / 5) * ps + j1 % 5] : 0u;
      v[e] = lo | hi << 16;
    }
    tile[kg * 64 + n] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the descriptor of k16 step s of piece `piece` of an im2col tile at `base`
__device__ __forceinline__ uint64_t im2col_desc(uint32_t base, int piece, int s) {
  return fvx::wgmma_desc(base + (4 * piece + 2 * s) * 1024, 1024, 128);
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 3)
edge_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ partial,
                int H, int W, int C, int Rp, int Cw, int Sr, int Sc) {
  constexpr int kTile = kTileBytes<T>;
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

  // the weights as the A operand, in registers for the block's life: rows
  // g and g + 8 of the warp's 16 channels, taps 16 s + 2t (+1) and + 8
  uint32_t ah[2][4], am[2][4], al[2][4];
  const int cw0 = blockIdx.y * kFwdChannels + warp * 16 + g;
  float bc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = cw0 + 8 * h;
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

  // the tile's input rows 2 r0 - 2 .. and columns 2 q0 - 2 .., zero
  // outside the image, as three planes of bf16 pieces (bf16 images: one
  // plane, the pixels' own bits)
  {
    const T* img = x + b * H * W;
    const int half = ps / 2;
    const int n = (2 * Rp + 4) * half;
    for (int i = tid; i < n; i += kFwdThreads) {
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

  // this thread writes row n of each im2col tile: pixel n = 16 j + 8 r + 2 t'
  // + e is column 2 t' + e of pool window 4 j + t' (of the N tile's 16), in
  // its top (r = 0) or bottom row; half kH of its k-groups
  const int n = tid % 64;
  const int wrow = (n / 8) % 2;
  const int wcol = 8 * (n / 16) + n % 8;  // conv column in the N tile's 32
  const uint16_t* hi_plane = reinterpret_cast<const uint16_t*>(planes);
  auto write_tile = [&](int nt) {
    const int prl = nt / nchunks, ch = nt % nchunks;
    const uint16_t* win = hi_plane + (2 * prl + wrow) * ps + 2 * kFwdChunk * ch + wcol;
    uint4* tile = tiles + (nt % 2) * (kTile / 16);
    if (tid < 64) write_im2col<0, 4 * kPieces<T>>(tile, win, plane, ps, n);
    else write_im2col<1, 4 * kPieces<T>>(tile, win, plane, ps, n);
  };

  __syncthreads();  // the planes are staged
  write_tile(0);
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
      if constexpr (kSplit<T>) {
        dx[i] = 0.0f;
        fvx::reg_fence(dx[i]);
      }
    }
    fvx::wgmma_fence();
    // every product unconditional: a product under a branch makes ptxas
    // put a warpgroup.arrive before each one
#pragma unroll
    for (int st = 0; st < 2; ++st) fvx::wgmma_m64n64k16_bf16(dh, ah[st], im2col_desc(base, 0, st));
    if constexpr (kSplit<T>) {
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        fvx::wgmma_m64n64k16_bf16(dx, am[st], im2col_desc(base, 0, st));
        fvx::wgmma_m64n64k16_bf16(dx, al[st], im2col_desc(base, 0, st));
        fvx::wgmma_m64n64k16_bf16(dx, ah[st], im2col_desc(base, 1, st));
        fvx::wgmma_m64n64k16_bf16(dx, am[st], im2col_desc(base, 1, st));
        fvx::wgmma_m64n64k16_bf16(dx, ah[st], im2col_desc(base, 2, st));
      }
    }
    fvx::wgmma_commit();
    // the next tile on the CUDA cores while the tensor cores take this one
    if (nt + 1 < n_tiles) write_tile(nt + 1);
    fvx::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fvx::reg_fence(dh[i]);
      if constexpr (kSplit<T>) fvx::reg_fence(dx[i]);
    }
    // conv output i of this thread's accumulator: hi x hi plus the cross
    // products (f32 images), or the one product's sum (bf16)
    auto z = [&](int i) {
      if constexpr (kSplit<T>) return dh[i] + dx[i];
      else return dh[i];
    };

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

// One entry of the backward's staged tile: the three bf16 pieces of the
// pixel pair (x[cx], x[cx + 1]) as bf16x2 fragment registers, and x[cx].
// A B fragment of the tap sums is two such pairs, the top and the bottom
// row of a pool window at the tap's offset.  bf16 images: the pair's own
// bits (one exact piece; the other two words unused), and x[cx] in f32.
template <typename T>
__device__ __forceinline__ void stage_tile(uint4* s, const T* __restrict__ img, int H, int W,
                                           int y0, int x0, int rows, int cols, int ws) {
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ry = i / cols;
    const int cx = i - ry * cols;
    const int y = y0 + ry;
    const int xx = x0 + cx;
    uint4 e;
    if constexpr (kSplit<T>) {
      float2 v = make_float2(0.0f, 0.0f);
      if (y >= 0 && y < H) {
        const float* row = img + static_cast<long long>(y) * W;
        if (xx >= 0 && xx < W) v.x = row[xx];
        if (xx + 1 >= 0 && xx + 1 < W) v.y = row[xx + 1];
      }
      fvx::split3_bf16x2(v, e.x, e.y, e.z);
      e.w = __float_as_uint(v.x);
    } else {
      uint32_t lo = 0u, hi = 0u;
      if (y >= 0 && y < H) {
        const uint16_t* row = reinterpret_cast<const uint16_t*>(img) + static_cast<long long>(y) * W;
        if (xx >= 0 && xx < W) lo = row[xx];
        if (xx + 1 >= 0 && xx + 1 < W) hi = row[xx + 1];
      }
      e = make_uint4(lo | hi << 16, 0u, 0u, lo << 16);
    }
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

// The winner of one pool window for one channel, by the f32 conv2x2 chain
// and the tie rule, as the window's two rows of the 0/1 mask operand: a
// bf16x2 of (left, right) for the top row and for the bottom row.
__device__ __forceinline__ void winner_mask(const float (&win)[6][6], const float (&wr)[kTaps],
                                            float bc, bool ok, uint32_t& top, uint32_t& bot) {
  float z00, z01, z10, z11;
  conv2x2(win, wr, z00, z01, z10, z11);
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

// acc += g * T for the two channels of this lane (rows g and g + 8 of the
// m-tile), then T = 0.  The dW columns take gh: g itself for f32 images, g
// rounded to bf16 for bf16 ones (the JAX kernel's dze.astype(bf16)); the
// odd columns of n-tile 3, db (25) and the zero columns 27, 29, 31, take g
__device__ __forceinline__ void flush_taps(float (&acc)[4][4], float (&tsum)[4][4], float g0,
                                           float g1, float gh0, float gh1) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    acc[nt][0] = fmaf(gh0, tsum[nt][0], acc[nt][0]);
    acc[nt][1] = fmaf(nt == 3 ? g0 : gh0, tsum[nt][1], acc[nt][1]);
    acc[nt][2] = fmaf(gh1, tsum[nt][2], acc[nt][2]);
    acc[nt][3] = fmaf(nt == 3 ? g1 : gh1, tsum[nt][3], acc[nt][3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) tsum[nt][i] = 0.0f;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(32 * kBwdWarps, 3)
edge_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
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
    if constexpr (!kSplit<T>) {  // the forward's weights: rounded to bf16
      w0[k] = round_bf16(w0[k]);
      w1[k] = round_bf16(w1[k]);
    }
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
    float g0, g1, gh0, gh1;
    if constexpr (kSplit<T>) {
      g0 = gh0 = act0 ? dout[b * C + c0] / n : 0.0f;
      g1 = gh1 = act1 ? dout[b * C + c1] / n : 0.0f;
    } else {  // dout times the f32 reciprocal, as the JAX kernel's Sel product
      const float inv = 1.0f / n;
      g0 = act0 ? dout[b * C + c0] * inv : 0.0f;
      g1 = act1 ? dout[b * C + c1] * inv : 0.0f;
      gh0 = round_bf16(g0);
      gh1 = round_bf16(g1);
    }
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
          if constexpr (kSplit<T>) {
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
          } else {  // the pair's one piece: the first word of each entry
            const uint32_t* words = reinterpret_cast<const uint32_t*>(rows);
            uint32_t bh[2] = {words[4 * (2 * pc + boff[nt])],
                              words[4 * (2 * pc + boff[nt] + ws)]};
            if (nt == 3 && 8 * 3 + g >= kTaps) bh[0] = bh[1] = col3;
            fvx::mma_bf16_16816(tsum[nt], a, bh);
          }
        }
        shift_window(win);
        if (++slabs == kFlushSlabs) {
          flush_taps(acc, tsum, g0, g1, gh0, gh1);
          slabs = 0;
        }
      }
    }
    flush_taps(acc, tsum, g0, g1, gh0, gh1);
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

template <typename T>
int tower_fwd(const void* x, const void* w, const void* bias, void* partial, void* out,
              long long B, long long H, long long W, long long C, long long Rp, long long Cw,
              void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = check_fwd_tile(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  if (B * Sr * Sc > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = fwd_smem_bytes<T>(Rp, Cw);
  err = allow_smem(edge_fwd_kernel<T>, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B * Sr * Sc),
                  static_cast<unsigned>((C + kFwdChannels - 1) / kFwdChannels));
  edge_fwd_kernel<T><<<grid, kFwdThreads, bytes, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
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

template <typename T>
int tower_bwd_blocks(long long C, long long Rp, long long Cw, long long* blocks) {
  int err = check_bwd_tile(Rp, Cw);
  if (err) return err;
  const size_t bytes = bwd_smem_bytes(C, Rp, Cw);
  err = allow_smem(edge_bwd_kernel<T>, bytes);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, edge_bwd_kernel<T>,
        bwd_layout(static_cast<int>(C), static_cast<int>(Rp)).threads, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return 0;
}

template <typename T>
int tower_bwd(const void* x, const void* w, const void* bias, const void* dout, void* partial,
              long long n_blocks, void* dwb, long long B, long long H, long long W,
              long long C, long long Rp, long long Cw, void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = check_bwd_tile(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  if (n_blocks < 1 || n_blocks > B * Sr * Sc || n_blocks > (1LL << 30) || Sr * Sc > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = bwd_smem_bytes(C, Rp, Cw);
  err = allow_smem(edge_bwd_kernel<T>, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((C + kBwdGroupChannels - 1) / kBwdGroupChannels));
  edge_bwd_kernel<T><<<grid, bwd_layout(static_cast<int>(C), static_cast<int>(Rp)).threads,
                       bytes, st>>>(
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
  return tower_fwd<float>(x, w, bias, partial, out, B, H, W, C, Rp, Cw, stream);
}
extern "C" int fvx_edge_tower_fwd_bf16(const void* x, const void* w, const void* bias,
                                       void* partial, void* out, long long B, long long H,
                                       long long W, long long C, long long Rp, long long Cw,
                                       void* stream) {
  return tower_fwd<__nv_bfloat16>(x, w, bias, partial, out, B, H, W, C, Rp, Cw, stream);
}

// The backward's grid: the blocks of one channel group that the card holds
// at once (its SMs times the blocks an SM holds) for tiles of Rp pooled rows
// (a multiple of 4) by Cw pooled columns; written to *blocks.
extern "C" int fvx_edge_tower_bwd_blocks(long long C, long long Rp, long long Cw,
                                         long long* blocks) {
  return tower_bwd_blocks<float>(C, Rp, Cw, blocks);
}
extern "C" int fvx_edge_tower_bwd_blocks_bf16(long long C, long long Rp, long long Cw,
                                              long long* blocks) {
  return tower_bwd_blocks<__nv_bfloat16>(C, Rp, Cw, blocks);
}

// The backward over tiles of Rp pooled rows (a multiple of 4) by Cw pooled
// columns: n_items = B * ceil((H/2) / Rp) * ceil((W/2) / Cw) tiles, grid
// n_blocks (1 <= n_blocks <= n_items) by the groups of 64 channels;
// `partial` is scratch of n_blocks*26*C floats.
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
