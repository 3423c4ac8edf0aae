// Fused edge-encoder tower (K7), forward and backward, for Hopper (sm_90a).
//
// For single-channel images x [B, H, W] (H, W even), filters w [5, 5, 1, C]
// (HWIO) and bias [C]:
//   z[b, y, x, c] = sum_{ky,kx} w[ky, kx, c] * x[b, y+ky-2, x+kx-2]
//                   (5x5 SAME cross-correlation, zero padding 2)
//   out[b, c]     = mean_{i < H/2, j < W/2}
//                   relu(max_{dy,dx in {0,1}} z[b, 2i+dy, 2j+dx, c] + bias[c])
// The [B, H, W, C] activation is never written: each thread keeps its conv
// outputs in registers and adds the pooled value to its channel's sum.
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
// the image, (5H-6)(5W-6) per channel and image: 2*154^2*C*B f32
// operations, 24.9 GFLOP at B=8192, 32x32, C=64 (0.37 ms at 67 TFLOP/s),
// against ~34 MB of images (0.01 ms).  The backward adds one FMA per valid
// tap of each winning conv output whose pre-activation is > 0 (dW), which
// it runs on the tensor cores as three exact bf16 products (0.014 ms at
// 989 TFLOP/s at that shape): the recomputed conv bounds it too.  The
// kernels themselves run all 25 taps on the zero halo.
//
// Forward (direct convolution on the CUDA cores, f32 FMAs, no TF32, no fast
// math).  The TPU kernel turned the conv into banded matmuls for the MXU and
// kept whole images in VMEM; neither is needed here.  A block takes one
// strip of R pooled rows of one image and stages its 2R+4 input rows, with
// a zero halo of 2 on every side, in shared memory; blockIdx.y picks a group
// of at most 256 channels (8 warps of 32), so any C runs.  Thread (c, rg)
// owns channel c (its 25 weights and bias in registers) and every nrg-th pooled
// row of the strip; it walks the row keeping a 6x6 input window in
// registers (two new columns per pooled pixel, float2 loads that every lane
// of the warp shares), computes the 2x2 conv outputs of the pooled pixel and
// pools them.  The forward sums each channel's pooled values per strip in a
// fixed order (thread, then row groups) into per-strip partials; a second
// kernel sums the strips of an image in order and divides by (H/2)(W/2).
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
// recomputes its window's four conv values with the forward's conv2x2
// (its decisions are the forward's bit for bit), applies the tie rule and
// writes the mask straight into its A registers.  The B fragments are the
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

#include <cstdint>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kTaps = 25;
constexpr int kAcc = kTaps + 1;  // dW taps, then db
constexpr int kThreads = 256;
constexpr int kMaxChannelWarps = kThreads / 32;
constexpr int kGroupChannels = 32 * kMaxChannelWarps;  // channels of one block
constexpr int kReduceThreads = 256;
constexpr int kStageBytesMax = 232448;  // an H100 block's dynamic shared memory

struct Layout {
  int cw;   // warps across the block's channels (32 channels each)
  int nrg;  // row groups
  int threads;
};

__host__ __device__ inline Layout layout(int C) {
  Layout l;
  l.cw = ((C < kGroupChannels ? C : kGroupChannels) + 31) / 32;
  l.nrg = kMaxChannelWarps / l.cw;
  l.threads = 32 * l.cw * l.nrg;
  return l;
}

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

// rows 2*r0-2 .. 2*r1+1 of image `img`, columns -2 .. W+1, zero outside
__device__ __forceinline__ void stage_strip(float* s, const float* __restrict__ img,
                                            int H, int W, int r0, int r1) {
  const int ws = W + 4;
  const int y0 = 2 * r0 - 2;
  const int n = (2 * (r1 - r0) + 4) * ws;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ry = i / ws;
    const int y = y0 + ry;
    const int x = i - ry * ws - 2;
    s[i] = (y >= 0 && y < H && x >= 0 && x < W)
               ? img[static_cast<long long>(y) * W + x] : 0.0f;
  }
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

__device__ __forceinline__ void load_cols(float (&win)[6][6], const float* rows, int ws,
                                          int col, int slot) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float2 v = *reinterpret_cast<const float2*>(rows + r * ws + col);
    win[r][slot] = v.x;
    win[r][slot + 1] = v.y;
  }
}

__device__ __forceinline__ void shift_window(float (&win)[6][6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) win[r][q] = win[r][q + 2];
  }
}

__global__ void __launch_bounds__(kThreads)
edge_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ partial,
                int H, int W, int C, int R, int S) {
  extern __shared__ float smem[];
  const Layout l = layout(C);
  const int warp = threadIdx.x / 32;
  const int rg = warp / l.cw;
  const int cl = (warp % l.cw) * 32 + threadIdx.x % 32;  // channel in the group
  const int c = blockIdx.y * kGroupChannels + cl;
  const bool active = c < C;
  float wr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) wr[t] = active ? w[t * C + c] : 0.0f;
  const float bc = active ? bias[c] : 0.0f;

  const int Hp = H / 2, Wp = W / 2, ws = W + 4;
  const long long item = blockIdx.x;
  const long long b = item / S;
  const int r0 = static_cast<int>(item % S) * R;
  const int r1 = min(r0 + R, Hp);
  stage_strip(smem, x + b * H * W, H, W, r0, r1);
  __syncthreads();

  float acc = 0.0f;
  for (int pr = r0 + rg; pr < r1; pr += l.nrg) {
    const float* rows = smem + 2 * (pr - r0) * ws;
    float win[6][6];
    load_cols(win, rows, ws, 0, 0);
    load_cols(win, rows, ws, 2, 2);
    for (int pc = 0; pc < Wp; ++pc) {
      load_cols(win, rows, ws, 2 * pc + 4, 4);
      float z00, z01, z10, z11;
      conv2x2(win, wr, z00, z01, z10, z11);
      const float top = fmaxf(fmaxf(z00, z01) + bc, 0.0f);
      const float bot = fmaxf(fmaxf(z10, z11) + bc, 0.0f);
      acc += fmaxf(top, bot);
      shift_window(win);
    }
  }

  __syncthreads();  // the strip is read; its memory now holds the row sums
  const int cpad = 32 * l.cw;
  smem[rg * cpad + cl] = acc;
  __syncthreads();
  if (rg == 0 && active) {
    float s = 0.0f;
    for (int g = 0; g < l.nrg; ++g) s += smem[g * cpad + cl];
    partial[item * C + c] = s;
  }
}

// out[b, c] = sum_s partial[b, s, c] / n, strips in order
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
// row of a pool window at the tap's offset.
__device__ __forceinline__ void stage_tile(uint4* s, const float* __restrict__ img, int H,
                                           int W, int y0, int x0, int rows, int cols,
                                           int ws) {
  const int n = rows * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ry = i / cols;
    const int cx = i - ry * cols;
    const int y = y0 + ry;
    const int xx = x0 + cx;
    float2 v = make_float2(0.0f, 0.0f);
    if (y >= 0 && y < H) {
      const float* row = img + static_cast<long long>(y) * W;
      if (xx >= 0 && xx < W) v.x = row[xx];
      if (xx + 1 >= 0 && xx + 1 < W) v.y = row[xx + 1];
    }
    uint4 e;
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

// The winner of one pool window for one channel, by the forward's conv2x2
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

long long groups(long long C) { return (C + kGroupChannels - 1) / kGroupChannels; }

// bytes of dynamic shared memory: the staged strip, or the row-group sums
size_t smem_bytes(long long W, long long C, long long R) {
  const Layout l = layout(static_cast<int>(C));
  const size_t stage = static_cast<size_t>(2 * R + 4) * static_cast<size_t>(W + 4);
  const size_t red = static_cast<size_t>(l.nrg) * 32 * l.cw;
  return 4 * (stage > red ? stage : red);
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

}  // namespace

// Plain C interface for ctypes.  All arrays f32, contiguous, on the current
// device: x [B, H, W], w [25, C] (HWIO [5, 5, 1, C]), bias [C], out [B, C],
// dout [B, C], dwb [26, C] (dW rows 0..24, db row 25).  R is the number of
// pooled rows per strip (S = ceil((H/2) / R) strips an image).  `partial` is
// scratch: B*S*C floats for the forward, n_blocks*26*C for the backward,
// whose grid is n_blocks (1 <= n_blocks <= B*S) by the channel groups.  Each
// returns the cudaError_t of its launches (0 = launched).
extern "C" int fvx_edge_tower_fwd(const void* x, const void* w, const void* bias,
                                  void* partial, void* out, long long B, long long H,
                                  long long W, long long C, long long R, void* stream) {
  int err = check_geometry(B, H, W, C, R);
  if (err) return err;
  const long long S = (H / 2 + R - 1) / R;
  const size_t bytes = smem_bytes(W, C, R);
  err = allow_smem(edge_fwd_kernel, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(B * S), static_cast<unsigned>(groups(C)));
  edge_fwd_kernel<<<grid, layout(static_cast<int>(C)).threads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(partial), static_cast<int>(H),
      static_cast<int>(W), static_cast<int>(C), static_cast<int>(R), static_cast<int>(S));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_out = B * C;
  edge_fwd_reduce_kernel<<<static_cast<unsigned>((n_out + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), B, static_cast<int>(C),
      static_cast<int>(S), static_cast<float>((H / 2) * (W / 2)));
  return static_cast<int>(cudaGetLastError());
}

// The backward's grid: the blocks of one channel group that the card holds
// at once (its SMs times the blocks an SM holds) for tiles of Rp pooled rows
// (a multiple of 4) by Cw pooled columns; written to *blocks.
extern "C" int fvx_edge_tower_bwd_blocks(long long C, long long Rp, long long Cw,
                                         long long* blocks) {
  int err = check_bwd_tile(Rp, Cw);
  if (err) return err;
  const size_t bytes = bwd_smem_bytes(C, Rp, Cw);
  err = allow_smem(edge_bwd_kernel, bytes);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, edge_bwd_kernel, bwd_layout(static_cast<int>(C), static_cast<int>(Rp)).threads,
        bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// The backward over tiles of Rp pooled rows (a multiple of 4) by Cw pooled
// columns: n_items = B * ceil((H/2) / Rp) * ceil((W/2) / Cw) tiles, grid
// n_blocks (1 <= n_blocks <= n_items) by the groups of 64 channels.
extern "C" int fvx_edge_tower_bwd(const void* x, const void* w, const void* bias,
                                  const void* dout, void* partial, long long n_blocks,
                                  void* dwb, long long B, long long H, long long W,
                                  long long C, long long Rp, long long Cw, void* stream) {
  int err = check_geometry(B, H, W, C, Rp);
  if (!err) err = check_bwd_tile(Rp, Cw);
  if (err) return err;
  const long long Sr = (H / 2 + Rp - 1) / Rp;
  const long long Sc = (W / 2 + Cw - 1) / Cw;
  if (n_blocks < 1 || n_blocks > B * Sr * Sc || n_blocks > (1LL << 30) || Sr * Sc > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = bwd_smem_bytes(C, Rp, Cw);
  err = allow_smem(edge_bwd_kernel, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>((C + kBwdGroupChannels - 1) / kBwdGroupChannels));
  edge_bwd_kernel<<<grid, bwd_layout(static_cast<int>(C), static_cast<int>(Rp)).threads, bytes,
                    st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
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
