// Fused scoring + >=-position counts (streaming evaluation) for Hopper,
// sm_90a.
//
//   out[u, t] = |{ items i : i not banned for u, iv[i] . uf[u] + ib[i] >= ref[u, t] }|
//
// in f32, with the banned ids given per 2048-item tile (or any item_tile,
// a multiple of 128) as tile-LOCAL offsets, loc[tile, u, w], -1 = none.
// Replaces the TPU kernel fashionvisualexpl_tpu/ops/counts.py::_kernel
// (behind counts_kernel and streaming_counts_pallas); the wrapper, its plain
// PyTorch version and the launch count are in
// fashionvisualexpl_tpu_torch/ops/counts.py.
//
// The counts are those of one f32 score per (user, item): the fmaf chain
// over d in ascending order from 0, then + ib[i] (f32), then >= ref.  That
// is what the first design of this kernel computed on the CUDA cores, and
// the counts stay identical to it on any data.
//
// What bounds it: operations.  The product is 2*B*Ip*D operations: at the
// streaming evaluator's shapes (B=4096 users, Ip=501,760 items, D=128) 526
// GFLOP, 0.53 ms at the H100 SXM's 989 TFLOP/s bf16 tensor-core rate (the
// convention of the port's bounds; 7.85 ms at 67 TFLOP/s on the CUDA
// cores), against ~0.26 GB of inputs (iv 257 MB), 0.08 ms at 3.35 TB/s.
//
// Design: the product runs on the tensor cores at f32-faithful precision
// (bf16x3), and the few pairs whose approximate score lies within a proven
// bound of a reference are scored again exactly.
//
// * bf16x3.  Each f32 operand x is split (mma.cuh::split_bf16x2) into
//   hi = rn_bf16(x) and lo = rn_bf16(x - hi) (x - hi is exact in f32), and
//   acc += lo.hi' + hi.lo' + hi.hi' with mma.sync.m16n8k16 bf16 -> f32
//   (bf16 products are exact in f32): half the mma instructions of
//   3xTF32 on m16n8k8 for the same products.
//   Users are the M dimension and items N: a lane takes its fragment
//   columns k, k + 1 of uf [B, D] (A, row-major) and iv [Ip, D] (B, "col")
//   as one 8-byte shared-memory load and splits them in registers.
// * Tiles.  A block of 16 warps owns 128 users, whose f32 rows stay in
//   shared memory (copied once with cp.async), and a chunk of the catalog,
//   walked in 128-item sub-tiles, double-buffered: the next sub-tile's rows
//   arrive by cp.async (16-byte copies) while the tensor cores work on this
//   one, and this one's rows stay until its epilogue has rechecked its
//   pairs.  Each warp owns 32 users x 32 items (2 x 4 fragments).  Shared
//   rows are D + 8 words apart (8 mod 32), so the 8-byte loads are
//   conflict-free.  The catalog is cut into chunks so that about eight
//   blocks per SM are launched in turn (4096 users make only 32 user
//   tiles).
// * The band.  For each pair the epilogue forms s~ = acc + ib[i] and, for
//   each reference r, decides directly where s~ - r > eps or s~ - r < -eps;
//   otherwise (and wherever s~, r or eps is not finite) it marks the pair,
//   and the marked pairs are scored again, one a lane at a time with every
//   lane of the warp in step, from both rows in shared memory: the fmaf
//   chain in ascending d, + ib[i], >= r.  With
//   A = sum_d |u_d v_d| <= |u|_2 |v|_2 and |b| = |ib[i]| (0 when infinite:
//   then both scores are the same infinity).  bf16 keeps 8 significant
//   bits, so with x = hi + lo + r (mma.cuh::split_bf16x2) |lo| <= 2^-8 |x|
//   and |r| <= 2^-17 |x|, and
//     |bf16x3 - exact product|  <= (2^-16 + 2 * 1.004 * 2^-17 + 2^-24) |x y|
//                                  <= 1.004 * 2^-15 * |x y| (the dropped
//                                  lo.lo' term and the split residuals
//                                  hi.r' + r.hi' + ..., on every product;
//                                  x = 1 + 2^-8 - 2^-17 - 2^-23 at D = 1
//                                  misses by 126.5 * 2^-22);
//     tensor-core accumulation  <= 3D * 2^-23 * 1.01 A if every one of the
//                                  3D additions truncates (assumed: the
//                                  rounding of the mma's f32 sum is not
//                                  documented);
//     the fmaf chain            <= D * 2^-24 * A (one rounding a step);
//     the two final f32 adds    <= 2^-24 (|s~| + |s|) <= 2^-23 (1.01 A + |b|);
//   so |s~ - s| <= (1.77 D + 129) * 2^-22 * A + 2^-23 |b|.  The kernel takes
//   at least twice each term against the mma's undocumented rounding:
//     eps = 1.001 * ((4D + 300) * 2^-22 * |u|_2 |v|_2 + 2^-22 |b|) + 2^-100,
//   the norms computed in f32 by the wrapper (their rounding, under
//   D * 2^-24 relative, is inside the 1.001), the 2^-100 for products that
//   the tensor core flushes to zero.  band_scale multiplies eps: infinity
//   sends every pair through the exact chain (0 * inf is NaN, which also
//   goes there).  A pair decided directly satisfies |s~ - r| > eps >=
//   |s~ - s|, so s - r has the sign of s~ - r: the count is the exact one.
// * Exclusion, refs and counts.  Banned offsets of the sub-tile become a
//   bit mask per user in shared memory (built one sub-tile ahead), the
//   sub-tile's bias and norms arrive with its rows, refs and the users'
//   norms sit in shared memory, each thread counts its 2 x 4 x 4 pairs per
//   reference (the compares specialised for T = 1), and the 4 lanes that share a user row add their
//   counts with warp shuffles into an int per (user, t) in shared memory.
//   At the end each block adds its counts into out with integer atomicAdd
//   (the wrapper zeroes out): integer sums are exact and order-free, so the
//   result is deterministic.  Pad items (bias -inf), pad users (ref +inf)
//   and NaN scores never satisfy >=; ragged users, items and D are masked.
//   A D not a multiple of 4 (or an operand not 16-byte aligned) is staged
//   with 4-byte loads instead of cp.async, in the same kernel.
//
// A D so wide that the user tile and two item sub-tiles outgrow shared
// memory (D > 128) takes the first design instead (counts_simt_kernel): the
// classic register-blocked SGEMM on the CUDA cores, 128 x 128 tiles, D
// staged 8 at a time, one fmaf per product in ascending d: the same counts.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int kMaxT = 4;
constexpr int kMaxW = 48;
constexpr int kBlocksPerSM = 8;

// ---------------------------------------------------------------------------
// CUDA-core kernel (very wide D)

constexpr int kThreads = 256;
constexpr int kTU = 128;           // users per block
constexpr int kTI = 128;           // items per sub-tile
constexpr int kBK = 8;             // D chunk staged in shared memory
constexpr int kStride = kTU + 4;   // padded shared row (kTU == kTI)

__global__ void __launch_bounds__(kThreads, 2)
counts_simt_kernel(const float* __restrict__ uf, const float* __restrict__ iv,
                   const float* __restrict__ ib, const float* __restrict__ ref,
                   const int* __restrict__ loc, int* __restrict__ out,
                   int B, long long Ip, int D, int T, int W, long long item_tile,
                   long long n_sub, long long subs_per_chunk) {
  __shared__ __align__(16) float us[kBK * kStride];
  __shared__ __align__(16) float is[kBK * kStride];
  __shared__ int ban_s[kTU * kMaxW];
  __shared__ float ref_s[kTU * kMaxT];
  __shared__ int tot_s[kTU * kMaxT];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // item column group (lane bits 0-3)
  const int ty = tid >> 4;  // user row group
  const long long u0 = static_cast<long long>(blockIdx.x) * kTU;
  const long long sub_lo = static_cast<long long>(blockIdx.y) * subs_per_chunk;
  const long long sub_hi = min(n_sub, sub_lo + subs_per_chunk);

  for (int idx = tid; idx < kTU * kMaxT; idx += kThreads) {
    const int ul = idx / kMaxT, t = idx % kMaxT;
    const long long b = u0 + ul;
    ref_s[idx] = (b < B && t < T) ? ref[b * T + t] : CUDART_INF_F;
    tot_s[idx] = 0;
  }
  long long cur_tile = -1;

  for (long long sub = sub_lo; sub < sub_hi; ++sub) {
    const long long n0 = sub * kTI;
    const long long tile = n0 / item_tile;  // the sub-tile lies in one tile
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kBK) {
      __syncthreads();  // the previous readers of us, is and ban_s are done
      if (d0 == 0 && tile != cur_tile) {
        for (int idx = tid; idx < kTU * W; idx += kThreads) {
          const int ul = idx / W, w = idx % W;
          const long long b = u0 + ul;
          ban_s[ul * kMaxW + w] =
              b < B ? loc[(tile * B + b) * W + w] : -1;
        }
        cur_tile = tile;
      }
#pragma unroll
      for (int r = 0; r < (kTU * kBK) / kThreads; ++r) {
        const int idx = tid + r * kThreads;
        const int row = idx / kBK, c = idx % kBK;
        const int d = d0 + c;
        const long long b = u0 + row;
        const long long g = n0 + row;
        us[c * kStride + row] = (b < B && d < D) ? uf[b * D + d] : 0.f;
        is[c * kStride + row] = (g < Ip && d < D) ? iv[g * D + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(us + k * kStride + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(us + k * kStride + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(is + k * kStride + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(is + k * kStride + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }

    // epilogue: bias, exclusion by id, compare, count
    const int local0 = static_cast<int>(n0 - tile * item_tile);
    float bias[8];
    int lid[8];
    unsigned in_range = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int il = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const long long g = n0 + il;
      lid[j] = local0 + il;
      bias[j] = g < Ip ? ib[g] : 0.f;
      in_range |= (g < Ip ? 1u : 0u) << j;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ul = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
      unsigned allowed = in_range;
      for (int w = 0; w < W; ++w) {
        const int o = ban_s[ul * kMaxW + w];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (o == lid[j]) allowed &= ~(1u << j);
      }
      for (int t = 0; t < T; ++t) {
        const float r = ref_s[ul * kMaxT + t];
        int c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          c += ((allowed >> j) & 1u) && (acc[i][j] + bias[j] >= r);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        if (tx == 0) tot_s[ul * kMaxT + t] += c;
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < kTU * T; idx += kThreads) {
    const int ul = idx / T, t = idx % T;
    const long long b = u0 + ul;
    const int c = tot_s[ul * kMaxT + t];
    if (b < B && c) atomicAdd(out + b * T + t, c);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16x3 with the exact recheck)

constexpr int kMU = 128;            // users per block (stationary)
constexpr int kNI = 128;            // items per sub-tile
constexpr int kMmaWarps = 16;       // 4 along users x 4 along items
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr float kBandD = 4.f;       // eps = 1.001 * ((kBandD * D + kBand0)
constexpr float kBand0 = 300.f;     //   * 2^-22 * |u| |v| + 2^-22 |b|) + 2^-100
constexpr float kBandAbs = 0x1p-100f;

struct CountsArgs {
  const float* uf;
  const float* iv;
  const float* ib;
  const float* ref;
  const int* loc;
  const float* nu;  // |uf[u]|_2, f32
  const float* nv;  // |iv[i]|_2, f32
  int* out;
  unsigned long long* rechecked;  // may be null
  float band_scale;
  int B, D, Dp, ld, T, W;  // ld: shared row stride in floats (Dp + 4)
  long long Ip, item_tile, n_sub, subs_per_chunk;
};

// rows [row0, row0 + rows) of src ([n_valid, D] row-major) into dst rows of
// stride ld, width Dp: 16-byte cp.async, or 4-byte loads when !kVec; rows
// past n_valid and columns past D are zero
template <bool kVec>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long row0, int rows,
                                          long long n_valid, int D, int Dp,
                                          int tid) {
  if (kVec) {
    const int pieces = Dp / 4;
    for (int idx = tid; idx < rows * pieces; idx += kMmaThreads) {
      const int r = idx / pieces, p = idx - r * pieces;
      const long long g = row0 + r;
      const bool ok = g < n_valid && 4 * p < D;
      fvx::cp_async16(fvx::smem_u32(dst + r * ld + 4 * p),
                      ok ? src + g * D + 4 * p : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * Dp; idx += kMmaThreads) {
      const int r = idx / Dp, c = idx - r * Dp;
      const long long g = row0 + r;
      dst[r * ld + c] = (g < n_valid && c < D) ? src[g * D + c] : 0.f;
    }
  }
}

// kT: the reference columns the epilogue compares (1, or up to kMaxT)
template <bool kVec, int kT>
__global__ void __launch_bounds__(kMmaThreads, 1)
counts_mma_kernel(const CountsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* users = reinterpret_cast<float*>(smem);  // [kMU][ld]
  float* items = users + kMU * a.ld;              // [2][kNI][ld]
  float* ib_s = items + 2 * kNI * a.ld;           // [2][kNI] bias
  float* nv_s = ib_s + 2 * kNI;                   // [2][kNI] norms
  uint32_t* bits = reinterpret_cast<uint32_t*>(nv_s + 2 * kNI);
  float* ref_s = reinterpret_cast<float*>(bits + 2 * kMU * (kNI / 32));
  int* tot_s = reinterpret_cast<int*>(ref_s + kMU * kMaxT);
  float* cu_s = reinterpret_cast<float*>(tot_s + kMU * kMaxT);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wu = warp & 3, wi = warp >> 2;  // user / item quarter
  const int g = lane >> 2, t = lane & 3;
  const long long u0 = static_cast<long long>(blockIdx.x) * kMU;
  const long long sub_lo = static_cast<long long>(blockIdx.y) * a.subs_per_chunk;
  const long long sub_hi = min(a.n_sub, sub_lo + a.subs_per_chunk);

  // sub-tile `sub`: its rows, their bias and norms (past the catalog: 0)
  auto stage_sub = [&](long long sub) {
    const int buf = static_cast<int>((sub - sub_lo) & 1);
    stage_f32<kVec>(items + buf * kNI * a.ld, a.ld, a.iv, sub * kNI, kNI, a.Ip,
                    a.D, a.Dp, tid);
    if (tid < 2 * kNI) {
      const long long n = sub * kNI + (tid & (kNI - 1));
      const float* src = tid < kNI ? a.ib : a.nv;
      fvx::cp_async4(fvx::smem_u32((tid < kNI ? ib_s : nv_s) + buf * kNI + (tid & (kNI - 1))),
                     n < a.Ip ? src + n : src, n < a.Ip ? 4 : 0);
    }
  };
  // banned offsets of sub-tile `sub` as bits: one (user, 32-item word) a
  // thread, into the buffer of the sub-tile's parity
  auto build_bits = [&](long long sub) {
    const int ul = tid >> 2, k = tid & 3;
    const long long b = u0 + ul;
    const long long n0 = sub * kNI;
    const long long tile = n0 / a.item_tile;
    const int base = static_cast<int>(n0 - tile * a.item_tile) + 32 * k;
    uint32_t word = 0;
    if (b < a.B) {
      const int* l = a.loc + (tile * a.B + b) * a.W;
      for (int w = 0; w < a.W; ++w) {
        const int o = __ldg(l + w) - base;
        if (o >= 0 && o < 32) word |= 1u << o;
      }
    }
    bits[((sub - sub_lo) & 1) * kMU * 4 + ul * 4 + k] = word;
  };

  // the user tile once, the first sub-tile, refs, eps's user factors, bits
  stage_f32<kVec>(users, a.ld, a.uf, u0, kMU, a.B, a.D, a.Dp, tid);
  stage_sub(sub_lo);
  fvx::cp_async_commit();
  for (int idx = tid; idx < kMU * kMaxT; idx += kMmaThreads) {
    const int ul = idx / kMaxT, tt = idx % kMaxT;
    const long long b = u0 + ul;
    ref_s[idx] = (b < a.B && tt < a.T) ? a.ref[b * a.T + tt] : CUDART_INF_F;
    tot_s[idx] = 0;
  }
  if (tid < kMU)
    cu_s[tid] = u0 + tid < a.B
        ? 1.001f * (kBandD * a.D + kBand0) * 0x1p-22f * a.nu[u0 + tid] : 0.f;
  build_bits(sub_lo);

  // this lane's rows: users (A) wu*32 + mi*16 + {g, g+8}, items (B)
  // wi*32 + ni*8 + g; columns k0 + 2t (+1) and k0 + 2t + 8 (+9)
  const float* a_row = users + (wu * 32 + g) * a.ld + 2 * t;
  const int b_row = (wi * 32 + g) * a.ld + 2 * t;
  unsigned long long n_re = 0;

  for (long long sub = sub_lo; sub < sub_hi; ++sub) {
    fvx::cp_async_wait<0>();
    __syncthreads();  // sub-tile sub landed; sub - 1's readers are done
    const int buf = static_cast<int>((sub - sub_lo) & 1);
    const float* cur = items + buf * kNI * a.ld;
    if (sub + 1 < sub_hi) {
      stage_sub(sub + 1);
      build_bits(sub + 1);
    }
    fvx::cp_async_commit();

    // bf16x3 product of the warp's 32 users x 32 items
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    const float* b_base = cur + b_row;
    for (int k0 = 0; k0 < a.Dp; k0 += 16) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // rows g / g + 8, columns +0 / +8
          const float2 x = *reinterpret_cast<const float2*>(
              a_row + (mi * 16 + (q & 1) * 8) * a.ld + k0 + (q >> 1) * 8);
          fvx::split_bf16x2(x, ah[mi][q], al[mi][q]);
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float2 x = *reinterpret_cast<const float2*>(
              b_base + ni * 8 * a.ld + k0 + q * 8);
          fvx::split_bf16x2(x, bh[ni][q], bl[ni][q]);
        }
      // the small terms first; 8 independent products between dependent ones
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) fvx::mma_bf16_16816(acc[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) fvx::mma_bf16_16816(acc[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) fvx::mma_bf16_16816(acc[mi][ni], ah[mi], bh[ni]);
    }

    // epilogue: bias, exclusion, band; pairs in the band are marked
    const long long n0 = sub * kNI;
    const uint32_t* bw = bits + buf * kMU * 4;
    float nv[4][2], bias[4][2], beps[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = wi * 32 + ni * 8 + 2 * t + e;
        // an item past the catalog never counts: bias -inf, no recheck
        const float b = n0 + il < a.Ip ? ib_s[buf * kNI + il] : -CUDART_INF_F;
        nv[ni][e] = nv_s[buf * kNI + il] * a.band_scale;
        bias[ni][e] = b;
        beps[ni][e] = fmaf(1.001f * 0x1p-22f * (isinf(b) ? 0.f : fabsf(b)),
                           a.band_scale, kBandAbs);
      }
    uint32_t pend = 0;  // bit (mi, h, ni, e): the pair goes to the exact chain
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ul = wu * 32 + mi * 16 + h * 8 + g;
        const float cu = cu_s[ul];
        const uint32_t word = bw[ul * 4 + wi];
        float r[kT];
        int cnt[kT];
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          r[tt] = ref_s[ul * kMaxT + tt];
          cnt[tt] = 0;
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = ni * 8 + 2 * t + e;  // item within the warp's 32
            if ((word >> j) & 1u) continue;    // banned
            const float st = acc[mi][ni][h * 2 + e] + bias[ni][e];
            // (cu * |v| + the bias term) * band_scale + 2^-100
            const float eps = fmaf(cu, nv[ni][e], beps[ni][e]);
            bool undecided = false;
#pragma unroll
            for (int tt = 0; tt < kT; ++tt) {
              const float d = st - r[tt];
              undecided |= !(fabsf(d) > eps) && (kT == 1 || tt < a.T);
            }
            if (undecided) {
              pend |= 1u << (mi * 16 + h * 8 + ni * 2 + e);
            } else {
#pragma unroll
              for (int tt = 0; tt < kT; ++tt) cnt[tt] += st - r[tt] > 0.f;
            }
          }
        }
        // the 4 lanes of the user row, then the 4 item warps, in shared memory
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          int v = cnt[tt];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t == 0 && (kT == 1 || tt < a.T) && v)
            atomicAdd(tot_s + ul * kMaxT + tt, v);
        }
      }
    }

    // the exact chain for the marked pairs, one a lane at a time, from the
    // rows in shared memory: fmaf in ascending d, + bias, >= each ref
    while (__any_sync(0xffffffffu, pend)) {
      if (pend) {
        const int p = __ffs(pend) - 1;
        pend &= pend - 1;
        const int mi = p >> 4, h = (p >> 3) & 1, ni = (p >> 1) & 3, e = p & 1;
        const int ul = wu * 32 + mi * 16 + h * 8 + g;
        const int il = wi * 32 + ni * 8 + 2 * t + e;
        const float* ur = users + ul * a.ld;
        const float* vr = cur + il * a.ld;
        float x = 0.f;
#pragma unroll 4
        for (int d = 0; d < a.D; ++d) x = fmaf(ur[d], vr[d], x);
        const float se =
            x + (n0 + il < a.Ip ? ib_s[buf * kNI + il] : -CUDART_INF_F);
        for (int tt = 0; tt < a.T; ++tt)
          if (se >= ref_s[ul * kMaxT + tt]) atomicAdd(tot_s + ul * kMaxT + tt, 1);
        ++n_re;
      }
    }
  }
  fvx::cp_async_wait<0>();

  if (a.rechecked) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n_re += __shfl_xor_sync(0xffffffffu, n_re, o);
    if (lane == 0 && n_re) atomicAdd(a.rechecked, n_re);
  }
  __syncthreads();
  for (int idx = tid; idx < kMU * a.T; idx += kMmaThreads) {
    const int ul = idx / a.T, tt = idx % a.T;
    const long long b = u0 + ul;
    const int v = tot_s[ul * kMaxT + tt];
    if (b < a.B && v) atomicAdd(a.out + b * a.T + tt, v);
  }
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on the H100

// catalog chunks: about kBlocksPerSM blocks an SM over n_ut user tiles
bool chunking(long long n_ut, long long n_sub, long long& n_chunks,
              long long& per_chunk) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  n_chunks = (static_cast<long long>(sms) * kBlocksPerSM + n_ut - 1) / n_ut;
  n_chunks = n_chunks < 1 ? 1 : (n_chunks > n_sub ? n_sub : n_chunks);
  per_chunk = (n_sub + n_chunks - 1) / n_chunks;
  n_chunks = (n_sub + per_chunk - 1) / per_chunk;
  return true;
}

template <bool kVec, int kT>
int launch_mma_as(const CountsArgs& a, dim3 grid, size_t smem,
                  cudaStream_t stream) {
  static size_t granted = 0;  // per instantiation
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        counts_mma_kernel<kVec, kT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  counts_mma_kernel<kVec, kT><<<grid, kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_mma_t(const CountsArgs& a, dim3 grid, size_t smem,
                 cudaStream_t stream) {
  return a.T == 1 ? launch_mma_as<kVec, 1>(a, grid, smem, stream)
                  : launch_mma_as<kVec, kMaxT>(a, grid, smem, stream);
}

}  // namespace

// Plain C interface for ctypes.  uf [B, D], iv [Ip, D], ib [Ip], ref [B, T]
// f32; loc [ceil(Ip / item_tile), B, W] int32 (-1 = none); nu [B], nv [Ip]
// f32, the rows' 2-norms (the band's factors); out [B, T]
// int32, zeroed by the caller; all contiguous on the current device.
// T <= 4, W <= 48, item_tile a multiple of 128.  band_scale multiplies the
// recheck band (1 = the proven bound; infinity = every pair exact);
// rechecked, if not null, is a device uint64 that gains the number of
// pairs scored exactly.  Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int fvx_counts(const void* uf, const void* iv, const void* ib,
                          const void* ref, const void* loc, const void* nu,
                          const void* nv, void* out,
                          long long B, long long Ip, long long D, long long T,
                          long long W, long long item_tile, double band_scale,
                          void* rechecked, void* stream) {
  if (B < 1 || Ip < 1 || D < 1 || T < 1 || T > kMaxT || W < 1 ||
      W > kMaxW || item_tile < kTI || item_tile % kTI != 0 ||
      B > (1LL << 30) || D > (1LL << 30) || !(band_scale >= 1.0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_ut = (B + kMU - 1) / kMU;
  const long long n_sub = (Ip + kNI - 1) / kNI;
  long long n_chunks = 0, per_chunk = 0;
  if (!chunking(n_ut, n_sub, n_chunks, per_chunk))
    return static_cast<int>(cudaGetLastError());
  if (n_ut > 0x7fffffffLL || n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_ut), static_cast<unsigned>(n_chunks));

  CountsArgs a;
  a.uf = static_cast<const float*>(uf);
  a.iv = static_cast<const float*>(iv);
  a.ib = static_cast<const float*>(ib);
  a.ref = static_cast<const float*>(ref);
  a.loc = static_cast<const int*>(loc);
  a.nu = static_cast<const float*>(nu);
  a.nv = static_cast<const float*>(nv);
  a.out = static_cast<int*>(out);
  a.rechecked = static_cast<unsigned long long*>(rechecked);
  a.band_scale = static_cast<float>(band_scale);
  a.B = static_cast<int>(B);
  a.D = static_cast<int>(D);
  a.Dp = static_cast<int>((D + 15) / 16 * 16);
  a.ld = a.Dp + 8;  // 8 words mod 32: the 8-byte fragment loads are conflict-free
  a.T = static_cast<int>(T);
  a.W = static_cast<int>(W);
  a.Ip = Ip;
  a.item_tile = item_tile;
  a.n_sub = n_sub;
  a.subs_per_chunk = per_chunk;
  // the user tile and two item sub-tiles, f32, in shared memory: D <= 128
  const size_t smem = static_cast<size_t>(kMU + 2 * kNI) * a.ld * 4 + 4 * kNI * 4 +
                      2 * kMU * (kNI / 32) * 4 + 2 * kMU * kMaxT * 4 + kMU * 4;
  if (smem <= kMaxSmem) {
    const bool vec = D % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(uf) |
                       reinterpret_cast<uintptr_t>(iv)) & 15) == 0;
    return vec ? launch_mma_t<true>(a, grid, smem, s)
               : launch_mma_t<false>(a, grid, smem, s);
  }
  // the CUDA-core design at very wide D (exact scores: no band)
  const long long simt_ut = (B + kTU - 1) / kTU;
  const dim3 sgrid(static_cast<unsigned>(simt_ut), static_cast<unsigned>(n_chunks));
  counts_simt_kernel<<<sgrid, kThreads, 0, s>>>(
      a.uf, a.iv, a.ib, a.ref, a.loc, a.out, a.B, Ip, a.D, a.T, a.W,
      item_tile, n_sub, per_chunk);
  return static_cast<int>(cudaGetLastError());
}
