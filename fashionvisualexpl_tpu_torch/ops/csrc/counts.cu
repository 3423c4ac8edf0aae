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
// * Tiles.  A block of 16 warps owns 128 users and a range of the catalog
//   (subs_per_chunk), walked in 128-item sub-tiles.  The pipeline's unit is
//   a (sub-tile, D-chunk) pair, double-buffered: the next unit's rows
//   arrive by cp.async (16-byte copies) while the tensor cores work on this
//   one.  D arrives in nk chunks of DK columns, the fewest whose two stages
//   fit in the 227 KB (one chunk at D <= 128, two of 80 at VBPR's D = 148).
//   The user tile stays whole in shared memory (copied once) where it fits
//   beside two chunks of 64 columns (D <= 256), else its chunk is staged
//   beside the items' in each unit.  Each warp owns 32 users x 32 items
//   (2 x 4 fragments), whose accumulators stay in registers across a
//   sub-tile's chunks; the chunks, and the k16 steps within each, run in
//   ascending order, so the accumulation is the one the band below was
//   derived for, at the whole D.  A sub-tile's bias, norms and banned bits
//   arrive with its first chunk, its epilogue runs after its last.  Shared
//   rows are Dp + 8 or DK + 8 words apart (8 or 24 mod 32), so the 8-byte
//   loads of a half-warp are conflict-free.  The catalog is cut into ranges
//   so that about eight blocks per SM are launched in turn (4096 users make
//   only 32 user tiles).
// * The recheck queue.  A sub-tile's marked pairs join a queue of the block
//   (1024 pairs).  When the queue is full (seen at the next unit's barrier,
//   so an empty queue costs no barrier), and after the block's last unit,
//   each thread rescores one queued pair, so the chains' latency is paid
//   once for many pairs and no warp holds the others at a barrier with a
//   chain of its own.  The item's row comes from device memory (through L2:
//   it was just streamed), the user's from shared memory where the tile is
//   whole, else from device memory too; four columns a load where the rows
//   are 16-byte aligned, the fmaf chain's order unchanged.
// * The band.  For each pair the epilogue forms s~ = acc + ib[i] and, for
//   each reference r, decides directly where s~ - r > eps or s~ - r < -eps;
//   otherwise (and wherever s~, r or eps is not finite) it marks the pair,
//   and the marked pairs are scored again (see the recheck queue): the
//   fmaf chain in ascending d, + ib[i], >= r.  With
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
// Every D takes this one kernel: no CUDA-core route and no whole-row
// variant for D <= 128 is left; the plain version in ops/counts.py is the
// reference.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int kMaxT = 4;
constexpr int kMaxW = 48;
constexpr int kBlocksPerSM = 8;
constexpr int kMU = 128;            // users per block (stationary)
constexpr int kNI = 128;            // items per sub-tile
constexpr int kMmaWarps = 16;       // 4 along users x 4 along items
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kQueue = 1024;        // marked pairs a block holds
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
  int B, D, Dp, ld, T, W;  // ld: the whole user tile's shared stride (Dp + 8)
  int DK, nk, ldc;         // chunk columns (a multiple of 16), chunks a sub-tile,
                           // their shared stride (DK + 8)
  bool users_resident;     // the user tile whole, else staged with each chunk
  long long Ip, item_tile, n_sub, subs_per_chunk;
};

// columns [c0, c0 + w) of rows [row0, row0 + rows) of src ([n_valid, D]
// row-major) into dst rows of stride ld: 16-byte cp.async, or 4-byte loads
// when !kVec; rows past n_valid and columns past D are zero
template <bool kVec>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long row0, int rows,
                                          long long n_valid, int D, int c0,
                                          int w, int tid) {
  if (kVec) {
    const int pieces = w / 4;
    for (int idx = tid; idx < rows * pieces; idx += kMmaThreads) {
      const int r = idx / pieces, p = idx - r * pieces;
      const long long g = row0 + r;
      const int c = c0 + 4 * p;
      const bool ok = g < n_valid && c < D;
      fvx::cp_async16(fvx::smem_u32(dst + r * ld + 4 * p),
                      ok ? src + g * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * w; idx += kMmaThreads) {
      const int r = idx / w, c = idx - r * w;
      const long long g = row0 + r;
      dst[r * ld + c] = (g < n_valid && c0 + c < D) ? src[g * D + c0 + c] : 0.f;
    }
  }
}

// banned offsets of sub-tile `sub` as bits: one (user, 32-item word) a
// thread of the block, into the bits of the sub-tile's parity
__device__ __forceinline__ void build_bits(const CountsArgs& a, uint32_t* bits,
                                           long long u0, long long sub,
                                           long long sub_lo, int tid) {
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
}

// one k16 step of the bf16x3 product of a warp's 32 users x 32 items: this
// lane's A rows a_row + {0, 8, 16, 24} * lda, B rows b_row + {0, 8, 16, 24}
// * ldb, columns k0 + 2t (+1) and k0 + 2t + 8 (+9)
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4], const float* a_row,
                                         int lda, const float* b_row, int ldb,
                                         int k0) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows g / g + 8, columns +0 / +8
      const float2 x = *reinterpret_cast<const float2*>(
          a_row + (mi * 16 + (q & 1) * 8) * lda + k0 + (q >> 1) * 8);
      fvx::split_bf16x2(x, ah[mi][q], al[mi][q]);
    }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 x = *reinterpret_cast<const float2*>(b_row + ni * 8 * ldb + k0 + q * 8);
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

// The epilogue of a warp's 32 x 32 pairs of sub-tile n0 (bias, norms and
// bits of its parity in ib_s, nv_s, bw): forms s~ = acc + bias, counts into
// tot_s the pairs decided directly (|s~ - r| > eps for every reference) and
// returns the others as bits (mi, h, ni, e): the pairs for the exact chain.
template <int kT>
__device__ __forceinline__ uint32_t count_decided(
    const float (&acc)[2][4][4], const CountsArgs& a, long long n0,
    const float* ib_s, const float* nv_s, const uint32_t* bw, const float* ref_s,
    const float* cu_s, int* tot_s, int wu, int wi, int g, int t) {
  float nv[4][2], bias[4][2], beps[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int il = wi * 32 + ni * 8 + 2 * t + e;
      // an item past the catalog never counts: bias -inf, no recheck
      const float b = n0 + il < a.Ip ? ib_s[il] : -CUDART_INF_F;
      nv[ni][e] = nv_s[il] * a.band_scale;
      bias[ni][e] = b;
      beps[ni][e] = fmaf(1.001f * 0x1p-22f * (isinf(b) ? 0.f : fabsf(b)),
                         a.band_scale, kBandAbs);
    }
  uint32_t pend = 0;
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
  return pend;
}

// the block's counts into out (integer atomics: exact, order-free), and
// its rechecked pairs into a.rechecked
__device__ __forceinline__ void finish(const CountsArgs& a, const int* tot_s,
                                       unsigned long long n_re, long long u0,
                                       int tid) {
  if (a.rechecked) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n_re += __shfl_xor_sync(0xffffffffu, n_re, o);
    if ((tid & 31) == 0 && n_re) atomicAdd(a.rechecked, n_re);
  }
  __syncthreads();
  for (int idx = tid; idx < kMU * a.T; idx += kMmaThreads) {
    const int ul = idx / a.T, tt = idx % a.T;
    const long long b = u0 + ul;
    const int v = tot_s[ul * kMaxT + tt];
    if (b < a.B && v) atomicAdd(a.out + b * a.T + tt, v);
  }
}

// refs, zeroed counts and eps's user factors of the block's users
__device__ __forceinline__ void init_users(const CountsArgs& a, float* ref_s,
                                           int* tot_s, float* cu_s, long long u0,
                                           int tid) {
  for (int idx = tid; idx < kMU * kMaxT; idx += kMmaThreads) {
    const int ul = idx / kMaxT, tt = idx % kMaxT;
    const long long b = u0 + ul;
    ref_s[idx] = (b < a.B && tt < a.T) ? a.ref[b * a.T + tt] : CUDART_INF_F;
    tot_s[idx] = 0;
  }
  if (tid < kMU)
    cu_s[tid] = u0 + tid < a.B
        ? 1.001f * (kBandD * a.D + kBand0) * 0x1p-22f * a.nu[u0 + tid] : 0.f;
}

// D in nk chunks of DK columns (one at D <= 128).  The pipeline's unit is
// chunk kc of sub-tile sub, in ascending order; the accumulators stay in
// registers across a sub-tile's chunks, and its epilogue runs after the
// last.  The marked pairs are queued and rescored: the item's row from
// device memory, the user's from shared memory where the tile is whole.
// kT: the reference columns the epilogue compares (1, or up to kMaxT).
template <bool kVec, int kT>
__global__ void __launch_bounds__(kMmaThreads, 1)
counts_mma_kernel(const CountsArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [kMU][ld] whole, or [2][kMU][ldc] a chunk a stage
  float* users = reinterpret_cast<float*>(smem);
  float* items = users + (a.users_resident ? kMU * a.ld : 2 * kMU * a.ldc);  // [2][kNI][ldc]
  float* ib_s = items + 2 * kNI * a.ldc;          // [2][kNI] bias
  float* nv_s = ib_s + 2 * kNI;                   // [2][kNI] norms
  uint32_t* bits = reinterpret_cast<uint32_t*>(nv_s + 2 * kNI);
  float* ref_s = reinterpret_cast<float*>(bits + 2 * kMU * (kNI / 32));
  int* tot_s = reinterpret_cast<int*>(ref_s + kMU * kMaxT);
  float* cu_s = reinterpret_cast<float*>(tot_s + kMU * kMaxT);
  // marked pairs, (item << 7) | user within the tile, and their count
  unsigned long long* queue = reinterpret_cast<unsigned long long*>(cu_s + kMU);
  int* q_n = reinterpret_cast<int*>(queue + kQueue);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wu = warp & 3, wi = warp >> 2;  // user / item quarter
  const int g = lane >> 2, t = lane & 3;
  const long long u0 = static_cast<long long>(blockIdx.x) * kMU;
  const long long sub_lo = static_cast<long long>(blockIdx.y) * a.subs_per_chunk;
  const long long sub_hi = min(a.n_sub, sub_lo + a.subs_per_chunk);

  // unit (sub, kc) into buffer buf: its chunk of the item rows (and of the
  // user rows when staged); with a sub-tile's first chunk its bias, norms
  // and banned bits (past the catalog: 0)
  auto stage_unit = [&](long long sub, int kc, int buf) {
    const int c0 = kc * a.DK, w = min(a.DK, a.Dp - c0);
    stage_f32<kVec>(items + buf * kNI * a.ldc, a.ldc, a.iv, sub * kNI, kNI, a.Ip,
                    a.D, c0, w, tid);
    if (!a.users_resident)
      stage_f32<kVec>(users + buf * kMU * a.ldc, a.ldc, a.uf, u0, kMU, a.B, a.D,
                      c0, w, tid);
    if (kc == 0) {
      const int sb = static_cast<int>((sub - sub_lo) & 1);
      if (tid < 2 * kNI) {
        const long long n = sub * kNI + (tid & (kNI - 1));
        const float* src = tid < kNI ? a.ib : a.nv;
        fvx::cp_async4(
            fvx::smem_u32((tid < kNI ? ib_s : nv_s) + sb * kNI + (tid & (kNI - 1))),
            n < a.Ip ? src + n : src, n < a.Ip ? 4 : 0);
      }
      build_bits(a, bits, u0, sub, sub_lo, tid);
    }
  };

  // The marked pairs that can count (a user of the batch, an item of the
  // catalog) of sub-tile rest_n0, as bits (mi, h, ni, e), join the block's
  // queue as far as it has room; the rest stay in `rest`.  Returns whether
  // this thread's append reached the queue's end.
  uint32_t rest = 0;
  long long rest_n0 = 0;
  auto enqueue = [&]() {
    const int n = __popc(rest);
    if (n == 0) return false;
    int slot = atomicAdd(q_n, n);
    const bool full = slot + n >= kQueue;
    for (; rest && slot < kQueue; ++slot) {
      const int p = __ffs(rest) - 1;
      rest &= rest - 1;
      const int mi = p >> 4, h = (p >> 3) & 1, ni = (p >> 1) & 3, e = p & 1;
      const unsigned long long il = wi * 32 + ni * 8 + 2 * t + e;
      queue[slot] = (static_cast<unsigned long long>(rest_n0) + il) << 7 |
                    static_cast<unsigned>(wu * 32 + mi * 16 + h * 8 + g);
    }
    return full;
  };
  // After a barrier: every thread rescores queued pairs, one a thread, so
  // the chains' latency is paid once for up to kQueue pairs; the exact
  // chain: fmaf in ascending d, + bias, >= each ref.  Then the queue is
  // empty again and takes what did not fit.  Returns whether that filled it.
  unsigned long long n_re = 0;
  auto drain = [&]() {
    const int filled = min(*q_n, kQueue);
    for (int k = tid; k < filled; k += kMmaThreads) {
      const unsigned long long qe = queue[k];
      const int ul = static_cast<int>(qe & (kMU - 1));
      const long long i = static_cast<long long>(qe >> 7);
      const float* vr = a.iv + i * a.D;
      const float* uw = users + ul * a.ld;               // the user tile whole
      const float* ug = a.uf + (u0 + ul) * a.D;          // ... or staged
      float x = 0.f;
      // rows 16-byte aligned (kVec): four columns a load, in the same order
      const float4* v4 = reinterpret_cast<const float4*>(vr);
      if (kVec && a.users_resident) {
#pragma unroll 4
        for (int d = 0; d < a.D / 4; ++d) {
          const float4 u = reinterpret_cast<const float4*>(uw)[d], v = __ldg(v4 + d);
          x = fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, x))));
        }
      } else if (kVec) {
#pragma unroll 4
        for (int d = 0; d < a.D / 4; ++d) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(ug) + d), v = __ldg(v4 + d);
          x = fmaf(u.w, v.w, fmaf(u.z, v.z, fmaf(u.y, v.y, fmaf(u.x, v.x, x))));
        }
      } else if (a.users_resident) {
#pragma unroll 8
        for (int d = 0; d < a.D; ++d) x = fmaf(uw[d], __ldg(vr + d), x);
      } else {
#pragma unroll 8
        for (int d = 0; d < a.D; ++d) x = fmaf(__ldg(ug + d), __ldg(vr + d), x);
      }
      const float se = x + __ldg(a.ib + i);
      for (int tt = 0; tt < a.T; ++tt)
        if (se >= ref_s[ul * kMaxT + tt]) atomicAdd(tot_s + ul * kMaxT + tt, 1);
      ++n_re;
    }
    __syncthreads();  // the queue's readers are done
    if (tid == 0) *q_n = 0;
    __syncthreads();
    return enqueue();
  };

  // the user tile once when whole, the first unit, refs, eps's user factors
  if (a.users_resident)
    stage_f32<kVec>(users, a.ld, a.uf, u0, kMU, a.B, a.D, 0, a.Dp, tid);
  stage_unit(sub_lo, 0, 0);
  fvx::cp_async_commit();
  init_users(a, ref_s, tot_s, cu_s, u0, tid);
  if (tid == 0) *q_n = 0;

  const int lda = a.users_resident ? a.ld : a.ldc;
  const float* a_base = users + (wu * 32 + g) * lda + 2 * t;
  const int b_row = (wi * 32 + g) * a.ldc + 2 * t;
  float acc[2][4][4];
  bool q_full = false;  // this thread's last append filled the queue
  int buf = 0, kc = 0;
  for (long long sub = sub_lo; sub < sub_hi; buf ^= 1) {
    fvx::cp_async_wait<0>();
    // unit (sub, kc) landed; the previous unit's readers are done; a full
    // queue is drained before the next sub-tile's pairs can join it
    if (__syncthreads_or(q_full))
      while (__syncthreads_or(drain())) {}
    q_full = false;
    const bool last_chunk = kc + 1 == a.nk;
    if (!last_chunk || sub + 1 < sub_hi)
      stage_unit(last_chunk ? sub + 1 : sub, last_chunk ? 0 : kc + 1, buf ^ 1);
    fvx::cp_async_commit();

    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const float* a_row = a.users_resident ? a_base + kc * a.DK : a_base + buf * kMU * a.ldc;
    const float* b_base = items + buf * kNI * a.ldc + b_row;
    const int w = min(a.DK, a.Dp - kc * a.DK);
    for (int k0 = 0; k0 < w; k0 += 16) mma_step(acc, a_row, lda, b_base, a.ldc, k0);
    if (!last_chunk) {  // the sub-tile's product is not whole yet
      ++kc;
      continue;
    }

    const long long n0 = sub * kNI;
    const int sb = static_cast<int>((sub - sub_lo) & 1);
    const uint32_t pend = count_decided<kT>(acc, a, n0, ib_s + sb * kNI, nv_s + sb * kNI,
                                            bits + sb * kMU * 4, ref_s, cu_s, tot_s, wu,
                                            wi, g, t);
    for (uint32_t m = pend; m; m &= m - 1) {
      const int p = __ffs(m) - 1;
      const int mi = p >> 4, h = (p >> 3) & 1, ni = (p >> 1) & 3, e = p & 1;
      if (u0 + wu * 32 + mi * 16 + h * 8 + g < a.B &&
          n0 + wi * 32 + ni * 8 + 2 * t + e < a.Ip)
        rest |= 1u << p;
    }
    rest_n0 = n0;
    q_full = enqueue();
    ++sub;
    kc = 0;
  }
  fvx::cp_async_wait<0>();
  // what is left in the queue, and what did not fit (then the queue is not
  // empty); *q_n is read between barriers
  for (;;) {
    __syncthreads();
    if (*q_n == 0) break;
    drain();
  }
  finish(a, tot_s, n_re, u0, tid);
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
int launch_as(const CountsArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
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

}  // namespace

// Plain C interface for ctypes.  uf [B, D], iv [Ip, D], ib [Ip], ref [B, T]
// f32; loc [ceil(Ip / item_tile), B, W] int32 (-1 = none); nu [B], nv [Ip]
// f32, the rows' 2-norms (the band's factors); out [B, T]
// int32, zeroed by the caller; all contiguous on the current device.
// T <= 4, W <= 48, item_tile a multiple of 128.  band_scale multiplies the
// recheck band (1 = the proven bound; infinity = every pair exact);
// rechecked, if not null, is a device uint64 that gains the number of pairs
// scored exactly.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int fvx_counts(const void* uf, const void* iv, const void* ib,
                          const void* ref, const void* loc, const void* nu,
                          const void* nv, void* out,
                          long long B, long long Ip, long long D, long long T,
                          long long W, long long item_tile,
                          double band_scale, void* rechecked, void* stream) {
  if (B < 1 || Ip < 1 || D < 1 || T < 1 || T > kMaxT || W < 1 ||
      W > kMaxW || item_tile < kNI || item_tile % kNI != 0 ||
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

  CountsArgs a{};
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
  a.T = static_cast<int>(T);
  a.W = static_cast<int>(W);
  a.Ip = Ip;
  a.item_tile = item_tile;
  a.n_sub = n_sub;
  a.subs_per_chunk = per_chunk;
  // D in chunks of DK columns, two stages of them; the user tile whole
  // where it fits beside two chunks of 64 columns (D <= 256); the fewest
  // chunks whose stages fit (one at D <= 128).  Rows Dp + 8 or DK + 8 words
  // apart: 8 or 24 mod 32, so the 8-byte fragment loads of a half-warp are
  // conflict-free.  Beside the rows: bias and norms, bits, refs, counts, the
  // users' band factors and the queue.
  const size_t fixed = 4 * kNI * 4 + 2 * kMU * (kNI / 32) * 4 + 2 * kMU * kMaxT * 4 +
                       kMU * 4 + kQueue * 8 + 16;
  a.ld = a.Dp + 8;
  const size_t whole = static_cast<size_t>(kMU) * a.ld * 4;
  a.users_resident = fixed + whole + 2 * kNI * 72 * 4 <= kMaxSmem;
  const size_t held = a.users_resident ? whole : 0;
  const size_t per_word = (a.users_resident ? 2 * kNI : 2 * kNI + 2 * kMU) * 4;
  for (a.nk = 1;; ++a.nk) {
    a.DK = (a.Dp / 16 + a.nk - 1) / a.nk * 16;
    if (fixed + held + per_word * (a.DK + 8) <= kMaxSmem) break;
  }
  a.nk = (a.Dp + a.DK - 1) / a.DK;
  a.ldc = a.DK + 8;
  const size_t smem = fixed + held + per_word * a.ldc;
  const bool vec = D % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(uf) |
                     reinterpret_cast<uintptr_t>(iv)) & 15) == 0;
  if (vec)
    return a.T == 1 ? launch_as<true, 1>(a, grid, smem, s)
                    : launch_as<true, kMaxT>(a, grid, smem, s);
  return a.T == 1 ? launch_as<false, 1>(a, grid, smem, s)
                  : launch_as<false, kMaxT>(a, grid, smem, s);
}
