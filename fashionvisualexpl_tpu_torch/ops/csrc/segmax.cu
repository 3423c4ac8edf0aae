// Fused catalog scoring + segment max (serving stage 1) for Hopper, sm_90a.
//
//   out[b, s] = max over items j of segment s of (uf[b] . iv[j] + ib_cand[j])
//
// with f32 accumulation from bf16 or f32 operands.  Replaces the TPU kernel
// fashionvisualexpl_tpu/ops/segmax.py::_kernel (behind segmax_scores); the
// wrapper, its plain PyTorch version and the launch count are in
// fashionvisualexpl_tpu_torch/ops/segmax.py.
//
// What bounds it, on an H100 SXM: at B=8 users (Ip=1,048,576 items, D=128)
// the 268 MB item read, ~0.08 ms at 3.35 TB/s; at B=4096 the 1.10 TFLOP
// product, ~1.11 ms at the 989 TFLOP/s bf16 tensor-core rate (the bytes,
// iv 268 MB + out 537 MB, take ~0.24 ms).  At VBPR's and GradFashion's
// D=148 over 524,288 items: the 155 MB item read at B=8, ~0.047 ms, and
// the 0.636 TFLOP product at B=4096, ~0.64 ms.  At CompVBPR's D=208 over
// 262,144 items: the 109 MB item read at B=8, ~0.033 ms, and the 0.447
// TFLOP product at B=4096, ~0.45 ms.
//
// The bf16 path runs on the tensor cores, items as the M dimension and
// users as N, so that iv [Ip, D] row-major is the row-major A operand and
// uf [B, D] row-major the "col" (K-major) B operand: no transpose.  Every
// block owns a tile of items for all of D and walks every user tile of 64
// users past it through a cp.async ring, so every item row is read from
// device memory once at any B, and uf (1 MB at B=4096) from L2.  Copies
// are as wide as the rows allow: 16 bytes (D a multiple of 8, operands
// 16-byte aligned), 8 (D a multiple of 4, 8-byte aligned: VBPR's and
// GradFashion's D=148, whose 296-byte rows are 16-byte aligned only every
// other row), 4, or else 2-byte loads.  plan() picks one of four kernels
// and their geometry (fvx_segmax_route reports it):
// * D up to 160 with 8- or 16-byte copies, B > 64: segmax_wgmma_kernel.
//   Warpgroup products, wgmma.m64n64k16 with A (items) in registers and B
//   (users) read by the tensor cores from shared memory: the operations
//   bound.  D zero-padded to 128 (8 16-deep steps; 16-byte rows only, so
//   that those kernels compile no narrower copy) or else 160 (10; the
//   items' columns 128 .. 159 are then read from shared memory too, which
//   keeps the registers of 8 steps).  256 items a block, 2 blocks an SM.
// * D in (160, 256] with 8- or 16-byte copies, B > 64:
//   segmax_wgmma_wide_kernel, the roles swapped: 256 items a block in
//   shared memory as the B operand (N = 256) of wgmma.m64n256k16, the
//   users (A) in registers by ldmatrix from a slot that one bulk copy fills
//   a tile, two warpgroups whose products alternate, each thread holding
//   whole segments of its items (details at the kernel).
// * D up to 256 with 8- or 16-byte copies, B <= 64: segmax_mma_regs_kernel,
//   mma.sync.m16n8k16 with the items' fragments over all of D (128, 160 or
//   256) in registers, taken with one 16-byte load (or two of 8) per row
//   and 32-wide slice of D (slices past D skipped): the bytes bound (at B=8
//   the block multiplies one 8-user fragment column and streams its 64 or
//   76 KB of items).  Above D = 160 a warp holds 16 items, not 32.
// * Any other D (above 256, or rows only 4- or 2-byte aligned, as D=150):
//   segmax_mma_kernel, mma.sync.m16n8k16 with a 128-item tile in shared
//   memory and both operands through ldmatrix (8 warps, each 32 items x 32
//   users a step); D zero-padded to a multiple of 16.  Shared rows are
//   padded by 16 bytes (an odd multiple of 16 bytes a row), so the 8 row
//   addresses of each ldmatrix phase fall in 8 different bank groups.
//
// Epilogue: the bias is added to (or starts) the accumulators in registers
// (ib_cand is -1e30 for pad items; rows past the catalog or the block's
// segments get -inf), then each thread takes the max over the rows it
// holds that share a segment (rows g and g + 8, and its two 16-row
// fragments), and 3 butterfly shuffles (xor 4, 8, 16) over the 8 lanes
// that hold the other rows finish the max over 8-, 16- or 32-row groups
// (group_max).  The group maxima go to shared memory, and the threads then
// take each segment's max over its groups and store out[b, s] with
// consecutive threads on consecutive segments of one user's row
// (store_segments).  The three kernels share both (the wide kernel has its
// own, where each thread holds whole segments).  Segments: a block
// holds floor(tile / seg) whole segments (seg <= tile), or one segment
// walked in sub-tiles (seg > tile, the maxima of a later sub-tile merged
// into out by the same thread that stored them).  seg < tile not a
// multiple of 8 takes a slower epilogue through a full f32 score tile in
// shared memory.
//
// The f32 entry (fvx_segmax_f32, on no main path), and the bf16 entry when
// D is so wide that the tiles outgrow shared memory (D > ~300), keep the
// first design on the CUDA cores (segmax_simt_kernel): a block of 16
// users x 256 items, D staged 32 at a time, one f32 fmaf per product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel (f32 operands; bf16 at very wide D)

constexpr int kThreads = 256;      // items per sub-tile, one per thread
constexpr int kTB = 16;            // users per block
constexpr int kDC = 32;            // D chunk staged in shared memory
constexpr int kIStride = kDC + 1;  // padded item row stride (bank spread)
constexpr int kRStride = kTB + 1;  // padded reduction row stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segmax_simt_kernel(const T* __restrict__ uf, const T* __restrict__ iv,
                   const float* __restrict__ ib, float* __restrict__ out,
                   int B, long long Ip, int D, int seg, long long S,
                   int span, int sub_tiles, int nseg, long long n_ut) {
  // item tile staging area; reused for the segment reduction at the end
  __shared__ float item_s[kThreads * kIStride];
  __shared__ __align__(16) float user_s[kTB * kDC];

  const int tid = threadIdx.x;
  const long long ut = blockIdx.x % n_ut;
  const long long it = blockIdx.x / n_ut;
  const long long b0 = ut * kTB;
  const long long j0 = it * span;  // first item of this block

  float mx[kTB];
#pragma unroll
  for (int u = 0; u < kTB; ++u) mx[u] = -CUDART_INF_F;

  for (int r = 0; r < sub_tiles; ++r) {
    const int lbase = r * kThreads;  // sub-tile base, local to the block
    float acc[kTB];
#pragma unroll
    for (int u = 0; u < kTB; ++u) acc[u] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDC) {
      const int dc = min(kDC, D - d0);
      __syncthreads();  // the previous chunk's readers are done
      for (int idx = tid; idx < kThreads * kDC; idx += kThreads) {
        const int row = idx / kDC, c = idx % kDC;
        const int local = lbase + row;
        const long long j = j0 + local;
        float v = 0.f;
        if (c < dc && local < span && j < Ip) v = to_f32(iv[j * D + d0 + c]);
        item_s[row * kIStride + c] = v;
      }
      for (int idx = tid; idx < kTB * kDC; idx += kThreads) {
        const int u = idx / kDC, c = idx % kDC;
        const long long b = b0 + u;
        float v = 0.f;
        if (c < dc && b < B) v = to_f32(uf[b * D + d0 + c]);
        user_s[u * kDC + c] = v;
      }
      __syncthreads();

      float x[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) x[c] = item_s[tid * kIStride + c];
#pragma unroll
      for (int u = 0; u < kTB; ++u) {
        const float4* w4 = reinterpret_cast<const float4*>(user_s + u * kDC);
        float a = acc[u];
#pragma unroll
        for (int c4 = 0; c4 < kDC / 4; ++c4) {
          const float4 w = w4[c4];
          a = fmaf(x[4 * c4 + 0], w.x, a);
          a = fmaf(x[4 * c4 + 1], w.y, a);
          a = fmaf(x[4 * c4 + 2], w.z, a);
          a = fmaf(x[4 * c4 + 3], w.w, a);
        }
        acc[u] = a;
      }
    }

    const int local = lbase + tid;
    const long long j = j0 + local;
    const float bias = (local < span && j < Ip) ? ib[j] : -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kTB; ++u) mx[u] = fmaxf(mx[u], acc[u] + bias);
  }

  // segment max through shared memory: slot-major [256][17] so that the
  // reading threads (user fastest) spread over the banks
  __syncthreads();
  float* red = item_s;
#pragma unroll
  for (int u = 0; u < kTB; ++u) red[tid * kRStride + u] = mx[u];
  __syncthreads();

  const int width = seg < kThreads ? seg : kThreads;  // slots per segment
  for (int idx = tid; idx < kTB * nseg; idx += kThreads) {
    const int u = idx % kTB, ls = idx / kTB;
    const long long b = b0 + u;
    const long long s = it * nseg + ls;
    if (b >= B || s >= S) continue;
    float m = -CUDART_INF_F;
    for (int t = 0; t < width; ++t)
      m = fmaxf(m, red[(ls * width + t) * kRStride + u]);
    out[b * S + s] = m;
  }
}

template <typename T>
int launch_simt(const void* uf, const void* iv, const void* ib, void* out,
                long long B, long long Ip, long long D, long long seg,
                cudaStream_t stream) {
  const long long S = Ip / seg;
  // an item tile holds whole segments: floor(256/seg) of them, or one
  // segment walked in 256-item sub-tiles when seg > 256
  const int nseg = seg <= kThreads ? static_cast<int>(kThreads / seg) : 1;
  const int span = seg <= kThreads ? static_cast<int>(nseg * seg)
                                   : static_cast<int>(seg);
  const int sub_tiles = (span + kThreads - 1) / kThreads;
  const long long n_ut = (B + kTB - 1) / kTB;
  const long long n_it = (S + nseg - 1) / nseg;
  const long long blocks = n_ut * n_it;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segmax_simt_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(uf), static_cast<const T*>(iv),
      static_cast<const float*>(ib), static_cast<float*>(out),
      static_cast<int>(B), Ip, static_cast<int>(D), static_cast<int>(seg), S,
      span, sub_tiles, nseg, n_ut);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16 operands)

constexpr int kMT = 128;     // items per block tile (segmax_mma_kernel)
constexpr int kNT = 64;      // users per streamed tile
constexpr int kWarps = 8;    // segmax_mma_kernel: 4 along items x 2 along users
constexpr int kMmaThreads = kWarps * 32;
constexpr int kStages = 3;   // user-tile ring depth
constexpr int kScoreLD = kNT + 1;  // row stride of the slow path's score tile

struct MmaArgs {
  const __nv_bfloat16* uf;
  const __nv_bfloat16* iv;
  const float* ib;
  float* out;
  int B, D, Dp, ld;  // ld: shared row stride in bf16
  long long Ip, S;
  int seg, span, nseg, sub_tiles, n_ut;
  int cw;  // bytes a copy moves: 16, 8, 4 or 2 (plan())
};

// rows [row0, row0 + rows) of src (row-major [n_rows, D]) into dst rows of
// stride ld, zero past n_valid rows and past D: cp.async of kW bytes (D a
// multiple of kW / 2 and the rows kW-byte aligned, so that a copy lies
// wholly inside D or wholly past it; the bytes past src-size are
// zero-filled), or 2-byte loads (kW = 2)
template <int kW, int kThr = kMmaThreads>
__device__ __forceinline__ void stage_rows_w(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             long long row0, int rows,
                                             long long n_valid, int D, int Dp,
                                             int ld, int tid) {
  if constexpr (kW == 2) {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < rows * Dp; idx += kThr) {
      const int r = idx / Dp, c = idx - r * Dp;
      const long long g = row0 + r;
      dst[r * ld + c] = (g < n_valid && c < D) ? src[g * D + c] : zero;
    }
  } else {
    constexpr int kE = kW / 2;  // bf16 a copy
    const int chunks = Dp / kE;
    for (int idx = tid; idx < rows * chunks; idx += kThr) {
      const int r = idx / chunks, c = idx - r * chunks;
      const long long g = row0 + r;
      const bool ok = g < n_valid && c * kE < D;
      const uint32_t d = fvx::smem_u32(dst + r * ld + c * kE);
      const __nv_bfloat16* p = ok ? src + g * D + c * kE : src;
      if constexpr (kW == 16) fvx::cp_async16(d, p, ok ? 16 : 0);
      else if constexpr (kW == 8) fvx::cp_async8(d, p, ok ? 8 : 0);
      else fvx::cp_async4(d, p, ok ? 4 : 0);
    }
  }
}

// stage_rows_w at the plan's copy width (kW16: 16 bytes, known at compile time)
template <bool kW16 = false>
__device__ __forceinline__ void stage_rows(const MmaArgs& a, __nv_bfloat16* dst,
                                           const __nv_bfloat16* src, long long row0,
                                           int rows, long long n_valid, int tid) {
  if constexpr (kW16) {
    stage_rows_w<16>(dst, src, row0, rows, n_valid, a.D, a.Dp, a.ld, tid);
  } else {
    switch (a.cw) {
      case 16: stage_rows_w<16>(dst, src, row0, rows, n_valid, a.D, a.Dp, a.ld, tid); break;
      case 8: stage_rows_w<8>(dst, src, row0, rows, n_valid, a.D, a.Dp, a.ld, tid); break;
      case 4: stage_rows_w<4>(dst, src, row0, rows, n_valid, a.D, a.Dp, a.ld, tid); break;
      default: stage_rows_w<2>(dst, src, row0, rows, n_valid, a.D, a.Dp, a.ld, tid);
    }
  }
}

// The rows a lane holds of one user column col, v[f][h] = row
// row0 + 16 f + 8 h + g of kF 16-row fragments.  kG > 0: the max over each
// kG-row group, in registers and then over the lanes that hold the group's
// other rows, into red[group][kNT]; kG = 0: every row into the score tile
// red[row][kScoreLD].
template <int kG, int kF>
__device__ __forceinline__ void group_max(float (&v)[kF][2], int row0, int col,
                                          float* red, int g) {
  static_assert(kG != 32 || kF == 2, "a 32-row group takes two fragments");
  if constexpr (kG == 0) {
#pragma unroll
    for (int f = 0; f < kF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(row0 + 16 * f + 8 * h + g) * kScoreLD + col] = v[f][h];
  } else {
    if constexpr (kG >= 16) {
#pragma unroll
      for (int f = 0; f < kF; ++f) v[f][0] = fmaxf(v[f][0], v[f][1]);
    }
    if constexpr (kG == 32) v[0][0] = fmaxf(v[0][0], v[1][0]);
#pragma unroll
    for (int f = 0; f < (kG == 32 ? 1 : kF); ++f)
#pragma unroll
      for (int h = 0; h < (kG >= 16 ? 1 : 2); ++h) {
        float m = v[f][h];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
        if (g == 0) red[((row0 + 16 * f + 8 * h) / kG) * kNT + col] = m;
      }
  }
}

// out[b, s] for the kNT users b0 + u of a tile and the block's segments
// s0 + ls, from group_max's rows of a kTile-item sub-tile: consecutive
// threads (kThr of them) on consecutive segments of one user's row.  A
// segment walked in sub-tiles (r > 0) merges with what this thread stored
// at r - 1.
template <int kG, int kTile, int kThr>
__device__ __forceinline__ void store_segments(const MmaArgs& a, const float* red,
                                               long long b0, long long s0, int r,
                                               int tid) {
  const int nseg = a.nseg;
  for (int idx = tid; idx < kNT * nseg; idx += kThr) {
    const int u = idx / nseg, ls = idx - u * nseg;
    const long long b = b0 + u;
    const long long s = s0 + ls;
    if (b >= a.B || s >= a.S) continue;
    float m = -CUDART_INF_F;
    if constexpr (kG > 0) {
      // seg > kTile: one segment spans every group of the sub-tile
      const int per = a.seg > kTile ? kTile / kG : a.seg / kG;
      const float* col = red + (ls * per) * kNT + u;
      for (int q = 0; q < per; ++q) m = fmaxf(m, col[q * kNT]);
    } else {
      const float* col = red + (ls * a.seg) * kScoreLD + u;
      for (int q = 0; q < a.seg; ++q) m = fmaxf(m, col[q * kScoreLD]);
    }
    float* o = a.out + b * a.S + s;
    if (r > 0) m = fmaxf(m, *o);
    *o = m;
  }
}

// Any D the two kernels below do not take.  kG: rows a thread and its
// shuffles reduce before the shared-memory pass (8, 16 or 32; the segment
// width is a multiple of it, or one segment spans the tile), or 0 for the
// slow path through a full score tile (seg < 128, seg % 8 != 0).
template <int kG>
__global__ void __launch_bounds__(kMmaThreads, 2)
segmax_mma_kernel(const MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* items = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* users = items + kMT * a.ld;
  const int n_buf = a.n_ut < kStages ? a.n_ut : kStages;
  float* red = reinterpret_cast<float*>(users + n_buf * kNT * a.ld);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // item / user quarter and half
  const int g = lane >> 2, t = lane & 3;
  const long long it = blockIdx.x;
  const long long j0 = it * a.span;  // first item of this block
  const long long j_end = min(a.Ip, j0 + a.span);
  const int ksteps = a.Dp / 16;

  // ldmatrix row addresses (bytes, shared space), k offset added per step
  const uint32_t a_addr0 = fvx::smem_u32(
      items + (wm * 32 + (lane & 15)) * a.ld + (lane >> 4) * 8);
  const int b_row = wn * 32 + (lane & 7) + ((lane >> 4) << 3);
  const int b_col = ((lane >> 3) & 1) * 8;

  for (int r = 0; r < a.sub_tiles; ++r) {
    const long long i0 = j0 + static_cast<long long>(r) * kMT;
    __syncthreads();  // the previous sub-tile's readers are done
    stage_rows(a, items, a.iv, i0, kMT, j_end, tid);
    stage_rows(a, users, a.uf, 0, kNT, a.B, tid);
    fvx::cp_async_commit();
    if (a.n_ut > 1) stage_rows(a, users + kNT * a.ld, a.uf, kNT, kNT, a.B, tid);
    fvx::cp_async_commit();

    // bias of the rows this thread holds: rows past the block's items -inf
    float bias[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long j = i0 + wm * 32 + mi * 16 + h * 8 + g;
        bias[mi][h] = j < j_end ? a.ib[j] : -CUDART_INF_F;
      }

    for (int ut = 0; ut < a.n_ut; ++ut) {
      fvx::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile ut landed; tile ut - 1's readers are done
      if (ut + kStages - 1 < a.n_ut) {
        const int nb = (ut + kStages - 1) % kStages;
        stage_rows(a, users + nb * kNT * a.ld, a.uf,
                   static_cast<long long>(ut + kStages - 1) * kNT, kNT, a.B, tid);
      }
      fvx::cp_async_commit();

      const int u0 = ut * kNT + wn * 32;  // this warp's first user
      const int n_act = min(4, max(0, (a.B - u0 + 7) / 8));  // fragments with users
      float acc[2][4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

      if (n_act > 0) {
        const uint32_t b_addr0 = fvx::smem_u32(
            users + (ut % kStages) * kNT * a.ld + b_row * a.ld + b_col);
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t af[2][4], bf[4][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            fvx::ldmatrix_x4(af[mi], a_addr0 + (mi * 16 * a.ld + ks * 16) * 2);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            if (2 * nj < n_act) {
              uint32_t q[4];
              fvx::ldmatrix_x4(q, b_addr0 + (nj * 16 * a.ld + ks * 16) * 2);
              bf[2 * nj][0] = q[0];
              bf[2 * nj][1] = q[1];
              bf[2 * nj + 1][0] = q[2];
              bf[2 * nj + 1][1] = q[3];
            }
          }
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            if (ni < n_act)
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
                fvx::mma_bf16_16816(acc[mi][ni], af[mi], bf[ni]);
        }
      }

#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v[2][2];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) v[mi][h] = acc[mi][ni][h * 2 + e] + bias[mi][h];
          group_max<kG>(v, wm * 32, wn * 32 + ni * 8 + 2 * t + e, red, g);
        }
      __syncthreads();
      store_segments<kG, kMT, kMmaThreads>(a, red, static_cast<long long>(ut) * kNT,
                                           it * a.nseg, r, tid);
    }
    fvx::cp_async_wait<0>();
  }
}

// D up to 256 in rows that take 8- or 16-byte copies (plan()): each warp
// keeps the A fragments of its items over the whole D, zero-padded to Dp =
// 16 kKS (128 or 160; 256 above 160), in registers, loaded once from
// device memory, so a block of 8 warps holds its items with no shared
// memory for them: 32 items a warp up to D = 160 (two 16-row fragments, 8
// kKS registers), 256 a block; above 160 one fragment of 16 items (4 kKS =
// 64 registers at kKS = 16), 128 a block, so that two blocks an SM still
// fit their registers.  The users stream through the same 3-stage ring; a
// warp multiplies them 16 at a time, which halves the shared-memory bytes
// a product of the kernel above, and the 256-item tile halves its L2 reads
// of uf.  The k order inside each 32-wide slice of D is permuted, the same
// way for both operands (a dot product does not depend on it): the lane
// with t = lane % 4 holds, for the slice's two 16-deep steps, the fragment
// columns {2t, 2t+1, 2t+8, 2t+9} of the first and then of the second step,
// and those are the slice's elements 8t .. 8t+7.  So each lane takes its A
// fragments with one 16-byte load per row and slice (two of 8 bytes where
// the rows are only 8-byte aligned, as VBPR's 296-byte rows at D=148), and
// its B fragments with one 16-byte shared load per 8-user fragment and
// slice.  The accumulators start at the items' bias.
constexpr int kMaxKS = 10;   // 16-deep steps of the two kernels: D <= 160
constexpr int kWideKS = 16;  // above 160: D <= 256

// 16-row item fragments a warp of the register kernel holds, and the items
// of its block
template <int kKS>
__host__ __device__ constexpr int regs_frags() { return kKS > kMaxKS ? 1 : 2; }
__host__ __device__ constexpr int regs_tile_of(int ks) {
  return kMmaThreads / 32 * 16 * (ks > kMaxKS ? 1 : 2);
}

// the A fragments of a warp's 16 kMI items over kKS steps (zero past D and
// past the block's items), read kW bytes at a time
template <int kMI, int kKS, int kW>
__device__ __forceinline__ void regs_fragments(uint32_t (&af)[kMI][kKS][4],
                                               const MmaArgs& a, long long i0,
                                               long long j_end, int warp, int g,
                                               int t) {
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long j = i0 + warp * 16 * kMI + mi * 16 + h * 8 + g;
      const bool ok = j < j_end;
      const __nv_bfloat16* row = a.iv + (ok ? j : 0) * a.D + 8 * t;
#pragma unroll
      for (int c = 0; c < kKS / 2; ++c) {
        const int k = 32 * c + 8 * t;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (kW == 16) {
          if (ok && k < a.D) v = __ldg(reinterpret_cast<const uint4*>(row + 32 * c));
        } else {
          if (ok && k < a.D) {
            const uint2 lo = __ldg(reinterpret_cast<const uint2*>(row + 32 * c));
            v.x = lo.x;
            v.y = lo.y;
          }
          if (ok && k + 4 < a.D) {
            const uint2 hi = __ldg(reinterpret_cast<const uint2*>(row + 32 * c + 4));
            v.z = hi.x;
            v.w = hi.y;
          }
        }
        af[mi][2 * c][h] = v.x;
        af[mi][2 * c][h + 2] = v.y;
        af[mi][2 * c + 1][h] = v.z;
        af[mi][2 * c + 1][h + 2] = v.w;
      }
    }
  }
}

template <int kKS, int kG>
__global__ void __launch_bounds__(kMmaThreads, 2)
segmax_mma_regs_kernel(const MmaArgs a) {
  constexpr int kMI = regs_frags<kKS>();
  constexpr int kTile = regs_tile_of(kKS);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* users = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_buf = a.n_ut < kStages ? a.n_ut : kStages;
  float* red = reinterpret_cast<float*>(users + n_buf * kNT * a.ld);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long j0 = static_cast<long long>(blockIdx.x) * a.span;
  const long long j_end = min(a.Ip, j0 + a.span);


  for (int r = 0; r < a.sub_tiles; ++r) {
    const long long i0 = j0 + static_cast<long long>(r) * kTile;
    __syncthreads();  // the previous sub-tile's readers are done
    stage_rows<kKS == 8>(a, users, a.uf, 0, kNT, a.B, tid);
    fvx::cp_async_commit();
    if (a.n_ut > 1)
      stage_rows<kKS == 8>(a, users + kNT * a.ld, a.uf, kNT, kNT, a.B, tid);
    fvx::cp_async_commit();

    // this warp's items: A fragments over all of D (permuted k), and bias
    uint32_t af[kMI][kKS][4];
    if (kKS == 8 || a.cw == 16)
      regs_fragments<kMI, kKS, 16>(af, a, i0, j_end, warp, g, t);
    else
      regs_fragments<kMI, kKS, 8>(af, a, i0, j_end, warp, g, t);
    float bias[kMI][2];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long j = i0 + warp * 16 * kMI + mi * 16 + h * 8 + g;
        bias[mi][h] = j < j_end ? a.ib[j] : -CUDART_INF_F;
      }

    for (int ut = 0; ut < a.n_ut; ++ut) {
      fvx::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile ut landed; tile ut - 1's readers are done
      if (ut + kStages - 1 < a.n_ut) {
        const int nb = (ut + kStages - 1) % kStages;
        stage_rows<kKS == 8>(a, users + nb * kNT * a.ld, a.uf,
                   static_cast<long long>(ut + kStages - 1) * kNT, kNT, a.B, tid);
      }
      fvx::cp_async_commit();
      const __nv_bfloat16* ubuf = users + (ut % kStages) * kNT * a.ld;

      for (int pass = 0; pass < kNT / 16; ++pass) {
        if (ut * kNT + pass * 16 >= a.B) break;
        float acc[kMI][2][4];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = bias[mi][e >> 1];
        const uint4* brow = reinterpret_cast<const uint4*>(
            ubuf + (pass * 16 + g) * a.ld + 8 * t);
#pragma unroll
        for (int c = 0; c < kKS / 2; ++c) {
          if (32 * c >= a.D) break;  // zero past D
          uint4 w[2];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) w[ni] = brow[(ni * 8 * a.ld + 32 * c) / 8];
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) {
              const uint32_t b[2] = {s ? w[ni].z : w[ni].x, s ? w[ni].w : w[ni].y};
#pragma unroll
              for (int mi = 0; mi < kMI; ++mi)
                fvx::mma_bf16_16816(acc[mi][ni], af[mi][2 * c + s], b);
            }
        }

#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int col = pass * 16 + ni * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v[kMI][2];
#pragma unroll
            for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) v[mi][h] = acc[mi][ni][h * 2 + e];
            group_max<kG>(v, warp * 16 * kMI, col + e, red, g);
          }
        }
      }
      __syncthreads();
      store_segments<kG, kTile, kMmaThreads>(
          a, red, static_cast<long long>(ut) * kNT,
          static_cast<long long>(blockIdx.x) * a.nseg, r, tid);
    }
    fvx::cp_async_wait<0>();
  }
}

// The same D and more than 64 users: the warpgroup products.  A block
// of 2 warpgroups owns 256 items; each warp keeps the A fragments of its 2
// x 16 items over the first 128 columns of D in registers (64 of them;
// warp w of a warpgroup holds rows 16w .. 16w+15 of each of its two
// 64-item tiles).  The users stream through the 3-stage ring in the
// K-major no-swizzle layout the tensor cores read (8x8 core matrices of
// 128 bytes: a user tile is [8 user groups][2 kKS k groups][8 users][8
// k]), and a warpgroup multiplies its 64-item tile by all 64 users of the
// tile with kKS wgmma.m64n64k16, reading the users from shared memory
// itself: no fragment loads for B.  At kKS = 10 the items' columns 128 ..
// 159 would cost 16 more registers a thread than the 128 that two blocks
// an SM leave (the kKS = 8 kernel takes 124-128): they are staged into
// shared memory once per sub-tile instead, in the same core-matrix layout
// ([32 item groups][4 k groups][8 items][8 k], 16 KB), and the last two
// products read A from there too.  The accumulators start at the items'
// bias; the epilogue reduces 8- or 16-row groups in registers and
// shuffles.
constexpr int kWgGroups = 2;                 // warpgroups per block
constexpr int kWgThreads = kWgGroups * 128;
constexpr int kWgMT = kWgGroups * 128;       // items per block
constexpr int kWgRegKS = 8;                  // 16-deep steps, A in registers

// columns k .. k + 7 of a bf16 row into one 16-byte row of a core matrix,
// zero past D or when !ok: one copy of kW = 16 bytes, or two of 8
template <int kW>
__device__ __forceinline__ void stage_core(uint32_t dst, const __nv_bfloat16* row,
                                           int k, int D, bool ok) {
  if constexpr (kW == 16) {
    const bool in = ok && k < D;
    fvx::cp_async16(dst, in ? row + k : row, in ? 16 : 0);
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = ok && k + 4 * h < D;
      fvx::cp_async8(dst + 8 * h, in ? row + k + 4 * h : row, in ? 8 : 0);
    }
  }
}

// user tile ut into buf as core matrices ([8 user groups][2 kKS k
// groups][8 users][8 k]), kW bytes a copy
template <int kKS, int kW>
__device__ __forceinline__ void stage_user_tile(const MmaArgs& a, __nv_bfloat16* buf,
                                                int ut, int tid) {
  constexpr int kC = 2 * kKS;  // 8-wide k groups a row
  for (int idx = tid; idx < kNT * kC; idx += kWgThreads) {
    // shift and mask at 16 k groups: the signed form times 2-3% faster at
    // D=128, B=4096 than an unsigned division (same SASS product loop)
    const int u = kC == 16 ? idx >> 4 : static_cast<unsigned>(idx) / kC;
    const int c = kC == 16 ? idx & 15 : static_cast<unsigned>(idx) % kC;
    const long long b = static_cast<long long>(ut) * kNT + u;
    const uint32_t dst = fvx::smem_u32(buf + ((u >> 3) * kC + c) * 64 + (u & 7) * 8);
    if constexpr (kW == 16) {
      const bool ok = b < a.B && c * 8 < a.D;
      fvx::cp_async16(dst, ok ? a.uf + b * a.D + c * 8 : a.uf, ok ? 16 : 0);
    } else {
      stage_core<kW>(dst, b < a.B ? a.uf + b * a.D : a.uf, c * 8, a.D, b < a.B);
    }
  }
}

// columns k0 .. k0 + 16 kTS - 1 of the block's items i0 .. i0 + 255 into
// tail as core matrices ([32 item groups][2 kTS k groups][8 items][8 k])
template <int kTS, int kW>
__device__ __forceinline__ void stage_item_tail(const MmaArgs& a, __nv_bfloat16* tail,
                                                long long i0, long long j_end, int k0,
                                                int tid) {
  for (int idx = tid; idx < kWgMT * 2 * kTS; idx += kWgThreads) {
    const int r = idx / (2 * kTS), c = idx - r * (2 * kTS);
    const long long j = i0 + r;
    const bool ok = j < j_end;
    stage_core<kW>(fvx::smem_u32(tail + ((r >> 3) * 2 * kTS + c) * 64 + (r & 7) * 8),
                   ok ? a.iv + j * a.D : a.iv, k0 + c * 8, a.D, ok);
  }
}

template <int kKS, int kG>
__global__ void __launch_bounds__(kWgThreads, 2)
segmax_wgmma_kernel(const MmaArgs a) {
  constexpr int kRS = kKS < kWgRegKS ? kKS : kWgRegKS;  // steps, A in registers
  constexpr int kTS = kKS - kRS;                        // steps, A in shared memory
  constexpr int kSlot = kNT * kKS * 16;                 // a user tile, bf16
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* users = reinterpret_cast<__nv_bfloat16*>(smem);
  const int n_buf = a.n_ut < kStages ? a.n_ut : kStages;
  __nv_bfloat16* tail = users + n_buf * kSlot;  // the items' last kTS steps
  float* red = reinterpret_cast<float*>(tail + kWgMT * kTS * 16);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const long long j0 = static_cast<long long>(blockIdx.x) * a.span;
  const long long j_end = min(a.Ip, j0 + a.span);

  // user tile ut into ring slot ut % kStages
  auto stage_users = [&](int ut) {
    __nv_bfloat16* buf = users + (ut % kStages) * kSlot;
    if (kKS == 8 || a.cw == 16)
      stage_user_tile<kKS, 16>(a, buf, ut, tid);
    else
      stage_user_tile<kKS, 8>(a, buf, ut, tid);
  };

  for (int r = 0; r < a.sub_tiles; ++r) {
    const long long i0 = j0 + static_cast<long long>(r) * kWgMT;
    __syncthreads();  // the previous sub-tile's readers are done
    if constexpr (kTS > 0) {  // lands with user tile 0
      if (kKS == 8 || a.cw == 16)
        stage_item_tail<kTS, 16>(a, tail, i0, j_end, kRS * 16, tid);
      else
        stage_item_tail<kTS, 8>(a, tail, i0, j_end, kRS * 16, tid);
    }
    stage_users(0);
    fvx::cp_async_commit();
    if (a.n_ut > 1) stage_users(1);
    fvx::cp_async_commit();

    // this warp's items: A fragments over the first kRS steps, and bias
    uint32_t af[2][kRS][4];
    float bias[2][2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long j = i0 + wg * 128 + p * 64 + wq * 16 + h * 8 + g;
        const bool ok = j < j_end;
        bias[p][h] = ok ? a.ib[j] : -CUDART_INF_F;
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(a.iv + (ok ? j : 0) * a.D);
#pragma unroll
        for (int ks = 0; ks < kRS; ++ks)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int k = ks * 16 + q * 8 + 2 * t;
            af[p][ks][h + 2 * q] = (ok && k < a.D) ? __ldg(row + k / 2) : 0u;
          }
      }
    }

    for (int ut = 0; ut < a.n_ut; ++ut) {
      fvx::cp_async_wait<kStages - 2>();
      fvx::fence_proxy_async();
      __syncthreads();  // tile ut landed; tile ut - 1's readers are done
      if (ut + kStages - 1 < a.n_ut) stage_users(ut + kStages - 1);
      fvx::cp_async_commit();
      const uint32_t base = fvx::smem_u32(users + (ut % kStages) * kSlot);

#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          d[i] = bias[p][(i >> 1) & 1];
          fvx::reg_fence(d[i]);
        }
        fvx::wgmma_fence();
        // all kKS steps, zeros past D: a product under a branch makes
        // ptxas put a warpgroup.arrive before each one
#pragma unroll
        for (int ks = 0; ks < kRS; ++ks)
          fvx::wgmma_m64n64k16_bf16(d, af[p][ks],
                                    fvx::wgmma_desc(base + ks * 256, 128, 256 * kKS));
#pragma unroll
        for (int s = 0; s < kTS; ++s)
          fvx::wgmma_m64n64k16_bf16_ss(
              d,
              fvx::wgmma_desc(fvx::smem_u32(tail) + (wg * 16 + p * 8) * 256 * kTS + s * 256,
                              128, 256 * kTS),
              fvx::wgmma_desc(base + (kRS + s) * 256, 128, 256 * kKS));
        fvx::wgmma_commit();
        fvx::wgmma_wait0();
#pragma unroll
        for (int i = 0; i < 32; ++i) fvx::reg_fence(d[i]);

        const int row0 = wg * 128 + p * 64 + wq * 16;  // the warp's first item
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float v[1][2] = {{d[4 * i + e], d[4 * i + 2 + e]}};  // rows g, g + 8
            group_max<kG>(v, row0, i * 8 + 2 * t + e, red, g);
          }
      }
      __syncthreads();
      store_segments<kG, kWgMT, kWgThreads>(
          a, red, static_cast<long long>(ut) * kNT,
          static_cast<long long>(blockIdx.x) * a.nseg, r, tid);
    }
    fvx::cp_async_wait<0>();
  }
}

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on the H100

// D in (160, 256] in rows that take 8- or 16-byte copies, more than 64
// users: segmax_wgmma_wide_kernel, bound by the operations (at D = 208,
// B = 4096: 0.447 TFLOP against the 134 MB of out and 109 MB of items).
// The warpgroup kernel above puts the items on M and the users on N: at
// these widths its A registers run out (the tail outgrows shared memory
// beside a 3-stage ring, one block an SM), and its epilogue takes each
// segment's max over the 8 lanes that hold an item column's rows, 3
// shuffles for every 16 scores.  Here the roles are swapped.  A block holds
// 256 items over all of D, zero-padded to Dp = 16 kKS (208 up to D = 208,
// else 256), in shared memory as the B operand (N = 256) of
// wgmma.m64n256k16, and its two warpgroups take turns over the 64-user
// tiles (warpgroup w the tiles w, w + 2, ...).  A warpgroup's users are
// the A operand in registers (4 kKS of them a thread, the mma.m16n8k16 A
// layout), read with ldmatrix from one shared slot of the warpgroup; its
// next tile is copied into the slot as soon as the fragments are out, so
// that the copy flies during the product and the epilogue.  In 16-byte
// rows a tile is one contiguous block of uf, which one thread moves with
// one 1-D bulk copy (the Tensor Memory Accelerator) completing on the
// slot's mbarrier, its rows dense in the slot (the columns past D then
// hold the next row's first values, finite, against the items' zero
// columns); 8-byte rows take cp.async by the warpgroup, zero past D and B,
// issued under the product.  Copies that the warpgroup's threads issue
// themselves are held back by the load unit for about as long as a
// product takes, so before the bulk copy they, not the tensor cores, set
// the pace (PERF.md).  The two warpgroups' products alternate: each issues
// its kKS products when the other's have finished (barriers 3 and 4), so
// that one's epilogue runs under the other's products; issued freely, the
// two run side by side, finish together and leave the tensor cores idle
// through both epilogues.  Every user tile is read from L2 once a 256-item
// block, as in the kernel above.  The items are laid along N in the order
// that gives each thread whole segments: a thread of quad t holds the
// accumulator columns 8i + 2t + e (i < 32, e < 2), and column n holds item
// 64t + 2i + e of the block (wide_item), so the thread holds items 64t ..
// 64t + 63 for its two users (rows g and g + 8 of its warp's 16).  A
// segment that divides 64 (seg 32: two of them) is reduced in the thread's
// registers and stored straight from them, with no shuffle and no shared
// memory (the direct epilogue, wide_rows); any other seg takes the max of
// each thread's run of a segment in registers and merges the runs with
// shared-memory atomics into the warpgroup's buffer, then stores each
// user's segments (seg > 256: one segment walked in 256-item sub-tiles,
// merged into out as above).  The bias is added in the epilogue, from a
// padded shared copy (conflict-free 16-byte reads).  The items are staged
// once a block as no-swizzle K-major core matrices by cp.async.
constexpr int kWideMT = 256;     // items a block: the N of one product
constexpr int kWideMidKS = 13;   // Dp = 208, for D in (160, 208]
constexpr int kBiasLD = 68;      // the bias of quad t at [68 t, 68 t + 64): 16-byte
                                 // reads of the four quads on distinct banks
constexpr size_t kWideBiasBytes = 4 * kBiasLD * 4;

// shared-memory bytes of the wide kernel: the items, the bias, each
// warpgroup's user slot (64 rows of Dp + 8 bf16: ldmatrix's 8 row
// addresses on distinct bank groups) and, for a seg that does not divide
// 64 (the merge), each warpgroup's [64 users][nseg] maxima
__host__ __device__ constexpr size_t wide_smem(int ks, long long nseg_merged) {
  return static_cast<size_t>(kWideMT) * 32 * ks + kWideBiasBytes +
         2 * static_cast<size_t>(kNT) * (16 * ks + 8) * 2 +
         2 * static_cast<size_t>(nseg_merged) * kNT * 4;
}
// the direct epilogue at the widest D; the merge at Dp = 208 with the most
// segments it takes (seg 3: 85); at Dp = 256 plan() sends a merge that does
// not fit (seg 3) to segmax_mma_kernel
static_assert(wide_smem(kWideKS, 0) <= kMaxSmem && wide_smem(kWideMidKS, kWideMT / 3) <= kMaxSmem,
              "wide kernel's shared memory");

// the block item that accumulator column n holds (a bijection of 0 .. 255)
__device__ __forceinline__ int wide_item(int n) {
  return 64 * ((n & 7) >> 1) + 2 * (n >> 3) + (n & 1);
}

// rows row0 + wide_item(n), n < kWideMT, of src (row-major [*, D]) into
// dst as K-major core matrices ([kWideMT / 8][2 kKS][8][8]), zero past
// n_valid and past D: each task one row's 8 columns (16 bytes, in copies
// of kW), the lanes 8q .. 8q + 7 of a warp on the 8 rows of one core
// matrix, column group c + q, so that a warp writes four whole core
// matrices (no bank conflict)
template <int kKS, int kW>
__device__ __forceinline__ void stage_items(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                            long long row0, long long n_valid, int D,
                                            int tid) {
  for (int x = tid; x < kWideMT * 2 * kKS; x += kWgThreads) {
    const int y = x >> 3;
    const int c = y % (2 * kKS), ng = y / (2 * kKS);  // column group, group of 8 rows
    const long long j = row0 + wide_item(ng * 8 + (x & 7));
    const bool ok = j < n_valid;
    stage_core<kW>(fvx::smem_u32(dst + (ng * 2 * kKS + c) * 64 + (x & 7) * 8),
                   ok ? src + j * D : src, 8 * c, D, ok);
  }
}

// the accumulator register of the thread's item q (< 64) for row h (g, g + 8)
#define WIDE_AT(q, h) d[4 * ((q) >> 1) + 2 * (h) + ((q) & 1)]

// direct epilogue, kS dividing 64: the max over each kS-item run of the
// thread's 64 items for row h, stored as out[b, s0 + q / kS]
template <int kS, int kH>
__device__ __forceinline__ void wide_rows(float (&d)[128], const MmaArgs& a, long long b,
                                          long long s0) {
#pragma unroll
  for (int w = 1; w < kS; w *= 2)
#pragma unroll
    for (int q = 0; q < 64; q += 2 * w) WIDE_AT(q, kH) = fmaxf(WIDE_AT(q, kH), WIDE_AT(q + w, kH));
  if (b >= a.B) return;
  float* o = a.out + b * a.S + s0;
#pragma unroll
  for (int q = 0; q < 64; q += kS)
    if (s0 + q / kS < a.S) o[q / kS] = WIDE_AT(q, kH);
}

template <int kH>
__device__ __forceinline__ void wide_rows_seg(float (&d)[128], const MmaArgs& a, long long b,
                                              long long s0) {
  switch (a.seg) {
    case 64: wide_rows<64, kH>(d, a, b, s0); break;
    case 32: wide_rows<32, kH>(d, a, b, s0); break;
    case 16: wide_rows<16, kH>(d, a, b, s0); break;
    case 8: wide_rows<8, kH>(d, a, b, s0); break;
    case 4: wide_rows<4, kH>(d, a, b, s0); break;
    case 2: wide_rows<2, kH>(d, a, b, s0); break;
    default: wide_rows<1, kH>(d, a, b, s0);
  }
}

// *p = max(*p, v) in shared memory, exact in any order: a float with the
// sign bit clear orders as a signed int, one with it set reversed as an
// unsigned int (-inf, the start value, is the largest such)
__device__ __forceinline__ void atomic_fmax(float* p, float v) {
  if (__float_as_int(v) >= 0) atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
}

template <int kKS, bool kDirect>
__global__ void __launch_bounds__(kWgThreads, 1)
segmax_wgmma_wide_kernel(const MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* items = reinterpret_cast<__nv_bfloat16*>(smem);
  float* bias_s = reinterpret_cast<float*>(items + kWideMT * kKS * 16);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int wtid = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const long long j0 = static_cast<long long>(blockIdx.x) * a.span;
  const long long j_end = min(a.Ip, j0 + a.span);
  const long long s_blk = static_cast<long long>(blockIdx.x) * a.nseg;  // first segment
  const int n_mine = (a.n_ut - wg + 1) / 2;  // user tiles wg, wg + 2, ...
  const int n_other = (a.n_ut - (1 - wg) + 1) / 2;
  __nv_bfloat16* slot = reinterpret_cast<__nv_bfloat16*>(bias_s + kWideBiasBytes / 4) +
                        wg * kNT * a.ld;
  // the merge's maxima of this warpgroup's users, red[u][ls]
  float* red = reinterpret_cast<float*>(slot + (2 - wg) * kNT * a.ld) + wg * a.nseg * kNT;
  const uint64_t desc_items = fvx::wgmma_desc(fvx::smem_u32(items), 128, 256 * kKS);

  // 16-byte rows: the slot's mbarrier, whose phase k this warpgroup's k-th
  // tile completes
  const bool bulk = a.cw == 16;
  __shared__ __align__(8) uint64_t full[2];
  const uint32_t bar = fvx::smem_u32(&full[wg]);
  int phase = 0;
  // this warpgroup's k-th user tile into its slot: one bulk copy (rows past
  // B keep the slot's old, finite values: they only feed product rows that
  // are not stored), or cp.async by the warpgroup (zero past B and D)
  auto stage_users = [&](int k) {
    const long long u0 = static_cast<long long>(wg + 2 * k) * kNT;
    if (bulk) {
      if (wtid == 0) {
        const long long bytes = min(static_cast<long long>(kNT), a.B - u0) * a.D * 2;
        fvx::fence_proxy_async();  // the warpgroup's ldmatrix reads come first
        fvx::mbar_expect(bar, static_cast<uint32_t>(bytes));
        fvx::bulk_copy(fvx::smem_u32(slot), a.uf + u0 * a.D, static_cast<uint32_t>(bytes), bar);
      }
    } else {
      stage_rows_w<8, 128>(slot, a.uf, u0, kNT, a.B, a.D, a.Dp, a.ld, wtid);
      fvx::cp_async_commit();
    }
  };
  // tile k in the slot, for the whole warpgroup
  auto wait_users = [&]() {
    if (bulk) {
      fvx::mbar_wait(bar, phase & 1);
      ++phase;
    } else {
      fvx::cp_async_wait<0>();
      fvx::bar_sync(1 + wg, 128);
    }
  };

  // ldmatrix row addresses of the warp's 16 users, k offset added per step
  const uint32_t a_addr =
      fvx::smem_u32(slot + (wq * 16 + (lane & 15)) * (bulk ? a.D : a.ld) + (lane >> 4) * 8);

  // finite values everywhere in the slot, before any copy
  for (int q = wtid; q < kNT * a.ld / 8; q += 128)
    reinterpret_cast<uint4*>(slot)[q] = make_uint4(0u, 0u, 0u, 0u);
  if (wtid == 0) fvx::mbar_init(bar);

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  uint32_t af[kKS][4];

  for (int r = 0; r < a.sub_tiles; ++r) {
    const long long i0 = j0 + static_cast<long long>(r) * kWideMT;
    __syncthreads();  // the previous sub-tile's readers are done
    if (a.cw == 16)
      stage_items<kKS, 16>(items, a.iv, i0, j_end, a.D, tid);
    else
      stage_items<kKS, 8>(items, a.iv, i0, j_end, a.D, tid);
    fvx::cp_async_commit();
    for (int q = tid; q < kWideMT; q += kWgThreads) {
      const long long j = i0 + q;
      bias_s[(q >> 6) * kBiasLD + (q & 63)] = j < j_end ? a.ib[j] : -CUDART_INF_F;
    }
    fvx::cp_async_wait<0>();
    fvx::fence_proxy_async();
    __syncthreads();  // every thread's items and bias landed; the slot zeroed
    stage_users(0);

    for (int k = 0; k < n_mine; ++k) {
      wait_users();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) fvx::ldmatrix_x4(af[ks], a_addr + ks * 32);
      fvx::bar_sync(1 + wg, 128);  // every warp has its fragments: the slot is free
      if (bulk && k + 1 < n_mine) stage_users(k + 1);
      // warpgroup 0's tile k, then 1's tile k, then 0's k + 1, ...: each
      // waits for the other's products to finish (barrier 3 or 4, which the
      // other arrives at after its wait)
      if (wg == 1 || k > 0) fvx::bar_sync(wg == 0 ? 3 : 4, kWgThreads);
#pragma unroll
      for (int i = 0; i < 128; ++i) fvx::reg_fence(d[i]);
      fvx::wgmma_fence();
      // all kKS steps, zeros past D; the first overwrites the accumulators
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        fvx::wgmma_m64n256k16_bf16(d, af[ks], desc_items + 16 * ks, ks > 0);
      fvx::wgmma_commit();
      if (!bulk && k + 1 < n_mine) stage_users(k + 1);  // under the product
      fvx::wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 128; ++i) fvx::reg_fence(d[i]);
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) fvx::reg_fence(af[ks][i]);
      if (wg == 0 ? k < n_other : k + 1 < n_other)  // the other has a product next
        fvx::bar_arrive(wg == 0 ? 4 : 3, kWgThreads);

      // the bias of items 64t + 4c .. 64t + 4c + 3 (columns i = 2c, 2c + 1)
      const float* bt = bias_s + t * kBiasLD;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + 4 * c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          d[8 * c + 2 * h] += bv.x;
          d[8 * c + 2 * h + 1] += bv.y;
          d[8 * c + 4 + 2 * h] += bv.z;
          d[8 * c + 4 + 2 * h + 1] += bv.w;
        }
      }
      const long long u0 = static_cast<long long>(wg + 2 * k) * kNT;  // the tile's first user
      const int row = wq * 16 + g;  // the thread's first row; the other row + 8

      if constexpr (kDirect) {
        const long long s0 = s_blk + 64 * t / a.seg;
        wide_rows_seg<0>(d, a, u0 + row, s0);
        wide_rows_seg<1>(d, a, u0 + row + 8, s0);
      } else {
        const int nseg = a.nseg;
        for (int q = wtid; q < nseg * kNT; q += 128) red[q] = -CUDART_INF_F;
        fvx::bar_sync(1 + wg, 128);
        const int L0 = 64 * t;  // the thread's first item of the sub-tile
        const bool one = a.seg > kWideMT;  // one segment walked in sub-tiles
        int ls = one ? 0 : L0 / a.seg;
        int next = one ? kWideMT : (ls + 1) * a.seg;  // where segment ls + 1 starts
        float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < 64; ++q) {
          if (L0 + q == next) {
            if (ls < nseg) {
              atomic_fmax(red + row * nseg + ls, m0);
              atomic_fmax(red + (row + 8) * nseg + ls, m1);
            }
            ++ls;
            next += a.seg;
            m0 = m1 = -CUDART_INF_F;
          }
          m0 = fmaxf(m0, WIDE_AT(q, 0));
          m1 = fmaxf(m1, WIDE_AT(q, 1));
        }
        if (ls < nseg) {
          atomic_fmax(red + row * nseg + ls, m0);
          atomic_fmax(red + (row + 8) * nseg + ls, m1);
        }
        fvx::bar_sync(1 + wg, 128);
        // consecutive threads on consecutive segments of one user's row
        for (int q = wtid; q < nseg * kNT; q += 128) {
          const int u = q / nseg;
          const long long b = u0 + u, s = s_blk + (q - u * nseg);
          if (b >= a.B || s >= a.S) continue;
          float m = red[q];
          float* o = a.out + b * a.S + s;
          if (r > 0) m = fmaxf(m, *o);
          *o = m;
        }
        fvx::bar_sync(1 + wg, 128);  // red read before the next tile's init
      }
    }
  }
}
#undef WIDE_AT

// one launch, the kernel's dynamic shared memory raised past 48 KB the
// first time it needs more (granted: the instantiation's own record)
int launch_with(void (*kernel)(MmaArgs), size_t& granted, const MmaArgs& a,
                long long blocks, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024 && smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kG>
int launch_mma_as(const MmaArgs& a, long long blocks, size_t smem, cudaStream_t s) {
  static size_t granted = 0;
  return launch_with(segmax_mma_kernel<kG>, granted, a, blocks, kMmaThreads, smem, s);
}

template <int kKS, int kG>
int launch_regs_as(const MmaArgs& a, long long blocks, size_t smem, cudaStream_t s) {
  static size_t granted = 0;
  return launch_with(segmax_mma_regs_kernel<kKS, kG>, granted, a, blocks, kMmaThreads,
                     smem, s);
}

template <int kKS, int kG>
int launch_wgmma_as(const MmaArgs& a, long long blocks, size_t smem, cudaStream_t s) {
  static size_t granted = 0;
  return launch_with(segmax_wgmma_kernel<kKS, kG>, granted, a, blocks, kWgThreads, smem,
                     s);
}

template <int kKS, bool kDirect>
int launch_wide_as(const MmaArgs& a, long long blocks, size_t smem, cudaStream_t s) {
  static size_t granted = 0;
  return launch_with(segmax_wgmma_wide_kernel<kKS, kDirect>, granted, a, blocks, kWgThreads,
                     smem, s);
}

template <int kKS>
int launch_regs(const MmaArgs& a, int kg, long long blocks, size_t smem, cudaStream_t s) {
  switch (kg) {
    case 32:  // two fragments a warp only (plan() gives one fragment 16)
      if constexpr (regs_frags<kKS>() == 2) return launch_regs_as<kKS, 32>(a, blocks, smem, s);
      return static_cast<int>(cudaErrorInvalidValue);
    case 16: return launch_regs_as<kKS, 16>(a, blocks, smem, s);
    case 8: return launch_regs_as<kKS, 8>(a, blocks, smem, s);
    default: return launch_regs_as<kKS, 0>(a, blocks, smem, s);
  }
}

template <int kKS>
int launch_wgmma(const MmaArgs& a, int kg, long long blocks, size_t smem, cudaStream_t s) {
  switch (kg) {
    case 16: return launch_wgmma_as<kKS, 16>(a, blocks, smem, s);
    case 8: return launch_wgmma_as<kKS, 8>(a, blocks, smem, s);
    default: return launch_wgmma_as<kKS, 0>(a, blocks, smem, s);
  }
}

enum Route { kRouteSimt = 0, kRouteMma = 1, kRouteRegs = 2, kRouteWgmma = 3, kRouteWide = 4 };

// what fvx_segmax_bf16 launches for a geometry
struct Plan {
  int route;
  int ks;      // 16-deep steps: D zero-padded to Dp = 16 ks
  int ld;      // shared row stride in bf16 (segmax_mma_kernel, register kernel)
  int cw;      // bytes a copy moves
  int kg;      // rows group_max reduces in registers; 0: the score tile.  Wide
               // kernel: seg where it divides 64 (reduced in registers), 0 else
  int mt;      // items a block tile holds
  int stages;  // user-tile ring slots a block
  size_t smem; // dynamic shared memory a block
};

// B users x D columns at segment width seg, both operands aligned to
// align bytes.  The copies are as wide as the rows allow: 16 bytes (D a
// multiple of 8 and 16-byte aligned operands), 8 (D a multiple of 4, 8-byte
// aligned: VBPR's and GradFashion's D=148, 296-byte rows), 4, else 2-byte
// loads.  8- or 16-byte copies and D <= 256 take the register kernel (one
// user tile, B <= 64; D zero-padded to 128 for 16-byte rows up to 128,
// else 160, and to 256 above 160) or a warpgroup kernel:
// segmax_wgmma_kernel up to D = 160 (Dp 128 or 160),
// segmax_wgmma_wide_kernel above (Dp 208 up to D = 208, else 256);
// anything else segmax_mma_kernel; and tiles that outgrow shared memory
// (D above ~300) the CUDA cores.
Plan plan(long long B, long long D, long long seg, int align) {
  Plan p;
  p.cw = D % 8 == 0 && align >= 16 ? 16
       : D % 4 == 0 && align >= 8  ? 8
       : D % 2 == 0 && align >= 4  ? 4
                                   : 2;
  const long long n_ut = (B + kNT - 1) / kNT;
  const bool wide = D > kMaxKS * 16;
  const int ks_wide = D <= 16 * kWideMidKS ? kWideMidKS : kWideKS;
  const long long merged = 64 % seg == 0 ? 0 : seg <= kWideMT ? kWideMT / seg : 1;
  // the register or a warpgroup kernel (not the wide one where its merge
  // outgrows shared memory: Dp = 256, seg 3)
  const bool regs = p.cw >= 8 && D <= kWideKS * 16 &&
                    !(wide && n_ut > 1 && wide_smem(ks_wide, merged) > kMaxSmem);
  const bool wg = regs && n_ut > 1;
  p.route = !regs ? kRouteMma : !wg ? kRouteRegs : wide ? kRouteWide : kRouteWgmma;
  // 8 steps only for 16-byte rows: those kernels compile no narrower copy
  p.ks = !regs ? static_cast<int>((D + 15) / 16)
       : !wide ? (D <= 128 && p.cw == 16 ? 8 : kMaxKS)
       : wg ? ks_wide : kWideKS;
  const int Dp = 16 * p.ks;
  // shared row stride: 16 bytes of pad for ldmatrix; for the register
  // kernel's 16-byte loads rows 64 bytes apart mod 128 (ld = 32 mod 64,
  // 160 at Dp = 128 and 160, 288 at 256), so that the 8 lanes of a load
  // phase (2 rows x 4 lanes) hit 8 different bank groups; the wide kernel's
  // core matrices have none
  p.ld = p.route == kRouteWide ? Dp + 8 : regs ? Dp + (96 - Dp % 64) % 64 : Dp + 8;
  p.mt = p.route == kRouteWide ? kWideMT
       : p.route == kRouteRegs ? regs_tile_of(p.ks)
       : regs ? kWgMT : kMT;
  // a warpgroup's warp, and the register kernel's above 160, hold 16 rows
  const bool one_frag = p.route == kRouteWgmma || (p.route == kRouteRegs && wide);
  if (p.route == kRouteWide) p.kg = 64 % seg == 0 ? static_cast<int>(seg) : 0;
  else if (seg > p.mt || seg % 32 == 0) p.kg = one_frag ? 16 : 32;
  else if (seg % 16 == 0) p.kg = 16;
  else if (seg % 8 == 0) p.kg = 8;
  else p.kg = 0;
  if (p.route == kRouteWide) {
    p.stages = 2;  // a user slot a warpgroup
    p.smem = wide_smem(p.ks, merged);
    return p;
  }
  const size_t n_buf = n_ut < kStages ? n_ut : kStages;
  p.stages = static_cast<int>(n_buf);
  const bool narrow_wg = p.route == kRouteWgmma;
  const size_t tiles =
      narrow_wg ? (n_buf * kNT * Dp + (p.ks > kWgRegKS ? kWgMT * 16 * (p.ks - kWgRegKS) : 0)) * 2
              : ((p.route == kRouteRegs ? 0 : kMT) + n_buf * kNT) * static_cast<size_t>(p.ld) * 2;
  const size_t reduce = p.kg ? static_cast<size_t>(p.mt / p.kg) * kNT * 4
                             : static_cast<size_t>(p.mt) * kScoreLD * 4;
  p.smem = tiles + reduce;
  if (p.smem > kMaxSmem) p.route = kRouteSimt;
  return p;
}

// the bf16 tensor-core launch of plan p (route other than kRouteSimt)
int launch_mma(const void* uf, const void* iv, const void* ib, void* out,
               long long B, long long Ip, long long D, long long seg, const Plan& p,
               cudaStream_t stream) {
  MmaArgs a;
  a.uf = static_cast<const __nv_bfloat16*>(uf);
  a.iv = static_cast<const __nv_bfloat16*>(iv);
  a.ib = static_cast<const float*>(ib);
  a.out = static_cast<float*>(out);
  a.B = static_cast<int>(B);
  a.D = static_cast<int>(D);
  a.Dp = 16 * p.ks;
  a.ld = p.ld;
  a.cw = p.cw;
  a.Ip = Ip;
  a.S = Ip / seg;
  a.seg = static_cast<int>(seg);
  a.n_ut = static_cast<int>((B + kNT - 1) / kNT);
  a.nseg = seg <= p.mt ? static_cast<int>(p.mt / seg) : 1;
  a.span = seg <= p.mt ? static_cast<int>(a.nseg * seg) : static_cast<int>(seg);
  a.sub_tiles = (a.span + p.mt - 1) / p.mt;
  const long long blocks = (a.S + a.nseg - 1) / a.nseg;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  switch (p.route) {
    case kRouteWide:
      if (p.ks == kWideMidKS)
        return p.kg ? launch_wide_as<kWideMidKS, true>(a, blocks, p.smem, stream)
                    : launch_wide_as<kWideMidKS, false>(a, blocks, p.smem, stream);
      return p.kg ? launch_wide_as<kWideKS, true>(a, blocks, p.smem, stream)
                  : launch_wide_as<kWideKS, false>(a, blocks, p.smem, stream);
    case kRouteWgmma:
      return p.ks > 8 ? launch_wgmma<kMaxKS>(a, p.kg, blocks, p.smem, stream)
                      : launch_wgmma<8>(a, p.kg, blocks, p.smem, stream);
    case kRouteRegs:
      return p.ks == kWideKS ? launch_regs<kWideKS>(a, p.kg, blocks, p.smem, stream)
           : p.ks > 8        ? launch_regs<kMaxKS>(a, p.kg, blocks, p.smem, stream)
                             : launch_regs<8>(a, p.kg, blocks, p.smem, stream);
    default:
      switch (p.kg) {
        case 32: return launch_mma_as<32>(a, blocks, p.smem, stream);
        case 16: return launch_mma_as<16>(a, blocks, p.smem, stream);
        case 8: return launch_mma_as<8>(a, blocks, p.smem, stream);
        default: return launch_mma_as<0>(a, blocks, p.smem, stream);
      }
  }
}

// the largest power of two up to 16 that divides both addresses
int operand_align(const void* uf, const void* iv) {
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(uf) | reinterpret_cast<uintptr_t>(iv) | 16;
  return static_cast<int>(bits & (~bits + 1));
}

bool bad_geometry(long long B, long long Ip, long long D, long long seg) {
  return B < 1 || Ip < 1 || D < 1 || seg < 1 || Ip % seg != 0 ||
         B > (1LL << 30) || D > (1LL << 30) || seg > (1LL << 30);
}

}  // namespace

// Plain C interface for ctypes.  uf [B, D], iv [Ip, D] (row-major, same
// dtype), ib [Ip] f32, out [B, Ip/seg] f32, all contiguous on the current
// device.  Returns the cudaError_t of the launch (0 = launched) and writes
// the route it launched to *route (as fvx_segmax_route returns it).
extern "C" int fvx_segmax_bf16(const void* uf, const void* iv, const void* ib,
                               void* out, long long B, long long Ip,
                               long long D, long long seg, void* stream,
                               int* route) {
  if (bad_geometry(B, Ip, D, seg))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(B, D, seg, operand_align(uf, iv));
  *route = p.route;
  return p.route == kRouteSimt
             ? launch_simt<__nv_bfloat16>(uf, iv, ib, out, B, Ip, D, seg, s)
             : launch_mma(uf, iv, ib, out, B, Ip, D, seg, p, s);
}

extern "C" int fvx_segmax_f32(const void* uf, const void* iv, const void* ib,
                              void* out, long long B, long long Ip,
                              long long D, long long seg, void* stream,
                              int* route) {
  if (bad_geometry(B, Ip, D, seg))
    return static_cast<int>(cudaErrorInvalidValue);
  *route = kRouteSimt;
  return launch_simt<float>(uf, iv, ib, out, B, Ip, D, seg,
                            static_cast<cudaStream_t>(stream));
}

// The route fvx_segmax_bf16 takes for B users x D at segment width seg
// with both operands aligned to align bytes, launching nothing: 0
// segmax_simt_kernel, 1 segmax_mma_kernel, 2 segmax_mma_regs_kernel, 3
// segmax_wgmma_kernel, 4 segmax_wgmma_wide_kernel, or -1 for a bad
// geometry.  info gets {16-deep steps, shared row stride, copy bytes, rows
// reduced in registers, shared memory bytes, items a block, user-tile ring
// slots a block}.
extern "C" int fvx_segmax_route(long long B, long long D, long long seg, int align,
                                long long* info) {
  if (bad_geometry(B, seg, D, seg) || align < 1) return -1;
  const Plan p = plan(B, D, seg, align);
  const long long fields[7] = {p.ks, p.ld, p.cw, p.kg, static_cast<long long>(p.smem),
                               p.mt, p.stages};
  for (int i = 0; i < 7; ++i) info[i] = fields[i];
  return p.route;
}
