// Fused catalog scoring + segment max (serving stage 1) for Hopper, sm_90a.
//
//   out[b, s] = max over items j of segment s of (uf[b] . iv[j] + ib_cand[j])
//
// with f32 accumulation from bf16 or f32 operands.  Replaces the TPU kernel
// fashionvisualexpl_tpu/ops/segmax.py::_kernel (behind segmax_scores); the
// wrapper, its plain PyTorch version and the launch count are in
// fashionvisualexpl_tpu_torch/ops/segmax.py.
//
// What bounds it: at the serving shapes (B=4096 users, Ip=1,048,576 items,
// D=128) the product is 1.10 TFLOP, ~1.11 ms at the H100 SXM's 989 TFLOP/s
// bf16 tensor-core rate, while the bytes that must move (iv 268 MB + out
// 537 MB) take ~0.24 ms at 3.35 TB/s: operations bound.  At B=8 the 268 MB
// item read alone bounds it, ~0.08 ms.  This first design runs on the CUDA
// cores (f32 FMA), so it sits far above the tensor-core bound; mma/wgmma and
// TMA are later work.
//
// Design: one block of 256 threads per (16-user tile, item tile).  The block
// walks D in chunks of 32: it stages the item tile and the user tile in
// shared memory as f32 (the item rows at a padded stride of 33 words, so the
// 32 threads of a warp reading 32 different rows hit 32 different banks),
// then each thread takes its own item's chunk into registers and
// accumulates its dot with all 16 users, reading the user values as
// broadcast float4s.  Scores never reach device memory: each thread keeps
// the running max of its item(s) per user, writes it to shared memory, and
// one pass over shared memory takes the max over each segment and stores
// out[b, s].  Any segment width works: an item tile holds floor(256/seg)
// whole segments (seg <= 256), or one segment walked in 256-item sub-tiles
// (seg > 256), so no segment straddles two blocks.  Blocks are numbered
// user tile fastest, so the blocks that share an item tile run together and
// read it from L2.  Ragged users, items and D are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

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
segmax_kernel(const T* __restrict__ uf, const T* __restrict__ iv,
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
int launch(const void* uf, const void* iv, const void* ib, void* out,
           long long B, long long Ip, long long D, long long seg,
           void* stream) {
  if (B < 1 || Ip < 1 || D < 1 || seg < 1 || Ip % seg != 0 ||
      B > (1LL << 30) || D > (1LL << 30) || seg > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
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
  segmax_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(uf), static_cast<const T*>(iv),
      static_cast<const float*>(ib), static_cast<float*>(out),
      static_cast<int>(B), Ip, static_cast<int>(D), static_cast<int>(seg), S,
      span, sub_tiles, nseg, n_ut);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  uf [B, D], iv [Ip, D] (row-major, same
// dtype), ib [Ip] f32, out [B, Ip/seg] f32, all contiguous on the current
// device.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int fvx_segmax_bf16(const void* uf, const void* iv, const void* ib,
                               void* out, long long B, long long Ip,
                               long long D, long long seg, void* stream) {
  return launch<__nv_bfloat16>(uf, iv, ib, out, B, Ip, D, seg, stream);
}

extern "C" int fvx_segmax_f32(const void* uf, const void* iv, const void* ib,
                              void* out, long long B, long long Ip,
                              long long D, long long seg, void* stream) {
  return launch<float>(uf, iv, ib, out, B, Ip, D, seg, stream);
}
