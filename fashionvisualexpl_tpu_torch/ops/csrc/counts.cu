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
// What bounds it: operations.  The product alone is 2*B*Ip*D operations:
// at the streaming evaluator's shapes (B=4096 users, Ip=501,760 items,
// D=128) 526 GFLOP, 7.85 ms at the H100 SXM's 67 TFLOP/s f32 rate on the
// CUDA cores, against ~0.26 GB of inputs (iv 257 MB), 0.08 ms at 3.35 TB/s.
// f32 only: no TF32, no tensor cores, and no --use_fast_math, so every
// score is the same f32 FMA chain whatever the data; counts are then equal
// to the plain version's wherever both compute exact scores (quantized
// data), and differ elsewhere only for items whose score lies within f32
// rounding of the reference.
//
// Design.  Scores never reach device memory.  A block of 256 threads owns
// a tile of 128 users and a chunk of the catalog, which it walks in
// 128-item sub-tiles: the classic register-blocked SGEMM, D staged 8 at a
// time in shared memory (transposed, rows padded to 132 floats so the
// stores spread over the banks and the float4 reads stay aligned), each
// thread holding an 8 users x 8 items micro-tile of f32 sums, one fmaf per
// d in ascending d order.  Then, per sub-tile, each thread tests its items
// against its users' W banned offsets of the item tile (staged in shared
// memory when the tile changes), compares the scores with the T refs, and
// the 16 threads that share a user row add their counts with warp shuffles
// into an int per (user, t) in shared memory.  At the end each block adds
// its counts into out with integer atomicAdd (the wrapper zeroes out):
// integer sums are exact and order-free, so the result is deterministic.
// The catalog is cut into chunks so that about eight blocks per SM are
// launched (4096 users make only 32 user tiles).  Pad items (bias -inf),
// pad users (ref +inf) and NaN scores never satisfy >=; ragged users,
// items and D are masked.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTU = 128;           // users per block
constexpr int kTI = 128;           // items per sub-tile
constexpr int kBK = 8;             // D chunk staged in shared memory
constexpr int kStride = kTU + 4;   // padded shared row (kTU == kTI)
constexpr int kMaxT = 4;
constexpr int kMaxW = 48;
constexpr int kBlocksPerSM = 8;

__global__ void __launch_bounds__(kThreads, 2)
counts_kernel(const float* __restrict__ uf, const float* __restrict__ iv,
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

}  // namespace

// Plain C interface for ctypes.  uf [B, D], iv [Ip, D], ib [Ip], ref [B, T]
// f32; loc [ceil(Ip / item_tile), B, W] int32 (-1 = none); out [B, T]
// int32, zeroed by the caller; all contiguous on the current device.
// T <= 4, W <= 48, item_tile a multiple of 128.  Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int fvx_counts(const void* uf, const void* iv, const void* ib,
                          const void* ref, const void* loc, void* out,
                          long long B, long long Ip, long long D, long long T,
                          long long W, long long item_tile, void* stream) {
  if (B < 1 || Ip < 1 || D < 1 || T < 1 || T > kMaxT || W < 1 ||
      W > kMaxW || item_tile < kTI || item_tile % kTI != 0 ||
      B > (1LL << 30) || D > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_ut = (B + kTU - 1) / kTU;
  const long long n_sub = (Ip + kTI - 1) / kTI;
  long long n_chunks = (static_cast<long long>(sms) * kBlocksPerSM + n_ut - 1) / n_ut;
  n_chunks = n_chunks < 1 ? 1 : (n_chunks > n_sub ? n_sub : n_chunks);
  const long long per_chunk = (n_sub + n_chunks - 1) / n_chunks;
  n_chunks = (n_sub + per_chunk - 1) / per_chunk;
  if (n_ut > 0x7fffffffLL || n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_ut), static_cast<unsigned>(n_chunks));
  counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uf), static_cast<const float*>(iv),
      static_cast<const float*>(ib), static_cast<const float*>(ref),
      static_cast<const int*>(loc), static_cast<int*>(out),
      static_cast<int>(B), Ip, static_cast<int>(D), static_cast<int>(T),
      static_cast<int>(W), item_tile, n_sub, per_chunk);
  return static_cast<int>(cudaGetLastError());
}
