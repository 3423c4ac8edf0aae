// Fused BPR triplet loss, forward and backward, for Hopper (sm_90a).
//
// Forward, per triple b:
//   diff_b  = (bp_b - bn_b) + sum_k gu_bk * (gp_bk - gn_bk)
//   loss    = sum_b softplus(-clip(diff_b, -80, 1e8))
//   sigma_b = sigmoid(-diff_b) inside the open interval (-80, 1e8), else 0
// Backward, with upstream gradient g:
//   dgu = g*(sigma*(gn - gp)), dgp = g*(-sigma*gu), dgn = g*(sigma*gu),
//   dbp = g*(-sigma),          dbn = g*sigma
//
// Replaces the TPU kernels fashionvisualexpl_tpu/ops/bpr.py::_fwd_kernel and
// ::_bwd_kernel (behind bpr_triplet_loss); the wrappers, their plain PyTorch
// versions, the autograd Function and the launch counts are in
// fashionvisualexpl_tpu_torch/ops/bpr.py.
//
// What bounds it: bytes.  At the training shapes (B=8192, K=128, f32) the
// forward reads three [B, K] row blocks and two [B] vectors and writes
// sigma (~12.7 MB, ~3.8 us at 3.35 TB/s) for ~4 FLOP per element; the
// backward reads sigma and three [B, K] blocks and writes three [B, K]
// blocks and two [B] vectors (~25.2 MB, ~7.5 us).  At that size launch
// latency, not bandwidth, is what a single call pays.
//
// Design.  Forward: one warp per triple (grid-stride over triples); the
// lanes walk K with a stride of 32, so each load instruction of a warp
// reads consecutive addresses; the dot product is an xor-shuffle tree.
// The TPU kernel carried the loss sum in scratch memory from grid step to
// grid step; CUDA blocks run in no order, so each block writes its own
// partial sum (warps summed in a fixed order) and a second one-block
// kernel sums the partials in a fixed order: the loss has the same bits
// from run to run (no float atomics).  Backward: one thread per [B, K]
// element, elementwise.  No padded rows: the grid masks the ragged edge.
// softplus(x) is written as jax.nn.softplus (logaddexp(x, 0)) computes it,
// max(x, 0) + log1p(exp(-|x|)); build without --use_fast_math so that
// expf, log1pf and division are IEEE-accurate, as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBwdBlocks = 132 * 16;
constexpr float kClipLo = -80.0f;
constexpr float kClipHi = 1e8f;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(kThreads)
bpr_fwd_kernel(const float* __restrict__ gu, const float* __restrict__ gp,
               const float* __restrict__ gn, const float* __restrict__ bp,
               const float* __restrict__ bn, float* __restrict__ sigma,
               float* __restrict__ partial, long long B, int K) {
  __shared__ float warp_loss[kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc = 0.0f;  // this warp's loss, held by lane 0
  for (long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
       b < B; b += static_cast<long long>(gridDim.x) * kWarps) {
    const long long base = b * K;
    float d = 0.0f;
    for (int k = lane; k < K; k += 32)
      d = fmaf(gu[base + k], gp[base + k] - gn[base + k], d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      const float diff = (bp[b] - bn[b]) + d;
      const float clipped = fminf(fmaxf(diff, kClipLo), kClipHi);
      acc += softplus(-clipped);
      const bool in_range = diff > kClipLo && diff < kClipHi;
      sigma[b] = in_range ? 1.0f / (1.0f + expf(diff)) : 0.0f;
    }
  }
  if (lane == 0) warp_loss[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += warp_loss[w];
    partial[blockIdx.x] = s;
  }
}

// one block: strided per-thread sums, then a fixed shared-memory tree
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partial, int n,
                    float* __restrict__ out) {
  __shared__ float buf[kThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partial[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

__global__ void __launch_bounds__(kThreads)
bpr_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ gu,
               const float* __restrict__ gp, const float* __restrict__ gn,
               const float* __restrict__ gout, float* __restrict__ dgu,
               float* __restrict__ dgp, float* __restrict__ dgn,
               float* __restrict__ dbp, float* __restrict__ dbn,
               long long B, int K) {
  const float g = gout[0];
  const long long n = B * K;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long b = i / K;
    const float s = sigma[b];
    const float u = gu[i], p = gp[i], q = gn[i];
    dgu[i] = g * (s * (q - p));
    dgp[i] = g * (-s * u);
    dgn[i] = g * (s * u);
    if (i - b * K == 0) {
      dbp[b] = g * (-s);
      dbn[b] = g * s;
    }
  }
}

}  // namespace

// Plain C interface for ctypes.  All arrays f32, contiguous, on the current
// device: gu/gp/gn [B, K], bp/bn/sigma [B], loss [1], gout [1], the d* the
// shapes of their inputs.  `partial` is scratch of n_partial floats; the
// forward runs at most n_partial blocks (one warp per triple, grid-stride
// beyond).  Each returns the cudaError_t of its launches (0 = launched).
extern "C" int fvx_bpr_fwd(const void* gu, const void* gp, const void* gn,
                           const void* bp, const void* bn, void* sigma,
                           void* partial, long long n_partial, void* loss,
                           long long B, long long K, void* stream) {
  if (B < 1 || K < 1 || K > (1LL << 30) || n_partial < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long want = (B + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < n_partial ? want : n_partial);
  bpr_fwd_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(gu), static_cast<const float*>(gp),
      static_cast<const float*>(gn), static_cast<const float*>(bp),
      static_cast<const float*>(bn), static_cast<float*>(sigma),
      static_cast<float*>(partial), B, static_cast<int>(K));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(partial), blocks, static_cast<float*>(loss));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fvx_bpr_bwd(const void* sigma, const void* gu, const void* gp,
                           const void* gn, const void* gout, void* dgu,
                           void* dgp, void* dgn, void* dbp, void* dbn,
                           long long B, long long K, void* stream) {
  if (B < 1 || K < 1 || K > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = B * K;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks =
      static_cast<int>(want < kMaxBwdBlocks ? want : kMaxBwdBlocks);
  bpr_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sigma), static_cast<const float*>(gu),
      static_cast<const float*>(gp), static_cast<const float*>(gn),
      static_cast<const float*>(gout), static_cast<float*>(dgu),
      static_cast<float*>(dgp), static_cast<float*>(dgn),
      static_cast<float*>(dbp), static_cast<float*>(dbn), B,
      static_cast<int>(K));
  return static_cast<int>(cudaGetLastError());
}
