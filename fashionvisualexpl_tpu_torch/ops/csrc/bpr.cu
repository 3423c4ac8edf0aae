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
// sigma (~12.7 MB, ~3.8 us at 3.35 TB/s) for ~3 FLOP per 12 bytes, far
// below the ~295 FLOP a byte where the tensor cores would matter; the
// backward reads sigma and three [B, K] blocks and writes three [B, K]
// blocks and two [B] vectors (~25.2 MB, ~7.5 us).  At that size a call
// pays mostly for getting every byte in flight and the first ones back,
// and for its launch; so the forward asks for all of its bytes at once
// and is one launch.
//
// Forward design: block i owns the contiguous tile of T triples
// [i*T, min((i+1)*T, B)); the ragged last tile is masked, never padded.
// The lanes read the rows straight from device memory, every load of a
// lane issued before its first FMA.  Two routes (the kVec template):
// - vec (K*4 a multiple of 16, gu, gp, gn 16-byte aligned): a quarter-warp
//   owns a triple and reads float4 columns (8 lanes cover 128 consecutive
//   bytes of a row), T = 32: a warp holds 4 triples, the block's 8 warps
//   all 32, each lane K/32 float4 of each row (12 loads in flight at
//   K=128), and the B=8192 grid is 256 blocks, one wave on 132 SMs.
// - plain (K*4 not a multiple of 16, or a storage offset): a warp owns a
//   triple and reads scalars, each load instruction of the warp on 32
//   consecutive floats; T = 16, two triples a warp in turn.
// Bringing a tile's rows into shared memory by bulk asynchronous copies
// (cp.async.bulk on an mbarrier, as the TPU kernel's BlockSpecs did) was
// measured on an H100 against this: no faster with the rows in device
// memory, and slower with the rows in L2, where the training step's
// gathers leave them: the copies land in shared memory later than the
// lanes' own loads come back.  The tile's dot products meet in shared
// memory; then thread t runs the clip, softplus and sigmoid of triple t,
// so the epilogue is spread over the lanes and sigma leaves as one
// coalesced store of the tile.
//
// The loss in the same launch, without float atomics: each block sums its
// tile's softplus terms in a fixed tree (an xor-shuffle tree in each
// warp, then warp 0 over the warp sums), writes that partial,
// __threadfence()s and takes a ticket with one integer atomicAdd.  The
// block that draws the last ticket reads every partial from L2 and sums
// them in index order through the same fixed tree (thread t takes
// partials t, t+256, ... in order), writes the loss and resets the ticket
// to 0 for the next launch on the stream.  Which block is last changes
// from run to run; the order of the additions does not, so the loss has
// the same bits.  The partials and the ticket are a workspace the wrapper
// keeps per (device, stream), zeroed once when made.  Tiles of 32 keep
// the tickets to 256 at B=8192: tickets on one address serialize, and a
// one-wave grid draws them all at its end.
//
// Backward: one thread per [B, K] element, elementwise.  softplus(x) is
// written as jax.nn.softplus (logaddexp(x, 0)) computes it, max(x, 0) +
// log1p(exp(-|x|)); build without --use_fast_math so that expf, log1pf and
// division are IEEE-accurate, as in the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecTile = 32;    // triples a block on the vec route
constexpr int kPlainTile = 16;  // triples a block on the plain route
constexpr int kMaxBwdBlocks = 132 * 16;
constexpr float kClipLo = -80.0f;
constexpr float kClipHi = 1e8f;

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// The sum over the block of each thread's v in a fixed tree; the result is
// thread 0's.  warp_sums is free again after the caller's next barrier.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// grid: one block a tile of T triples (kVecTile or kPlainTile)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bpr_fwd_kernel(const float* __restrict__ gu, const float* __restrict__ gp,
               const float* __restrict__ gn, const float* __restrict__ bp,
               const float* __restrict__ bn, float* __restrict__ sigma,
               float* __restrict__ partial, unsigned int* __restrict__ ticket,
               float* __restrict__ loss, long long B, int K) {
  constexpr int T = kVec ? kVecTile : kPlainTile;
  constexpr int kLanes = kVec ? 8 : 32;  // lanes a triple
  __shared__ float dot[T];
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const int n = static_cast<int>(B - r0 < T ? B - r0 : T);
  const float bias = tid < n ? bp[r0 + tid] - bn[r0 + tid] : 0.0f;

  // lane j of a triple's group takes columns j, j + kLanes, ... (float4
  // columns on the vec route); the passes over the tile are a constant
  // count (1 on the vec route, 2 on the plain), unrolled
  const int j = tid % kLanes;
#pragma unroll
  for (int base = 0; base < T; base += kThreads / kLanes) {
    const int row = base + tid / kLanes;
    float d = 0.0f;
    if (row < n) {
      if constexpr (kVec) {
        const int k4 = K / 4;
        const long long o = (r0 + row) * k4;
        const float4* u = reinterpret_cast<const float4*>(gu) + o;
        const float4* p = reinterpret_cast<const float4*>(gp) + o;
        const float4* q = reinterpret_cast<const float4*>(gn) + o;
#pragma unroll 4
        for (int k = j; k < k4; k += kLanes) {
          const float4 a = u[k], x = p[k], y = q[k];
          d = fmaf(a.x, x.x - y.x, d);
          d = fmaf(a.y, x.y - y.y, d);
          d = fmaf(a.z, x.z - y.z, d);
          d = fmaf(a.w, x.w - y.w, d);
        }
      } else {
        const long long o = (r0 + row) * K;
#pragma unroll 4
        for (int k = j; k < K; k += kLanes)
          d = fmaf(gu[o + k], gp[o + k] - gn[o + k], d);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    if (j == 0 && row < n) dot[row] = d;
  }
  __syncthreads();

  float term = 0.0f;
  if (tid < n) {
    const float diff = bias + dot[tid];
    const float clipped = fminf(fmaxf(diff, kClipLo), kClipHi);
    term = softplus(-clipped);
    const bool in_range = diff > kClipLo && diff < kClipHi;
    sigma[r0 + tid] = in_range ? 1.0f / (1.0f + expf(diff)) : 0.0f;
  }
  const float tile_loss = block_sum(term, warp_sums);
  if (tid == 0) {
    partial[blockIdx.x] = tile_loss;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int i = tid; i < static_cast<int>(gridDim.x); i += kThreads)
    s += __ldcg(partial + i);
  s = block_sum(s, warp_sums);
  if (tid == 0) {
    loss[0] = s;
    *ticket = 0u;
  }
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
// shapes of their inputs.  The forward runs ceil(B / T) blocks, T =
// kVecTile if `vec` else kPlainTile (the caller passes it, as
// ops/bpr.py::fwd_tiles chose it); `partial` holds a float for each block
// and `ticket` an unsigned int that is 0 between launches (the last block
// resets it).  For `vec` the caller has checked that K*4 is a multiple of
// 16 and that gu, gp, gn are 16-byte aligned.  Each returns the
// cudaError_t of its launch (0 = launched).
extern "C" int fvx_bpr_fwd(const void* gu, const void* gp, const void* gn,
                           const void* bp, const void* bn, void* sigma,
                           void* partial, void* ticket, void* loss, long long B,
                           long long K, long long T, int vec, void* stream) {
  if (B < 1 || K < 1 || K > (1LL << 30) || T != (vec ? kVecTile : kPlainTile) ||
      (B + T - 1) / T > 0x7fffffffLL || (vec && K % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((B + T - 1) / T);
  auto* kernel = vec ? bpr_fwd_kernel<true> : bpr_fwd_kernel<false>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gu), static_cast<const float*>(gp),
      static_cast<const float*>(gn), static_cast<const float*>(bp),
      static_cast<const float*>(bn), static_cast<float*>(sigma),
      static_cast<float*>(partial), static_cast<unsigned int*>(ticket),
      static_cast<float*>(loss), B, static_cast<int>(K));
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
