// Fused Adam sweep for Hopper (sm_90a): one in-place pass over p, m, v.
//
//   m <- B1*m,  v <- B2*v,  p <- p - lr_t1*m / (sqrt(v*inv_bc2) + EPS)
//
// with lr_t1 = lr/(1 - B1^t) and inv_bc2 = 1/(1 - B2^t) computed once by
// the caller in float32 and read from device memory (scal[0], scal[1]), as
// the TPU kernel read them from SMEM.  Replaces the TPU kernel
// fashionvisualexpl_tpu/ops/adam.py::_sweep_kernel (behind fused_adam_sweep
// and sparse_adam_table_fused); the wrapper, its plain PyTorch version and
// the launch count are in fashionvisualexpl_tpu_torch/ops/adam.py.
//
// What bounds it: bytes.  Each element reads p, m, v once and writes them
// once (24 bytes) for ~8 FLOP, far below the card's ~20 FLOP/byte f32
// balance.  At the training shapes (Gu 1M x 128, Gi 500k x 128, Bi 500k)
// that is ~4.6 GB per step over the three tables: ~1.38 ms at 3.35 TB/s.
//
// Design: a grid-stride loop of 16-byte (float4) loads and stores when the
// three arrays are 16-byte aligned, and a scalar loop for the n % 4 tail
// (or for everything when they are not aligned), so any length works.
// The grid is capped at 16 blocks of 256 threads per SM, enough loads in
// flight to saturate HBM.  Build without --use_fast_math: sqrtf and the
// division stay IEEE-rounded, as in the plain version, so the two agree to
// the bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;
constexpr float kB1 = 0.9f;
constexpr float kB2 = 0.999f;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ void adam1(float& p, float& m, float& v,
                                      float lr_t1, float inv_bc2) {
  m = m * kB1;
  v = v * kB2;
  p = p - lr_t1 * m / (sqrtf(v * inv_bc2) + kEps);
}

__global__ void __launch_bounds__(kThreads)
adam_sweep_vec4(float4* __restrict__ p, float4* __restrict__ m,
                float4* __restrict__ v, const float* __restrict__ scal,
                long long n4) {
  const float lr_t1 = scal[0], inv_bc2 = scal[1];
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads) {
    float4 pp = p[i], mm = m[i], vv = v[i];
    adam1(pp.x, mm.x, vv.x, lr_t1, inv_bc2);
    adam1(pp.y, mm.y, vv.y, lr_t1, inv_bc2);
    adam1(pp.z, mm.z, vv.z, lr_t1, inv_bc2);
    adam1(pp.w, mm.w, vv.w, lr_t1, inv_bc2);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_sweep_scalar(float* __restrict__ p, float* __restrict__ m,
                  float* __restrict__ v, const float* __restrict__ scal,
                  long long start, long long n) {
  const float lr_t1 = scal[0], inv_bc2 = scal[1];
  for (long long i = start + static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * kThreads) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam1(pp, mm, vv, lr_t1, inv_bc2);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

int blocks_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

}  // namespace

// Plain C interface for ctypes.  p, m, v: n contiguous f32 each (a table of
// any shape, flattened), updated in place; scal: 2 f32 on the device
// {lr/(1-B1^t), 1/(1-B2^t)}.  Returns the cudaError_t of the launches
// (0 = launched).
extern "C" int fvx_adam_sweep(void* p, void* m, void* v, const void* scal,
                              long long n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* sc = static_cast<const float*>(scal);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(pf) |
                         reinterpret_cast<std::uintptr_t>(mf) |
                         reinterpret_cast<std::uintptr_t>(vf)) & 15u) == 0;
  long long done = 0;
  if (aligned && n >= 4) {
    const long long n4 = n / 4;
    adam_sweep_vec4<<<blocks_for(n4), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(pf), reinterpret_cast<float4*>(mf),
        reinterpret_cast<float4*>(vf), sc, n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    done = n4 * 4;
  }
  if (done < n) {
    adam_sweep_scalar<<<blocks_for(n - done), kThreads, 0, st>>>(
        pf, mf, vf, sc, done, n);
  }
  return static_cast<int>(cudaGetLastError());
}
