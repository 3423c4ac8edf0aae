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
// The backward recomputes the forward and sends dout[b, c] / ((H/2)(W/2))
// of each pooled pixel to one conv output, with the TPU kernel's tie rule:
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
// tap of each winning conv output whose pre-activation is > 0 (dW).  The
// kernel itself runs all 25 taps on the zero halo.
//
// Design (direct convolution on the CUDA cores, f32 FMAs, no TF32, no fast
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
// The backward walks a fixed share of the (image, strip) items per block
// (grid-stride over a grid that depends only on the shapes), accumulates
// g * window values of the winning outputs into 25 + 1 registers, reduces
// the row groups in order into per-block partials, and a second kernel sums
// the blocks in order.  No float atomics: two runs give the same bits.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(kThreads)
edge_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ dout,
                float* __restrict__ partial, int H, int W, int C, int R, int S,
                long long n_items, float n) {
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
  float acc[kAcc];
#pragma unroll
  for (int t = 0; t < kAcc; ++t) acc[t] = 0.0f;

  const int Hp = H / 2, Wp = W / 2, ws = W + 4;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    const long long b = item / S;
    const int r0 = static_cast<int>(item % S) * R;
    const int r1 = min(r0 + R, Hp);
    __syncthreads();  // every warp is done with the previous strip
    stage_strip(smem, x + b * H * W, H, W, r0, r1);
    __syncthreads();
    const float g = active ? dout[b * C + c] / n : 0.0f;
    for (int pr = r0 + rg; pr < r1; pr += l.nrg) {
      const float* rows = smem + 2 * (pr - r0) * ws;
      float win[6][6];
      load_cols(win, rows, ws, 0, 0);
      load_cols(win, rows, ws, 2, 2);
      for (int pc = 0; pc < Wp; ++pc) {
        load_cols(win, rows, ws, 2 * pc + 4, 4);
        float z00, z01, z10, z11;
        conv2x2(win, wr, z00, z01, z10, z11);
        const bool even_t = z00 >= z01;
        const bool even_b = z10 >= z11;
        const float pre_t = (even_t ? z00 : z01) + bc;
        const float pre_b = (even_b ? z10 : z11) + bc;
        const bool top_w = fmaxf(pre_t, 0.0f) >= fmaxf(pre_b, 0.0f);
        const float pre = top_w ? pre_t : pre_b;
        const bool even = top_w ? even_t : even_b;
        const float m = pre > 0.0f ? g : 0.0f;
#pragma unroll
        for (int ky = 0; ky < 5; ++ky) {
          float row[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) row[q] = top_w ? win[ky][q] : win[ky + 1][q];
#pragma unroll
          for (int kx = 0; kx < 5; ++kx)
            acc[ky * 5 + kx] = fmaf(m, even ? row[kx] : row[kx + 1], acc[ky * 5 + kx]);
        }
        acc[kTaps] += m;
        shift_window(win);
      }
    }
  }

  __syncthreads();  // the last strip is read; its memory now holds the sums
  const int cpad = 32 * l.cw;
#pragma unroll
  for (int t = 0; t < kAcc; ++t) smem[(rg * kAcc + t) * cpad + cl] = acc[t];
  __syncthreads();
  if (rg == 0 && active) {
    for (int t = 0; t < kAcc; ++t) {
      float s = 0.0f;
      for (int g = 0; g < l.nrg; ++g) s += smem[(g * kAcc + t) * cpad + cl];
      partial[(static_cast<long long>(blockIdx.x) * kAcc + t) * C + c] = s;
    }
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
size_t smem_bytes(long long W, long long C, long long R, int acc) {
  const Layout l = layout(static_cast<int>(C));
  const size_t stage = static_cast<size_t>(2 * R + 4) * static_cast<size_t>(W + 4);
  const size_t red = static_cast<size_t>(l.nrg) * acc * 32 * l.cw;
  return 4 * (stage > red ? stage : red);
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
  const size_t bytes = smem_bytes(W, C, R, 1);
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

extern "C" int fvx_edge_tower_bwd(const void* x, const void* w, const void* bias,
                                  const void* dout, void* partial, long long n_blocks,
                                  void* dwb, long long B, long long H, long long W,
                                  long long C, long long R, void* stream) {
  int err = check_geometry(B, H, W, C, R);
  if (err) return err;
  const long long S = (H / 2 + R - 1) / R;
  if (n_blocks < 1 || n_blocks > B * S || n_blocks > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(W, C, R, kAcc);
  err = allow_smem(edge_bwd_kernel, bytes);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(groups(C)));
  edge_bwd_kernel<<<grid, layout(static_cast<int>(C)).threads, bytes, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(dout),
      static_cast<float*>(partial), static_cast<int>(H), static_cast<int>(W),
      static_cast<int>(C), static_cast<int>(R), static_cast<int>(S), B * S,
      static_cast<float>((H / 2) * (W / 2)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kAcc * static_cast<int>(C);
  edge_bwd_reduce_kernel<<<(n_out + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0,
                           st>>>(static_cast<const float*>(partial), static_cast<float*>(dwb),
                                 static_cast<int>(n_blocks), static_cast<int>(C));
  return static_cast<int>(cudaGetLastError());
}
