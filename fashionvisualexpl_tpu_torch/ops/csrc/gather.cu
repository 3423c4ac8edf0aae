// Row gather for Hopper (sm_90a): out[b] = table[ids[b]].
//
// Replaces the TPU kernel fashionvisualexpl_tpu/ops/gather.py::
// _make_gather_kernel (behind gather_rows), which issued one HBM->VMEM row
// DMA per id with a semaphore each.  The wrapper, its plain PyTorch version
// and the launch count are in fashionvisualexpl_tpu_torch/ops/gather.py.
// The packed LazyAdam step reads its rows through it (four launches a
// step: the forward user and item rows, then the deduped user and item
// rows).
//
// Ids outside [0, R) are mapped as the TPU kernel maps them: a negative id
// wraps once (id + R), then the result is clamped into [0, R - 1].  So an
// id of 2**30 (the dedupe's pad) reads row R - 1 and -1 reads row R - 1.
//
// What bounds it: bytes.  Each output row reads one table row and writes
// one row (B * W * 4 bytes each way, plus the ids); there is no arithmetic.
// At the packed step's shapes (B = 16384 item rows of 388 floats) that is
// ~51 MB, ~15 us at 3.35 TB/s.
//
// Design: one warp per output row, a grid-stride loop over rows, the row
// copied as 16-byte words when the width and both base pointers allow it,
// else 8-byte, else 4-byte words.  Every copy is of unsigned integers: the
// packed rows hold bf16 and fp8 moment codes bit-cast to float32 (NaN and
// denormal patterns among them), which no float instruction may touch.
// Neighbouring lanes copy neighbouring words, so each warp's loads and
// stores are coalesced within a row; rows land in no particular order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                   T* __restrict__ out, long long num_rows, int words,
                   long long batch) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long b = first; b < batch; b += stride) {
    long long r = ids[b];
    if (r < 0) r += num_rows;
    r = r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
    const T* src = table + r * words;
    T* dst = out + b * words;
    for (int c = lane; c < words; c += 32) dst[c] = src[c];
  }
}

int blocks_for(long long rows) {
  const long long want = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename T>
int launch(const void* table, const int* ids, void* out, long long num_rows,
           long long width, long long batch, cudaStream_t st) {
  const int words = static_cast<int>(width * 4 / sizeof(T));
  gather_rows_kernel<T><<<blocks_for(batch), kThreads, 0, st>>>(
      static_cast<const T*>(table), ids, static_cast<T*>(out), num_rows, words,
      batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  table: [num_rows, width] 4-byte words,
// contiguous; ids: [batch] int32; out: [batch, width] 4-byte words,
// contiguous.  num_rows >= 1.  Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int fvx_gather_rows(const void* table, const void* ids, void* out,
                               long long num_rows, long long width,
                               long long batch, void* stream) {
  if (num_rows < 1 || width < 1 || width > (1LL << 28) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const std::uintptr_t bases = reinterpret_cast<std::uintptr_t>(table) |
                               reinterpret_cast<std::uintptr_t>(out);
  if (width % 4 == 0 && (bases & 15u) == 0)
    return launch<uint4>(table, id, out, num_rows, width, batch, st);
  if (width % 2 == 0 && (bases & 7u) == 0)
    return launch<uint2>(table, id, out, num_rows, width, batch, st);
  return launch<unsigned int>(table, id, out, num_rows, width, batch, st);
}
