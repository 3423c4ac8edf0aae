// Row scatter-set for Hopper (sm_90a): table[ids[b]] = vals[b], in place.
//
// Replaces the TPU kernel fashionvisualexpl_tpu/ops/row_scatter.py::
// _make_scatter_kernel (behind scatter_rows_set), which issued one
// VMEM->HBM row DMA per id into the aliased table.  The wrapper, its plain
// PyTorch version and the launch count are in
// fashionvisualexpl_tpu_torch/ops/row_scatter.py.  The packed LazyAdam step
// writes its updated rows through it (two launches a step: users, items).
//
// Semantics of `.at[ids].set(vals, unique_indices=True, mode="drop")` with
// negative ids dropped too: an id is written only when (unsigned)id < R, so
// the dedupe's pads (2**30) and any id < 0 leave the table untouched.  The
// ids must be unique (the caller's contract, as on the TPU): two rows
// writing one id would race.  No atomics are needed, and none are used.
//
// What bounds it: bytes.  Each kept row reads one row of vals and writes
// one table row (B * W * 4 bytes each way, plus the ids).  At the packed
// step's shapes (up to 16384 item rows of 388 floats) that is ~51 MB, ~15
// us at 3.35 TB/s.
//
// Design: the mirror of gather.cu.  One warp per row, a grid-stride loop
// over rows, 16-, 8- or 4-byte unsigned words as the width and the base
// pointers allow; bits are copied, never float values (the packed rows
// carry bf16 and fp8 moment codes bit-cast to float32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132 * 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(T* __restrict__ table, const int* __restrict__ ids,
                    const T* __restrict__ vals, unsigned int num_rows, int words,
                    long long batch) {
  const int lane = threadIdx.x & 31;
  const long long first = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long b = first; b < batch; b += stride) {
    const unsigned int r = static_cast<unsigned int>(ids[b]);
    if (r >= num_rows) continue;  // pads and negative ids drop
    const T* src = vals + b * words;
    T* dst = table + static_cast<long long>(r) * words;
    for (int c = lane; c < words; c += 32) dst[c] = src[c];
  }
}

int blocks_for(long long rows) {
  const long long want = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename T>
int launch(void* table, const int* ids, const void* vals, unsigned int num_rows,
           long long width, long long batch, cudaStream_t st) {
  const int words = static_cast<int>(width * 4 / sizeof(T));
  scatter_rows_kernel<T><<<blocks_for(batch), kThreads, 0, st>>>(
      static_cast<T*>(table), ids, static_cast<const T*>(vals), num_rows, words,
      batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  table: [num_rows, width] 4-byte words,
// contiguous, written in place; ids: [batch] int32, unique among those in
// range; vals: [batch, width] 4-byte words, contiguous.  0 <= num_rows <
// 2**31.  Returns the cudaError_t of the launch (0 = launched).
extern "C" int fvx_scatter_rows_set(void* table, const void* ids,
                                    const void* vals, long long num_rows,
                                    long long width, long long batch,
                                    void* stream) {
  if (num_rows < 0 || num_rows > 0x7FFFFFFFLL || width < 1 ||
      width > (1LL << 28) || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || num_rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const unsigned int rows = static_cast<unsigned int>(num_rows);
  const std::uintptr_t bases = reinterpret_cast<std::uintptr_t>(table) |
                               reinterpret_cast<std::uintptr_t>(vals);
  if (width % 4 == 0 && (bases & 15u) == 0)
    return launch<uint4>(table, id, vals, rows, width, batch, st);
  if (width % 2 == 0 && (bases & 7u) == 0)
    return launch<uint2>(table, id, vals, rows, width, batch, st);
  return launch<unsigned int>(table, id, vals, rows, width, batch, st);
}
