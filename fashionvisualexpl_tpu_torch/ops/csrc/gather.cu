// Row gather for Hopper (sm_90a): out[b] = table[ids[b]].
//
// Replaces the TPU kernel fashionvisualexpl_tpu/ops/gather.py::
// _make_gather_kernel (behind gather_rows, pl.pallas_call at :69), which
// issued one HBM->VMEM row DMA per id with a semaphore each.  The wrapper,
// its plain PyTorch version, the route plan (gather_plan) and the launch
// counts are in fashionvisualexpl_tpu_torch/ops/gather.py.  The packed
// LazyAdam step reads its rows through it (four launches a step: the
// forward user and item rows, then the deduped user and item rows).
//
// Ids outside [0, R) are mapped as the TPU kernel maps them: a negative id
// wraps once (id + R), then the result is clamped into [0, R - 1].  So an
// id of 2**30 (the dedupe's pad) reads row R - 1 and -1 reads row R - 1.
// Every copy is of unsigned integers: the packed rows hold bf16 and fp8
// moment codes bit-cast to float32 (NaN and denormal patterns among them),
// which no float instruction may touch.
//
// What bounds it: bytes.  Each output row reads one table row and writes
// one row (B * W * 4 bytes each way, plus the ids); there is no
// arithmetic.  At VBPR's packed item rows (16384 rows of 4484 floats) that
// is 588 MB, 0.175 ms at 3.35 TB/s.  A copy at that rate needs some 30 KB
// of reads in flight on each of the 132 SMs, all the way to the end.
//
// Design.  The grid is persistent: as many blocks as are resident at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each walking its
// share of the work, so there is no ragged second wave.  The caller picks
// one of five routes (gather.py::gather_plan: rows of 2 KB and more take a
// bulk route, where the bulk copies beat the lanes with the L2 flushed);
// the C entry checks that the geometry allows the route and returns
// cudaErrorInvalidValue if not.
//
// - lanes4 / lanes16 (narrow rows): warp w copies output rows w,
//   w + warps, ...; each lane issues U independent loads (U fixed at
//   compile time: 2, 4, 8 or 16, the fewest that take the row in one
//   trip) before its U stores, and at U <= 8 also the next row's loads
//   before this row's stores, so two rows are in flight; the id of the
//   row after is read before the row is copied.  16-byte words need
//   W % 4 == 0 and both base pointers 16-byte aligned; 4 bytes always do.
// - bulk_store and bulk_lanes (wide rows): each warp of a 4-warp block runs
//   its own ring of `stages` shared-memory stages (stage = piece + 32
//   bytes).  A row is cut into pieces of at most piece_bytes (a multiple
//   of 16); the warp's lanes issue the first `stages` pieces, then its lane
//   0 keeps them in flight by 1-D bulk asynchronous copies (cp.async.bulk
//   ... mbarrier::complete_tx::bytes, one mbarrier a stage): 8 pieces of
//   about 4 KB a warp on bulk_store, one block an SM (128 KB in flight).
//   - bulk_store needs W % 4 == 0 and both bases 16-byte aligned, so every
//     source and destination offset and every piece is a multiple of 16:
//     lane 0 stores each piece by cp.async.bulk.global.shared::cta, and
//     waits (cp.async.bulk.wait_group.read) for a stage's store to have
//     read it before it loads the stage again.
//   - bulk_lanes takes any width: the load brings the 16-byte-aligned span
//     that holds the piece, and the lanes store it: 4-byte words up to the
//     destination's first 16-byte boundary, 16-byte words after it (each
//     assembled from two aligned shared-memory words when source and
//     destination differ mod 16), 4-byte words for the tail.  A piece
//     whose span would reach outside the table (the first row of a table
//     whose base is not 16-byte aligned, the last row when R * W * 4 is
//     not a multiple of 16) is never loaded in bulk: the lanes copy it
//     from the table directly, so nothing past the table is read.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

enum Route { kLanes4 = 0, kLanes16 = 1, kBulkStore = 2, kBulkLanes = 3 };

constexpr int kLaneThreads = 256;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kBulkWarps = 4;
constexpr int kBulkThreads = kBulkWarps * 32;
constexpr int kMaxStages = 16;
constexpr int kStageSlack = 32;  // a piece's aligned span exceeds it by < 32 bytes
constexpr int kRingOffset = 8 * kBulkWarps * kMaxStages;  // mbarriers first
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block may take

__device__ __forceinline__ long long row_of(int id, long long num_rows) {
  long long r = id;
  if (r < 0) r += num_rows;
  return r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
}

// ---------------------------------------------------------------- lanes

// Warp w copies output rows w, w + warps, ... (the persistent grid's warps
// in order), each lane U loads before its U stores, the id of the warp's
// next row read before this row's words.  Where a row takes one trip
// (words <= 32 U) and U <= 8, the lanes also issue the next row's loads
// before this row's stores: two rows in flight (at U = 16 the second set
// of registers would cost a block an SM).
template <typename T, int U>
__global__ void __launch_bounds__(kLaneThreads)
gather_lanes_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                    T* __restrict__ out, long long num_rows, int words, long long batch) {
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * kLaneWarps;
  long long b = static_cast<long long>(blockIdx.x) * kLaneWarps + (threadIdx.x >> 5);
  if (b >= batch) return;
  int id = __ldg(ids + b);
  if (U > 8 || words > 32 * U) {
    for (; b < batch; b += nw) {
      const int next = b + nw < batch ? __ldg(ids + b + nw) : 0;
      const T* src = table + row_of(id, num_rows) * words;
      T* dst = out + b * words;
      for (int c0 = lane; c0 < words; c0 += 32 * U) {
        T v[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + 32 * u < words) v[u] = __ldg(src + c0 + 32 * u);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c0 + 32 * u < words) dst[c0 + 32 * u] = v[u];
      }
      id = next;
    }
    return;
  }
  if constexpr (U <= 8) {
    T v[U];
    const T* src = table + row_of(id, num_rows) * words;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (lane + 32 * u < words) v[u] = __ldg(src + lane + 32 * u);
    id = b + nw < batch ? __ldg(ids + b + nw) : 0;
    for (; b < batch; b += nw) {
      const long long nb = b + nw;
      T w[U];
      if (nb < batch) {
        src = table + row_of(id, num_rows) * words;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (lane + 32 * u < words) w[u] = __ldg(src + lane + 32 * u);
        id = nb + nw < batch ? __ldg(ids + nb + nw) : 0;
      }
      T* dst = out + b * words;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lane + 32 * u < words) dst[lane + 32 * u] = v[u];
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = w[u];
    }
  }
}

// ----------------------------------------------------------------- bulk

struct BulkArgs {
  const unsigned char* table;
  const unsigned char* table_end;  // table + R * W * 4
  const int* ids;
  unsigned char* out;
  long long num_rows, batch, row_bytes, piece_bytes;
  int pieces, stages, stage_bytes;
};

struct Piece {
  const unsigned char* src;
  unsigned char* dst;
  int n;        // bytes, a multiple of 4
  bool direct;  // its aligned span leaves the table: the lanes copy it
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ long long out_row(const BulkArgs& a, long long j) {
  return a.pieces == 1 ? j : j / a.pieces;
}

// Piece j (of output row out_row(j), whose id is `id`).
__device__ __forceinline__ Piece piece_at(const BulkArgs& a, long long j, int id) {
  const long long b = out_row(a, j);
  const long long off = (j - b * a.pieces) * a.piece_bytes;
  const long long left = a.row_bytes - off;
  Piece p;
  p.n = static_cast<int>(left < a.piece_bytes ? left : a.piece_bytes);
  p.src = a.table + row_of(id, a.num_rows) * a.row_bytes + off;
  p.dst = a.out + b * a.row_bytes + off;
  const std::uintptr_t s = reinterpret_cast<std::uintptr_t>(p.src);
  p.direct = (s & ~std::uintptr_t(15)) < reinterpret_cast<std::uintptr_t>(a.table) ||
             ((s + p.n + 15) & ~std::uintptr_t(15)) >
                 reinterpret_cast<std::uintptr_t>(a.table_end);
  return p;
}

// Bring piece p's aligned span into `stage`, completing on `bar` (a direct
// piece only arrives on it).
__device__ __forceinline__ void issue(const Piece& p, unsigned char* stage, uint32_t bar) {
  if (p.direct) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    return;
  }
  const std::uintptr_t lo = reinterpret_cast<std::uintptr_t>(p.src) & ~std::uintptr_t(15);
  const std::uintptr_t hi =
      (reinterpret_cast<std::uintptr_t>(p.src) + p.n + 15) & ~std::uintptr_t(15);
  const uint32_t bytes = static_cast<uint32_t>(hi - lo);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(stage)), "l"(lo), "r"(bytes), "r"(bar) : "memory");
}

// Wait for a stage's phase `parity` to complete.  A wait that outlasts
// ~10 s of clock (a copy that never lands) traps: the launch then fails
// with an error instead of holding the card.
__device__ __forceinline__ void wait_full(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 34)) asm volatile("trap;");
  }
}

// 16-byte destination words q = lane, lane + 32, ... < m from the stage's
// aligned words, the source kS words (4 bytes each) past an aligned word.
template <int kS>
__device__ __forceinline__ void store_quads(const uint4* sq, uint4* dq, int m, int lane) {
#pragma unroll 4
  for (int q = lane; q < m; q += 32) {
    const uint4 x = sq[q];
    if constexpr (kS == 0) {
      dq[q] = x;
    } else {
      const uint4 y = sq[q + 1];
      if constexpr (kS == 1) dq[q] = make_uint4(x.y, x.z, x.w, y.x);
      if constexpr (kS == 2) dq[q] = make_uint4(x.z, x.w, y.x, y.y);
      if constexpr (kS == 3) dq[q] = make_uint4(x.w, y.x, y.y, y.z);
    }
  }
}

// The warp stores piece p from its stage (the span from src & ~15 on).
__device__ __forceinline__ void store_piece(const Piece& p, const unsigned char* stage,
                                            int lane) {
  const int words = p.n >> 2;
  uint32_t* d32 = reinterpret_cast<uint32_t*>(p.dst);
  if (p.direct) {
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(p.src);
    for (int c = lane; c < words; c += 32) d32[c] = s32[c];
    return;
  }
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(stage);
  const int h = static_cast<int>(reinterpret_cast<std::uintptr_t>(p.src) & 15);
  int d = static_cast<int>((16 - (reinterpret_cast<std::uintptr_t>(p.dst) & 15)) & 15);
  if (d > p.n) d = p.n;
  if (lane < (d >> 2)) d32[lane] = s32[(h >> 2) + lane];
  const int m = (p.n - d) >> 4;
  const int e = h + d;  // the stage offset of the first 16-byte word's source
  const uint4* sq = reinterpret_cast<const uint4*>(stage + (e & ~15));
  uint4* dq = reinterpret_cast<uint4*>(p.dst + d);
  switch ((e & 15) >> 2) {
    case 0: store_quads<0>(sq, dq, m, lane); break;
    case 1: store_quads<1>(sq, dq, m, lane); break;
    case 2: store_quads<2>(sq, dq, m, lane); break;
    default: store_quads<3>(sq, dq, m, lane); break;
  }
  const int t = (p.n - d - 16 * m) >> 2, w0 = (d + 16 * m) >> 2;
  if (lane < t) d32[w0 + lane] = s32[((e + 16 * m) >> 2) + lane];
}

template <bool kStore>
__global__ void __launch_bounds__(kBulkThreads) gather_bulk_kernel(const BulkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long jobs = a.batch * a.pieces;
  const long long first = static_cast<long long>(blockIdx.x) * kBulkWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kBulkWarps;
  if (first >= jobs) return;  // the whole warp: no block-wide barrier follows
  const uint32_t bars = smem_u32(smem) + 8u * warp * kMaxStages;
  unsigned char* ring =
      smem + kRingOffset + static_cast<long long>(warp) * a.stages * a.stage_bytes;
  if (lane == 0) {
    for (int s = 0; s < a.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8u * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  {  // the first `stages` pieces, lane s issuing stage s's load
    const long long j = first + lane * step;
    if (lane < a.stages && j < jobs)
      issue(piece_at(a, j, a.ids[out_row(a, j)]), ring + lane * a.stage_bytes, bars + 8u * lane);
  }
  if constexpr (kStore) {
    if (lane != 0) return;  // lane 0 alone stores and loads from here on
  }
  int s = 0;
  uint32_t phase = 0;
  for (long long j = first; j < jobs; j += step) {
    // the piece to load once this one is out: into this stage (the lanes
    // store it), or into the previous one (a bulk store still reads this)
    const long long next = j + static_cast<long long>(kStore ? a.stages - 1 : a.stages) * step;
    const int id = a.ids[out_row(a, j)];  // both ids read before the wait
    const int next_id = next < jobs ? a.ids[out_row(a, next)] : 0;
    unsigned char* stage = ring + s * a.stage_bytes;
    wait_full(bars + 8u * s, phase);
    const Piece p = piece_at(a, j, id);
    if constexpr (kStore) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                   ::"l"(p.dst), "r"(smem_u32(stage)), "r"(p.n) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (j != first) {  // the previous stage, once its store has read it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int prev = s == 0 ? a.stages - 1 : s - 1;
        if (next < jobs)
          issue(piece_at(a, next, next_id), ring + prev * a.stage_bytes, bars + 8u * prev);
      }
    } else {
      store_piece(p, stage, lane);
      // the lanes' reads of the stage come before the next bulk load into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0 && next < jobs) issue(piece_at(a, next, next_id), stage, bars + 8u * s);
    }
    if (++s == a.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if constexpr (kStore) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ----------------------------------------------------------------- host

template <typename T>
const void* lanes_kernel(int u) {
  if (u == 2) return reinterpret_cast<const void*>(gather_lanes_kernel<T, 2>);
  if (u == 4) return reinterpret_cast<const void*>(gather_lanes_kernel<T, 4>);
  if (u == 8) return reinterpret_cast<const void*>(gather_lanes_kernel<T, 8>);
  if constexpr (sizeof(T) < 16)
    if (u == 16) return reinterpret_cast<const void*>(gather_lanes_kernel<T, 16>);
  return nullptr;
}

const void* kernel_of(int route, int param) {
  if (route == kLanes4) return lanes_kernel<unsigned int>(param);
  if (route == kLanes16) return lanes_kernel<uint4>(param);
  if (route == kBulkStore) return reinterpret_cast<const void*>(gather_bulk_kernel<true>);
  if (route == kBulkLanes) return reinterpret_cast<const void*>(gather_bulk_kernel<false>);
  return nullptr;
}

// Resident blocks an SM and SMs, cached by (device, kernel, shared
// memory); the bulk kernels' shared-memory limit is raised once a device.
struct Residency {
  int device;
  const void* kernel;
  int smem, per_sm, sms;
};
std::mutex cache_mutex;
Residency cache[64];
int cached = 0;
bool smem_raised[64][2];

cudaError_t residency(const void* kernel, int threads, int smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(cache_mutex);
  for (int i = 0; i < cached; ++i)
    if (cache[i].device == dev && cache[i].kernel == kernel && cache[i].smem == smem) {
      *per_sm = cache[i].per_sm;
      *sms = cache[i].sms;
      return cudaSuccess;
    }
  if (smem > 0 && dev < 64) {
    const int k = kernel == reinterpret_cast<const void*>(gather_bulk_kernel<true>) ? 0 : 1;
    if (!smem_raised[dev][k]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
      smem_raised[dev][k] = true;
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  cache[cached % 64] = Residency{dev, kernel, smem, *per_sm, *sms};
  if (cached < 64) ++cached;
  return cudaSuccess;
}

int bulk_smem(int stages, long long piece_bytes) {
  return kRingOffset + kBulkWarps * stages * static_cast<int>(piece_bytes + kStageSlack);
}

// The route's geometry is allowed: 0, else cudaErrorInvalidValue.
int check(const void* table, const void* out, long long width, int route, int param,
          long long piece_bytes) {
  const std::uintptr_t bases =
      reinterpret_cast<std::uintptr_t>(table) | reinterpret_cast<std::uintptr_t>(out);
  const bool ok =
      (bases & 3u) == 0 &&
      (route == kLanes4 ||
       (route == kLanes16 && width % 4 == 0 && (bases & 15u) == 0) || route == kBulkLanes ||
       (route == kBulkStore && width % 4 == 0 && (bases & 15u) == 0)) &&
      (route >= kBulkStore ? param >= 2 && param <= kMaxStages && piece_bytes >= 16 &&
                                 piece_bytes % 16 == 0 && piece_bytes <= kMaxSmem &&
                                 bulk_smem(param, piece_bytes) <= kMaxSmem
                           : kernel_of(route, param) != nullptr && width <= (1LL << 22));
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface for ctypes.  table: [num_rows, width] 4-byte words,
// contiguous; ids: [batch] int32; out: [batch, width] 4-byte words,
// contiguous.  num_rows >= 1.  route: 0 lanes, 1 bulk_store, 2
// bulk_lanes (gather.py::ROUTES); param: the lanes route's units a warp
// at a time (2, 4 or 8), the bulk routes' stages a
// warp (2 ... 16); piece_bytes: the bulk routes' largest piece (a multiple
// of 16).  Returns the cudaError_t of the launch (0 = launched), or
// cudaErrorInvalidValue when the geometry does not allow the route.
extern "C" int fvx_gather_rows(const void* table, const void* ids, void* out,
                               long long num_rows, long long width, long long batch,
                               int route, int param, long long piece_bytes, void* stream) {
  if (num_rows < 1 || width < 1 || width > (1LL << 28) || batch < 0 ||
      check(table, out, width, route, param, piece_bytes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const void* kernel = kernel_of(route, param);
  int per_sm = 0, sms = 0;
  const unsigned char* t = static_cast<const unsigned char*>(table);
  const unsigned char* t_end = t + num_rows * width * 4;
  if (route < kBulkStore) {
    cudaError_t e = residency(kernel, kLaneThreads, 0, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long resident = static_cast<long long>(per_sm) * sms;
    const int blocks = static_cast<int>(batch < resident ? batch : resident);
    int words = static_cast<int>(route == kLanes16 ? width / 4 : width);
    void* args[] = {&t, &id, &out, &num_rows, &words, &batch};
    e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kLaneThreads), args, 0, st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  const int smem = bulk_smem(param, piece_bytes);
  cudaError_t e = residency(kernel, kBulkThreads, smem, &per_sm, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  BulkArgs a;
  a.table = t;
  a.row_bytes = width * 4;
  a.table_end = t_end;
  a.ids = id;
  a.out = static_cast<unsigned char*>(out);
  a.num_rows = num_rows;
  a.batch = batch;
  a.piece_bytes = piece_bytes;
  a.pieces = static_cast<int>((a.row_bytes + piece_bytes - 1) / piece_bytes);
  a.stages = param;
  a.stage_bytes = static_cast<int>(piece_bytes + kStageSlack);
  const long long warps = (batch * a.pieces + kBulkWarps - 1) / kBulkWarps;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(warps < resident ? warps : resident);
  void* args[] = {&a};
  e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kBulkThreads), args, smem, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Resident blocks an SM and the SM count for a route's kernel (0, else a
// cudaError_t), for the reports; the same checks as fvx_gather_rows.
extern "C" int fvx_gather_residency(long long width, int route, int param,
                                    long long piece_bytes, int* info) {
  const void* aligned = reinterpret_cast<const void*>(16);  // any 16-byte-aligned base
  if (width < 1 || check(aligned, aligned, width, route, param, piece_bytes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bulk = route >= kBulkStore;
  return static_cast<int>(residency(kernel_of(route, param), bulk ? kBulkThreads : kLaneThreads,
                                    bulk ? bulk_smem(param, piece_bytes) : 0, &info[0],
                                    &info[1]));
}
