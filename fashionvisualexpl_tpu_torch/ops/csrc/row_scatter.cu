// Row scatter-set for Hopper (sm_90a): table[ids[b]] = vals[b], in place.
//
// Replaces the TPU kernel fashionvisualexpl_tpu/ops/row_scatter.py::
// _make_scatter_kernel (behind scatter_rows_set, pl.pallas_call at :106),
// which issued one VMEM->HBM row DMA per id into the aliased table.  The
// wrapper, its plain PyTorch version, the route plan (scatter_plan) and the
// launch counts are in fashionvisualexpl_tpu_torch/ops/row_scatter.py.  The
// packed LazyAdam step writes its updated rows through it (two launches a
// step: users, items).
//
// Semantics of `.at[ids].set(vals, unique_indices=True, mode="drop")` with
// negative ids dropped too: an id is written only when (unsigned)id < R, so
// the dedupe's pads (2**30) and any id < 0 leave the table untouched, and a
// dropped slot reads its id and nothing else (no vals row, no write).  The
// ids must be unique (the caller's contract, as on the TPU): two rows
// writing one id would race.  No atomics are needed, and none are used.
// Every copy is of unsigned integers: the packed rows hold bf16 and fp8
// moment codes bit-cast to float32, which no float instruction may touch.
//
// What bounds it: bytes.  Each kept row reads one row of vals and writes
// one table row (B * W * 4 bytes each way, plus the ids); there is no
// arithmetic.  At BPRMF's fp8-moment user rows (16384 rows of 193 floats)
// that is 25 MB, 7.6 us at 3.35 TB/s; at VBPR's fused item rows (24576 of
// 4484 floats) 882 MB, 0.26 ms.  A copy at that rate needs some 30 KB of
// loads in flight on each of the 132 SMs, all the way to the end.
//
// Design: K4's (gather.cu) turned round.  The reads of vals are one
// contiguous block whose addresses do not depend on the ids; the writes go
// to random rows.  The grid is persistent: as many blocks as are resident
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each
// walking its share of the work.  The caller picks one of four routes
// (row_scatter.py::scatter_plan: rows wider than one trip of 8 loads a
// lane take a bulk route); the C entry checks that the geometry allows the
// route and returns cudaErrorInvalidValue if not.
//
// - lanes4 / lanes16 (narrow rows: the plan takes them where 8 loads a
//   lane hold the row, 1 KB of 4-byte words or 4 KB of 16-byte ones):
//   warp w writes rows w, w + warps, ...; each lane issues U independent
//   loads of vals[b] (U fixed at compile time: 2, 4 or 8, the fewest that
//   take the row in one trip) before its U stores, and also the next row's
//   loads before this row's stores, so two rows are in flight; the id of
//   the row after is read before this row is stored.  A lanes route forced
//   on wider rows takes 16 loads a lane, or several trips, one row at a
//   time.  16-byte words need W % 4 == 0 and both base pointers 16-byte
//   aligned; 4 bytes always do.
// - bulk_store and bulk_lanes (wide rows): each warp of a 4-warp block runs
//   its own ring of `stages` shared-memory stages (stage = piece + 32
//   bytes).  A row is cut into pieces of at most piece_bytes (a multiple
//   of 16); lane 0 keeps `stages` pieces in flight by 1-D bulk
//   asynchronous copies from vals (cp.async.bulk ...
//   mbarrier::complete_tx::bytes, one mbarrier a stage).
//   The warp reads the ids of its next 32 pieces at once (a lane each) and
//   walks only those of kept rows, so the dedupe's pads, which can be most
//   of a batch (ACF's B x P extra item rows), cost an id read and no stage.
//   - bulk_store needs W % 4 == 0 and both bases 16-byte aligned, so every
//     source and destination offset and every piece is a multiple of 16:
//     lane 0 stores each piece to table[id] by cp.async.bulk.global.
//     shared::cta, commits one bulk group a piece, and waits
//     (cp.async.bulk.wait_group.read) for a stage's store to have read it
//     before it loads the stage again.  All stores are waited for before
//     the warp exits.
//   - bulk_lanes takes any width: the load brings the 16-byte-aligned span
//     of vals that holds the piece, and the lanes store it to table[id]:
//     4-byte words up to the destination's first 16-byte boundary, 16-byte
//     words after it (each assembled from two aligned shared-memory words
//     when source and destination differ mod 16), 4-byte words for the
//     tail.  The destination's alignment changes from row to row ((id * W
//     * 4) mod 16), so head, body and tail are worked out for each piece.
//     A piece whose span would reach outside vals (the first row of a vals
//     whose base is not 16-byte aligned, the last row when B * W * 4 is not
//     a multiple of 16) is never loaded in bulk: the lanes copy it from
//     vals directly, so nothing past vals is read.

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

// ---------------------------------------------------------------- lanes

// Warp w writes rows w, w + warps, ... (the persistent grid's warps in
// order), each lane U loads of vals before its U stores, the id of the
// warp's next row read before this row's words.  Where a row takes one
// trip (words <= 32 U) and U <= 8, the lanes also issue the next row's
// loads before this row's stores: two rows in flight (at U = 16 the second
// set of registers would cost a block an SM).
template <typename T, int U>
__global__ void __launch_bounds__(kLaneThreads)
scatter_lanes_kernel(T* __restrict__ table, const int* __restrict__ ids,
                     const T* __restrict__ vals, unsigned int num_rows, int words,
                     long long batch) {
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * kLaneWarps;
  long long b = static_cast<long long>(blockIdx.x) * kLaneWarps + (threadIdx.x >> 5);
  if (b >= batch) return;
  unsigned int r = static_cast<unsigned int>(__ldg(ids + b));
  if (U > 8 || words > 32 * U) {
    for (; b < batch; b += nw) {
      const unsigned int next =
          b + nw < batch ? static_cast<unsigned int>(__ldg(ids + b + nw)) : num_rows;
      if (r < num_rows) {
        const T* src = vals + b * words;
        T* dst = table + static_cast<long long>(r) * words;
        for (int c0 = lane; c0 < words; c0 += 32 * U) {
          T v[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (c0 + 32 * u < words) v[u] = __ldg(src + c0 + 32 * u);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (c0 + 32 * u < words) dst[c0 + 32 * u] = v[u];
        }
      }
      r = next;
    }
    return;
  }
  if constexpr (U <= 8) {
    T v[U];
    if (r < num_rows) {
      const T* src = vals + b * words;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (lane + 32 * u < words) v[u] = __ldg(src + lane + 32 * u);
    }
    unsigned int rn =
        b + nw < batch ? static_cast<unsigned int>(__ldg(ids + b + nw)) : num_rows;
    for (; b < batch; b += nw) {
      const long long nb = b + nw;
      T w[U];
      unsigned int after = num_rows;
      if (nb < batch) {
        if (rn < num_rows) {
          const T* src = vals + nb * words;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (lane + 32 * u < words) w[u] = __ldg(src + lane + 32 * u);
        }
        after = nb + nw < batch ? static_cast<unsigned int>(__ldg(ids + nb + nw)) : num_rows;
      }
      if (r < num_rows) {
        T* dst = table + static_cast<long long>(r) * words;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (lane + 32 * u < words) dst[lane + 32 * u] = v[u];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = w[u];
      r = rn;
      rn = after;
    }
  }
}

// ----------------------------------------------------------------- bulk

struct BulkArgs {
  unsigned char* table;
  const unsigned char* vals;
  const unsigned char* vals_end;  // vals + B * W * 4
  const int* ids;
  unsigned int num_rows;
  long long batch, row_bytes, piece_bytes;
  int pieces, stages, stage_bytes;
};

struct Piece {
  const unsigned char* src;  // in vals
  unsigned char* dst;        // in the table
  int n;                     // bytes, a multiple of 4
  bool direct;               // its aligned span leaves vals: the lanes copy it
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ long long row_of_piece(const BulkArgs& a, long long j) {
  return a.pieces == 1 ? j : j / a.pieces;
}

// Piece j (of vals row row_of_piece(j), whose id, in range, is `id`).
__device__ __forceinline__ Piece piece_at(const BulkArgs& a, long long j, int id) {
  const long long b = row_of_piece(a, j);
  const long long off = (j - b * a.pieces) * a.piece_bytes;
  const long long left = a.row_bytes - off;
  Piece p;
  p.n = static_cast<int>(left < a.piece_bytes ? left : a.piece_bytes);
  p.src = a.vals + b * a.row_bytes + off;
  p.dst = a.table + static_cast<long long>(static_cast<unsigned int>(id)) * a.row_bytes + off;
  const std::uintptr_t s = reinterpret_cast<std::uintptr_t>(p.src);
  p.direct = (s & ~std::uintptr_t(15)) < reinterpret_cast<std::uintptr_t>(a.vals) ||
             ((s + p.n + 15) & ~std::uintptr_t(15)) >
                 reinterpret_cast<std::uintptr_t>(a.vals_end);
  return p;
}

// Bring piece p's aligned span into `stage`, completing on `bar` (a
// direct piece only arrives on it).
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

// The warp stores piece p from its stage (the span from src & ~15 on), or
// from vals when it is direct.
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

// A warp's pieces are j = first + k step, k = 0, 1, ...; a cursor walks
// those of kept rows in order, 32 of them (a window) at a time: lane l
// reads the id of the window's piece l, a ballot marks the kept ones.  So a
// dropped row costs a lane one id read, and no stage, barrier or copy.
struct Cursor {
  long long base = -32;  // the window's first k
  unsigned int mask = 0;  // its kept pieces not yet taken
  int id = 0;             // this lane's piece's id
};

// The cursor's next kept piece (j, id) and true, or false when none is
// left.  The whole warp calls it, with the same cursor state in each lane.
__device__ __forceinline__ bool next_kept(Cursor& c, const BulkArgs& a, long long first,
                                          long long step, int lane, long long* j, int* id) {
  const long long jobs = a.batch * a.pieces;
  while (c.mask == 0) {
    c.base += 32;
    if (first + c.base * step >= jobs) return false;
    const long long mine = first + (c.base + lane) * step;
    c.id = mine < jobs ? __ldg(a.ids + row_of_piece(a, mine)) : -1;
    c.mask = __ballot_sync(0xffffffffu,
                           mine < jobs && static_cast<unsigned int>(c.id) < a.num_rows);
  }
  const int bit = __ffs(c.mask) - 1;
  c.mask &= c.mask - 1;
  *j = first + (c.base + bit) * step;
  *id = __shfl_sync(0xffffffffu, c.id, bit);
  return true;
}

template <bool kStore>
__global__ void __launch_bounds__(kBulkThreads) scatter_bulk_kernel(const BulkArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(blockIdx.x) * kBulkWarps + warp;
  const long long step = static_cast<long long>(gridDim.x) * kBulkWarps;
  if (first >= a.batch * a.pieces) return;  // the whole warp: no block-wide barrier follows
  const uint32_t bars = smem_u32(smem) + 8u * warp * kMaxStages;
  unsigned char* ring =
      smem + kRingOffset + static_cast<long long>(warp) * a.stages * a.stage_bytes;
  if (lane == 0) {
    for (int s = 0; s < a.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8u * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  // `ahead` walks the kept pieces as their loads are issued: the n-th takes
  // stage n % stages, and lane s keeps the piece (j, id) its stage holds
  Cursor ahead;
  long long j, slot_j = 0;
  int id, slot_id = 0;
  long long issued = 0;
  bool left = true;  // `ahead` may hold more
  for (int s = 0; s < a.stages && left; ++s) {  // the first `stages` loads
    left = next_kept(ahead, a, first, step, lane, &j, &id);
    if (left) {
      if (lane == s) {
        slot_j = j;
        slot_id = id;
      }
      if (lane == 0) issue(piece_at(a, j, id), ring + s * a.stage_bytes, bars + 8u * s);
      ++issued;
    }
  }
  int s = 0;
  uint32_t phase = 0;
  for (long long n = 0; n < issued; ++n) {
    unsigned char* stage = ring + s * a.stage_bytes;
    const Piece p = piece_at(a, __shfl_sync(0xffffffffu, slot_j, s),
                             __shfl_sync(0xffffffffu, slot_id, s));
    wait_full(bars + 8u * s, phase);
    // the stage the next load goes into: this one once the lanes have
    // stored it, or the previous one once its bulk store has read it
    const int t = !kStore ? s : s == 0 ? a.stages - 1 : s - 1;
    if constexpr (kStore) {
      if (lane == 0) {
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                     ::"l"(p.dst), "r"(smem_u32(stage)), "r"(p.n) : "memory");
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    } else {
      store_piece(p, stage, lane);
      // the lanes' reads of the stage come before the next bulk load into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
    }
    if ((!kStore || n > 0) && left) {
      left = next_kept(ahead, a, first, step, lane, &j, &id);
      if (left) {
        if (lane == t) {
          slot_j = j;
          slot_id = id;
        }
        if (lane == 0) {
          if constexpr (kStore) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
          issue(piece_at(a, j, id), ring + t * a.stage_bytes, bars + 8u * t);
        }
        ++issued;
      }
    }
    if (++s == a.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
  if constexpr (kStore) {
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ----------------------------------------------------------------- host

template <typename T>
const void* lanes_kernel(int u) {
  if (u == 2) return reinterpret_cast<const void*>(scatter_lanes_kernel<T, 2>);
  if (u == 4) return reinterpret_cast<const void*>(scatter_lanes_kernel<T, 4>);
  if (u == 8) return reinterpret_cast<const void*>(scatter_lanes_kernel<T, 8>);
  if constexpr (sizeof(T) < 16)
    if (u == 16) return reinterpret_cast<const void*>(scatter_lanes_kernel<T, 16>);
  return nullptr;
}

const void* kernel_of(int route, int param) {
  if (route == kLanes4) return lanes_kernel<unsigned int>(param);
  if (route == kLanes16) return lanes_kernel<uint4>(param);
  if (route == kBulkStore) return reinterpret_cast<const void*>(scatter_bulk_kernel<true>);
  if (route == kBulkLanes) return reinterpret_cast<const void*>(scatter_bulk_kernel<false>);
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
    const int k = kernel == reinterpret_cast<const void*>(scatter_bulk_kernel<true>) ? 0 : 1;
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
int check(const void* table, const void* vals, long long width, int route, int param,
          long long piece_bytes) {
  const std::uintptr_t bases =
      reinterpret_cast<std::uintptr_t>(table) | reinterpret_cast<std::uintptr_t>(vals);
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
// contiguous, written in place; ids: [batch] int32, unique among those in
// range; vals: [batch, width] 4-byte words, contiguous.  0 <= num_rows <
// 2**31.  route: 0 lanes4, 1 lanes16, 2 bulk_store, 3 bulk_lanes
// (row_scatter.py::ROUTES); param: the lanes routes' loads a lane for a
// row (2, 4, 8 or 16; 16 on lanes4 only), the bulk routes' stages a warp
// (2 ... 16); piece_bytes: the bulk routes' largest piece (a multiple of
// 16).  Returns the cudaError_t of the launch (0 = launched), or
// cudaErrorInvalidValue when the geometry does not allow the route.
extern "C" int fvx_scatter_rows_set(void* table, const void* ids, const void* vals,
                                    long long num_rows, long long width, long long batch,
                                    int route, int param, long long piece_bytes,
                                    void* stream) {
  if (num_rows < 0 || num_rows > 0x7FFFFFFFLL || width < 1 || width > (1LL << 28) ||
      batch < 0 || check(table, vals, width, route, param, piece_bytes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || num_rows == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const void* kernel = kernel_of(route, param);
  unsigned int rows = static_cast<unsigned int>(num_rows);
  int per_sm = 0, sms = 0;
  if (route < kBulkStore) {
    cudaError_t e = residency(kernel, kLaneThreads, 0, &per_sm, &sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long warps = (batch + kLaneWarps - 1) / kLaneWarps;
    const long long resident = static_cast<long long>(per_sm) * sms;
    const int blocks = static_cast<int>(warps < resident ? warps : resident);
    int words = static_cast<int>(route == kLanes16 ? width / 4 : width);
    void* args[] = {&table, &id, &vals, &rows, &words, &batch};
    e = cudaLaunchKernel(kernel, dim3(blocks), dim3(kLaneThreads), args, 0, st);
    return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
  }
  const int smem = bulk_smem(param, piece_bytes);
  cudaError_t e = residency(kernel, kBulkThreads, smem, &per_sm, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  BulkArgs a;
  a.table = static_cast<unsigned char*>(table);
  a.vals = static_cast<const unsigned char*>(vals);
  a.row_bytes = width * 4;
  a.vals_end = a.vals + batch * a.row_bytes;
  a.ids = id;
  a.num_rows = rows;
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
// cudaError_t), for the reports; the same checks as fvx_scatter_rows_set.
extern "C" int fvx_scatter_residency(long long width, int route, int param,
                                     long long piece_bytes, int* info) {
  const void* aligned = reinterpret_cast<const void*>(16);  // any 16-byte-aligned base
  if (width < 1 || check(aligned, aligned, width, route, param, piece_bytes) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool bulk = route >= kBulkStore;
  return static_cast<int>(residency(kernel_of(route, param), bulk ? kBulkThreads : kLaneThreads,
                                    bulk ? bulk_smem(param, piece_bytes) : 0, &info[0],
                                    &info[1]));
}
