// Native data-path runtime for fashionvisualexpl_tpu.
//
// The reference loads interaction TSVs with a per-line Python loop
// (reference src/dataset/dataset.py:52-81) — fine at 10^5 rows, minutes at
// the scaled config's 10^7-10^8 rows.  This library provides the host-side
// data plane in C++: mmap'd multithreaded TSV parsing and the padded
// sorted-positives construction the on-device sampler consumes.
//
// C ABI only (consumed via ctypes; no pybind11 in this image).  All output
// buffers are caller-allocated numpy arrays; two-phase (count, then fill).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
};

MappedFile map_file(const char* path) {
  MappedFile m;
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    close(m.fd);
    m.fd = -1;
    return m;
  }
  m.data = static_cast<const char*>(p);
  m.size = st.st_size;
  return m;
}

void unmap_file(MappedFile& m) {
  if (m.data) munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) close(m.fd);
  m.data = nullptr;
  m.fd = -1;
}

// Parse a (possibly signed) decimal integer starting at p; advances p.
inline int64_t parse_int(const char*& p, const char* end) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  return neg ? -v : v;
}

inline void skip_to(const char*& p, const char* end, char c) {
  while (p < end && *p != c && *p != '\n') ++p;
  if (p < end && *p == c) ++p;
}

// Chunk boundaries aligned to newlines.
std::vector<std::pair<size_t, size_t>> chunks_of(const MappedFile& m,
                                                 int n_threads) {
  std::vector<std::pair<size_t, size_t>> out;
  size_t per = m.size / n_threads;
  size_t start = 0;
  for (int t = 0; t < n_threads; ++t) {
    size_t end = (t == n_threads - 1) ? m.size : (t + 1) * per;
    while (end < m.size && m.data[end] != '\n') ++end;
    if (end < m.size) ++end;  // include the newline
    if (end > start) out.emplace_back(start, end);
    start = end;
  }
  return out;
}

inline bool is_data_line(const char* p, const char* line_end) {
  // skip CR / leading spaces; a data row starts with a digit or '-'
  while (p < line_end && (*p == '\r' || *p == ' ' || *p == '\t')) ++p;
  return p < line_end && ((*p >= '0' && *p <= '9') || *p == '-');
}

size_t count_lines_range(const char* data, size_t start, size_t end) {
  size_t n = 0;
  const char* p = data + start;
  const char* e = data + end;
  while (p < e) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', e - p));
    const char* line_end = nl ? nl : e;
    if (is_data_line(p, line_end)) ++n;
    if (!nl) break;
    p = nl + 1;
  }
  return n;
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

}  // namespace

extern "C" {

// Number of non-empty lines in the file (row capacity for the parse call).
long fvx_count_tsv_rows(const char* path) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int nt = hw_threads();
  auto ch = chunks_of(m, nt);
  std::vector<size_t> counts(ch.size(), 0);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < ch.size(); ++i) {
    threads.emplace_back([&, i] {
      counts[i] = count_lines_range(m.data, ch[i].first, ch[i].second);
    });
  }
  for (auto& t : threads) t.join();
  size_t total = 0;
  for (size_t c : counts) total += c;
  unmap_file(m);
  return static_cast<long>(total);
}

// Parse `user \t item [\t time [...]]` rows into caller buffers (capacity
// rows each; times may be null).  Preserves file order.  Returns rows
// parsed, or -1 on error.
long fvx_parse_interactions(const char* path, int32_t* users, int32_t* items,
                            int64_t* times, long capacity) {
  MappedFile m = map_file(path);
  if (!m.ok()) return -1;
  int nt = hw_threads();
  auto ch = chunks_of(m, nt);

  // per-chunk row counts -> output offsets (order preserving)
  std::vector<size_t> counts(ch.size(), 0);
  {
    std::vector<std::thread> threads;
    for (size_t i = 0; i < ch.size(); ++i) {
      threads.emplace_back([&, i] {
        counts[i] = count_lines_range(m.data, ch[i].first, ch[i].second);
      });
    }
    for (auto& t : threads) t.join();
  }
  std::vector<size_t> offsets(ch.size() + 1, 0);
  for (size_t i = 0; i < ch.size(); ++i) offsets[i + 1] = offsets[i] + counts[i];
  if (static_cast<long>(offsets.back()) > capacity) {
    unmap_file(m);
    return -1;
  }

  std::atomic<bool> bad{false};
  std::vector<std::thread> threads;
  for (size_t i = 0; i < ch.size(); ++i) {
    threads.emplace_back([&, i] {
      const char* p = m.data + ch[i].first;
      const char* e = m.data + ch[i].second;
      size_t row = offsets[i];
      while (p < e) {
        const char* line_end =
            static_cast<const char*>(memchr(p, '\n', e - p));
        if (!line_end) line_end = e;
        // non-data lines (headers, blanks, CR-only) are skipped — matching
        // the counting pass and the Python fallback's strip()/int() behavior
        if (!is_data_line(p, line_end)) {
          p = line_end + 1;
          continue;
        }
        const char* q = p;
        while (q < line_end && (*q == '\r' || *q == ' ' || *q == '\t')) ++q;
        int64_t u = parse_int(q, line_end);
        skip_to(q, line_end, '\t');
        int64_t it = parse_int(q, line_end);
        int64_t tm = 0;
        skip_to(q, line_end, '\t');
        if (q < line_end) tm = parse_int(q, line_end);
        if (row >= offsets[i] + counts[i]) {
          bad = true;
          return;
        }
        users[row] = static_cast<int32_t>(u);
        items[row] = static_cast<int32_t>(it);
        if (times) times[row] = tm;
        ++row;
        p = line_end + 1;
      }
    });
  }
  for (auto& t : threads) t.join();
  long total = static_cast<long>(offsets.back());
  unmap_file(m);
  return bad ? -1 : total;
}

// Max unique-positive count over users (the padded width the sampler needs).
int32_t fvx_max_pos_count(const int32_t* users, const int32_t* items, long n,
                          int32_t num_users) {
  // counts of unique (user, item) pairs: sort per user via buckets
  std::vector<std::vector<int32_t>> per_user(num_users);
  for (long i = 0; i < n; ++i) {
    if (users[i] >= 0 && users[i] < num_users) per_user[users[i]].push_back(items[i]);
  }
  int32_t mx = 0;
  for (auto& v : per_user) {
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
    mx = std::max<int32_t>(mx, static_cast<int32_t>(v.size()));
  }
  return mx;
}

// Build the padded strictly-increasing positives matrix + counts
// (semantics of data/interactions.py::pad_sorted_positives): row u holds
// u's unique sorted positives, padded with num_items + slot so the row is
// strictly increasing.  padded is [num_users * width], counts [num_users].
// Returns 0 on success, -1 if any user has more than `width` unique
// positives (the Python implementation raises; silent truncation would let
// the sampler emit actual positives as "negatives").
int32_t fvx_pad_positives(const int32_t* users, const int32_t* items, long n,
                          int32_t num_users, int32_t num_items, int32_t width,
                          int32_t* padded, int32_t* counts) {
  std::vector<std::vector<int32_t>> per_user(num_users);
  for (long i = 0; i < n; ++i) {
    if (users[i] >= 0 && users[i] < num_users) per_user[users[i]].push_back(items[i]);
  }
  int nt = hw_threads();
  std::vector<std::thread> threads;
  std::atomic<bool> overflow{false};
  int32_t per = (num_users + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      int32_t lo = t * per;
      int32_t hi = std::min(num_users, lo + per);
      for (int32_t u = lo; u < hi; ++u) {
        auto& v = per_user[u];
        std::sort(v.begin(), v.end());
        v.erase(std::unique(v.begin(), v.end()), v.end());
        if (static_cast<int32_t>(v.size()) > width) overflow = true;
        int32_t c = std::min<int32_t>(static_cast<int32_t>(v.size()), width);
        counts[u] = c;
        int32_t* row = padded + static_cast<size_t>(u) * width;
        for (int32_t j = 0; j < c; ++j) row[j] = v[j];
        for (int32_t j = c; j < width; ++j) row[j] = num_items + j;
      }
    });
  }
  for (auto& t : threads) t.join();
  return overflow ? -1 : 0;
}

// Write a recommendation dump TSV: k rows `user \t item \t score` per user
// (the Evaluator.store_recommendation format).  Rows are formatted in
// parallel into per-chunk buffers, then written sequentially — the Python
// f-string loop costs tens of seconds at 10^7 rows.  Scores print with %.9g
// (float32 round-trip).  Returns bytes written, or -1 on error.
long fvx_write_recs_tsv(const char* path, const int32_t* users,
                        const int32_t* ids, const float* vals, long n_users,
                        long k) {
  int nt = hw_threads();
  long per = (n_users + nt - 1) / nt;
  std::vector<std::string> bufs(nt);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      long lo = t * per;
      long hi = std::min(n_users, lo + per);
      if (lo >= hi) return;
      std::string& out = bufs[t];
      out.reserve(static_cast<size_t>(hi - lo) * k * 28);
      char line[96];
      for (long r = lo; r < hi; ++r) {
        for (long j = 0; j < k; ++j) {
          int len = snprintf(line, sizeof(line), "%d\t%d\t%.9g\n",
                             users[r], ids[r * k + j],
                             static_cast<double>(vals[r * k + j]));
          out.append(line, len);
        }
      }
    });
  }
  for (auto& t : threads) t.join();
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  long total = 0;
  for (auto& b : bufs) {
    if (!b.empty() && fwrite(b.data(), 1, b.size(), f) != b.size()) {
      fclose(f);
      return -1;
    }
    total += static_cast<long>(b.size());
  }
  fclose(f);
  return total;
}

// Parallel row gather: dst[i, :] = src[ids[i], :] for fixed-size rows —
// the host side of the streamed >HBM trainer's per-batch feature gather
// (train/streamed.py::ArrayFeatureStore).  numpy's fancy indexing runs a
// single-thread memcpy loop (~1.1 GB/s measured on this host); threading
// the copy scales it by the core count, and against an np.memmap source
// the per-thread page faults parallelize the DISK reads too.  Out-of-range
// ids are a caller bug; they are clamped rather than read wild.
void fvx_gather_rows(const char* src, long n_rows, long row_bytes,
                     const int32_t* ids, long n_ids, char* dst) {
  int nt = hw_threads();
  long per = (n_ids + nt - 1) / nt;
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      long lo = t * per;
      long hi = std::min(n_ids, lo + per);
      for (long i = lo; i < hi; ++i) {
        long r = ids[i];
        if (r < 0) r = 0;
        if (r >= n_rows) r = n_rows - 1;
        memcpy(dst + i * row_bytes, src + r * row_bytes, row_bytes);
      }
    });
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
