// deeprec_tpu native host runtime: sharded host KV row store + batched
// Criteo parser.
//
// Counterparts of the reference's host-side C++ (built from
// scratch, same roles):
//   * HostKV  — the DRAM/PMEM storage tier behind EmbeddingVariable
//     multi-tier storage (reference: tensorflow/core/framework/embedding/
//     kv_interface.h:27 KVInterface, dense_hash_map.h mutex-sharded map,
//     embedding/config.proto StorageType{DRAM,PMEM,SSD}). Holds evicted /
//     long-tail rows in host memory; batched lookup/upsert/erase/export.
//   * criteo_parse — the input-pipeline hot path (reference: tf.data CSV
//     kernels + modelzoo train.py pipelines): parses label + 13 ints +
//     26 hex-categorical TSV rows into dense numpy-ready buffers, hashing
//     tokens to stable 64-bit ids.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
// Build: g++ -O3 -march=native -shared -fPIC -o libdeeprec_native.so
//        deeprec_native.cc -lpthread
#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// 64-bit mix hash (splitmix64 finalizer) — stable across runs/platforms.
static inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// FNV-1a over bytes -> int64 id; -1 (the EMPTY sentinel) remapped to -2,
// empty token -> -2 (matches data/criteo.py _hash_token semantics).
static inline int64_t hash_token(const char* s, size_t n) {
  if (n == 0) return -2;
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ull;
  }
  h = mix64(h);
  int64_t v = (int64_t)h;
  return v == -1 ? -2 : v;
}

// ---------------------------------------------------------------------------
// FileArena: mmap-backed block allocator for the SSD storage tier
// (reference embedding/config.proto StorageType SSD + ssd_hash kv). Rows
// live in page-cache-backed file segments; the kernel writes cold pages
// out, so the working set is bounded by RAM while capacity is bounded by
// disk.

struct FileArena {
  int fd = -1;
  std::mutex mu;
  std::vector<float*> maps;  // one mapping per block
  size_t block_bytes = 0;
  int64_t file_rows = 0;

  bool open_file(const char* path, size_t bytes_per_block) {
    fd = ::open(path, O_RDWR | O_CREAT, 0644);
    block_bytes = bytes_per_block;
    return fd >= 0;
  }

  float* alloc_block() {
    std::lock_guard<std::mutex> g(mu);
    size_t off = maps.size() * block_bytes;
    if (ftruncate(fd, (off_t)(off + block_bytes)) != 0) return nullptr;
    void* p = mmap(nullptr, block_bytes, PROT_READ | PROT_WRITE, MAP_SHARED,
                   fd, (off_t)off);
    if (p == MAP_FAILED) return nullptr;
    maps.push_back((float*)p);
    return (float*)p;
  }

  ~FileArena() {
    for (float* m : maps) munmap(m, block_bytes);
    if (fd >= 0) ::close(fd);
  }
};

// ---------------------------------------------------------------------------
// HostKV: sharded open-addressing map key -> row index into a block arena.

struct Shard {
  std::mutex mu;
  std::vector<int64_t> keys;   // capacity-sized, EMPTY = INT64_MIN
  std::vector<uint32_t> slot;  // row index into arena
  std::vector<float*> blocks;  // arena blocks of kRowsPerBlock rows
  size_t size = 0;
  size_t mask = 0;
  int64_t dim = 0;

  static constexpr int64_t kEmpty = INT64_MIN;
  static constexpr size_t kRowsPerBlock = 4096;
  FileArena* arena = nullptr;  // non-null: disk-backed blocks (SSD tier)
  bool owns_blocks = true;

  void init(int64_t d, size_t cap_pow2, FileArena* a = nullptr) {
    dim = d;
    arena = a;
    owns_blocks = (a == nullptr);
    keys.assign(cap_pow2, kEmpty);
    slot.assign(cap_pow2, 0);
    mask = cap_pow2 - 1;
  }

  float* row_ptr(uint32_t idx) {
    return blocks[idx / kRowsPerBlock] + (size_t)(idx % kRowsPerBlock) * dim;
  }

  void grow() {
    std::vector<int64_t> old_keys = std::move(keys);
    std::vector<uint32_t> old_slot = std::move(slot);
    size_t cap = (mask + 1) * 2;
    keys.assign(cap, kEmpty);
    slot.assign(cap, 0);
    mask = cap - 1;
    for (size_t i = 0; i < old_keys.size(); ++i) {
      if (old_keys[i] == kEmpty) continue;
      size_t j = mix64((uint64_t)old_keys[i]) & mask;
      while (keys[j] != kEmpty) j = (j + 1) & mask;
      keys[j] = old_keys[i];
      slot[j] = old_slot[i];
    }
  }

  // returns row pointer; creates if absent
  float* upsert(int64_t key, bool* created) {
    if (size * 10 >= (mask + 1) * 7) grow();
    size_t j = mix64((uint64_t)key) & mask;
    while (keys[j] != kEmpty) {
      if (keys[j] == key) { *created = false; return row_ptr(slot[j]); }
      j = (j + 1) & mask;
    }
    if (size % kRowsPerBlock == 0)
      blocks.push_back(arena ? arena->alloc_block()
                             : new float[kRowsPerBlock * dim]);
    keys[j] = key;
    slot[j] = (uint32_t)size++;
    *created = true;
    return row_ptr(slot[j]);
  }

  float* find(int64_t key) {
    size_t j = mix64((uint64_t)key) & mask;
    while (keys[j] != kEmpty) {
      if (keys[j] == key) return row_ptr(slot[j]);
      j = (j + 1) & mask;
    }
    return nullptr;
  }

  // erase by tombstone-free backward-shift deletion
  bool erase(int64_t key) {
    size_t j = mix64((uint64_t)key) & mask;
    while (keys[j] != kEmpty) {
      if (keys[j] == key) break;
      j = (j + 1) & mask;
    }
    if (keys[j] == kEmpty) return false;
    // note: arena row is leaked until compaction; size tracks live rows
    size_t i = j;
    for (;;) {
      size_t k = (i + 1) & mask;
      while (keys[k] != kEmpty) {
        size_t home = mix64((uint64_t)keys[k]) & mask;
        // can keys[k] move into slot i? (its home must not lie after i in
        // the probe order)
        bool wraps = (k < i);
        bool fits = wraps ? (home <= i && home > k) : (home <= i || home > k);
        if (fits) break;
        k = (k + 1) & mask;
      }
      if (keys[k] == kEmpty) { keys[i] = kEmpty; break; }
      keys[i] = keys[k];
      slot[i] = slot[k];
      i = k;
    }
    return true;
  }

  ~Shard() {
    if (owns_blocks)
      for (float* b : blocks) delete[] b;
  }
};

struct HostKV {
  static constexpr int kShards = 16;
  Shard shards[kShards];
  int64_t dim;
  std::atomic<int64_t> live{0};
  FileArena* arena = nullptr;  // non-null for the disk-backed variant

  HostKV(int64_t d, int64_t cap_hint, const char* disk_path = nullptr)
      : dim(d) {
    if (disk_path && disk_path[0]) {
      arena = new FileArena();
      if (!arena->open_file(disk_path,
                            Shard::kRowsPerBlock * (size_t)d * sizeof(float))) {
        delete arena;  // fall back to heap blocks
        arena = nullptr;
      }
    }
    size_t per = 64;
    while ((int64_t)(per * kShards) < cap_hint) per <<= 1;
    for (auto& s : shards) s.init(d, per, arena);
  }

  ~HostKV() { delete arena; }

  Shard& shard_of(int64_t key) {
    return shards[mix64((uint64_t)key ^ 0xABCDull) & (kShards - 1)];
  }
};

// split a batch across worker threads
template <typename F>
static void parallel_for(int64_t n, F f, int max_threads = 8) {
  int nt = (int)std::min<int64_t>(max_threads, std::max<int64_t>(1, n / 4096));
  if (nt <= 1) {
    f(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { f(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

HostKV* hostkv_create(int64_t dim, int64_t capacity_hint) {
  return new HostKV(dim, capacity_hint);
}

// disk-backed variant: rows live in an mmap'd file arena (the SSD storage
// tier). Same API as the DRAM store.
HostKV* hostkv_create_disk(int64_t dim, int64_t capacity_hint,
                           const char* path) {
  return new HostKV(dim, capacity_hint, path);
}

// 1 if the store is file-backed (its arena opened successfully)
int64_t hostkv_is_disk(HostKV* kv) { return kv->arena != nullptr; }

void hostkv_destroy(HostKV* kv) { delete kv; }

int64_t hostkv_size(HostKV* kv) { return kv->live.load(); }

int64_t hostkv_dim(HostKV* kv) { return kv->dim; }

// batched upsert (insert-or-overwrite) of n rows
void hostkv_upsert(HostKV* kv, const int64_t* keys, const float* rows,
                   int64_t n) {
  const int64_t dim = kv->dim;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Shard& s = kv->shard_of(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      bool created = false;
      float* dst = s.upsert(keys[i], &created);
      std::memcpy(dst, rows + i * dim, sizeof(float) * dim);
      if (created) kv->live.fetch_add(1, std::memory_order_relaxed);
    }
  });
}

// batched lookup: found[i]=1 and out_rows[i*dim..] filled on hit.
// Returns the hit count.
int64_t hostkv_lookup(HostKV* kv, const int64_t* keys, float* out_rows,
                      uint8_t* found, int64_t n) {
  const int64_t dim = kv->dim;
  std::atomic<int64_t> hits{0};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t h = 0;
    for (int64_t i = lo; i < hi; ++i) {
      Shard& s = kv->shard_of(keys[i]);
      std::lock_guard<std::mutex> g(s.mu);
      float* src = s.find(keys[i]);
      if (src) {
        std::memcpy(out_rows + i * dim, src, sizeof(float) * dim);
        found[i] = 1;
        ++h;
      } else {
        found[i] = 0;
      }
    }
    hits.fetch_add(h, std::memory_order_relaxed);
  });
  return hits.load();
}

void hostkv_erase(HostKV* kv, const int64_t* keys, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    Shard& s = kv->shard_of(keys[i]);
    std::lock_guard<std::mutex> g(s.mu);
    if (s.erase(keys[i])) kv->live.fetch_sub(1, std::memory_order_relaxed);
  }
}

// export all live rows; returns the number written (<= max_n)
int64_t hostkv_export(HostKV* kv, int64_t* keys_out, float* rows_out,
                      int64_t max_n) {
  const int64_t dim = kv->dim;
  int64_t w = 0;
  for (auto& s : kv->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (size_t j = 0; j <= s.mask; ++j) {
      if (s.keys[j] == Shard::kEmpty) continue;
      if (w >= max_n) return w;
      keys_out[w] = s.keys[j];
      std::memcpy(rows_out + w * dim, s.row_ptr(s.slot[j]),
                  sizeof(float) * dim);
      ++w;
    }
  }
  return w;
}

// export all live keys plus ONE row column (the version stamp): the spill
// path of the DRAM->SSD cascade ranks rows by coldness without paying the
// full-row export bandwidth (width x fewer bytes than hostkv_export)
int64_t hostkv_export_col(HostKV* kv, int64_t* keys_out, float* col_out,
                          int64_t col, int64_t max_n) {
  int64_t w = 0;
  for (auto& s : kv->shards) {
    std::lock_guard<std::mutex> g(s.mu);
    for (size_t j = 0; j <= s.mask; ++j) {
      if (s.keys[j] == Shard::kEmpty) continue;
      if (w >= max_n) return w;
      keys_out[w] = s.keys[j];
      col_out[w] = s.row_ptr(s.slot[j])[col];
      ++w;
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// Criteo TSV parser: label \t 13 ints \t 26 hex tokens per line.
// Parses up to max_rows complete lines from buf[0..len); returns rows
// parsed; *consumed = bytes of complete lines eaten.
int64_t criteo_parse(const char* buf, int64_t len, int64_t max_rows,
                     float* labels, float* dense, int64_t* cats,
                     int64_t* consumed) {
  int64_t rows = 0;
  const char* p = buf;
  const char* end = buf + len;
  const char* row_start = p;
  while (rows < max_rows) {
    // find line end
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!nl) break;
    // split into fields
    const char* f = p;
    int field = 0;
    float lab = 0.f;
    float* drow = dense + rows * 13;
    int64_t* crow = cats + rows * 26;
    for (int i = 0; i < 13; ++i) drow[i] = 0.f;
    for (int i = 0; i < 26; ++i) crow[i] = -2;
    while (f <= nl && field < 40) {
      const char* tab = f;
      while (tab < nl && *tab != '\t') ++tab;
      size_t flen = (size_t)(tab - f);
      if (field == 0) {
        lab = (flen && *f == '1') ? 1.f : 0.f;
      } else if (field <= 13) {
        if (flen) {
          // integer (possibly negative) parse
          bool neg = (*f == '-');
          const char* q = f + (neg ? 1 : 0);
          long v = 0;
          while (q < tab && *q >= '0' && *q <= '9') v = v * 10 + (*q++ - '0');
          drow[field - 1] = (float)(neg ? -v : v);
        }
      } else {
        crow[field - 14] = hash_token(f, flen);
      }
      ++field;
      f = tab + 1;
    }
    labels[rows] = lab;
    ++rows;
    p = nl + 1;
    row_start = p;
  }
  *consumed = (int64_t)(row_start - buf);
  return rows;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// HostIndexResolver: the host-resident key -> dense-slot index behind the
// host-index embedding fast path.
//
// Role: the reference keeps the EmbeddingVariable key index in CPU hash
// maps probed inside the gather/apply kernels (tensorflow/core/framework/
// embedding/dense_hash_map.h, lockless_hash_map.h:41); this resolver plays
// the same role for the device engine, but *pipelined*: while the device
// executes step N, the host resolves step N+1's ids into
// (unique keys, dense row slots, inverse permutation, created flags,
// multiplicities) so the jitted step needs NO on-device dedup sort and NO
// hash-table probe — its sparse path collapses to gather/segment/scatter.
//
// Layout: keys are sharded over n_groups sub-maps by key hash (pure in the
// key, so restore can regroup); row slots are assigned DENSELY in
// deterministic first-seen order (groups in index order, positions in
// batch order), independent of thread count. "Pending" map entries
// (slot == -1) exist when the row store was full or the unique budget
// overflowed: the key is known but has no row yet; it materializes on a
// later batch once there is room, and reads the null row meanwhile —
// byte-identical to the device index's overflow semantics.
namespace {

// one 16B entry: 4 per cache line, never straddles a line, so the hot
// loop's single-line prefetch covers the whole probe window. `meta` packs
// the in-batch dedup scratch: epoch (12 bits, kNoEpoch = invalid, swept
// on wrap) | lidx (20 bits, batch-local unique index).
struct IdxEnt {
  int64_t key;
  int32_t slot;   // -1 = pending (no row assigned yet)
  uint32_t meta;
};
static constexpr uint32_t kNoEpoch = 0xFFFu;
static constexpr uint32_t kLidxBits = 20;
static constexpr uint32_t kLidxMask = (1u << kLidxBits) - 1;

struct IdxGroup {
  static constexpr int64_t kEmpty = INT64_MIN;
  IdxEnt* ents = nullptr;
  size_t size = 0, mask = 0;
  bool grew_in_batch = false;

  static IdxEnt* alloc(size_t cap) {
    void* p = nullptr;
    if (posix_memalign(&p, 2 << 20, cap * sizeof(IdxEnt)) != 0)
      p = malloc(cap * sizeof(IdxEnt));
#ifdef MADV_HUGEPAGE
    madvise(p, cap * sizeof(IdxEnt), MADV_HUGEPAGE);
#endif
    IdxEnt* e = (IdxEnt*)p;
    for (size_t i = 0; i < cap; ++i)
      e[i] = IdxEnt{kEmpty, -1, kNoEpoch << kLidxBits};
    return e;
  }

  void init(size_t cap_pow2) {
    free(ents);
    ents = alloc(cap_pow2);
    size = 0;
    mask = cap_pow2 - 1;
    grew_in_batch = false;
  }

  void grow() {
    IdxEnt* old = ents;
    size_t old_cap = mask + 1;
    size_t cap = old_cap * 2;
    ents = alloc(cap);
    mask = cap - 1;
    for (size_t i = 0; i < old_cap; ++i) {
      const IdxEnt& e = old[i];
      if (e.key == kEmpty) continue;
      size_t j = (mix64((uint64_t)e.key) >> 8) & mask;
      while (ents[j].key != kEmpty) j = (j + 1) & mask;
      ents[j] = e;
    }
    free(old);
    grew_in_batch = true;
  }

  void clear_epochs() {
    for (size_t i = 0; i <= mask; ++i)
      ents[i].meta = (kNoEpoch << kLidxBits) | (ents[i].meta & kLidxMask);
  }

  ~IdxGroup() { free(ents); }
  IdxGroup() = default;
  IdxGroup(const IdxGroup&) = delete;
  IdxGroup& operator=(const IdxGroup&) = delete;
  IdxGroup(IdxGroup&& o) noexcept
      : ents(o.ents), size(o.size), mask(o.mask),
        grew_in_batch(o.grew_in_batch) {
    o.ents = nullptr;
  }

  // find-or-insert starting from a precomputed probe hash
  size_t probe_insert(int64_t key, uint64_t h, bool* found) {
    if (size * 2 >= mask + 1) grow();  // 0.5 max load: short probe chains
    size_t j = (h >> 8) & mask;
    while (ents[j].key != kEmpty) {
      if (ents[j].key == key) { *found = true; return j; }
      j = (j + 1) & mask;
    }
    ents[j] = IdxEnt{key, -1, kNoEpoch << kLidxBits};
    ++size;
    *found = false;
    return j;
  }

  // find-only; returns SIZE_MAX when absent
  size_t probe(int64_t key, uint64_t h) const {
    size_t j = (h >> 8) & mask;
    while (ents[j].key != kEmpty) {
      if (ents[j].key == key) return j;
      j = (j + 1) & mask;
    }
    return SIZE_MAX;
  }

  size_t probe(int64_t key) const {
    return probe(key, mix64((uint64_t)key));
  }
};

struct HostIndexResolver {
  int64_t n_groups;  // power of two
  std::vector<IdxGroup> groups;
  std::atomic<int> busy{0};  // detects concurrent (mis)use: resolves
  //                            must be serialized in step order
  int64_t next_slot = 0;
  std::vector<int64_t> keys_by_slot;
  int32_t cur_epoch = 0;
  int64_t cap_overflow = 0;   // cumulative rows refused: row store full
  int64_t uniq_overflow = 0;  // cumulative uniques beyond the static width
  // per-call scratch (kept across calls to avoid churn)
  std::vector<uint64_t> hash;  // one mix64 per position, reused everywhere
  std::vector<std::vector<int64_t>> scr_keys;   // per-group first-seen uniques
  std::vector<std::vector<int32_t>> scr_count;
  std::vector<std::vector<uint32_t>> scr_j;     // map index per unique
  std::vector<int64_t> goff;
  // wire-mode scratch (hidx_resolve_wire packs from these)
  std::vector<int64_t> w_ukeys;
  std::vector<int32_t> w_uslots;
  std::vector<uint8_t> w_created;
  std::vector<int32_t> w_counts;
  std::vector<int32_t> w_inv;
  // touched-slot recording for incremental checkpoints (the reference's
  // RecordSparseIndices/IndicesIncrRecorder, incr_save_restore_ops.h:329,
  // relocated into the resolver: every train resolve already visits each
  // touched slot exactly once, so recording is one bit-OR per unique).
  bool track_touched = false;
  std::vector<uint64_t> touched;  // bitmap over slots

  void mark_touched(int64_t slot) {
    const size_t w = (size_t)(slot >> 6);
    if (w >= touched.size()) touched.resize(w + 64, 0);
    touched[w] |= 1ull << (slot & 63);
  }

  // counting-bloom admission (reference embedding_filter.h:28-130
  // BloomFilter), relocated into the resolver: pre-admission counts live
  // in this count-min sketch, and a key claims a dense slot only once its
  // post-bump min estimate reaches cbf_freq. Semantics (hash family, bump
  // by within-batch multiplicity, post-ALL-bumps estimate, per-batch
  // re-check) replicate sparse/embedding_var.py _cbf_bump_and_estimate
  // bit-for-bit so host- and device-engine admission agree. Unlike the
  // reference's pure bloom, a seen-but-unadmitted key also holds a 16-byte
  // pending map entry (the in-batch dedup needs it) — bounded by distinct
  // keys seen, still ~100x smaller than a row.
  int64_t cbf_m = 0;       // counters (power of two); 0 = disabled
  int64_t cbf_hashes = 0;
  int64_t cbf_freq = 0;
  std::vector<int32_t> cbf;

  static inline uint32_t hash32_key(int64_t k, uint32_t seed) {
    // K.hash32 / hash32_np mirror (murmur3 finalizer over the two planes)
    uint32_t lo = (uint32_t)((uint64_t)k & 0xFFFFFFFFull);
    uint32_t hi = (uint32_t)((uint64_t)k >> 32);
    uint32_t h = lo ^ (hi * 0x85EBCA6Bu) ^ (seed * 0x9E3779B9u);
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
  }

  explicit HostIndexResolver(int64_t g) : n_groups(g) {
    groups.resize((size_t)g);
    for (auto& m : groups) m.init(1024);
    scr_keys.resize((size_t)g);
    scr_count.resize((size_t)g);
    scr_j.resize((size_t)g);
    goff.resize((size_t)g + 1);
  }

  // owner group = low bits of the SAME hash whose upper bits start the
  // in-group probe (>> 8 clears the owner bits; n_groups <= 256)
  int group_of(int64_t key) const {
    if (key == INT64_MIN) key = INT64_MIN + 1;  // match the resolve remap
    return (int)(mix64((uint64_t)key) & (uint64_t)(n_groups - 1));
  }

  void reset() {
    for (auto& m : groups) m.init(1024);
    next_slot = 0;
    keys_by_slot.clear();
    cur_epoch = 0;
    cap_overflow = 0;
    uniq_overflow = 0;
    touched.clear();
    std::fill(cbf.begin(), cbf.end(), 0);
  }
};

template <typename F>
static void over_groups(int64_t n_groups, F f) {
  int nt = (int)std::min<int64_t>(
      n_groups, std::max(1u, std::thread::hardware_concurrency()));
  nt = std::min(nt, 8);
  if (nt <= 1) {
    for (int64_t g = 0; g < n_groups; ++g) f(g);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t)
    ts.emplace_back([=] {
      for (int64_t g = t; g < n_groups; g += nt) f(g);
    });
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

HostIndexResolver* hidx_create(int64_t n_groups) {
  if (n_groups < 1 || (n_groups & (n_groups - 1)) || n_groups > 256)
    return nullptr;
  return new HostIndexResolver(n_groups);
}

void hidx_destroy(HostIndexResolver* r) { delete r; }

void hidx_reset(HostIndexResolver* r) { r->reset(); }

// stats_out[0..3] = {next_slot, cap_overflow, uniq_overflow, n_groups}
void hidx_stats(HostIndexResolver* r, int64_t* stats_out) {
  stats_out[0] = r->next_slot;
  stats_out[1] = r->cap_overflow;
  stats_out[2] = r->uniq_overflow;
  stats_out[3] = r->n_groups;
}

// Resolve one id batch. keys: int64[n] (-1 = padding). Outputs sized
// inverse[n], ukeys/uslots/created/counts[u_out]; the last unique lane
// (u_out-1) is the overflow group (null slot). mode 0 = train
// (find-or-insert, assign dense slots), 1 = readonly (find-only, no
// mutation of slots/keys; `created` then flags MISSING keys).
// Returns (n_unique << 32) | n_overflow_batch, or -1 on error.
int64_t hidx_resolve(HostIndexResolver* r, const int64_t* keys, int64_t n,
                     int64_t u_out, int64_t null_slot, int64_t row_capacity,
                     int64_t mode, int32_t* inverse, int64_t* ukeys,
                     int32_t* uslots, uint8_t* created, int32_t* counts) {
  if (u_out < 2 || n < 0 || n > (int64_t)kLidxMask) return -1;
  int expected = 0;
  if (!r->busy.compare_exchange_strong(expected, 1)) return -2;
  struct Unbusy {  // clear on every exit path
    std::atomic<int>* b;
    ~Unbusy() { b->store(0); }
  } unbusy{&r->busy};
  const int64_t G = r->n_groups;
  const uint64_t gmask = (uint64_t)(G - 1);
  // 12-bit cycling epoch (kNoEpoch excluded); stale stamps are swept once
  // per cycle so a recycled value can never alias a live one
  const uint32_t ep = (uint32_t)(r->cur_epoch % 4094) + 1;
  if (ep == 1 && r->cur_epoch > 0)
    for (auto& m : r->groups) m.clear_epochs();
  ++r->cur_epoch;
  if ((int64_t)r->hash.size() < n) r->hash.resize((size_t)n);
  uint64_t* hash = r->hash.data();

  // phase 0: ONE mix64 per position, reused for both the owning group
  // (low bits) and the in-group probe start (bits 8+)
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t k = keys[i];
      if (k == INT64_MIN) k = INT64_MIN + 1;  // sentinel remap
      hash[i] = mix64((uint64_t)k);
    }
  });

  // readonly mode needs a side map for batch-dedup of MISSING keys (the
  // main maps are not mutated beyond scratch stamps); sized from the true
  // per-group position counts (skew-safe without worst-case allocation)
  std::vector<std::vector<int64_t>> miss_keys;
  std::vector<std::vector<int32_t>> miss_lidx;
  std::vector<size_t> side_caps;
  if (mode == 1) {
    std::vector<int64_t> per_group((size_t)G, 0);
    for (int64_t i = 0; i < n; ++i) ++per_group[hash[i] & gmask];
    side_caps.assign((size_t)G, 64);
    for (int64_t g = 0; g < G; ++g)
      while ((int64_t)side_caps[(size_t)g] < 2 * (per_group[(size_t)g] + 2))
        side_caps[(size_t)g] <<= 1;
    miss_keys.assign((size_t)G, {});
    miss_lidx.assign((size_t)G, {});
  }

  // the per-position body shared by the fused (1-thread) and per-group
  // (multi-thread) schedules; scratch lists are per-group either way, so
  // the resulting layout is schedule-independent (deterministic)
  auto visit = [&](int64_t g, int64_t i, int32_t* empty_lidx,
                   std::vector<int64_t>* mk, std::vector<int32_t>* ml,
                   size_t smask) {
    auto& m = r->groups[(size_t)g];
    auto& uk = r->scr_keys[(size_t)g];
    auto& ct = r->scr_count[(size_t)g];
    auto& sj = r->scr_j[(size_t)g];
    int64_t k = keys[i];
    if (k == INT64_MIN) k = INT64_MIN + 1;
    if (k == -1) {  // padding: one EMPTY lane per group
      if (empty_lidx[g] < 0) {
        empty_lidx[g] = (int32_t)uk.size();
        uk.push_back(IdxGroup::kEmpty);
        ct.push_back(0);
        sj.push_back(UINT32_MAX);
      }
      inverse[i] = empty_lidx[g];
      return;
    }
    size_t j;
    if (mode == 1) {
      j = m.probe(k, hash[i]);
      if (j == SIZE_MAX) {  // side-map dedup of missing keys
        size_t s = (hash[i] >> 8) & smask;
        while ((*mk)[s] != IdxGroup::kEmpty && (*mk)[s] != k)
          s = (s + 1) & smask;
        if ((*mk)[s] == k) {
          inverse[i] = (*ml)[s];
          ++ct[(size_t)(*ml)[s]];
          return;
        }
        (*mk)[s] = k;
        (*ml)[s] = (int32_t)uk.size();
        inverse[i] = (int32_t)uk.size();
        uk.push_back(k);
        ct.push_back(1);
        sj.push_back(UINT32_MAX);
        return;
      }
    } else {
      bool found;
      j = m.probe_insert(k, hash[i], &found);
    }
    IdxEnt& e = m.ents[j];
    if ((e.meta >> kLidxBits) != ep) {  // first sight this batch
      e.meta = (ep << kLidxBits) | (uint32_t)uk.size();
      uk.push_back(k);
      ct.push_back(0);
      sj.push_back((uint32_t)j);
    }
    const uint32_t l = e.meta & kLidxMask;
    inverse[i] = (int32_t)l;
    ++ct[(size_t)l];
  };

  int nt = std::min<int>(
      (int)G, std::min(8u, std::max(1u, std::thread::hardware_concurrency())));
  std::vector<int32_t> empty_lidx((size_t)G, -1);
  for (int64_t g = 0; g < G; ++g) {
    r->scr_keys[(size_t)g].clear();
    r->scr_count[(size_t)g].clear();
    r->scr_j[(size_t)g].clear();
    r->groups[(size_t)g].grew_in_batch = false;
    if (mode == 1) {
      miss_keys[(size_t)g].assign(side_caps[(size_t)g], IdxGroup::kEmpty);
      miss_lidx[(size_t)g].assign(side_caps[(size_t)g], 0);
    }
  }
  if (nt <= 1 && mode == 0) {
    // specialized fused single-core train pass: one scan, raw pointers
    // hoisted, grow-check only on the (rare) insert branch, probe cache
    // line prefetched PF ahead — the duplicate-heavy common case runs in
    // L1/L2 (its entry was touched earlier this batch)
    constexpr int64_t PF = 16;
    IdxGroup* const gs = r->groups.data();
    for (int64_t i = 0; i < n; ++i) {
      if (i + PF < n) {
        const uint64_t hp = hash[i + PF];
        const IdxGroup& mp = gs[hp & gmask];
        __builtin_prefetch(&mp.ents[(hp >> 8) & mp.mask]);
      }
      int64_t k = keys[i];
      if (k == INT64_MIN) k = INT64_MIN + 1;
      const uint64_t h = hash[i];
      const int64_t g = (int64_t)(h & gmask);
      IdxGroup& m = gs[g];
      auto& uk = r->scr_keys[(size_t)g];
      if (k == -1) {
        if (empty_lidx[(size_t)g] < 0) {
          empty_lidx[(size_t)g] = (int32_t)uk.size();
          uk.push_back(IdxGroup::kEmpty);
          r->scr_count[(size_t)g].push_back(0);
          r->scr_j[(size_t)g].push_back(UINT32_MAX);
        }
        inverse[i] = empty_lidx[(size_t)g];
        continue;
      }
      size_t j = (h >> 8) & m.mask;
      IdxEnt* e = &m.ents[j];
      while (e->key != IdxGroup::kEmpty && e->key != k) {
        j = (j + 1) & m.mask;
        e = &m.ents[j];
      }
      if (e->key == IdxGroup::kEmpty) {  // insert (grow-check here only)
        if (m.size * 2 >= m.mask + 1) {
          m.grow();
          bool found;
          j = m.probe_insert(k, h, &found);
          e = &m.ents[j];
        } else {
          *e = IdxEnt{k, -1, kNoEpoch << kLidxBits};
          ++m.size;
        }
      }
      if ((e->meta >> kLidxBits) != ep) {
        e->meta = (ep << kLidxBits) | (uint32_t)uk.size();
        uk.push_back(k);
        r->scr_count[(size_t)g].push_back(0);
        r->scr_j[(size_t)g].push_back((uint32_t)j);
      }
      const uint32_t l = e->meta & kLidxMask;
      inverse[i] = (int32_t)l;
      ++r->scr_count[(size_t)g][(size_t)l];
    }
  } else if (nt <= 1) {
    constexpr int64_t PF = 16;
    for (int64_t i = 0; i < n; ++i) {
      if (i + PF < n) {
        const uint64_t hp = hash[i + PF];
        const IdxGroup& mp = r->groups[hp & gmask];
        __builtin_prefetch(&mp.ents[(hp >> 8) & mp.mask]);
      }
      const size_t gi = hash[i] & gmask;
      visit((int64_t)gi, i, empty_lidx.data(),
            mode == 1 ? &miss_keys[gi] : nullptr,
            mode == 1 ? &miss_lidx[gi] : nullptr,
            mode == 1 ? side_caps[gi] - 1 : 0);
    }
  } else {
    over_groups(G, [&](int64_t g) {
      for (int64_t i = 0; i < n; ++i)
        if ((int64_t)(hash[i] & gmask) == g)
          visit(g, i, empty_lidx.data(),
                mode == 1 ? &miss_keys[(size_t)g] : nullptr,
                mode == 1 ? &miss_lidx[(size_t)g] : nullptr,
                mode == 1 ? side_caps[(size_t)g] - 1 : 0);
    });
  }

  // barrier: group offsets + deterministic dense slot assignment
  int64_t total = 0;
  for (int64_t g = 0; g < G; ++g) {
    r->goff[(size_t)g] = total;
    total += (int64_t)r->scr_keys[(size_t)g].size();
  }
  r->goff[(size_t)G] = total;
  const int64_t ovf_lane = u_out - 1;
  int64_t n_unique = 0, n_overflow = 0;

  // prefill outputs
  parallel_for(u_out, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      ukeys[i] = -1;
      uslots[i] = (int32_t)null_slot;
      created[i] = 0;
      counts[i] = 0;
    }
  });

  // counting-bloom bump pass (train only): every real unique lane adds its
  // within-batch multiplicity to its H cells BEFORE any estimate is read —
  // the same all-bumps-then-estimate order as the device engine's
  // vectorized scatter-add + min-gather (embedding_var.py
  // _cbf_bump_and_estimate), so same-batch cell sharing admits identically.
  if (r->cbf_m && mode == 0) {
    const uint32_t cm = (uint32_t)(r->cbf_m - 1);
    for (int64_t g = 0; g < G; ++g) {
      auto& uk = r->scr_keys[(size_t)g];
      auto& ct = r->scr_count[(size_t)g];
      const int64_t off = r->goff[(size_t)g];
      for (size_t l = 0; l < uk.size(); ++l) {
        if (uk[l] == IdxGroup::kEmpty || off + (int64_t)l >= ovf_lane)
          continue;
        for (int64_t h = 0; h < r->cbf_hashes; ++h)
          r->cbf[HostIndexResolver::hash32_key(uk[l], (uint32_t)(h + 1)) & cm] += ct[l];
      }
    }
  }

  // unique lanes + slot assignment (slot order: group order, then
  // first-seen order — deterministic, independent of thread count).
  // scr_j map indices stay valid unless the group's map grew this batch.
  for (int64_t g = 0; g < G; ++g) {
    auto& m = r->groups[(size_t)g];
    auto& uk = r->scr_keys[(size_t)g];
    auto& ct = r->scr_count[(size_t)g];
    auto& sj = r->scr_j[(size_t)g];
    const int64_t off = r->goff[(size_t)g];
    const bool stale_j = m.grew_in_batch;
    for (size_t l = 0; l < uk.size(); ++l) {
      if (uk[l] == IdxGroup::kEmpty) continue;
      const int64_t gi = off + (int64_t)l;
      if (gi >= ovf_lane) { ++n_overflow; continue; }
      ++n_unique;
      ukeys[gi] = uk[l];
      counts[gi] = ct[l];
      if (mode == 1) {
        size_t j = (sj[l] == UINT32_MAX) ? SIZE_MAX
                   : (stale_j ? m.probe(uk[l]) : (size_t)sj[l]);
        if (j != SIZE_MAX && m.ents[j].slot >= 0)
          uslots[gi] = m.ents[j].slot;
        else
          created[gi] = 1;  // readonly: MISSING marker
        continue;
      }
      if (r->cbf_m) {
        // bloom-gated access: a key under the admission estimate neither
        // claims a slot nor touches an existing row this batch (the
        // device engine probes it as EMPTY — gated = where(insertable,
        // ukeys, EMPTY) in lookup_or_create_unique)
        const uint32_t cm = (uint32_t)(r->cbf_m - 1);
        int32_t est = INT32_MAX;
        for (int64_t h = 0; h < r->cbf_hashes; ++h)
          est = std::min(est,
                         r->cbf[HostIndexResolver::hash32_key(uk[l], (uint32_t)(h + 1)) & cm]);
        if (est < r->cbf_freq) continue;
      }
      size_t j = stale_j ? m.probe(uk[l]) : (size_t)sj[l];
      IdxEnt& e = m.ents[j];
      if (e.slot < 0) {
        if (r->next_slot < row_capacity) {
          e.slot = (int32_t)r->next_slot++;
          r->keys_by_slot.push_back(uk[l]);
          created[gi] = 1;
        } else {
          ++r->cap_overflow;
        }
      }
      if (e.slot >= 0) {
        uslots[gi] = e.slot;
        if (r->track_touched) r->mark_touched(e.slot);
      }
    }
  }
  r->uniq_overflow += n_overflow;

  // lift inverse to global unique indices
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t gi = r->goff[hash[i] & gmask] + inverse[i];
      inverse[i] = (int32_t)(gi >= ovf_lane ? ovf_lane : gi);
    }
  });
  return (n_unique << 32) | (n_overflow & 0xFFFFFFFFll);
}

// Resolve directly into the single H2D "wire" byte buffer the jitted step
// decodes (deeprec_tpu/host_index.py ResolvedWire). Layout (little-endian,
// U = u_out, n = batch width):
//   [slots|created<<30 : i32 U][key hi : i32 U][key lo : i32 U]
//   [counts : i32 U, only if with_counts]
//   [inverse : i16 n (padded to 4B) if inv16 else i32 n]
//   [tail : i32 4 = n_unique, n_overflow, mode, 0x5EC2]
// One buffer means ONE host->device enqueue per step, and the int16
// inverse plane (valid while u_out <= 32767) carries the bulk of the
// wire at half width — both matter on hosts where transfer serialization
// shares cores with the resolver. Returns hidx_resolve's rc.
int64_t hidx_resolve_wire(HostIndexResolver* r, const int64_t* keys,
                          int64_t n, int64_t u_out, int64_t null_slot,
                          int64_t row_capacity, int64_t mode,
                          int64_t with_counts, int64_t inv16,
                          uint8_t* wire) {
  if (u_out < 2 || null_slot >= (1ll << 30) || (inv16 && u_out > 32767))
    return -1;
  if ((int64_t)r->w_ukeys.size() < u_out) {
    r->w_ukeys.resize((size_t)u_out);
    r->w_uslots.resize((size_t)u_out);
    r->w_created.resize((size_t)u_out);
    r->w_counts.resize((size_t)u_out);
  }
  if ((int64_t)r->w_inv.size() < n) r->w_inv.resize((size_t)n);
  int64_t rc = hidx_resolve(r, keys, n, u_out, null_slot, row_capacity,
                            mode, r->w_inv.data(), r->w_ukeys.data(),
                            r->w_uslots.data(), r->w_created.data(),
                            r->w_counts.data());
  if (rc < 0) return rc;
  int32_t* p32 = (int32_t*)wire;
  for (int64_t i = 0; i < u_out; ++i)
    p32[i] = r->w_uslots[(size_t)i] | ((int32_t)r->w_created[(size_t)i] << 30);
  int32_t* hi = p32 + u_out;
  int32_t* lo = hi + u_out;
  for (int64_t i = 0; i < u_out; ++i) {
    const int64_t k = r->w_ukeys[(size_t)i];
    hi[i] = (int32_t)(k >> 32);
    lo[i] = (int32_t)(k & 0xFFFFFFFFll);
  }
  int32_t* cur = lo + u_out;
  if (with_counts) {
    std::memcpy(cur, r->w_counts.data(), sizeof(int32_t) * (size_t)u_out);
    cur += u_out;
  }
  uint8_t* pb = (uint8_t*)cur;
  if (inv16) {
    int16_t* inv = (int16_t*)pb;
    for (int64_t i = 0; i < n; ++i) inv[i] = (int16_t)r->w_inv[(size_t)i];
    pb += ((2 * n + 3) & ~3ll);
  } else {
    std::memcpy(pb, r->w_inv.data(), sizeof(int32_t) * (size_t)n);
    pb += 4 * n;
  }
  int32_t* tail = (int32_t*)pb;
  tail[0] = (int32_t)(rc >> 32);
  tail[1] = (int32_t)(rc & 0xFFFFFFFFll);
  tail[2] = (int32_t)mode;
  tail[3] = 0x5EC2;
  return rc;
}

// --- counting-bloom admission ----------------------------------------------

// enable (m = power-of-two counter count) or disable (m = 0) the bloom
// gate; counters reset to zero on every call.
int64_t hidx_cbf_enable(HostIndexResolver* r, int64_t m, int64_t n_hashes,
                        int64_t freq) {
  if (m < 0 || (m & (m - 1)) || n_hashes < 0 || n_hashes > 16) return -1;
  r->cbf_m = m;
  r->cbf_hashes = n_hashes;
  r->cbf_freq = freq;
  r->cbf.assign((size_t)m, 0);
  return 0;
}

int64_t hidx_cbf_export(HostIndexResolver* r, int32_t* out, int64_t max_n) {
  int64_t n = std::min<int64_t>(r->cbf_m, max_n);
  std::memcpy(out, r->cbf.data(), sizeof(int32_t) * (size_t)n);
  return n;
}

int64_t hidx_cbf_load(HostIndexResolver* r, const int32_t* in, int64_t n) {
  if (n != r->cbf_m) return -1;
  std::memcpy(r->cbf.data(), in, sizeof(int32_t) * (size_t)n);
  return n;
}

// --- touched-slot recording (incremental-checkpoint recorder) -------------

void hidx_track_touched(HostIndexResolver* r, int64_t enable) {
  r->track_touched = enable != 0;
  if (!enable) r->touched.clear();
}

// export touched slots (ascending); returns count written (<= max_n).
// clear != 0 resets the recording window (the IncrSave "swap-out" step).
int64_t hidx_touched_export(HostIndexResolver* r, int32_t* slots_out,
                            int64_t max_n, int64_t clear) {
  int64_t w = 0;
  for (size_t wi = 0; wi < r->touched.size() && w < max_n; ++wi) {
    uint64_t bits = r->touched[wi];
    while (bits && w < max_n) {
      const int b = __builtin_ctzll(bits);
      slots_out[w++] = (int32_t)(wi * 64 + (size_t)b);
      bits &= bits - 1;
    }
  }
  if (clear) std::fill(r->touched.begin(), r->touched.end(), 0);
  return w;
}

int64_t hidx_touched_count(HostIndexResolver* r) {
  int64_t c = 0;
  for (uint64_t w : r->touched) c += (int64_t)__builtin_popcountll(w);
  return c;
}

// pre-size the key buffer and group maps for ~n_rows keys (kills the
// rehash churn of incremental growth; purely an optimization)
void hidx_reserve(HostIndexResolver* r, int64_t n_rows) {
  if (n_rows <= 0) return;
  r->keys_by_slot.reserve((size_t)n_rows);
  size_t per = 1024;
  while ((int64_t)per < (n_rows / r->n_groups + 1) * 2) per <<= 1;
  for (auto& m : r->groups)
    while (m.mask + 1 < per) m.grow();
}

// all materialized keys in slot order; returns next_slot
int64_t hidx_export(HostIndexResolver* r, int64_t* keys_out, int64_t max_n) {
  int64_t n = std::min<int64_t>(r->next_slot, max_n);
  std::memcpy(keys_out, r->keys_by_slot.data(), sizeof(int64_t) * (size_t)n);
  return n;
}

// rebuild from a dense key list: key i -> slot i. Returns n, or -1 on a
// duplicate key. Resets pending/overflow state.
int64_t hidx_load(HostIndexResolver* r, const int64_t* keys, int64_t n) {
  r->reset();
  hidx_reserve(r, n);
  r->keys_by_slot.assign(keys, keys + n);
  r->next_slot = n;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] == -1) return -1;
    int64_t k = keys[i] == INT64_MIN ? INT64_MIN + 1 : keys[i];
    auto& m = r->groups[(size_t)r->group_of(k)];
    bool found;
    size_t j = m.probe_insert(k, mix64((uint64_t)k), &found);
    if (found) return -1;
    m.ents[j].slot = (int32_t)i;
  }
  return n;
}

// drop rows where keep[slot] == 0 and re-densify (save-time eviction /
// Shrink). old_to_new[old_slot] = new slot, or -1 when dropped. Pending
// map entries are discarded. Returns the new size.
int64_t hidx_compact(HostIndexResolver* r, const uint8_t* keep,
                     int32_t* old_to_new) {
  const int64_t old_n = r->next_slot;
  std::vector<int64_t> kept;
  kept.reserve((size_t)old_n);
  for (int64_t i = 0; i < old_n; ++i) {
    if (keep[i]) {
      old_to_new[i] = (int32_t)kept.size();
      kept.push_back(r->keys_by_slot[(size_t)i]);
    } else {
      old_to_new[i] = -1;
    }
  }
  // carry the touched-recording window through the renumbering (compaction
  // happens at save-time eviction; rows touched since the last incremental
  // must stay recorded under their new slots)
  std::vector<uint64_t> old_touched;
  old_touched.swap(r->touched);
  hidx_load(r, kept.data(), (int64_t)kept.size());
  if (r->track_touched)
    for (int64_t i = 0; i < old_n; ++i)
      if (old_to_new[i] >= 0 && (size_t)(i >> 6) < old_touched.size() &&
          (old_touched[(size_t)(i >> 6)] >> (i & 63)) & 1)
        r->mark_touched(old_to_new[i]);
  return (int64_t)kept.size();
}

}  // extern "C"
