// thermite-tpu native host engine.
//
// Covers the host-side hot paths that the reference implements in Rust
// with native-speed crates:
//
// * SMEM seeding (reference src/index.rs:228-255; suffix-array
//   construction via libdivsufsort, src/index.rs:104): re-designed as a
//   k-mer anchor table + maximal extension + supermaximal-envelope
//   selection, byte-identical in output to the Python engine in
//   thermite_tpu_torch/seed/smem.py (same algorithm, same canonical order).
// * The per-read batch pipeline's host stages (reference
//   src/aligner.rs:123-314 rules): chunk task building (seed -> genome
//   window + transcript-candidate extension problems as device gather
//   offsets) and post-kernel arbitration (genome-vs-transcriptome
//   choice, thresholds, overlap filter, primary selection) — exact
//   ports of the Python implementations in thermite_tpu_torch/align/batch.py,
//   which remain as the fallback and the parity referee.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C csrc  (g++ -O3 -shared -fPIC)

#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <new>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

namespace {

constexpr int kMaxAnchorK = 20;  // 5^20 < 2^63 (int64 keys)

// byte -> base-5 code, 255 invalid (alphabet ACGTN, matching the
// reference FM alphabet "ACGNT" so N-N matches seed exactly)
struct CodeTable {
  uint8_t code[256];
  CodeTable() {
    std::memset(code, 255, sizeof(code));
    code['A'] = 0;
    code['C'] = 1;
    code['G'] = 2;
    code['T'] = 3;
    code['N'] = 4;
  }
};
const CodeTable kCodes;

// mmap + MADV_HUGEPAGE allocator for the multi-GB table arrays.  The
// genome-scale build touches ~50 GB of fresh anonymous memory (packed
// sort keys + the three output arrays); with 4 KB pages that is ~12 M
// minor faults, and this deployment's kernel runs THP in madvise-only
// mode, so without the madvise every fault zeroes one 4 KB page (the
// emit pass measured 100% system time — fault-bound, not compute-
// bound).  2 MB-backed regions cut the fault count 512x and let the
// kernel zero with streaming stores.  Falls back to operator new for
// small blocks and to plain mmap pages when hugepages are unavailable
// (madvise failure is advisory).  The threshold decides mmap-vs-new
// deterministically from the byte count, so deallocate can recompute
// the choice from (p, n) without a side table.
template <typename T>
struct HugeAlloc {
  using value_type = T;
  static constexpr size_t kThreshold = (size_t)8 << 20;
  static constexpr size_t kHuge = (size_t)2 << 20;
  HugeAlloc() = default;
  template <typename U>
  HugeAlloc(const HugeAlloc<U>&) {}
  T* allocate(size_t n) {
    size_t bytes = n * sizeof(T);
    if (bytes >= kThreshold) {
      size_t len = (bytes + kHuge - 1) & ~(kHuge - 1);
      void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
      // big blocks are mmap-or-fail: a mixed fallback would make
      // deallocate guess the origin from (p, n) alone, and a wrong
      // munmap over allocator-owned pages corrupts the heap
      if (p == MAP_FAILED) throw std::bad_alloc();
      madvise(p, len, MADV_HUGEPAGE);
      return (T*)p;
    }
    return (T*)::operator new(bytes);
  }
  void deallocate(T* p, size_t n) {
    size_t bytes = n * sizeof(T);
    if (bytes >= kThreshold) {
      size_t len = (bytes + kHuge - 1) & ~(kHuge - 1);
      munmap(p, len);
      return;
    }
    ::operator delete(p);
  }
  // default-initialize on resize: every HugeVec here is fully
  // overwritten right after resize (sort scatter / cursor emit), and
  // value-initializing a multi-GB array is a serial full write pass
  // over exactly the fresh pages this allocator exists to economize
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    ::new ((void*)p) U(std::forward<Args>(args)...);
  }
  template <typename U>
  void construct(U* p) noexcept(
      std::is_nothrow_default_constructible<U>::value) {
    ::new ((void*)p) U;
  }
  bool operator==(const HugeAlloc&) const { return true; }
  bool operator!=(const HugeAlloc&) const { return false; }
};

template <typename T>
using HugeVec = std::vector<T, HugeAlloc<T>>;

int table_threads();  // defined below (THERMITE_THREADS)

struct SeedIndex {
  const uint8_t* text;  // borrowed; owner is the Python Index
  int64_t n;
  int k;
  // bucketed posting list sorted by key; positions ascending per
  // bucket.  The search path reads through the view pointers; the
  // vectors own storage only when the table was built in-process.
  // Tables restored from a persisted artifact BORROW the caller's
  // arrays (a genome-scale table is ~37 GB — a second copy OOMs the
  // host), so the Python side must keep them alive.
  HugeVec<int64_t> uniq_keys_v, offsets_v, positions_v;
  // classic-output path: the sort array IS the positions array after
  // pass E rewrites each entry in place (an extra fresh positions_v
  // would be +GBs of first-touch pages — this deployment's hypervisor
  // throttles fresh-page supply to ~tens of MB/s past a ~10 GB
  // footprint, so fresh bytes, not passes, are the build cost)
  HugeVec<uint64_t> kv_v;
  const int64_t* uniq_keys = nullptr;
  const int64_t* offsets = nullptr;
  const int64_t* positions = nullptr;
  const int32_t* positions32 = nullptr;  // narrow adopted form (see pos_at)
  // hugepage-backed copy of an adopted (artifact-mmapped) posting
  // array: file-backed 4 KB pages pay a TLB walk per anchor probe and
  // x86 DROPS prefetches whose page misses the TLB, so the pass-ahead
  // prefetch never hides the posting read there (measured ~2x on the
  // chunk build's seed phase at 45 Mbp).  Bounded by
  // THERMITE_HUGE_COPY_MAX (below); empty when the table was built
  // in-process (already hugepage-backed) or too big to copy.
  HugeVec<int32_t> pos32_copy_v;
  int64_t n_keys = 0, n_pos = 0;

  // stride this table was built with, when KNOWN (0 = unknown, e.g.
  // classic posting arrays adopted from an artifact that predates the
  // seed_stride metadata).  thermite_smems' adaptive probe skip is
  // only valid — and only engages — when this is exactly 1 (see the
  // proof at the skip site).
  int64_t skip_stride = 0;

  // ---- packed mode (genome scale): kv IS the table ----
  // Above kPackedMin entries the uniq/offsets/positions arrays are
  // never materialized (at 3.2 Gbp they are ~37 GB of fresh pages and
  // ~2/3 of the artifact); lookups instead binary-search the sorted
  // packed entries (rem_key<<pos_bits | p/stride) through the same
  // kPfxBits prefix table the classic big-table path uses, and
  // positions decode on the fly.  Probe count is identical to the
  // classic pfx path (~5 bisect steps into one L2-resident range).
  bool packed = false;
  const uint64_t* kvp = nullptr;   // sorted packed entries
  // hugepage copies of artifact-adopted packed arrays (same rationale
  // as pos32_copy_v: file-backed 4 KB pages defeat both the TLB and
  // the probe prefetches); bounded by THERMITE_HUGE_COPY_MAX
  HugeVec<uint64_t> kv_copy_v;
  HugeVec<int64_t> pfx_copy_v;
  const int64_t* bucket_off = nullptr;  // (n_top+1) MSD bucket bounds
  int64_t n_top_packed = 0;
  int top_bits_p = 0, pos_bits_p = 0, rem_shift_p = 0;
  int64_t stride_p = 1;
  uint64_t pmask_p = 0;
  HugeVec<int64_t> bucket_off_v;  // owned when built in-process

  void adopt_vectors() {
    uniq_keys = uniq_keys_v.data();
    offsets = offsets_v.data();
    if (packed) {
      kvp = kv_v.data();
      bucket_off = bucket_off_v.data();
      n_pos = (int64_t)kv_v.size();
      n_keys = 0;  // not materialized in packed mode
      return;
    }
    if (!kv_v.empty()) {
      positions = (const int64_t*)kv_v.data();
      n_pos = (int64_t)kv_v.size();
    } else {
      positions = positions_v.data();
      n_pos = (int64_t)positions_v.size();
    }
    n_keys = (int64_t)uniq_keys_v.size();
  }
  // open-addressing key -> posting-range hash (2 probes typical vs ~14
  // for the binary search; seeding is the host pipeline's hottest
  // loop).  One 16-byte slot carries (key+1, lo, count) so a probe hit
  // resolves the whole posting range from a single (prefetched) cache
  // line — the earlier split key/bucket/offsets layout cost three
  // dependent misses per anchor, and the miss chain, not the probe
  // count, dominated chunk-build wall time.
  struct HSlot {
    uint64_t key1;  // key + 1; 0 = empty
    uint32_t lo;    // posting range start
    uint32_t cnt;   // posting range length
  };
  // hugepage-backed: the table is GBs and every anchor probe lands on
  // a fresh page, so 4 KB pages pay a TLB walk per probe
  HugeVec<HSlot> hslots;
  uint64_t hmask = 0;
  // genome-scale tables (>kHashMaxKeys keys) skip the open-addressing
  // hash (12 B/slot at 2x load would reach tens of GB) and use a
  // prefix-bucket + bounded binary search instead: pfx[p] is the first
  // bucket whose key's top kPfxBits bits are >= p (~5 probe steps).
  static constexpr int64_t kHashMaxKeys = (int64_t)1 << 27;
  static constexpr int kPfxBits = 26;
  std::vector<int64_t> pfx;           // owned storage (built in-process)
  const int64_t* pfxp = nullptr;      // lookup pointer: owned or adopted
  int64_t pfxn = 0;                   // pfx length (cells + 1)
  int key_shift = 0;

  // deterministic pfx geometry for anchor length k (adoption must
  // reproduce exactly what build_hash computes)
  static void pfx_geometry(int k, int* key_shift_out, int64_t* cells_out) {
    int key_bits = 1;
    int64_t max_key = 1;
    for (int t = 0; t < k; ++t) max_key *= 5;
    while ((max_key >> key_bits) != 0) ++key_bits;
    int pfx_bits = key_bits > kPfxBits ? kPfxBits : key_bits;
    *key_shift_out = key_bits > pfx_bits ? key_bits - pfx_bits : 0;
    *cells_out = (int64_t)1 << pfx_bits;
  }

  void build_hash() {
    if (packed) {
      // pfx over the FULL key's top kPfxBits: each pfx cell lies
      // inside one MSD bucket (kPfxBits >= top_bits always — top_bits
      // caps at 18), so a range's entries share their bucket and
      // compare by rem_key alone.
      int64_t nb;
      pfx_geometry(k, &key_shift, &nb);
      pfx.assign(nb + 1, 0);
      // count entries per pfx cell (full key reconstructed from the
      // bucket id + packed rem_key), then exclusive scan.  The count
      // parallelizes by MSD bucket: every pfx cell (and its +1 slot)
      // lies inside exactly one bucket, so threads touch disjoint pfx
      // ranges — no atomics.  This pass walks the whole kv array
      // (~19 GB at genome scale) and dominates a loaded-artifact
      // engine's startup (~4 min single-core measured).
      auto count_bucket = [&](int64_t b) {
        const int64_t base_key = b << rem_shift_p;
        for (int64_t i = bucket_off[b]; i < bucket_off[b + 1]; ++i) {
          int64_t key = base_key | (int64_t)(kvp[i] >> pos_bits_p);
          pfx[(key >> key_shift) + 1]++;
        }
      };
      int nthreads = table_threads();
      if (nthreads > 1 && n_top_packed >= 2 * nthreads) {
        std::atomic<int64_t> next(0);
        auto worker = [&]() {
          while (true) {
            int64_t b = next.fetch_add(1, std::memory_order_relaxed);
            if (b >= n_top_packed) break;
            count_bucket(b);
          }
        };
        std::vector<std::thread> pool;
        for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
        worker();
        for (auto& th : pool) th.join();
      } else {
        for (int64_t b = 0; b < n_top_packed; ++b) count_bucket(b);
      }
      for (int64_t p = 0; p < nb; ++p) pfx[p + 1] += pfx[p];
      pfxp = pfx.data();
      pfxn = nb + 1;
      return;
    }
    if (n_keys > kHashMaxKeys || n_pos > (int64_t)UINT32_MAX) {
      int key_bits = 1;
      int64_t max_key = 1;
      for (int t = 0; t < k; ++t) max_key *= 5;
      while ((max_key >> key_bits) != 0) ++key_bits;
      key_shift = key_bits > kPfxBits ? key_bits - kPfxBits : 0;
      int64_t nb = ((int64_t)1 << (key_bits - key_shift));
      pfx.assign(nb + 1, 0);
      // counts then exclusive scan
      for (int64_t b = 0; b < n_keys; ++b)
        pfx[(uniq_keys[b] >> key_shift) + 1]++;
      for (int64_t p = 0; p < nb; ++p) pfx[p + 1] += pfx[p];
      pfxp = pfx.data();
      pfxn = nb + 1;
      return;
    }
    size_t cap = 64;
    while ((int64_t)cap < n_keys * 2) cap <<= 1;
    hslots.assign(cap, HSlot{0, 0, 0});
    hmask = cap - 1;
    for (int64_t b = 0; b < n_keys; ++b) {
      uint64_t slot = ((uint64_t)uniq_keys[b] * 0x9E3779B97F4A7C15ull) & hmask;
      while (hslots[slot].key1 != 0) slot = (slot + 1) & hmask;
      hslots[slot] = {(uint64_t)uniq_keys[b] + 1, (uint32_t)offsets[b],
                      (uint32_t)(offsets[b + 1] - offsets[b])};
    }
  }
  // posting range [*lo, *hi) for key; false when absent.  Unified
  // lookup over the three representations (hash / pfx+uniq / packed).
  inline bool find_range(int64_t key, int64_t* lo, int64_t* hi) const {
    if (packed) {
      int64_t p = key >> key_shift;
      int64_t a = pfxp[p], b = pfxp[p + 1];
      const uint64_t want = (uint64_t)key & ((rem_shift_p
          ? (((uint64_t)1 << rem_shift_p) - 1) : 0));
      // lower bound on rem_key
      while (a < b) {
        int64_t mid = (a + b) >> 1;
        if ((kvp[mid] >> pos_bits_p) < want) a = mid + 1; else b = mid;
      }
      if (a >= pfxp[p + 1] || (kvp[a] >> pos_bits_p) != want) return false;
      *lo = a;
      int64_t c = a + 1, d = pfxp[p + 1];
      while (c < d) {
        int64_t mid = (c + d) >> 1;
        if ((kvp[mid] >> pos_bits_p) == want) c = mid + 1; else d = mid;
      }
      *hi = c;
      return true;
    }
    if (pfxp) {
      int64_t p = key >> key_shift;
      int64_t a = pfxp[p], b = pfxp[p + 1];
      while (a < b) {
        int64_t mid = (a + b) >> 1;
        if (uniq_keys[mid] < key) a = mid + 1; else b = mid;
      }
      if (a >= pfxp[p + 1] || uniq_keys[a] != key) return false;
      *lo = offsets[a];
      *hi = offsets[a + 1];
      return true;
    }
    uint64_t slot = ((uint64_t)key * 0x9E3779B97F4A7C15ull) & hmask;
    uint64_t want = (uint64_t)key + 1;
    while (true) {
      const HSlot& e = hslots[slot];
      if (e.key1 == 0) return false;
      if (e.key1 == want) {
        *lo = (int64_t)e.lo;
        *hi = (int64_t)e.lo + e.cnt;
        return true;
      }
      slot = (slot + 1) & hmask;
    }
  }

  // reference position for posting-array index i.  positions32 serves
  // artifacts saved with int32 positions (<2 GiB texts) zero-copy —
  // widening 720 MB at load costs ~a minute in this deployment's
  // throttled fresh-page windows.
  inline int64_t pos_at(int64_t i) const {
    if (packed) return (int64_t)(kvp[i] & pmask_p) * stride_p;
    return positions32 ? (int64_t)positions32[i] : positions[i];
  }

};

}  // namespace

namespace {

// worker thread count for the table build and the chunk build
// (THERMITE_THREADS env override; default: hardware concurrency)
int table_threads() {
  const char* env = std::getenv("THERMITE_THREADS");
  if (env && *env) {
    int n = std::atoi(env);
    return n > 0 ? n : 1;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw > 0 ? (int)hw : 1;
}

// one rolling-key scan over window starts [lo, hi) (window start p is
// valid iff p+k <= n, all k bytes valid, p % stride == 0); calls
// emit(key, p) for each sampled window.
template <typename Emit>
void rolling_scan(const uint8_t* text, int64_t n, int k, int64_t stride,
                  int64_t lo, int64_t hi, Emit&& emit) {
  if (lo >= hi || lo + k > n) return;
  int64_t pow_top = 1;
  for (int t = 0; t < k - 1; ++t) pow_top *= 5;
  int64_t key = 0;
  int inv = 0;
  for (int t = 0; t < k; ++t) {
    uint8_t c = kCodes.code[text[lo + t]];
    key = key * 5 + (c == 255 ? 0 : c);
    inv += (c == 255);
  }
  if (inv == 0 && lo % stride == 0) emit(key, lo);
  for (int64_t i = lo + 1; i < hi && i + k <= n; ++i) {
    uint8_t c_out = kCodes.code[text[i - 1]];
    uint8_t c_in = kCodes.code[text[i + k - 1]];
    key -= (c_out == 255 ? 0 : c_out) * pow_top;
    key = key * 5 + (c_in == 255 ? 0 : c_in);
    inv -= (c_out == 255);
    inv += (c_in == 255);
    if (inv == 0 && i % stride == 0) emit(key, i);
  }
}

// Packed-u64 build path: when (key_bits - top_bits) + pos_bits <= 64,
// each sampled window packs into ONE u64 as
//     (rem_key << pos_bits) | (p / stride)
// which (a) halves the sort working set vs the (key, pos) pair path
// (genome scale: 25.6 GB -> 12.8 GB), (b) turns the per-bucket LSD
// into a plain u64 radix whose LOW bits are the position, so stable
// digit passes over the rem_key bits alone leave equal keys
// position-ascending for free, and (c) lets the MSD scatter go through
// per-bucket write-combining buffers — the ~16 K bucket streams hit
// memory as sequential bursts instead of one random 8 B store per
// entry (a genome-scale build spends most of its time in that
// scatter otherwise).  Returns false when the packing does not fit (keys too
// wide for the position range) — the caller falls back to the pair
// path.  Output layout and order are bit-identical to the pair path.
bool build_stride_packed(SeedIndex* idx, const uint8_t* text, int64_t n,
                         int k, int64_t stride) {
  // THERMITE_TABLE_DEBUG=1: per-pass wall times to stderr (profiling
  // the genome-scale locality cliff; zero cost when off)
  const char* dbg_env = std::getenv("THERMITE_TABLE_DEBUG");
  const bool dbg = dbg_env && *dbg_env == '1';
  auto t_last = std::chrono::steady_clock::now();
  auto lap = [&](const char* name) {
    if (!dbg) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[table] %s %.1fs\n", name,
                 std::chrono::duration<double>(now - t_last).count());
    t_last = now;
  };
  int64_t max_key = 1;
  for (int t = 0; t < k; ++t) max_key *= 5;
  int key_bits = 0;
  while ((max_key >> key_bits) != 0) ++key_bits;
  const int64_t n_starts = n >= k ? n - k + 1 : 0;
  const int64_t q_max = n_starts > 0 ? (n_starts - 1) / stride : 0;
  int pos_bits = 1;
  while ((q_max >> pos_bits) != 0) ++pos_bits;

  // size the MSD partition so a bucket (8 B/entry) stays ~L2-resident
  // for the per-bucket LSD passes, then raise it until rem_key + pos
  // fit one u64 (bounded: >18 top bits would need per-thread count
  // arrays past the point of diminishing locality)
  int top_bits = 11;
  {
    int64_t est_entries = n / stride + 1;
    while (top_bits < 16 && (est_entries >> top_bits) * 8 > (int64_t)2 << 20)
      ++top_bits;
  }
  if (top_bits < key_bits + pos_bits - 64) top_bits = key_bits + pos_bits - 64;
  if (top_bits > 18) return false;  // cannot pack; pair fallback
  if (top_bits > key_bits) top_bits = key_bits;
  const int rem_shift = key_bits - top_bits;  // rem_key bit width
  const int64_t n_top = (int64_t)1 << top_bits;
  const uint64_t rem_mask =
      rem_shift ? (((uint64_t)1 << rem_shift) - 1) : 0;
  const uint64_t pmask = ((uint64_t)1 << pos_bits) - 1;

  const int nthreads = (n > (int64_t)1 << 22) ? table_threads() : 1;
  const int64_t slice = (n_starts + nthreads - 1) / nthreads;

  // pass A: per-(slice, top-bucket) counts
  std::vector<std::vector<int64_t>> counts(nthreads);
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&, t]() {
        auto& c = counts[t];
        c.assign(n_top, 0);
        int64_t lo = t * slice, hi = std::min(n_starts, lo + slice);
        rolling_scan(text, n, k, stride, lo, hi,
                     [&](int64_t key, int64_t) { c[key >> rem_shift]++; });
      });
    }
    for (auto& th : pool) th.join();
  }
  lap("A:count");
  // exclusive scan in (bucket-major, slice-minor) order -> write bases
  std::vector<int64_t> bucket_off(n_top + 1, 0);
  {
    int64_t sum = 0;
    for (int64_t b = 0; b < n_top; ++b) {
      bucket_off[b] = sum;
      for (int t = 0; t < nthreads; ++t) {
        int64_t c = counts[t][b];
        counts[t][b] = sum;  // becomes this slice's write cursor
        sum += c;
      }
    }
    bucket_off[n_top] = sum;
  }
  const int64_t total = bucket_off[n_top];
  HugeVec<uint64_t>& kv = idx->kv_v;
  kv.resize(total);
  lap("alloc");

  // pass B: scatter packed entries via write-combining buffers
  // (per-thread staging capped at 64 MB; slice cursor regions are
  // disjoint so flushes never race)
  int64_t stage = 64;
  while (stage > 8 && n_top * stage * 8 > (int64_t)64 << 20) stage >>= 1;
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&, t]() {
        auto& cur = counts[t];
        HugeVec<uint64_t> buf((size_t)(n_top * stage));
        std::vector<int32_t> fill(n_top, 0);
        int64_t lo = t * slice, hi = std::min(n_starts, lo + slice);
        rolling_scan(
            text, n, k, stride, lo, hi, [&](int64_t key, int64_t p) {
              int64_t b = key >> rem_shift;
              uint64_t v = (((uint64_t)key & rem_mask) << pos_bits) |
                           (uint64_t)(p / stride);
              uint64_t* s = buf.data() + b * stage;
              int32_t f = fill[b];
              s[f++] = v;
              if (f == stage) {
                std::memcpy(kv.data() + cur[b], s, (size_t)stage * 8);
                cur[b] += stage;
                f = 0;
              }
              fill[b] = f;
            });
        for (int64_t b = 0; b < n_top; ++b)
          if (fill[b]) {
            std::memcpy(kv.data() + cur[b], buf.data() + b * stage,
                        (size_t)fill[b] * 8);
            cur[b] += fill[b];
          }
      });
    }
    for (auto& th : pool) th.join();
  }
  lap("B:scatter");

  // pass C: per-bucket stable LSD on the rem_key bits (positions ride
  // in the low bits, untouched by the digit extraction, so ties stay
  // position-ascending)
  if (rem_shift > 0) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      std::vector<uint64_t> tmp;
      std::vector<int64_t> cnt(1 << 12);
      while (true) {
        int64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= n_top) break;
        int64_t lo = bucket_off[b], hi = bucket_off[b + 1];
        int64_t m = hi - lo;
        if (m <= 1) continue;
        tmp.resize(m);
        uint64_t* a = kv.data() + lo;
        uint64_t* bbuf = tmp.data();
        for (int shift = 0; shift < rem_shift; shift += 12) {
          int digits = rem_shift - shift < 12 ? rem_shift - shift : 12;
          int64_t nd = (int64_t)1 << digits;
          std::fill(cnt.begin(), cnt.begin() + nd, 0);
          uint64_t mask = (uint64_t)nd - 1;
          int dshift = pos_bits + shift;
          for (int64_t i = 0; i < m; ++i) cnt[(a[i] >> dshift) & mask]++;
          int64_t sum = 0;
          for (int64_t d = 0; d < nd; ++d) {
            int64_t c = cnt[d];
            cnt[d] = sum;
            sum += c;
          }
          for (int64_t i = 0; i < m; ++i)
            bbuf[cnt[(a[i] >> dshift) & mask]++] = a[i];
          std::swap(a, bbuf);
        }
        if (a != kv.data() + lo)  // odd pass count: copy back
          std::copy(a, a + m, kv.data() + lo);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }

  lap("C:lsd");
  // genome-scale tables stay in PACKED MODE: kv + bucket_off ARE the
  // table (searched via the pfx prefix + rem_key bisection — same
  // probe profile as the classic big-table pfx path), so the
  // uniq/offsets/positions materialization below (~37 GB of fresh
  // pages at 3.2 Gbp, 73% of the measured single-core build) never
  // runs.  Threshold defaults to the same bound past which classic
  // lookups already used pfx+bisection; THERMITE_PACKED_MIN overrides
  // (tests force packed mode at tiny scale with =1).
  {
    int64_t packed_min = SeedIndex::kHashMaxKeys;
    if (const char* e = std::getenv("THERMITE_PACKED_MIN"))
      if (*e) packed_min = std::atoll(e);
    // also require the KEY SPACE to exceed the hash bound: with a
    // small k (5^k <= 2^27) the classic path would keep its 2-probe
    // open-addressing hash no matter how many positions there are,
    // and packed bisection would be a silent seeding regression
    const bool env_forced = std::getenv("THERMITE_PACKED_MIN") != nullptr;
    if (total >= packed_min &&
        (env_forced || max_key > SeedIndex::kHashMaxKeys)) {
      idx->packed = true;
      idx->top_bits_p = top_bits;
      idx->pos_bits_p = pos_bits;
      idx->rem_shift_p = rem_shift;
      idx->stride_p = stride;
      idx->pmask_p = pmask;
      idx->n_top_packed = n_top;
      idx->bucket_off_v.assign(bucket_off.begin(), bucket_off.end());
      lap("packed:done");
      return true;
    }
  }
  // pass D: per-bucket unique-key counts (parallel over buckets) so
  // the output arrays allocate exactly once and pass E can write with
  // per-bucket cursors instead of a serial push_back walk (the pair
  // path's push_back doubling copied ~2x the 25 GB output transiently
  // at genome scale; the serial emit was 73% of the single-core build)
  std::vector<int64_t> ubase(n_top + 1, 0);
  {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      while (true) {
        int64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= n_top) break;
        int64_t c = 0;
        uint64_t prev = ~(uint64_t)0;  // > any rem_key (< 2^46)
        for (int64_t i = bucket_off[b]; i < bucket_off[b + 1]; ++i) {
          uint64_t rk = kv[i] >> pos_bits;
          c += (rk != prev);
          prev = rk;
        }
        ubase[b + 1] = c;
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }
  for (int64_t b = 0; b < n_top; ++b) ubase[b + 1] += ubase[b];
  const int64_t nuniq = ubase[n_top];
  lap("D:uniq");
  // pass E: parallel per-bucket emit via disjoint cursor ranges.  The
  // position is written IN PLACE over the consumed sort entry (same
  // 8-byte slot; rk is read before the store), so kv becomes the
  // positions array with zero fresh allocation — see kv_v in SeedIndex
  idx->uniq_keys_v.resize(nuniq);
  idx->offsets_v.resize(nuniq + 1);
  {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      while (true) {
        int64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= n_top) break;
        const int64_t base_key = b << rem_shift;
        int64_t u = ubase[b];
        uint64_t prev = ~(uint64_t)0;
        for (int64_t i = bucket_off[b]; i < bucket_off[b + 1]; ++i) {
          uint64_t v = kv[i];
          uint64_t rk = v >> pos_bits;
          if (rk != prev) {
            idx->uniq_keys_v[u] = base_key | (int64_t)rk;
            idx->offsets_v[u] = i;
            ++u;
            prev = rk;
          }
          kv[i] = (uint64_t)((int64_t)(v & pmask) * stride);
        }
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }
  idx->offsets_v[nuniq] = total;
  lap("E:emit");
  return true;
}

}  // namespace

// adopted-array copy bound: artifact posting arrays arrive as
// file-backed 4 KB-page mmaps; copying them into hugepage-backed
// anonymous memory removes a TLB walk per anchor probe and lets the
// pass-ahead prefetches actually fire (x86 drops prefetches that miss
// the TLB).  Default 8 GiB; THERMITE_HUGE_COPY_MAX=0 disables.
static int64_t huge_copy_max() {
  const char* e = std::getenv("THERMITE_HUGE_COPY_MAX");
  return e ? std::atoll(e) : ((int64_t)8 << 30);
}

// Copy an adopted array into hugepage-backed memory when it fits the
// cap; on allocation failure keep the borrowed pointer (the copy is
// purely a TLB/prefetch optimization — these entry points are called
// through ctypes, so an escaping bad_alloc would abort the process).
template <typename T>
static const T* try_huge_copy(HugeVec<T>& dst, const T* src,
                              int64_t count) {
  if (count * (int64_t)sizeof(T) > huge_copy_max()) return src;
  try {
    dst.resize((size_t)count);
  } catch (const std::bad_alloc&) {
    HugeVec<T>().swap(dst);
    return src;
  }
  std::memcpy(dst.data(), src, (size_t)count * sizeof(T));
  return dst.data();
}

extern "C" {

// stride > 1 indexes only text positions === 0 (mod stride): a maximal
// match of length >= k + stride - 1 covers k-window starts at `stride`
// consecutive text offsets, so at least one is sampled and maximal
// extension from it reconstructs the full match.  Matches shorter than
// k + stride - 1 may be missed — the documented whole-genome tradeoff
// (cf. STAR's sparse suffix array); the oracle shares the same table,
// so oracle/batch parity is unaffected.
//
// Sort strategy (a global 8-bit LSD thrashes the cache single-threaded
// at genome scale): MSD partition on the top
// <=11 key bits (one counting scan + one scatter scan, both threaded
// over text slices), then an independent per-top-bucket LSD radix on
// the remaining bits with 12-bit digits — each bucket is ~L2-sized, so
// the inner passes stream instead of thrashing, and buckets
// parallelize across THERMITE_THREADS with no synchronization.  Final
// order is (key asc, position asc): slice scatter preserves position
// order, and the per-bucket LSD is stable.
void* thermite_seed_index_new_stride(const uint8_t* text, int64_t n, int k,
                                     int64_t stride) {
  if (k < 1 || k > kMaxAnchorK || stride < 1) return nullptr;
  auto* idx = new SeedIndex();
  idx->text = text;
  idx->n = n;
  idx->k = k;
  idx->skip_stride = stride;

  // fast path: packed-u64 sort (always fits for k <= 20 at any
  // realistic text length; the pair path below remains as fallback,
  // forceable via THERMITE_TABLE_PAIR=1 for differential testing)
  const char* force_pair = std::getenv("THERMITE_TABLE_PAIR");
  if (!(force_pair && *force_pair == '1') &&
      build_stride_packed(idx, text, n, k, stride)) {
    idx->adopt_vectors();
    idx->build_hash();
    return idx;
  }

  int64_t max_key = 1;
  for (int t = 0; t < k; ++t) max_key *= 5;
  int key_bits = 0;
  while ((max_key >> key_bits) != 0) ++key_bits;
  // size the MSD partition so a bucket (16 B/entry) stays ~L2-resident
  // for the per-bucket LSD passes: ~2 MB buckets, 11..16 top bits
  int top_bits = 11;
  {
    int64_t est_entries = n / stride + 1;
    while (top_bits < 16 &&
           (est_entries >> top_bits) * 16 > (int64_t)2 << 20)
      ++top_bits;
  }
  if (top_bits > key_bits) top_bits = key_bits;
  const int rem_shift = key_bits - top_bits;
  const int64_t n_top = (int64_t)1 << top_bits;

  const int nthreads =
      (n > (int64_t)1 << 22) ? table_threads() : 1;
  const int64_t n_starts = n >= k ? n - k + 1 : 0;
  const int64_t slice = (n_starts + nthreads - 1) / nthreads;

  // pass A: per-(slice, top-bucket) counts
  std::vector<std::vector<int64_t>> counts(nthreads);
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&, t]() {
        auto& c = counts[t];
        c.assign(n_top, 0);
        int64_t lo = t * slice, hi = std::min(n_starts, lo + slice);
        rolling_scan(text, n, k, stride, lo, hi,
                     [&](int64_t key, int64_t) { c[key >> rem_shift]++; });
      });
    }
    for (auto& th : pool) th.join();
  }
  // exclusive scan in (bucket-major, slice-minor) order -> write bases
  std::vector<int64_t> bucket_off(n_top + 1, 0);
  {
    int64_t sum = 0;
    for (int64_t b = 0; b < n_top; ++b) {
      bucket_off[b] = sum;
      for (int t = 0; t < nthreads; ++t) {
        int64_t c = counts[t][b];
        counts[t][b] = sum;  // becomes this slice's write cursor
        sum += c;
      }
    }
    bucket_off[n_top] = sum;
  }
  const int64_t total = bucket_off[n_top];
  std::vector<std::pair<int64_t, int64_t>> kv(total);

  // pass B: scatter (key, pos) into bucket regions
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) {
      pool.emplace_back([&, t]() {
        auto& cur = counts[t];
        int64_t lo = t * slice, hi = std::min(n_starts, lo + slice);
        rolling_scan(text, n, k, stride, lo, hi,
                     [&](int64_t key, int64_t p) {
                       kv[cur[key >> rem_shift]++] = {key, p};
                     });
      });
    }
    for (auto& th : pool) th.join();
  }

  // pass C: per-bucket stable LSD on the remaining bits, 12-bit digits
  if (rem_shift > 0) {
    std::atomic<int64_t> next(0);
    auto worker = [&]() {
      std::vector<std::pair<int64_t, int64_t>> tmp;
      std::vector<int64_t> cnt(1 << 12);
      while (true) {
        int64_t b = next.fetch_add(1, std::memory_order_relaxed);
        if (b >= n_top) break;
        int64_t lo = bucket_off[b], hi = bucket_off[b + 1];
        int64_t m = hi - lo;
        if (m <= 1) continue;
        tmp.resize(m);
        auto* a = kv.data() + lo;
        auto* bbuf = tmp.data();
        for (int shift = 0; shift < rem_shift; shift += 12) {
          int digits = rem_shift - shift < 12 ? rem_shift - shift : 12;
          int64_t nd = (int64_t)1 << digits;
          std::fill(cnt.begin(), cnt.begin() + nd, 0);
          int64_t mask = nd - 1;
          for (int64_t i = 0; i < m; ++i) cnt[(a[i].first >> shift) & mask]++;
          int64_t sum = 0;
          for (int64_t d = 0; d < nd; ++d) {
            int64_t c = cnt[d];
            cnt[d] = sum;
            sum += c;
          }
          for (int64_t i = 0; i < m; ++i)
            bbuf[cnt[(a[i].first >> shift) & mask]++] = a[i];
          std::swap(a, bbuf);
        }
        if (a != kv.data() + lo)  // odd pass count: copy back
          std::copy(a, a + m, kv.data() + lo);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }

  idx->positions_v.resize(kv.size());
  for (size_t i = 0; i < kv.size(); ++i) idx->positions_v[i] = kv[i].second;
  // bucket boundaries
  for (size_t i = 0; i < kv.size(); ++i) {
    if (i == 0 || kv[i].first != kv[i - 1].first) {
      idx->uniq_keys_v.push_back(kv[i].first);
      idx->offsets_v.push_back((int64_t)i);
    }
  }
  idx->offsets_v.push_back((int64_t)kv.size());
  idx->adopt_vectors();
  idx->build_hash();
  return idx;
}

void* thermite_seed_index_new(const uint8_t* text, int64_t n, int k) {
  return thermite_seed_index_new_stride(text, n, k, 1);
}

void thermite_seed_index_free(void* h) { delete static_cast<SeedIndex*>(h); }

// Declare the stride a borrowed-array table was built with (classic
// artifacts record it as meta["seed_stride"]; older artifacts don't,
// and the adoption entry points leave it unknown = 0, which keeps the
// adaptive probe skip off).  Only call with a stride actually known.
void thermite_seed_index_set_stride_hint(void* h, int64_t stride) {
  static_cast<SeedIndex*>(h)->skip_stride = stride;
}

int64_t thermite_seed_index_size(void* h) {
  return static_cast<SeedIndex*>(h)->n_pos;
}

// ---- table persistence: export the posting arrays / rebuild from them
// (the radix-sort build costs ~42 s at chromosome scale; the index
// artifact stores these arrays so aligner construction is array copies
// + the linear hash build only) ----

int64_t thermite_seed_index_n_keys(void* h) {
  return static_cast<SeedIndex*>(h)->n_keys;
}

void thermite_seed_index_export(void* h, int64_t* keys, int64_t* offsets,
                                int64_t* positions) {
  auto* idx = static_cast<SeedIndex*>(h);
  std::memcpy(keys, idx->uniq_keys, idx->n_keys * sizeof(int64_t));
  std::memcpy(offsets, idx->offsets, (idx->n_keys + 1) * sizeof(int64_t));
  if (idx->positions32)  // widen the narrow adopted form
    for (int64_t i = 0; i < idx->n_pos; ++i)
      positions[i] = idx->positions32[i];
  else
    std::memcpy(positions, idx->positions, idx->n_pos * sizeof(int64_t));
}

// zero-copy views of the posting arrays (valid while the handle
// lives).  A genome-scale export copy is ~37 GB of fresh pages (and
// this deployment throttles fresh-page supply — see HugeAlloc); the
// Python side wraps these pointers as numpy views and keeps the
// engine handle alive instead.
void thermite_seed_index_views(void* h, const int64_t** keys,
                               const int64_t** offsets,
                               const int64_t** positions) {
  auto* idx = static_cast<SeedIndex*>(h);
  *keys = idx->uniq_keys;
  *offsets = idx->offsets;
  // a narrow (int32-positions) adopted table has no int64 view; the
  // caller already owns the artifact arrays, so nullptr is a loud "use
  // what you adopted from" (export_table checks)
  *positions = idx->positions32 ? nullptr : idx->positions;
}

// ---- packed-mode persistence: the sorted u64 entries + MSD bucket
// bounds ARE the genome-scale table; ~half the bytes of the classic
// three-array form and zero build-side materialization ----

int thermite_seed_index_is_packed(void* h) {
  return static_cast<SeedIndex*>(h)->packed ? 1 : 0;
}

void thermite_seed_index_packed_meta(void* h, int64_t* n_top,
                                     int32_t* top_bits, int32_t* pos_bits,
                                     int64_t* stride, int64_t* total) {
  auto* idx = static_cast<SeedIndex*>(h);
  *n_top = idx->n_top_packed;
  *top_bits = idx->top_bits_p;
  *pos_bits = idx->pos_bits_p;
  *stride = idx->stride_p;
  *total = idx->n_pos;
}

void thermite_seed_index_packed_views(void* h, const uint64_t** kv,
                                      const int64_t** bucket_off) {
  auto* idx = static_cast<SeedIndex*>(h);
  *kv = idx->kvp;
  *bucket_off = idx->bucket_off;
}

// `pfx_ext`/`pfx_len` optionally adopt a persisted pfx prefix array
// (the artifact's seed_pfx member) and skip the full-kv count pass —
// ~4 min single-core at genome scale.  The caller keeps it alive; a
// length mismatch with this build's pfx geometry returns nullptr (the
// caller rebuilds without it).
void* thermite_seed_index_new_from_kv(const uint8_t* text, int64_t n, int k,
                                      int64_t stride, int32_t top_bits,
                                      int32_t pos_bits, const uint64_t* kv,
                                      int64_t total,
                                      const int64_t* bucket_off,
                                      int64_t n_top,
                                      const int64_t* pfx_ext,
                                      int64_t pfx_len) {
  if (k < 1 || k > kMaxAnchorK) return nullptr;
  auto* idx = new SeedIndex();
  idx->text = text;
  idx->n = n;
  idx->k = k;
  // borrow: the caller keeps kv/bucket_off alive for the handle's life
  idx->packed = true;
  idx->kvp = kv;
  idx->bucket_off = bucket_off;
  idx->n_top_packed = n_top;
  idx->top_bits_p = top_bits;
  idx->pos_bits_p = pos_bits;
  idx->stride_p = stride;
  idx->skip_stride = stride;
  idx->pmask_p = ((uint64_t)1 << pos_bits) - 1;
  int key_bits = 0;
  int64_t max_key = 1;
  for (int t = 0; t < k; ++t) max_key *= 5;
  while ((max_key >> key_bits) != 0) ++key_bits;
  idx->rem_shift_p = key_bits - top_bits;
  idx->n_pos = total;
  // hugepage-copy the adopted kv (every probe bisects it and pos_at
  // decodes from it; file-backed 4 KB pages pay a TLB walk per touch
  // and drop the probe prefetches).  The pfx rides along below.
  idx->kvp = try_huge_copy(idx->kv_copy_v, kv, total);
  if (pfx_ext) {
    int64_t cells;
    SeedIndex::pfx_geometry(k, &idx->key_shift, &cells);
    if (pfx_len != cells + 1 || pfx_ext[pfx_len - 1] != total) {
      delete idx;
      return nullptr;
    }
    idx->pfxp = try_huge_copy(idx->pfx_copy_v, pfx_ext, pfx_len);
    idx->pfxn = pfx_len;
  } else {
    idx->build_hash();  // pfx over the packed entries
  }
  return idx;
}

// pfx view for persistence (packed tables; valid while the handle
// lives).  *p is null when no pfx exists (small classic tables).
void thermite_seed_index_pfx(void* h, const int64_t** p, int64_t* n) {
  auto* idx = static_cast<SeedIndex*>(h);
  *p = idx->pfxp;
  *n = idx->pfxn;
}

void* thermite_seed_index_new_from_arrays(const uint8_t* text, int64_t n,
                                          int k, const int64_t* keys,
                                          int64_t m, const int64_t* offsets,
                                          const int64_t* positions,
                                          int64_t total) {
  if (k < 1 || k > kMaxAnchorK) return nullptr;
  auto* idx = new SeedIndex();
  idx->text = text;
  idx->n = n;
  idx->k = k;
  // borrow: the caller keeps the arrays alive for the handle's life
  idx->uniq_keys = keys;
  idx->offsets = offsets;
  idx->positions = positions;
  idx->n_keys = m;
  idx->n_pos = total;
  idx->positions = try_huge_copy(idx->positions_v, positions, total);
  idx->build_hash();
  return idx;
}

// int32-position variant: adopts an artifact's narrow posting array
// zero-copy (Index.save stores int32 positions for <2 GiB texts)
void* thermite_seed_index_new_from_arrays32(const uint8_t* text, int64_t n,
                                            int k, const int64_t* keys,
                                            int64_t m, const int64_t* offsets,
                                            const int32_t* positions32,
                                            int64_t total) {
  if (k < 1 || k > kMaxAnchorK) return nullptr;
  auto* idx = new SeedIndex();
  idx->text = text;
  idx->n = n;
  idx->k = k;
  idx->uniq_keys = keys;
  idx->offsets = offsets;
  idx->positions32 = positions32;
  idx->n_keys = m;
  idx->n_pos = total;
  idx->positions32 = try_huge_copy(idx->pos32_copy_v, positions32, total);
  idx->build_hash();
  return idx;
}

// THERMITE_SEED_NOSKIP=1 forces the probe-everything discovery path
// (differential testing / ops escape hatch for the adaptive probe
// skip below).  Latched at first use — set it before the first call.
static bool seed_skip_on() {
  static const bool on = [] {
    const char* e = std::getenv("THERMITE_SEED_NOSKIP");
    return !(e && *e && *e != '0');
  }();
  return on;
}

namespace {

// ---- shared SMEM-search building blocks (thermite_smems and the
// interleaved chunk-build seeder below use the exact same pieces, so
// their outputs are identical by construction) ----

// occurrence interval: (diag, s_o, e_o, p_o), deduped per diagonal
struct SeedOcc {
  int64_t diag, s, e, p;
};
struct SeedMem {
  int64_t q, t, len;
};

// per-diagonal coverage dedupe: remember last covered query end per
// diagonal via a growable open-addressing map (sizing it from raw
// anchor-hit counts could allocate GBs for repeat-pathological reads)
struct DiagCoverMap {
  struct Ent {
    int64_t diag;
    int64_t qend;
  };
  std::vector<Ent> tab;
  size_t cap = 0;
  size_t count = 0;

  void reset() {
    if (cap == 0 || cap > 4096) {
      cap = 256;
      tab.assign(cap, {INT64_MIN, -1});
    } else if (count) {
      std::fill(tab.begin(), tab.end(), Ent{INT64_MIN, -1});
    }
    count = 0;
  }
  int64_t covered_until(int64_t diag) const {
    size_t slot = ((uint64_t)diag * 0x9E3779B97F4A7C15ull) & (cap - 1);
    while (tab[slot].diag != INT64_MIN) {
      if (tab[slot].diag == diag) return tab[slot].qend;
      slot = (slot + 1) & (cap - 1);
    }
    return -1;
  }
  static bool raw_insert(std::vector<Ent>& t, size_t c, int64_t diag,
                         int64_t qend) {
    size_t slot = ((uint64_t)diag * 0x9E3779B97F4A7C15ull) & (c - 1);
    while (t[slot].diag != INT64_MIN && t[slot].diag != diag)
      slot = (slot + 1) & (c - 1);
    bool fresh = t[slot].diag == INT64_MIN;
    t[slot] = {diag, qend};
    return fresh;
  }
  void set_covered(int64_t diag, int64_t qend) {
    if ((count + 1) * 2 > cap) {  // grow at 50% load
      std::vector<Ent> bigger(cap << 1, {INT64_MIN, -1});
      for (const auto& e : tab)
        if (e.diag != INT64_MIN) raw_insert(bigger, cap << 1, e.diag, e.qend);
      tab.swap(bigger);
      cap <<= 1;
    }
    count += raw_insert(tab, cap, diag, qend);
  }
};

// rolling base-5 anchor keys: one code lookup per read byte instead
// of k per anchor; anchor q is valid iff no invalid byte lands in its
// window [q, q+k).  keys must have rlen-k+1 slots, prefilled use not
// required (every slot is written or set to -1).  Returns whether the
// read contains any invalid (non-ACGTN) byte.
bool seed_roll_keys(const uint8_t* read, int64_t rlen, int k,
                    int64_t* keys) {
  const int64_t n_anchor = rlen - k + 1;
  for (int64_t q = 0; q < n_anchor; ++q) keys[q] = -1;
  int64_t pow = 1;  // 5^(k-1)
  for (int t = 0; t < k - 1; ++t) pow *= 5;
  int64_t key = 0;
  int64_t last_bad = -1;
  for (int64_t i = 0; i < rlen; ++i) {
    uint8_t c = kCodes.code[read[i]];
    if (c == 255) {
      last_bad = i;
      c = 0;
    }
    if (i >= k) {
      uint8_t c0 = kCodes.code[read[i - k]];
      key -= (int64_t)(c0 == 255 ? 0 : c0) * pow;
    }
    key = key * 5 + c;
    int64_t q = i - k + 1;
    if (q >= 0 && last_bad < q) keys[q] = key;
  }
  return last_bad >= 0;
}

// extend one posting range's occurrences around anchor q; returns the
// max extension end seen (0 when none were fresh)
int64_t seed_extend_range(const SeedIndex* idx, const uint8_t* read,
                          int64_t rlen, int64_t q, int64_t lo, int64_t hi,
                          DiagCoverMap* cover, std::vector<SeedOcc>* occs) {
  const int k = idx->k;
  const uint8_t* text = idx->text;
  const int64_t n = idx->n;
  int64_t emax = 0;
  for (int64_t pi = lo; pi < hi; ++pi) {
    int64_t p = idx->pos_at(pi);
    int64_t diag = p - q;
    if (cover->covered_until(diag) >= q + k) continue;  // inside known run
    // maximal extension around the anchor
    int64_t l = 0;
    while (q - 1 - l >= 0 && p - 1 - l >= 0 &&
           read[q - 1 - l] == text[p - 1 - l])
      ++l;
    int64_t r = 0;
    while (q + k + r < rlen && p + k + r < n &&
           read[q + k + r] == text[p + k + r])
      ++r;
    int64_t s = q - l, e = q + k + r;
    occs->push_back({diag, s, e, p - l});
    cover->set_covered(diag, e);
    if (e > emax) emax = e;
  }
  return emax;
}

// envelope + emission + canonical sort: occs -> mems (appended).
// ``env_scratch`` is caller-provided so per-read calls don't pay a
// heap allocation (resized/zeroed here).
void seed_emit(const std::vector<SeedOcc>& occs, int64_t rlen,
               int64_t min_seed_len, std::vector<SeedMem>* mems,
               std::vector<int64_t>* env_scratch) {
  // envelope P(s) = max e over intervals with s_o <= s
  std::vector<int64_t>& env = *env_scratch;
  env.assign(rlen + 1, 0);
  for (const auto& o : occs) {
    if (o.e > env[o.s]) env[o.s] = o.e;
  }
  for (int64_t s = 1; s <= rlen; ++s)
    if (env[s - 1] > env[s]) env[s] = env[s - 1];

  // SMEM starts: envelope increases and length >= min_seed_len
  size_t base = mems->size();
  int64_t prev = 0;
  for (int64_t s = 0; s < rlen; ++s) {
    int64_t e = env[s];
    if (e - s >= min_seed_len && e > prev) {
      for (const auto& o : occs) {
        if (o.s <= s && o.e >= e) mems->push_back({s, o.p + (s - o.s), e - s});
      }
    }
    if (env[s] > prev) prev = env[s];
  }
  std::sort(mems->begin() + base, mems->end(),
            [](const SeedMem& a, const SeedMem& b) {
              if (a.len != b.len) return a.len > b.len;
              if (a.q != b.q) return a.q < b.q;
              return a.t < b.t;
            });
}

}  // namespace

// SMEM search for one read.  Returns the number of mems written, or
// -(required capacity) if out buffers are too small.
// Output arrays: (qpos, tpos, len) sorted by (-len, qpos, tpos).
int64_t thermite_smems(void* h, const uint8_t* read, int64_t rlen,
                       int64_t min_seed_len, int64_t* out_q, int64_t* out_t,
                       int64_t* out_len, int64_t cap) {
  auto* idx = static_cast<SeedIndex*>(h);
  const int k = idx->k;
  if (rlen < min_seed_len || rlen < k) return 0;

  std::vector<SeedOcc> occs;

  // pre-pass: resolve and cache each anchor's posting range
  // (prefetched a pass ahead — the probes' cache misses dominate
  // seeding on chromosome-scale tables)
  const int64_t n_anchor = rlen - k + 1;
  std::vector<int64_t> keys(n_anchor);
  bool any_invalid = seed_roll_keys(read, rlen, k, keys.data());

  DiagCoverMap cover;
  cover.reset();
  auto extend_range = [&](int64_t q, int64_t lo, int64_t hi) -> int64_t {
    return seed_extend_range(idx, read, rlen, q, lo, hi, &cover, &occs);
  };

  if (seed_skip_on() && idx->skip_stride == 1 && !any_invalid) {
    // Adaptive probe skip: probe anchors left to right, but after a
    // probe jump straight to q_next = max(q+1, E-k+1), where E is the
    // max extension END over every occurrence found so far.  For a
    // clean well-matching read this is ~(1 + #mismatches) probes
    // instead of rlen-k+1, and the output is IDENTICAL to probing
    // every anchor.  Proof sketch (stride 1, no invalid read bytes —
    // both enforced above):
    //   * An SMEM is emitted at read position s iff the envelope
    //     e = env[s] = max end over found maximal-match intervals with
    //     start <= s strictly increases at s (see the emission loop
    //     below); the emitted occurrences are exactly the found
    //     intervals covering [s, e).
    //   * Completeness: suppose interval I' = (s', e') is emitted by
    //     the probe-everything algorithm but some jump skipped all of
    //     its anchors [s', e'-k].  At that jump, E >= q_next + k - 1
    //     with q_next > s'... every found interval so far started at
    //     <= its probe anchor <= s'-1, so env[s'-1] >= E; emission of
    //     I' needs e' > env[s'-1] >= E, hence e'-k >= E-k+1 = q_next,
    //     so q_next itself lies in [s', e'-k] — its window is inside
    //     I', the probe returns I''s position, and maximal extension
    //     reconstructs I' exactly.  Contradiction: I' is never missed.
    //   * Soundness: a skipped (never-found) interval M = (sm, em)
    //     cannot change the result.  At the jump that skipped it,
    //     em <= E (else the argument above would have found it), and
    //     the interval realizing E starts <= sm - 1, so M never wins
    //     the envelope at any position and is never collected by any
    //     emission point (collection at (s, env[s]) needs em >=
    //     env[s] >= E >= em, i.e. em == E == env[s], but then the
    //     E-interval's earlier start forces env[s-1] >= env[s], so s
    //     is not an emission point).
    // The fallbacks: stride > 1 samples text positions, where a jump
    // can land past the one anchor whose diagonal position is
    // sampled; invalid read bytes make windows unprobeable while raw
    // byte equality can still extend through equal non-ACGTN bytes.
    // Both take the probe-everything path (and THERMITE_SEED_NOSKIP=1
    // forces it for differential testing).
    int64_t E = 0;
    for (int64_t q = 0; q < n_anchor;) {
      int64_t lo, hi;
      if (idx->find_range(keys[q], &lo, &hi)) {
        int64_t e = extend_range(q, lo, hi);
        if (e > E) E = e;
      }
      int64_t nq = E - k + 1;
      q = nq > q + 1 ? nq : q + 1;
    }
  } else {
    const uint8_t* text = idx->text;
    const int64_t n = idx->n;
    std::vector<int64_t> rlo(n_anchor, 0), rhi(n_anchor, 0);
    // Full-span early exit (stride > 1 tables, where the adaptive
    // probe skip above is unsound): once (a) an occurrence covering
    // the WHOLE read [0, rlen) has been found and (b) at least
    // `stride` consecutive anchors have been probed, probing can
    // stop.  Proof: with a full-span interval starting at 0, the
    // envelope is rlen everywhere, so the only emission point is
    // s = 0 and it collects exactly the full-span occurrences; a
    // full-span occurrence on diagonal d is found iff some probed
    // anchor a has (d + a) % stride == 0 (text positions are sampled
    // at `stride`), and any `stride` CONSECUTIVE probed anchors cover
    // every residue class — all anchors are valid here because the
    // read is clean (no invalid byte), which the gate requires.
    // Probing proceeds in anchor chunks so the bounded-lookahead /
    // text-warming pipelining is preserved within a chunk.
    const bool chunked =
        seed_skip_on() && idx->skip_stride > 1 && !any_invalid;
    const int64_t CK =
        chunked ? std::max<int64_t>(16, idx->skip_stride) : n_anchor;
    bool full_span = false;
    // probe pass with bounded-lookahead prefetching: issuing every
    // anchor's prefetch up front (the old pre-pass) overflows the
    // core's ~dozen line-fill buffers and the excess prefetches drop,
    // serializing one full memory latency per probe.  A sliding window
    // of D outstanding misses keeps the memory pipeline exactly full.
    const int64_t D = 12;
    auto probe_prefetch = [&](int64_t key) {
      if (idx->pfxp)
        __builtin_prefetch(&idx->pfxp[key >> idx->key_shift]);
      else
        __builtin_prefetch(
            &idx->hslots[((uint64_t)key * 0x9E3779B97F4A7C15ull) &
                         idx->hmask]);
    };
    for (int64_t c0 = 0; c0 < n_anchor; c0 += CK) {
      const int64_t c1 = std::min(c0 + CK, n_anchor);
      if (c0 == 0)
        for (int64_t q = 0; q < c1 && q < D; ++q)
          if (keys[q] >= 0) probe_prefetch(keys[q]);
      if (idx->packed) {
        // packed (genome-scale) tables bisect a pfx cell's kv range —
        // ~3 dependent line misses per anchor if run cold.  Split the
        // probe: a bounds pass reads the (lookahead-warm) pfx and
        // prefetches each anchor's whole kv range (a cell is a few
        // cache lines), then the bisect pass runs on warm lines.
        for (int64_t q = c0; q < c1; ++q) {
          if (q + D < n_anchor && keys[q + D] >= 0)
            probe_prefetch(keys[q + D]);
          if (keys[q] < 0) continue;
          int64_t p = keys[q] >> idx->key_shift;
          int64_t a = idx->pfxp[p], b = idx->pfxp[p + 1];
          rlo[q] = a;
          rhi[q] = ~b;  // mark "bounds only" (bisect pass resolves below)
          int64_t end = b < a + 64 ? b : a + 64;  // cap repeat-heavy cells
          for (int64_t off = a; off < end; off += 8)
            __builtin_prefetch(&idx->kvp[off]);
        }
        for (int64_t q = c0; q < c1; ++q) {
          if (keys[q] < 0 || rhi[q] >= 0) continue;
          rlo[q] = rhi[q] = 0;
          int64_t lo, hi;
          if (!idx->find_range(keys[q], &lo, &hi)) continue;
          rlo[q] = lo;
          rhi[q] = hi;
        }
      } else {
        for (int64_t q = c0; q < c1; ++q) {
          if (q + D < n_anchor && keys[q + D] >= 0)
            probe_prefetch(keys[q + D]);
          if (keys[q] < 0) continue;
          int64_t lo, hi;
          if (!idx->find_range(keys[q], &lo, &hi)) continue;
          rlo[q] = lo;
          rhi[q] = hi;
          // warm the posting range for the text pass below
          __builtin_prefetch(idx->positions32
                                 ? (const void*)&idx->positions32[lo]
                                 : (const void*)&idx->positions[lo]);
        }
      }
      // text-warming pass: each anchor's first occurrence extends
      // against text lines around p; same-diagonal anchors hit the
      // same few lines (p advances with q), so these prefetches
      // collapse to a handful of distinct misses that overlap with
      // this loop instead of stalling the extension loop one line at
      // a time.
      for (int64_t q = c0; q < c1; ++q) {
        if (rlo[q] >= rhi[q]) continue;
        int64_t p = idx->pos_at(rlo[q]);
        if (p >= 64) __builtin_prefetch(&text[p - 64]);
        __builtin_prefetch(&text[p]);
        if (p + k < n) __builtin_prefetch(&text[p + k]);
      }
      for (int64_t q = c0; q < c1; ++q) {
        if (rlo[q] >= rhi[q]) continue;
        int64_t e = extend_range(q, rlo[q], rhi[q]);
        if (chunked && !full_span && e == rlen) {
          for (const auto& o : occs)
            if (o.s == 0 && o.e == rlen) {
              full_span = true;
              break;
            }
        }
      }
      if (chunked && full_span && c1 >= idx->skip_stride) break;
    }
  }

  std::vector<SeedMem> mems;
  std::vector<int64_t> env_scratch;
  seed_emit(occs, rlen, min_seed_len, &mems, &env_scratch);

  if ((int64_t)mems.size() > cap) return -(int64_t)mems.size();
  for (size_t i = 0; i < mems.size(); ++i) {
    out_q[i] = mems[i].q;
    out_t[i] = mems[i].t;
    out_len[i] = mems[i].len;
  }
  return (int64_t)mems.size();
}

}  // extern "C"

namespace {

// W-way interleaved adaptive seeding for sequential chunk builds.
//
// The adaptive probe skip (thermite_smems above) leaves only
// ~(1 + #mismatches) probes per read, but each probe is a chain of
// DEPENDENT cache misses — hash slot -> posting entries -> text
// around the hit — that a single in-flight read serializes at one
// full memory latency per link.  This engine runs kW reads' probe
// state machines round-robin, one pipeline stage per visit, so every
// load was prefetched a full rotation earlier and different reads'
// chains overlap in the memory system (the single-core host's
// line-fill buffers are the real execution resource here).
//
// Each slot cycles PROBE -> POS -> EXT:
//   PROBE: hash slot line (prefetched last visit) -> posting range;
//          prefetch the first posting-entry lines.
//   POS:   read posting entries (warm); prefetch the text lines each
//          occurrence's extension will touch first.  Ranges longer
//          than kChunk process in kChunk-sized POS/EXT rounds.
//   EXT:   run the shared seed_extend_range on the (warm) text,
//          update E, advance the cursor q = max(q+1, E-k+1) and
//          prefetch the next probe's slot line — or finish the read
//          (shared seed_emit) and refill the slot with the next one.
//
// Per-read algorithm, state, and visit order of (q, posting index)
// are EXACTLY thermite_smems' adaptive path, so output is identical
// (tests/test_native_seed.py::test_interleaved_chunk_seed_identity
// plus the chunk-build parity suite).  Only the hash-slot table
// representation interleaves (stride-1 tables below the pfx/packed
// threshold — every headline config); dirty reads (invalid bytes) and
// other representations fall back to thermite_smems per read.
class SeedInterleaver {
 public:
  static constexpr int kW = 16;      // in-flight reads (16 and 24 measured equal; 12 slightly worse)
  static constexpr int64_t kChunk = 8;  // posting entries per POS round

  SeedInterleaver(SeedIndex* idx, int64_t min_seed_len)
      : idx_(idx),
        min_len_(min_seed_len),
        eligible_(seed_skip_on() && idx->skip_stride == 1 &&
                  !idx->packed && idx->pfxp == nullptr &&
                  !idx->hslots.empty()) {}

  bool eligible() const { return eligible_; }

  // Seed reads [0, n) of the padded block: read i's mems land at
  // out_mems[(*out_off)[i] .. (*out_off)[i+1]) sorted (-len, q, t).
  void seed_all(const uint8_t* reads, int64_t rpad, const int64_t* read_lens,
                int64_t n, std::vector<SeedMem>* out_mems,
                std::vector<int64_t>* out_off) {
    if (per_read_.size() < (size_t)n) per_read_.resize(n);
    for (int64_t i = 0; i < n; ++i) per_read_[i].clear();

    int64_t next_ri = 0;
    int active = 0;
    for (int w = 0; w < kW; ++w) {
      slots_[w].ri = -1;
      if (refill(slots_[w], reads, rpad, read_lens, n, &next_ri)) ++active;
    }
    while (active > 0) {
      for (int w = 0; w < kW; ++w) {
        Slot& s = slots_[w];
        if (s.ri < 0) continue;
        if (!step(s, reads, rpad, read_lens, n, &next_ri)) --active;
      }
    }

    out_mems->clear();
    out_off->resize(n + 1);
    (*out_off)[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
      out_mems->insert(out_mems->end(), per_read_[i].begin(),
                       per_read_[i].end());
      (*out_off)[i + 1] = (int64_t)out_mems->size();
    }
  }

 private:
  struct Slot {
    int64_t ri = -1;
    const uint8_t* read = nullptr;
    int64_t rlen = 0, n_anchor = 0;
    int64_t q = 0, E = 0;
    int64_t lo = 0, hi = 0, cur = 0;  // posting range + POS cursor
    int stage = 0;                    // 0 PROBE, 1 POS, 2 EXT
    int64_t pbuf[kChunk];             // decoded positions of this round
    int64_t pcnt = 0;
    std::vector<int64_t> keys;
    std::vector<SeedOcc> occs;
    DiagCoverMap cover;
  };

  void prefetch_slot(int64_t key) const {
    __builtin_prefetch(
        &idx_->hslots[((uint64_t)key * 0x9E3779B97F4A7C15ull) & idx_->hmask]);
  }
  void prefetch_positions(int64_t a, int64_t b) const {
    if (idx_->positions32) {
      for (int64_t i = a; i < b; i += 16)
        __builtin_prefetch(&idx_->positions32[i]);
    } else {
      for (int64_t i = a; i < b; i += 8)
        __builtin_prefetch(&idx_->positions[i]);
    }
  }

  // advance the probe cursor after anchor q's range is fully handled;
  // finishes + refills the slot when the read is done.  Returns false
  // when the slot went idle (no reads left).
  bool advance(Slot& s, const uint8_t* reads, int64_t rpad,
               const int64_t* read_lens, int64_t n, int64_t* next_ri) {
    const int k = idx_->k;
    int64_t nq = s.E - k + 1;
    s.q = nq > s.q + 1 ? nq : s.q + 1;
    if (s.q < s.n_anchor) {
      prefetch_slot(s.keys[s.q]);
      s.stage = 0;
      return true;
    }
    seed_emit(s.occs, s.rlen, min_len_, &per_read_[s.ri], &env_scratch_);
    s.ri = -1;
    return refill(s, reads, rpad, read_lens, n, next_ri);
  }

  // load the next eligible read into the slot (keys + first prefetch);
  // short reads finish empty and dirty reads run the per-read referee
  // path inline, both without occupying the slot.
  bool refill(Slot& s, const uint8_t* reads, int64_t rpad,
              const int64_t* read_lens, int64_t n, int64_t* next_ri) {
    const int k = idx_->k;
    while (*next_ri < n) {
      int64_t ri = (*next_ri)++;
      const uint8_t* read = reads + ri * rpad;
      int64_t rlen = read_lens[ri];
      if (rlen < min_len_ || rlen < k) continue;  // no mems (smems: 0)
      s.n_anchor = rlen - k + 1;
      if (s.keys.size() < (size_t)s.n_anchor) s.keys.resize(s.n_anchor);
      if (seed_roll_keys(read, rlen, k, s.keys.data())) {
        seed_dirty(read, rlen, ri);  // invalid bytes: referee path
        continue;
      }
      s.ri = ri;
      s.read = read;
      s.rlen = rlen;
      s.q = 0;
      s.E = 0;
      s.occs.clear();
      s.cover.reset();
      s.stage = 0;
      prefetch_slot(s.keys[0]);
      return true;
    }
    return false;
  }

  // one pipeline stage for one slot; false when the slot went idle
  bool step(Slot& s, const uint8_t* reads, int64_t rpad,
            const int64_t* read_lens, int64_t n, int64_t* next_ri) {
    const int k = idx_->k;
    switch (s.stage) {
      case 0: {  // PROBE (slot line warm)
        int64_t lo, hi;
        if (idx_->find_range(s.keys[s.q], &lo, &hi)) {
          s.lo = lo;
          s.hi = hi;
          s.cur = lo;
          int64_t cend = s.cur + kChunk < hi ? s.cur + kChunk : hi;
          prefetch_positions(s.cur, cend);
          s.stage = 1;
          return true;
        }
        return advance(s, reads, rpad, read_lens, n, next_ri);
      }
      case 1: {  // POS (posting entries warm): decode + prefetch text
        int64_t cend = s.cur + kChunk < s.hi ? s.cur + kChunk : s.hi;
        s.pcnt = 0;
        const uint8_t* text = idx_->text;
        for (int64_t pi = s.cur; pi < cend; ++pi) {
          int64_t p = idx_->pos_at(pi);
          s.pbuf[s.pcnt++] = p;
          if (p >= 64) __builtin_prefetch(&text[p - 64]);
          __builtin_prefetch(&text[p]);
          if (p + k < idx_->n) __builtin_prefetch(&text[p + k]);
        }
        s.stage = 2;
        return true;
      }
      default: {  // EXT (text warm): extend this POS round's entries
        int64_t cend = s.cur + s.pcnt;
        int64_t e = seed_extend_range(idx_, s.read, s.rlen, s.q, s.cur,
                                      cend, &s.cover, &s.occs);
        if (e > s.E) s.E = e;
        s.cur = cend;
        if (s.cur < s.hi) {
          int64_t nxt = s.cur + kChunk < s.hi ? s.cur + kChunk : s.hi;
          prefetch_positions(s.cur, nxt);
          s.stage = 1;
          return true;
        }
        return advance(s, reads, rpad, read_lens, n, next_ri);
      }
    }
  }

  // referee path for reads the machine can't interleave (invalid
  // bytes force thermite_smems' probe-everything branch anyway)
  void seed_dirty(const uint8_t* read, int64_t rlen, int64_t ri) {
    if (dirty_q_.size() < 4096) {
      dirty_q_.resize(4096);
      dirty_t_.resize(4096);
      dirty_l_.resize(4096);
    }
    int64_t nm = thermite_smems(idx_, read, rlen, min_len_, dirty_q_.data(),
                                dirty_t_.data(), dirty_l_.data(),
                                (int64_t)dirty_q_.size());
    if (nm < 0) {
      dirty_q_.resize(-nm);
      dirty_t_.resize(-nm);
      dirty_l_.resize(-nm);
      nm = thermite_smems(idx_, read, rlen, min_len_, dirty_q_.data(),
                          dirty_t_.data(), dirty_l_.data(),
                          (int64_t)dirty_q_.size());
    }
    auto& out = per_read_[ri];
    for (int64_t i = 0; i < nm; ++i)
      out.push_back({dirty_q_[i], dirty_t_[i], dirty_l_[i]});
  }

  SeedIndex* idx_;
  int64_t min_len_;
  bool eligible_;
  Slot slots_[kW];
  std::vector<std::vector<SeedMem>> per_read_;
  std::vector<int64_t> env_scratch_;
  std::vector<int64_t> dirty_q_, dirty_t_, dirty_l_;
};

}  // namespace

// ---------------------------------------------------------------------------
// Batch pipeline host stages: chunk building + arbitration.
// Exact ports of thermite_tpu_torch/align/batch.py (_build_chunk /
// _arbitrate_chunk), which stay as the Python fallback + parity referee.
// ---------------------------------------------------------------------------

namespace {

struct IntervalTable {
  std::vector<int64_t> start, end, data, maxend;
  // payloads of intervals overlapping [s, e), in table order
  void find(int64_t s, int64_t e, std::vector<int64_t>* out) const {
    out->clear();
    if (start.empty() || e <= s) return;
    int64_t hi = std::lower_bound(start.begin(), start.end(), e) - start.begin();
    if (hi == 0) return;
    int64_t lo =
        std::upper_bound(maxend.begin(), maxend.begin() + hi, s) - maxend.begin();
    for (int64_t i = lo; i < hi; ++i)
      if (end[i] > s) out->push_back(data[i]);
  }
};

struct Engine {
  SeedIndex* seeds = nullptr;
  bool owns_seeds = true;
  int64_t min_seed_len;
  // refs (concatenated copies: fwd + revcomp per chromosome)
  std::vector<int64_t> ref_start, ref_end, ref_len, ref_rank;
  std::vector<uint8_t> ref_strand;
  // combined reference text (genome + tx spliced seqs); borrowed
  const uint8_t* ref_text;
  int64_t ref_text_len;
  // transcripts
  std::vector<int64_t> tx_off;       // n_txs+1 offsets into ref_text
  std::vector<int64_t> tx_exon_off;  // n_txs+1 offsets into exon arrays
  std::vector<int64_t> exon_start, exon_end;
  IntervalTable e2t, genes;
  // opts
  double pct;
  int64_t min_score, mm_range, intron_mode, match_score;
  // output string tables (thermite_engine_set_strings); one blob copy
  std::vector<uint8_t> str_blob;
  std::vector<int64_t> ref_name_off, gene_id_off, gene_name_off, tx_id_off;
  std::vector<int64_t> tx_gene;
  std::vector<int32_t> bam_ref;

  int64_t ref_of(int64_t idx) const {  // idx_to_ref binary search
    return std::upper_bound(ref_end.begin(), ref_end.end(), idx) -
           ref_end.begin();
  }
  int64_t tx_len(int64_t t) const { return tx_off[t + 1] - tx_off[t]; }
};

// task columns (kept int64; mirrors batch.py _Task)
enum {
  T_READ = 0, T_ISTX, T_HITREF, T_HITQ, T_HITLEN, T_LP, T_RP,
  T_REFLEN, T_SEQSTART, T_TXIDX, T_NCOL
};
// selected columns
enum {
  S_READ = 0, S_TASK, S_TYPE, S_GENE, S_REFID, S_SCORE,
  S_YS, S_YE, S_XS, S_XE, S_PRIMARY, S_NCOL
};
// aln types (match thermite_tpu_torch/align/types.py EXONIC/INTRONIC/INTERGENIC)
enum { A_EXONIC = 0, A_INTRONIC = 1, A_INTERGENIC = 2 };

struct Chunk {
  int64_t n_reads = 0;  // consumed
  std::vector<int64_t> read_len, read_minscore;
  std::vector<int32_t> meta;         // (P, 9) — layout.META_COLS
  std::vector<int64_t> tasks;        // (T, T_NCOL)
  std::vector<int64_t> read_task_off;  // (n_reads+1,)
  std::vector<int64_t> selected;     // (S, S_NCOL)
  std::vector<int64_t> winner_pids;
  // finalize outputs (RLE runs packed (op << 32) | len)
  std::vector<int64_t> fin_runs, fin_off;     // final chr-coord ops
  std::vector<int64_t> tx_runs, tx_off_runs;  // EXONIC tx_aln ops
  std::vector<int64_t> tx_meta;               // (S, 5) ys, ye, xs, xe, txlen
  std::vector<uint8_t> fallback;              // per-selected host-redo flag
  std::vector<uint8_t> emit;                  // serialized SAM/BAM records
  // paired-end state (thermite_chunk_pair): reads are interleaved
  // R1/R2, pair p = reads (2p, 2p+1).  Per-READ decision of the FR
  // pairing (mirrors thermite_tpu_torch/align/paired.py, the parity referee).
  bool paired = false;
  std::vector<int64_t> sel_off;    // (n_reads+1) selected-row ranges
  std::vector<int64_t> p_chosen;   // per read: chosen selected row, -1 none
  std::vector<int32_t> p_flag;     // per read: base FLAG bits (0x1|0x40/..)
  std::vector<uint8_t> p_proper;   // per read: proper pair
  std::vector<int64_t> p_mrefid;   // per read: mate chosen refid, -1 none
  std::vector<int64_t> p_mpos1;    // per read: mate chosen pos (1-based)
  std::vector<int64_t> p_tlen;     // per read: signed TLEN at rank 0
  std::vector<uint8_t> p_skip;     // per read: python splices this pair
  std::vector<int64_t> splice_pair;  // per skipped pair: pair index
  std::vector<int64_t> splice_off;   // per skipped pair: emit byte offset
  // the transcriptome path: problems whose window lies in the transcript
  // text (the build's), and the lifts of exonic alignments, [0] in
  // arbitration and [1] in finalize: how many, and their steady-clock
  // seconds summed over the call
  int64_t tx_problems = 0;
  int64_t lift_n[2] = {0, 0};
  double lift_s[2] = {0.0, 0.0};
  int64_t n_problems() const { return (int64_t)meta.size() / 9; }
  int64_t n_tasks() const { return (int64_t)tasks.size() / T_NCOL; }
};

// zero-byte padding the nibble-packed device text carries at both ends
// (MUST match ops/layout.py _WPAD)
constexpr int64_t kWpad = 512;

int64_t add_problem(Chunk* ch, int64_t yb, int64_t yd, int64_t yl, int64_t xb,
                    int64_t xd, int64_t xl, int64_t band, int64_t xdrop) {
  // the y anchor is split into (word, sub) of the nibble-packed text so
  // every device-side quantity stays int32 for texts up to ~17 Gbp
  int64_t lo = yb + kWpad;
  int32_t row[9] = {(int32_t)(lo >> 3), (int32_t)(lo & 7),
                    (int32_t)yd,   (int32_t)yl,   (int32_t)xb,
                    (int32_t)xd,   (int32_t)xl,   (int32_t)band,
                    (int32_t)xdrop};
  ch->meta.insert(ch->meta.end(), row, row + 9);
  return ch->n_problems() - 1;
}

// right + (reversed) left extension problems (batch.py _extend_problems)
void extend_problems(Chunk* ch, int64_t seed_y, int64_t seed_len, int64_t y_lo,
                     int64_t y_hi, int64_t read_off, int64_t q, int64_t rlen,
                     int64_t band, int64_t xdrop, int64_t* lp, int64_t* rp) {
  int64_t xlen_r = rlen - q - seed_len;
  int64_t yb_r = seed_y + seed_len;
  int64_t ylen_r = std::max(std::min(y_hi - yb_r, xlen_r + band + 1), (int64_t)0);
  *rp = add_problem(ch, yb_r, 1, ylen_r, read_off + q + seed_len, 1, xlen_r,
                    band, xdrop);
  int64_t xlen_l = q;
  int64_t ylen_l = std::max(std::min(seed_y - y_lo, xlen_l + band + 1), (int64_t)0);
  *lp = add_problem(ch, seed_y - 1, -1, ylen_l, read_off + q - 1, -1, xlen_l,
                    band, xdrop);
}

// lift_mem_to_tx (txome.py:119-137): clip MEM to first intersecting exon
bool lift_mem_to_tx(const Engine& E, int64_t tx, int64_t mref, int64_t mq,
                    int64_t mlen, int64_t* oref, int64_t* oq, int64_t* olen) {
  int64_t exon_sum = 0;
  for (int64_t e = E.tx_exon_off[tx]; e < E.tx_exon_off[tx + 1]; ++e) {
    int64_t es = E.exon_start[e], ee = E.exon_end[e];
    int64_t a0 = mref, a1 = mref + mlen;
    if ((es <= a0 && a0 < ee) || (a0 <= es && es < a1)) {
      int64_t start = std::max(mref - es, (int64_t)0) + exon_sum;
      int64_t start_offset = std::max(es - mref, (int64_t)0);
      int64_t end = std::min(mref + mlen, ee) - es + exon_sum;
      *oref = start;
      *oq = mq + start_offset;
      *olen = end - start;
      return true;
    }
    exon_sum += ee - es;
  }
  return false;
}

// extend_seed_match (align/extend.py:68-82)
void extend_seed_match(const uint8_t* seq, int64_t seq_len, const uint8_t* read,
                       int64_t rlen, int64_t* ref_idx, int64_t* q_idx,
                       int64_t* len) {
  int64_t r = *ref_idx, q = *q_idx, l = *len;
  while (r + l < seq_len && q + l < rlen && seq[r + l] == read[q + l]) ++l;
  while (r > 0 && q > 0 && seq[r - 1] == read[q - 1]) {
    --r; --q; ++l;
  }
  *ref_idx = r; *q_idx = q; *len = l;
}

// lift_tx_span_to_gx (index/span_lift.py)
void lift_tx_span(const Engine& E, int64_t tx, int64_t ys, int64_t ye,
                  bool trailing_nonref, int64_t* gys, int64_t* gye) {
  int64_t e0 = E.tx_exon_off[tx], e1 = E.tx_exon_off[tx + 1];
  auto elen = [&](int64_t k) { return E.exon_end[k] - E.exon_start[k]; };
  int64_t exon_sum = 0, k0 = e0;
  while (exon_sum + elen(k0) <= ys) {
    exon_sum += elen(k0);
    ++k0;
  }
  *gys = E.exon_start[k0] + (ys - exon_sum);
  if (ye == ys) {
    *gye = E.exon_start[k0] + (ye - exon_sum);
    return;
  }
  int64_t k = k0, end_sum = exon_sum;
  while (k + 1 < e1 && end_sum + elen(k) <= ye - 1) {
    end_sum += elen(k);
    ++k;
  }
  if (trailing_nonref && k + 1 < e1 && end_sum + elen(k) <= ye) {
    end_sum += elen(k);
    ++k;
  }
  *gye = E.exon_start[k] + (ye - end_sum);
}

// _span_to_chr (batch.py): concatenated span -> chromosome-local span
void span_to_chr(const Engine& E, int64_t gys, int64_t gye, int64_t* ys,
                 int64_t* ye) {
  int64_t r = E.ref_of(gys);
  if (E.ref_strand[r]) {
    *ys = gys - E.ref_start[r];
    *ye = gye - E.ref_start[r];
  } else {
    *ys = E.ref_len[r] - (gye - E.ref_start[r]);
    *ye = E.ref_len[r] - (gys - E.ref_start[r]);
  }
}

}  // namespace

extern "C" {

void* thermite_engine_new(
    void* seeds_handle,  // borrow an existing seed index (may be null)
    const uint8_t* text, int64_t text_len, int64_t min_seed_len, int64_t k,
    int64_t n_refs, const int64_t* ref_start, const int64_t* ref_end,
    const uint8_t* ref_strand, const int64_t* ref_len, const int64_t* ref_rank,
    const uint8_t* ref_text, int64_t ref_text_len, int64_t n_txs,
    const int64_t* tx_off, const int64_t* tx_exon_off, int64_t n_exons,
    const int64_t* exon_start, const int64_t* exon_end, int64_t n_e2t,
    const int64_t* e2t_start, const int64_t* e2t_end, const int64_t* e2t_data,
    const int64_t* e2t_maxend, int64_t n_gi, const int64_t* gi_start,
    const int64_t* gi_end, const int64_t* gi_data, const int64_t* gi_maxend,
    double pct, int64_t min_score, int64_t mm_range, int64_t intron_mode,
    int64_t match_score) {
  // problems encode the y anchor as (nibble word, sub-offset) int32
  // pairs: word indices fit int32 for texts up to 2^34 bytes (~17 Gbp
  // incl. revcomp — any earthly genome); beyond that, fail loudly
  if (ref_text_len > (((int64_t)1 << 34) - 4 * kWpad)) return nullptr;
  auto* E = new Engine();
  if (seeds_handle) {
    E->seeds = static_cast<SeedIndex*>(seeds_handle);
    E->owns_seeds = false;
  } else {
    E->seeds = static_cast<SeedIndex*>(
        thermite_seed_index_new(text, text_len, (int)k));
    E->owns_seeds = true;
  }
  if (!E->seeds) {
    delete E;
    return nullptr;
  }
  E->min_seed_len = min_seed_len;
  E->ref_start.assign(ref_start, ref_start + n_refs);
  E->ref_end.assign(ref_end, ref_end + n_refs);
  E->ref_strand.assign(ref_strand, ref_strand + n_refs);
  E->ref_len.assign(ref_len, ref_len + n_refs);
  E->ref_rank.assign(ref_rank, ref_rank + n_refs);
  E->ref_text = ref_text;
  E->ref_text_len = ref_text_len;
  E->tx_off.assign(tx_off, tx_off + n_txs + 1);
  E->tx_exon_off.assign(tx_exon_off, tx_exon_off + n_txs + 1);
  E->exon_start.assign(exon_start, exon_start + n_exons);
  E->exon_end.assign(exon_end, exon_end + n_exons);
  E->e2t.start.assign(e2t_start, e2t_start + n_e2t);
  E->e2t.end.assign(e2t_end, e2t_end + n_e2t);
  E->e2t.data.assign(e2t_data, e2t_data + n_e2t);
  E->e2t.maxend.assign(e2t_maxend, e2t_maxend + n_e2t);
  E->genes.start.assign(gi_start, gi_start + n_gi);
  E->genes.end.assign(gi_end, gi_end + n_gi);
  E->genes.data.assign(gi_data, gi_data + n_gi);
  E->genes.maxend.assign(gi_maxend, gi_maxend + n_gi);
  E->pct = pct;
  E->min_score = min_score;
  E->mm_range = mm_range;
  E->intron_mode = intron_mode;
  E->match_score = match_score;
  return E;
}

void thermite_engine_free(void* h) {
  auto* E = static_cast<Engine*>(h);
  if (E->seeds && E->owns_seeds) thermite_seed_index_free(E->seeds);
  delete E;
}

}  // extern "C"

namespace {

// Per-read build worker state + output (thread-reusable scratch and a
// local chunk fragment whose problem ids are read-local; the serial
// merge rebases them).  The per-read body is shared verbatim between
// the sequential path and the threaded one, so outputs are identical
// bit for bit regardless of thread count.
struct ReadBuild {
  std::vector<int32_t> meta;   // (p, 9) local problems
  std::vector<int64_t> tasks;  // (t, T_NCOL) with local lp/rp, read_i=0
  int64_t rlen = 0, min_aln = 0;
  int64_t tx_problems = 0;  // of meta: those in transcript windows
};

struct BuildScratch {
  std::vector<int64_t> mq, mt, ml, tx_cands;
  BuildScratch() { mq.resize(4096); mt.resize(4096); ml.resize(4096); }
};

void build_one_read(const Engine& E, const uint8_t* read, int64_t rlen,
                    int64_t read_off, BuildScratch& S, ReadBuild* out,
                    const SeedMem* pre = nullptr, int64_t npre = 0) {
  out->meta.clear();
  out->tasks.clear();
  out->rlen = rlen;
  out->tx_problems = 0;
  int64_t min_aln = std::max((int64_t)(E.pct * (double)rlen), E.min_score);
  out->min_aln = min_aln;
  int64_t band = std::max(rlen - min_aln, (int64_t)0);
  int64_t xdrop = band;

  // local problem emitter (Chunk::meta layout, read-local ids)
  Chunk local;
  int64_t nm;
  if (pre != nullptr) {
    // pre-seeded by the interleaved engine (sequential chunk builds)
    nm = npre;
    if ((int64_t)S.mq.size() < nm) {
      S.mq.resize(nm); S.mt.resize(nm); S.ml.resize(nm);
    }
    for (int64_t i = 0; i < nm; ++i) {
      S.mq[i] = pre[i].q;
      S.mt[i] = pre[i].t;
      S.ml[i] = pre[i].len;
    }
  } else {
    nm = thermite_smems(E.seeds, read, rlen, E.min_seed_len,
                        S.mq.data(), S.mt.data(), S.ml.data(),
                        (int64_t)S.mq.size());
    if (nm < 0) {
      S.mq.resize(-nm); S.mt.resize(-nm); S.ml.resize(-nm);
      nm = thermite_smems(E.seeds, read, rlen, E.min_seed_len, S.mq.data(),
                          S.mt.data(), S.ml.data(), (int64_t)S.mq.size());
    }
  }
  for (int64_t m = 0; m < nm; ++m) {
    int64_t hq = S.mq[m], href = S.mt[m], hlen = S.ml[m];
    int64_t r = E.ref_of(href);

    // genome window (reference src/aligner.rs:209-227)
    int64_t seq_start = std::max(href - (rlen + band), E.ref_start[r]);
    int64_t seq_end = std::min(href + hlen + rlen + band, E.ref_end[r] - 1);
    int64_t lp, rp;
    extend_problems(&local, href, hlen, seq_start, seq_end, read_off, hq,
                    rlen, band, xdrop, &lp, &rp);
    int64_t row[T_NCOL] = {0,        0,  href - seq_start, hq, hlen,
                           lp,       rp, seq_end - seq_start,
                           seq_start, -1};
    local.tasks.insert(local.tasks.end(), row, row + T_NCOL);

    // transcriptome candidates (src/aligner.rs:230-258), ascending tx
    E.e2t.find(href, href + hlen, &S.tx_cands);
    std::sort(S.tx_cands.begin(), S.tx_cands.end());
    S.tx_cands.erase(std::unique(S.tx_cands.begin(), S.tx_cands.end()),
                     S.tx_cands.end());
    for (int64_t tx : S.tx_cands) {
      int64_t sref, sq, slen;
      if (!lift_mem_to_tx(E, tx, href, hq, hlen, &sref, &sq, &slen))
        continue;  // Python raises; SMEM candidates always intersect
      const uint8_t* tseq = E.ref_text + E.tx_off[tx];
      int64_t tlen = E.tx_len(tx);
      extend_seed_match(tseq, tlen, read, rlen, &sref, &sq, &slen);
      int64_t base = E.tx_off[tx];
      int64_t y_lo = std::max(sref - (rlen + band), (int64_t)0);
      int64_t p0 = local.n_problems();
      extend_problems(&local, base + sref, slen, base + y_lo, base + tlen,
                      read_off, sq, rlen, band, xdrop, &lp, &rp);
      out->tx_problems += local.n_problems() - p0;
      int64_t trow[T_NCOL] = {0, 1, sref, sq, slen, lp, rp, tlen, 0, tx};
      local.tasks.insert(local.tasks.end(), trow, trow + T_NCOL);
    }
  }
  out->meta.swap(local.meta);
  out->tasks.swap(local.tasks);
}

// append one built read to the chunk, rebasing local problem/task ids
void merge_read(Chunk* ch, int64_t ri, const ReadBuild& rb) {
  int64_t pbase = ch->n_problems();
  ch->read_len.push_back(rb.rlen);
  ch->read_minscore.push_back(rb.min_aln);
  ch->read_task_off.push_back(ch->n_tasks());
  ch->n_reads = ri + 1;
  ch->tx_problems += rb.tx_problems;
  ch->meta.insert(ch->meta.end(), rb.meta.begin(), rb.meta.end());
  size_t t0 = ch->tasks.size();
  ch->tasks.insert(ch->tasks.end(), rb.tasks.begin(), rb.tasks.end());
  for (size_t t = t0; t < ch->tasks.size(); t += T_NCOL) {
    ch->tasks[t + T_READ] = ri;
    ch->tasks[t + T_LP] += pbase;
    ch->tasks[t + T_RP] += pbase;
  }
}

int build_threads() { return table_threads(); }

}  // namespace

extern "C" {

// Build tasks/problems for reads until the problem budget is reached.
// reads: (n_reads, rpad) row-major padded block. Returns a Chunk handle;
// the number of consumed reads is read back via thermite_chunk_n_reads.
//
// The per-read work (seed lookup + task construction) parallelizes
// across THERMITE_THREADS (default: hardware concurrency) worker
// threads — the reference's own concurrency contract is clone-across-
// threads over a shared index (src/wrapper.rs:20-27).  Reads merge
// back in input order with identical budget semantics (read ri is
// consumed iff fewer than `problem_budget` problems precede it), so
// output is bit-identical at any thread count (tests/test_native_seed
// ::test_threaded_build_identity).
// `paired` != 0: reads are interleaved R1/R2 and consumption only cuts
// at PAIR boundaries (the budget check runs at even reads), so a mate
// never lands in the next chunk.
void* thermite_chunk_build(void* h, const uint8_t* reads, int64_t n_reads,
                           int64_t rpad, const int64_t* read_lens,
                           int64_t problem_budget, int64_t paired) {
  auto& E = *static_cast<Engine*>(h);
  auto* ch = new Chunk();

  int nthreads = build_threads();
  if (nthreads <= 1 || n_reads < 64) {
    BuildScratch S;
    ReadBuild rb;
    // interleaved seeding pre-pass: seeds every OFFERED read (the
    // caller sizes the offer to ~1.25x the expected chunk — the same
    // tradeoff the threaded path makes) so the per-read probe chains
    // overlap in the memory system; consumption below is unchanged,
    // so output is bit-identical with or without it
    SeedInterleaver ilv(E.seeds, E.min_seed_len);
    std::vector<SeedMem> pre_mems;
    std::vector<int64_t> pre_off;
    const bool use_ilv = ilv.eligible() && n_reads >= 2 * SeedInterleaver::kW;
    if (use_ilv)
      ilv.seed_all(reads, rpad, read_lens, n_reads, &pre_mems, &pre_off);
    for (int64_t ri = 0; ri < n_reads; ++ri) {
      if ((!paired || (ri & 1) == 0) && ch->n_problems() >= problem_budget)
        break;
      if (use_ilv)
        build_one_read(E, reads + ri * rpad, read_lens[ri], ri * rpad, S,
                       &rb, pre_mems.data() + pre_off[ri],
                       pre_off[ri + 1] - pre_off[ri]);
      else
        build_one_read(E, reads + ri * rpad, read_lens[ri], ri * rpad, S,
                       &rb);
      merge_read(ch, ri, rb);
    }
    ch->read_task_off.push_back(ch->n_tasks());
    return ch;
  }

  // threaded: build every offered read in parallel (the caller sizes
  // the offer to ~1.25x the expected chunk), then merge in order until
  // the budget cuts — identical consumption rule to the sequential path
  std::vector<ReadBuild> built(n_reads);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    BuildScratch S;
    while (true) {
      int64_t ri = next.fetch_add(1, std::memory_order_relaxed);
      if (ri >= n_reads) break;
      build_one_read(E, reads + ri * rpad, read_lens[ri], ri * rpad, S,
                     &built[ri]);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads - 1; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();

  for (int64_t ri = 0; ri < n_reads; ++ri) {
    if ((!paired || (ri & 1) == 0) && ch->n_problems() >= problem_budget)
      break;
    merge_read(ch, ri, built[ri]);
  }
  ch->read_task_off.push_back(ch->n_tasks());
  return ch;
}

void thermite_chunk_free(void* ch) { delete static_cast<Chunk*>(ch); }
int64_t thermite_chunk_n_reads(void* ch) {
  return static_cast<Chunk*>(ch)->n_reads;
}
int64_t thermite_chunk_n_problems(void* ch) {
  return static_cast<Chunk*>(ch)->n_problems();
}
int64_t thermite_chunk_n_tasks(void* ch) {
  return static_cast<Chunk*>(ch)->n_tasks();
}
const int32_t* thermite_chunk_meta(void* ch) {
  return static_cast<Chunk*>(ch)->meta.data();
}
const int64_t* thermite_chunk_tasks(void* ch) {
  return static_cast<Chunk*>(ch)->tasks.data();
}

// Post-kernel arbitration (batch.py _arbitrate_chunk rules; reference
// src/aligner.rs:143-190 + 263-313).  Three passes: each read's
// candidates (one a seed group, the transcript's when it scores at
// least the genome's), then the lifts of the exonic candidates that pass
// the filters, timed as one interval (lift_n/lift_s[0]), then each
// read's selection.
void thermite_chunk_arbitrate(void* eh, void* chh, const int32_t* scores,
                              const int32_t* mi, const int32_t* mj) {
  auto& E = *static_cast<Engine*>(eh);
  auto& ch = *static_cast<Chunk*>(chh);
  ch.selected.clear();
  ch.winner_pids.clear();

  struct Cand {  // one chosen alignment per seed group
    int64_t task, type, gene, refid, score, ys, ye, xs, xe, rank, strand;
    int64_t tx, tys, tye;  // exonic: the transcript span to lift
    bool trailing_nonref;
  };
  std::vector<Cand> cands, kept, res;
  std::vector<int64_t> cand_off(1, 0), exonic, gidx;

  auto task = [&](int64_t t, int c) { return ch.tasks[t * T_NCOL + c]; };

  for (int64_t ri = 0; ri < ch.n_reads; ++ri) {
    int64_t t0 = ch.read_task_off[ri], t1 = ch.read_task_off[ri + 1];
    int64_t rlen = ch.read_len[ri];
    int64_t min_aln = ch.read_minscore[ri];

    int64_t t = t0;
    while (t < t1) {
      // group: one gx task + its tx tasks
      int64_t gx = t++;
      int64_t lp = task(gx, T_LP), rp = task(gx, T_RP);
      int64_t gx_score =
          scores[lp] + E.match_score * task(gx, T_HITLEN) + scores[rp];
      int64_t abs_ref = task(gx, T_SEQSTART) + task(gx, T_HITREF);
      int64_t gys = abs_ref - mj[lp];
      int64_t gye = abs_ref + task(gx, T_HITLEN) + mj[rp];
      int64_t gxs = task(gx, T_HITQ) - mi[lp];
      int64_t gxe = task(gx, T_HITQ) + task(gx, T_HITLEN) + mi[rp];

      // best transcript (first max; early break on perfect score)
      int64_t best = -1, best_score = 0;
      int64_t tys = 0, tye = 0, txs = 0, txe = 0;
      while (t < t1 && task(t, T_ISTX)) {
        int64_t tl = task(t, T_LP), tr = task(t, T_RP);
        int64_t sc = scores[tl] + E.match_score * task(t, T_HITLEN) + scores[tr];
        if (best < 0 || sc > best_score) {
          best = t;
          best_score = sc;
          tys = task(t, T_HITREF) - mj[tl];
          tye = task(t, T_HITREF) + task(t, T_HITLEN) + mj[tr];
          txs = task(t, T_HITQ) - mi[tl];
          txe = task(t, T_HITQ) + task(t, T_HITLEN) + mi[tr];
        }
        ++t;
        if (sc >= rlen * E.match_score) {  // perfect score
          while (t < t1 && task(t, T_ISTX)) ++t;  // skip rest of group
          break;
        }
      }

      int64_t hit_r = E.ref_of(abs_ref);
      Cand c;
      c.refid = hit_r;
      c.rank = E.ref_rank[hit_r];
      c.strand = E.ref_strand[hit_r];
      if (best >= 0 && best_score >= gx_score) {
        c.task = best;
        c.type = A_EXONIC;
        c.gene = -1;
        c.score = best_score;
        c.tx = task(best, T_TXIDX);
        c.tys = tys;
        c.tye = tye;
        c.trailing_nonref = txe < rlen;
        c.xs = txs;
        c.xe = txe;
      } else {
        E.genes.find(gys, gye, &gidx);
        c.task = gx;
        c.type = gidx.empty() ? A_INTERGENIC : A_INTRONIC;
        c.gene = gidx.empty() ? -1 : gidx[0];
        c.score = gx_score;
        span_to_chr(E, gys, gye, &c.ys, &c.ye);
        c.xs = gxs;
        c.xe = gxe;
      }

      if (!E.intron_mode && c.type != A_EXONIC) continue;
      if (c.score < E.min_score || c.score < min_aln) continue;
      if (c.type == A_EXONIC) exonic.push_back((int64_t)cands.size());
      cands.push_back(c);
    }
    cand_off.push_back((int64_t)cands.size());
  }

  // the transcriptome lifts: transcript span -> chromosome span
  auto lift_t0 = std::chrono::steady_clock::now();
  for (int64_t k : exonic) {
    Cand& c = cands[k];
    int64_t lys, lye;
    lift_tx_span(E, c.tx, c.tys, c.tye, c.trailing_nonref, &lys, &lye);
    span_to_chr(E, lys, lye, &c.ys, &c.ye);
  }
  ch.lift_s[0] = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - lift_t0).count();
  ch.lift_n[0] = (int64_t)exonic.size();

  for (int64_t ri = 0; ri < ch.n_reads; ++ri) {
    const Cand* c0 = cands.data() + cand_off[ri];
    const Cand* c1 = cands.data() + cand_off[ri + 1];
    int64_t max_score = ch.read_minscore[ri];
    for (const Cand* c = c0; c < c1; ++c) max_score = std::max(max_score, c->score);
    kept.clear();
    for (const Cand* c = c0; c < c1; ++c)
      if (c->score >= max_score - E.mm_range) kept.push_back(*c);

    // filter_overlapping (driver.py / reference src/aligner.rs:317-349):
    // stable sort by (name, strand, ystart), then linear max-end dedupe
    std::stable_sort(kept.begin(), kept.end(), [](const Cand& a, const Cand& b) {
      if (a.rank != b.rank) return a.rank < b.rank;
      if (a.strand != b.strand) return a.strand < b.strand;
      return a.ys < b.ys;
    });
    res.clear();
    int64_t max_end = 0;
    for (const auto& c : kept) {
      if (res.empty() || c.ys >= max_end || c.rank != res.back().rank ||
          c.strand != res.back().strand) {
        max_end = c.ye;
        res.push_back(c);
      } else {
        if (c.score > res.back().score) res.back() = c;
        max_end = std::max(max_end, res.back().ye);
      }
    }
    std::stable_sort(res.begin(), res.end(),
                     [](const Cand& a, const Cand& b) { return a.score > b.score; });

    for (size_t s = 0; s < res.size(); ++s) {
      const auto& c = res[s];
      int64_t row[S_NCOL] = {ri,      c.task, c.type, c.gene, c.refid, c.score,
                             c.ys,    c.ye,   c.xs,   c.xe,   s == 0 ? 1 : 0};
      ch.selected.insert(ch.selected.end(), row, row + S_NCOL);
      ch.winner_pids.push_back(task(c.task, T_LP));
      ch.winner_pids.push_back(task(c.task, T_RP));
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Finalize: decode device traceback streams, stitch around the seed,
// lift transcript alignments through exons (inserting intron skips),
// normalise '-'-strand coords, and emit final RLE op runs.
// Ports of ops/runs.py decode_stream_batch + align/extend.py stitch +
// index/txome.py lift_tx_to_gx + align/driver.py concat_to_chr_aln.
// ---------------------------------------------------------------------------

namespace {

// run op codes: 0..3 = DIR M/S/D/I; 4 = SC (query soft clip);
// 5 = N (intron skip).  Packed (op << 32) | len in int64.
enum { OP_M = 0, OP_S = 1, OP_D = 2, OP_I = 3, OP_SC = 4, OP_N = 5 };

inline int64_t pack_run(int64_t op, int64_t len) { return (op << 32) | len; }

struct RunAln {  // a decoded/stitched alignment as RLE runs
  std::vector<int64_t> runs;
  int64_t score, ystart, yend, xstart, xend;
  void push(int64_t op, int64_t len) {
    if (len <= 0) return;
    if (!runs.empty() && (runs.back() >> 32) == op && op < OP_SC)
      runs.back() += len;
    else
      runs.push_back(pack_run(op, len));
  }
};

// decode one problem's backward-order 2-bit stream into forward runs
// (ops/runs.py decode_stream_batch semantics, runs not per-cell ops)
bool decode_stream(const int32_t* row, int64_t pw, int64_t xlen,
                   std::vector<int64_t>* runs, int64_t* score, int64_t* max_i,
                   int64_t* max_j) {
  *score = row[0];
  *max_i = row[1];
  *max_j = row[2];
  int64_t n = row[3];
  if (n < 0 || n > pw * 16) return false;  // flagged/corrupt: host fallback
  runs->clear();
  // stream is backward; walk from the end to emit forward order
  int64_t prev_op = -1, len = 0;
  for (int64_t s = n - 1; s >= 0; --s) {
    int64_t w = (uint32_t)row[4 + (s >> 4)];
    int64_t op = (w >> (2 * (s & 15))) & 3;
    if (op == prev_op) {
      ++len;
    } else {
      if (len) runs->push_back(pack_run(prev_op, len));
      prev_op = op;
      len = 1;
    }
  }
  if (len) runs->push_back(pack_run(prev_op, len));
  if (*max_i < xlen) runs->push_back(pack_run(OP_SC, xlen - *max_i));
  return true;
}

// stitch (align/extend.py:17-43) on runs: reversed(left) + M*seed + right
void stitch_runs(const RunAln& left, const RunAln& right, int64_t hit_ref,
                 int64_t hit_q, int64_t hit_len, int64_t match_score,
                 RunAln* out) {
  out->runs.clear();
  out->score = left.score + match_score * hit_len + right.score;
  out->ystart = hit_ref - left.yend;
  out->yend = hit_ref + hit_len + right.yend;
  out->xstart = hit_q - left.xend;
  out->xend = hit_q + hit_len + right.xend;
  for (auto it = left.runs.rbegin(); it != left.runs.rend(); ++it)
    out->push(*it >> 32, *it & 0xffffffff);
  out->push(OP_M, hit_len);
  for (int64_t r : right.runs) out->push(r >> 32, r & 0xffffffff);
}

// lift_tx_to_gx (index/txome.py:140-174) on runs
void lift_runs(const Engine& E, int64_t tx, const RunAln& in, RunAln* out) {
  int64_t e0 = E.tx_exon_off[tx], e1 = E.tx_exon_off[tx + 1];
  auto elen = [&](int64_t k) { return E.exon_end[k] - E.exon_start[k]; };
  int64_t i = in.ystart, exon_sum = 0, k = e0;
  while (exon_sum + elen(k) <= i) {
    exon_sum += elen(k);
    ++k;
  }
  out->runs.clear();
  out->score = in.score;
  out->xstart = in.xstart;
  out->xend = in.xend;
  out->ystart = E.exon_start[k] + (i - exon_sum);
  auto advance = [&]() {
    if (k + 1 < e1 && exon_sum + elen(k) <= i) {
      exon_sum += elen(k);
      ++k;
      out->push(OP_N, E.exon_start[k] - E.exon_end[k - 1]);
      return true;
    }
    return false;
  };
  for (int64_t r : in.runs) {
    int64_t op = r >> 32, len = r & 0xffffffff;
    if (op == OP_M || op == OP_S || op == OP_D) {
      int64_t rem = len;
      while (rem) {
        advance();
        int64_t room = exon_sum + elen(k) - i;
        int64_t take = std::min(rem, room);
        out->push(op, take);
        i += take;
        rem -= take;
      }
    } else {
      // non-ref-consuming run: the boundary check fires once (before
      // its first element); i does not move
      advance();
      out->push(op, len);
    }
  }
  out->yend = E.exon_start[k] + (i - exon_sum);
}

// concat_to_chr_aln (align/driver.py:212-231) on runs
void chr_runs(const Engine& E, RunAln* a) {
  int64_t r = E.ref_of(a->ystart);
  if (E.ref_strand[r]) {
    a->ystart -= E.ref_start[r];
    a->yend -= E.ref_start[r];
  } else {
    int64_t ys = E.ref_len[r] - (a->yend - E.ref_start[r]);
    int64_t ye = E.ref_len[r] - (a->ystart - E.ref_start[r]);
    a->ystart = ys;
    a->yend = ye;
    std::reverse(a->runs.begin(), a->runs.end());
  }
}

}  // namespace

extern "C" {

// Finalize all selected alignments of an arbitrated chunk.
// tb_out: (n_rows, 4 + pw) int32 stream-traceback output rows indexed
// BY PROBLEM ID (the single-pass pipeline runs the stream kernel on
// every nontrivial problem; trivial problems have all-zero rows).
// tb_meta: (n_rows, 9) int32 problem meta (for xlen).
// Returns 0 on success, -(s+1) if the finalized span/score of selected
// s disagrees with arbitration (the first such s; a bug), and fills
// per-selected outputs readable via getters.  Rows whose stream was
// flagged get fallback=1 and empty runs (host recomputes those in
// Python).  Two passes and an assembly: decode and stitch every selected
// (the genome ones placed on their chromosome, the exonic ones kept as
// their transcript payload), then lift the exonic ones through their
// exons, timed as one interval (lift_n/lift_s[1]), then the runs in
// selected order.
int64_t thermite_chunk_finalize(void* eh, void* chh, const int32_t* tb_out,
                                int64_t n_rows, int64_t pw,
                                const int32_t* tb_meta) {
  auto& E = *static_cast<Engine*>(eh);
  auto& ch = *static_cast<Chunk*>(chh);
  int64_t S = (int64_t)ch.selected.size() / S_NCOL;
  ch.fin_runs.clear();
  ch.fin_off.assign(1, 0);
  ch.tx_runs.clear();
  ch.tx_off_runs.assign(1, 0);
  ch.tx_meta.assign(S * 5, 0);
  ch.fallback.assign(S, 0);

  RunAln left, right, stitched, lifted;
  std::vector<int64_t> runs, run_lo(S, 0), run_hi(S, 0), exonic, ex_score;
  int64_t bad = S;  // the first selected that disagrees with arbitration
  auto place = [&](int64_t s, const RunAln& fin) {
    const int64_t* sel = ch.selected.data() + s * S_NCOL;
    if (fin.ystart != sel[S_YS] || fin.yend != sel[S_YE] ||
        fin.score != sel[S_SCORE])
      bad = std::min(bad, s);
    run_lo[s] = (int64_t)runs.size();
    runs.insert(runs.end(), fin.runs.begin(), fin.runs.end());
    run_hi[s] = (int64_t)runs.size();
  };
  for (int64_t s = 0; s < S; ++s) {
    const int64_t* sel = ch.selected.data() + s * S_NCOL;
    const int64_t* tk = ch.tasks.data() + sel[S_TASK] * T_NCOL;
    int64_t lrow = tk[T_LP], rrow = tk[T_RP];
    if (lrow >= n_rows || rrow >= n_rows) return -1000000 - s;
    int64_t ls, li, lj, rs2, ri2, rj2;
    bool okl = decode_stream(tb_out + lrow * (4 + pw), pw,
                             tb_meta[lrow * 9 + 6], &left.runs, &ls, &li, &lj);
    bool okr = decode_stream(tb_out + rrow * (4 + pw), pw,
                             tb_meta[rrow * 9 + 6], &right.runs, &rs2, &ri2,
                             &rj2);
    if (!okl || !okr) {
      ch.fallback[s] = 1;
      ch.tx_off_runs.push_back((int64_t)ch.tx_runs.size());
      continue;
    }
    left.score = ls; left.xend = li; left.yend = lj;
    right.score = rs2; right.xend = ri2; right.yend = rj2;
    stitch_runs(left, right, tk[T_HITREF], tk[T_HITQ], tk[T_HITLEN],
                E.match_score, &stitched);

    if (sel[S_TYPE] == A_EXONIC) {
      // tx_aln payload (stitched, tx coords): also the lift's input
      ch.tx_runs.insert(ch.tx_runs.end(), stitched.runs.begin(),
                        stitched.runs.end());
      int64_t* tm = ch.tx_meta.data() + s * 5;
      tm[0] = stitched.ystart; tm[1] = stitched.yend;
      tm[2] = stitched.xstart; tm[3] = stitched.xend;
      tm[4] = tk[T_REFLEN];  // tx length
      exonic.push_back(s);
      ex_score.push_back(stitched.score);
    } else {
      stitched.ystart += tk[T_SEQSTART];
      stitched.yend += tk[T_SEQSTART];
      chr_runs(E, &stitched);
      place(s, stitched);
    }
    ch.tx_off_runs.push_back((int64_t)ch.tx_runs.size());
  }

  // the transcriptome lifts: transcript alignment -> chromosome, with N
  // skips over the introns
  auto lift_t0 = std::chrono::steady_clock::now();
  for (size_t k = 0; k < exonic.size(); ++k) {
    int64_t s = exonic[k];
    const int64_t* tm = ch.tx_meta.data() + s * 5;
    stitched.runs.assign(ch.tx_runs.begin() + ch.tx_off_runs[s],
                         ch.tx_runs.begin() + ch.tx_off_runs[s + 1]);
    stitched.ystart = tm[0]; stitched.yend = tm[1];
    stitched.xstart = tm[2]; stitched.xend = tm[3];
    stitched.score = ex_score[k];
    const int64_t* sel = ch.selected.data() + s * S_NCOL;
    lift_runs(E, ch.tasks[sel[S_TASK] * T_NCOL + T_TXIDX], stitched, &lifted);
    chr_runs(E, &lifted);
    place(s, lifted);
  }
  ch.lift_s[1] = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - lift_t0).count();
  ch.lift_n[1] = (int64_t)exonic.size();

  for (int64_t s = 0; s < S; ++s) {
    ch.fin_runs.insert(ch.fin_runs.end(), runs.begin() + run_lo[s],
                       runs.begin() + run_hi[s]);
    ch.fin_off.push_back((int64_t)ch.fin_runs.size());
  }
  return bad < S ? -(bad + 1) : 0;
}

int64_t thermite_chunk_fin_nruns(void* ch) {
  return (int64_t)static_cast<Chunk*>(ch)->fin_runs.size();
}
const int64_t* thermite_chunk_fin_runs(void* ch) {
  return static_cast<Chunk*>(ch)->fin_runs.data();
}
const int64_t* thermite_chunk_fin_off(void* ch) {
  return static_cast<Chunk*>(ch)->fin_off.data();
}
int64_t thermite_chunk_tx_nruns(void* ch) {
  return (int64_t)static_cast<Chunk*>(ch)->tx_runs.size();
}
const int64_t* thermite_chunk_tx_runs(void* ch) {
  return static_cast<Chunk*>(ch)->tx_runs.data();
}
const int64_t* thermite_chunk_tx_run_off(void* ch) {
  return static_cast<Chunk*>(ch)->tx_off_runs.data();
}
const int64_t* thermite_chunk_tx_meta(void* ch) {
  return static_cast<Chunk*>(ch)->tx_meta.data();
}
const uint8_t* thermite_chunk_fallback(void* ch) {
  return static_cast<Chunk*>(ch)->fallback.data();
}
int64_t thermite_chunk_tx_problems(void* ch) {
  return static_cast<Chunk*>(ch)->tx_problems;
}
// the exonic lifts of the last arbitration (stage 0) or finalize (1) of
// the chunk: their count, and their seconds into *s
int64_t thermite_chunk_lift(void* chh, int64_t stage, double* s) {
  auto& ch = *static_cast<Chunk*>(chh);
  *s = ch.lift_s[stage];
  return ch.lift_n[stage];
}

int64_t thermite_chunk_n_selected(void* ch) {
  return (int64_t)static_cast<Chunk*>(ch)->selected.size() / S_NCOL;
}
const int64_t* thermite_chunk_selected(void* ch) {
  return static_cast<Chunk*>(ch)->selected.data();
}
int64_t thermite_chunk_n_winners(void* ch) {
  return (int64_t)static_cast<Chunk*>(ch)->winner_pids.size();
}
const int64_t* thermite_chunk_winners(void* ch) {
  return static_cast<Chunk*>(ch)->winner_pids.data();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Scalar banded SWG extension (exact mirror of the Python oracle
// thermite_tpu_torch/ops/swg_ref.py, itself the cleaned-up semantic of
// reference src/swg.rs:31-240): anchored at (0,0), free end at the
// global max cell, banded, affine gaps, X-drop early termination,
// diag > del > ins tie priority, strictly-greater max updates.
//
// Output is the stream-traceback kernel's packed row format
// ([score, max_i, max_j, nsteps, 2-bit dir codes 16/word in BACKWARD
// walk order]), so the host can splice oracle-computed rows into the
// device output unchanged.  Used (a) to patch the rare problems whose
// narrow-band device pass fails its exactness certificate, and (b) as
// the all-native single-core baseline engine.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t kMatch = 1, kMismatch = -1, kGapOpen = -1, kGapExtend = -1;
constexpr int32_t kMinScore = -(1 << 30);
enum { D_MATCH = 0, D_SUBST = 1, D_DEL = 2, D_INS = 3 };

struct SwgScratch {
  std::vector<int32_t> D, C, R;
  std::vector<uint8_t> trace;  // (ylen+1, w) dir codes
};

// walk from (max_i, max_j) back to (0,0), packing 2-bit codes in
// backward order, 16 per int32 word.  Returns nsteps or -1 on overflow.
int64_t pack_walk(const SwgScratch& S, int64_t w, int64_t band, int64_t mi,
                  int64_t mj, int32_t* words, int64_t pw) {
  int64_t i = mi, j = mj, n = 0;
  const int64_t cap = pw * 16;
  while (i > 0 || j > 0) {
    int64_t lo = j - band;
    int64_t bi = i - (lo > 0 ? lo : 0);
    if (bi < 0) bi = 0;
    if (bi > w - 1) bi = w - 1;
    int32_t d = S.trace[j * w + bi];
    if (n >= cap) return -1;
    words[n >> 4] |= d << (2 * (n & 15));
    ++n;
    if (d == D_MATCH || d == D_SUBST) { --i; --j; }
    else if (d == D_INS) { --i; }
    else { --j; }
  }
  return n;
}

// one banded SWG extension into a packed stream row (4 + pw int32s,
// caller-zeroed).  Returns 0, or -1 if the walk overflowed pw.
//
// When `cert_out` is non-null, also evaluates the band-exactness
// certificate (same soundness argument as the device kernel,
// ops/swg_stream.py stream-kernel docstring): *cert_out
// is set to 1 iff the SAME problem at ANY wider band (ylen re-clamped
// accordingly, same x_drop) provably yields a bit-identical row.
// Tracked per column j: E(j) = min(j, xlen)*M + o + (band+1)*e bounds
// any out-of-band path prefix; (a) every pre-stop column's band max
// must exceed E(j) - x_drop, (b) the final max must strictly exceed
// E(j_stop) + x_drop on a real x-drop stop, or E(ylen) on completion.
int64_t swg_stream_row(SwgScratch& S, const uint8_t* x, int64_t xlen,
                       const uint8_t* y, int64_t ylen, int64_t band,
                       int64_t xdrop, int32_t* out, int64_t pw,
                       int32_t* cert_out = nullptr) {
  if (cert_out) *cert_out = 1;  // trivial rows are band-independent
  if (xlen <= 0 || ylen <= 0) return 0;  // trivial: all-zero row
  const int64_t w = 2 * band + 1;
  S.D.assign(w, 0);
  S.C.assign(w, 0);
  S.R.assign(w, 0);
  S.trace.assign((size_t)((ylen + 1) * w), D_MATCH);
  int32_t* D = S.D.data();
  int32_t* C = S.C.data();
  int32_t* R = S.R.data();
  uint8_t* tr = S.trace.data();

  int32_t max_score = 0;
  int64_t max_i = 0, max_j = 0;

  // certificate state (only maintained when cert_out != nullptr)
  const int64_t e_ladder = kGapOpen + (band + 1) * (int64_t)kGapExtend;
  const int64_t ub_final = xlen * (int64_t)kMatch + e_ladder;
  int64_t cmin = int64_t(1) << 40;  // "no pre-stop column yet"
  int64_t ecap = ub_final;
  bool rstop = false;

  // column 0: gap ladder, Ins trace
  tr[0] = D_INS;
  for (int64_t i = 1; i < w; ++i) {
    C[i] = kMinScore;
    R[i] = (int32_t)(i * kGapExtend + kGapOpen);
    D[i] = R[i];
    tr[i] = D_INS;
  }

  bool stopped = false;
  // phase 1: band anchored at row 0
  int64_t p1_end = band < ylen ? band : ylen;
  for (int64_t j = 1; j <= p1_end && !stopped; ++j) {
    int32_t band_max = kMinScore;
    int32_t prev_D = kMinScore;
    int64_t ilim = w < xlen + 1 ? w : xlen + 1;
    for (int64_t i = 0; i < ilim; ++i) {
      int32_t cc = C[i] + kGapExtend;
      int32_t cd = D[i] + kGapExtend + kGapOpen;
      C[i] = cc > cd ? cc : cd;
      if (i == 0) {
        R[i] = kMinScore;
      } else {
        int32_t rr = R[i - 1] + kGapExtend;
        int32_t rd = D[i - 1] + kGapExtend + kGapOpen;
        R[i] = rr > rd ? rr : rd;
      }
      bool is_match = false;
      int32_t d;
      if (i == 0) {
        d = kMinScore;
      } else {
        is_match = x[i - 1] == y[j - 1];
        d = prev_D + (is_match ? kMatch : kMismatch);
      }
      prev_D = D[i];
      int32_t cur = d >= C[i] ? (d >= R[i] ? d : (C[i] >= R[i] ? C[i] : R[i]))
                              : (C[i] >= R[i] ? C[i] : R[i]);
      uint8_t op;
      if (cur == d) op = is_match ? D_MATCH : D_SUBST;
      else if (cur == C[i]) op = D_DEL;
      else op = D_INS;
      D[i] = cur;
      tr[j * w + i] = op;
      if (cur > max_score) { max_score = cur; max_i = i; max_j = j; }
      if (cur > band_max) band_max = cur;
    }
    if (band_max < max_score - xdrop) {
      stopped = true;  // global stop
      if (cert_out && band_max > kMinScore) {  // real drop, not exhaustion
        ecap = (j < xlen ? j : xlen) * (int64_t)kMatch + e_ladder;
        rstop = true;
      }
    } else if (cert_out) {
      int64_t v = band_max - ((j < xlen ? j : xlen) * (int64_t)kMatch + e_ladder);
      if (v < cmin) cmin = v;
    }
  }

  // phase 2: band slides one row per column
  for (int64_t j = band + 1; j <= ylen && !stopped; ++j) {
    int32_t band_max = kMinScore;
    int64_t lo = j - band;
    int64_t hi = lo + w < xlen + 1 ? lo + w : xlen + 1;
    for (int64_t i = lo; i < hi; ++i) {
      int64_t bi = i - lo;
      if (bi >= w - 1) {
        C[bi] = kMinScore;
      } else {
        int32_t cc = C[bi + 1] + kGapExtend;
        int32_t cd = D[bi + 1] + kGapExtend + kGapOpen;
        C[bi] = cc > cd ? cc : cd;
      }
      if (bi == 0) {
        R[bi] = kMinScore;
      } else {
        int32_t rr = R[bi - 1] + kGapExtend;
        int32_t rd = D[bi - 1] + kGapExtend + kGapOpen;
        R[bi] = rr > rd ? rr : rd;
      }
      bool is_match = x[i - 1] == y[j - 1];
      int32_t d = D[bi] + (is_match ? kMatch : kMismatch);
      int32_t cur = d >= C[bi] ? (d >= R[bi] ? d : (C[bi] >= R[bi] ? C[bi] : R[bi]))
                               : (C[bi] >= R[bi] ? C[bi] : R[bi]);
      uint8_t op;
      if (cur == d) op = is_match ? D_MATCH : D_SUBST;
      else if (cur == C[bi]) op = D_DEL;
      else op = D_INS;
      D[bi] = cur;
      tr[j * w + bi] = op;
      if (cur > max_score) { max_score = cur; max_i = i; max_j = j; }
      if (cur > band_max) band_max = cur;
    }
    if (band_max < max_score - xdrop) {
      if (cert_out && band_max > kMinScore) {
        ecap = (j < xlen ? j : xlen) * (int64_t)kMatch + e_ladder;
        rstop = true;
      }
      break;
    }
    if (cert_out) {
      int64_t v = band_max - ((j < xlen ? j : xlen) * (int64_t)kMatch + e_ladder);
      if (v < cmin) cmin = v;
    }
  }

  if (cert_out) {
    int64_t cert_ub = rstop ? ecap + xdrop : ub_final;
    *cert_out = (cmin > -xdrop && max_score > cert_ub) ? 1 : 0;
  }
  out[0] = max_score;
  out[1] = (int32_t)max_i;
  out[2] = (int32_t)max_j;
  int64_t n = pack_walk(S, w, band, max_i, max_j, out + 4, pw);
  out[3] = (int32_t)n;
  return n < 0 ? -1 : 0;
}

// Adaptive narrow-band scalar SWG (CPU-engine mirror of the device
// pipeline's adaptive pass, align/batch.py::_narrow_meta): run at
// band' = min(band, narrow) with ylen re-clamped to xlen + band' + 1;
// accept iff the exactness certificate passes, else recompute at the
// full band.  Output is bit-identical to a full-band run either way.
// `*patched` (optional) counts certificate failures.
int64_t swg_stream_row_adaptive(SwgScratch& S, const uint8_t* x,
                                int64_t xlen, const uint8_t* y,
                                int64_t ylen, int64_t band, int64_t narrow,
                                int64_t xdrop, int32_t* out, int64_t pw,
                                int64_t* patched = nullptr) {
  if (narrow <= 0 || narrow >= band) {
    return swg_stream_row(S, x, xlen, y, ylen, band, xdrop, out, pw);
  }
  int64_t nylen = ylen < xlen + narrow + 1 ? ylen : xlen + narrow + 1;
  int32_t cert = 0;
  int64_t rc =
      swg_stream_row(S, x, xlen, y, nylen, narrow, xdrop, out, pw, &cert);
  if (rc == 0 && cert) return 0;
  if (patched) ++*patched;
  std::memset(out, 0, (size_t)(4 + pw) * sizeof(int32_t));
  return swg_stream_row(S, x, xlen, y, ylen, band, xdrop, out, pw);
}

}  // namespace

extern "C" {

// Batch oracle: fill packed stream rows for `n` problems described by
// 9-int32 meta rows over HOST byte arrays (ref_bytes = concatenated
// reference text WITHOUT the device _WPAD padding; reads = the padded
// read block).  Only rows listed in `pids` are computed; each row is
// written at out + pids[k]*(4+pw).  Meta y anchor is the device
// (word, sub) split, so y byte base = 8*word + sub - wpad.
// Returns the number of walk overflows (0 = all exact).
int64_t thermite_swg_patch_rows(
    const uint8_t* ref_bytes, int64_t ref_len, const uint8_t* reads,
    int64_t reads_len, const int32_t* meta, const int64_t* pids, int64_t n,
    int64_t wpad, int32_t* out, int64_t pw) {
  SwgScratch S;
  std::vector<uint8_t> xbuf, ybuf;
  int64_t bad = 0;
  for (int64_t k = 0; k < n; ++k) {
    int64_t pid = pids[k];
    const int32_t* m = meta + pid * 9;
    int64_t yb = 8 * (int64_t)m[0] + m[1] - wpad;
    int64_t yd = m[2], ylen = m[3];
    int64_t xb = m[4], xd = m[5], xlen = m[6];
    int64_t band = m[7], xdrop = m[8];
    xbuf.resize(xlen > 0 ? xlen : 0);
    for (int64_t i = 0; i < xlen; ++i) {
      int64_t p = xb + xd * i;
      xbuf[i] = (p >= 0 && p < reads_len) ? reads[p] : 0;
    }
    ybuf.resize(ylen > 0 ? ylen : 0);
    for (int64_t i = 0; i < ylen; ++i) {
      int64_t p = yb + yd * i;
      ybuf[i] = (p >= 0 && p < ref_len) ? ref_bytes[p] : 0;
    }
    int32_t* row = out + pid * (4 + pw);
    std::memset(row, 0, (4 + pw) * sizeof(int32_t));
    bad -= swg_stream_row(S, xbuf.data(), xlen, ybuf.data(), ylen, band,
                          xdrop, row, pw);
  }
  return bad;
}

// Single-problem entry (tests / the all-native baseline engine).
int64_t thermite_swg_stream(const uint8_t* x, int64_t xlen, const uint8_t* y,
                            int64_t ylen, int64_t band, int64_t xdrop,
                            int32_t* out, int64_t pw) {
  SwgScratch S;
  std::memset(out, 0, (4 + pw) * sizeof(int32_t));
  return swg_stream_row(S, x, xlen, y, ylen, band, xdrop, out, pw);
}

// Single-problem adaptive entry (tests; must be bit-identical to
// thermite_swg_stream for every input).  `patched` (nullable) is
// incremented when the narrow pass failed its certificate.
int64_t thermite_swg_stream_adaptive(const uint8_t* x, int64_t xlen,
                                     const uint8_t* y, int64_t ylen,
                                     int64_t band, int64_t narrow,
                                     int64_t xdrop, int32_t* out, int64_t pw,
                                     int64_t* patched) {
  SwgScratch S;
  std::memset(out, 0, (4 + pw) * sizeof(int32_t));
  return swg_stream_row_adaptive(S, x, xlen, y, ylen, band, narrow, xdrop,
                                 out, pw, patched);
}

// All-native single-core chunk pipeline: build -> scalar banded SWG on
// every nontrivial problem -> arbitrate -> finalize, one thread, no
// device.  This is the honest "thermite-equivalent single core"
// baseline (the original aligner is compiled Rust at opt-level 3;
// comparing the device pipeline against a Python oracle would flatter
// it).  Returns a finalized Chunk handle
// ready for thermite_chunk_emit / the standard getters, or nullptr on
// internal error.  `consumed` reads back via thermite_chunk_n_reads.
// `narrow_band` > 0 enables the same adaptive narrow-band pass the
// device pipeline runs (certificate-gated, bit-identical outputs);
// certificate failures are counted into *cert_patches (nullable).
// `nthreads` <= 1 keeps everything on one thread — the honest
// "thermite-equivalent single core" baseline bench.py measures.
// nthreads > 1 parallelizes the DP loop over problems (independent by
// construction; each writes its own row/score slots) — the production
// CPU mode for multi-core hosts, where the reference's own contract is
// caller-threading over a shared index (src/wrapper.rs:20-27), which a
// GIL-bound Python caller cannot deliver.  Output is bit-identical at
// any thread count (tests/test_cpu_engine.py).
void* thermite_chunk_align_cpu_mt(void* eh, const uint8_t* reads,
                                  int64_t n_reads, int64_t rpad,
                                  const int64_t* read_lens,
                                  int64_t problem_budget,
                                  int64_t wpad, int64_t pw,
                                  int64_t narrow_band, int64_t* cert_patches,
                                  int64_t paired, int64_t nthreads) {
  auto& E = *static_cast<Engine*>(eh);
  const uint8_t* ref_bytes = E.ref_text;
  const int64_t ref_len = E.ref_text_len;
  Chunk* ch;
  {
    BuildScratch S;
    ReadBuild rb;
    ch = new Chunk();
    for (int64_t ri = 0; ri < n_reads; ++ri) {
      if ((!paired || (ri & 1) == 0) && ch->n_problems() >= problem_budget)
        break;
      build_one_read(E, reads + ri * rpad, read_lens[ri], ri * rpad, S, &rb);
      merge_read(ch, ri, rb);
    }
    ch->read_task_off.push_back(ch->n_tasks());
  }
  const int64_t P = ch->n_problems();
  std::vector<int32_t> rows((size_t)(P * (4 + pw)), 0);
  std::vector<int32_t> scores(P), mi(P), mj(P);
  std::atomic<int64_t> patches_total(0);
  std::atomic<bool> failed(false);
  auto dp_range = [&](std::atomic<int64_t>& next) {
    SwgScratch S;
    std::vector<uint8_t> xbuf, ybuf;
    int64_t patches_local = 0;
    while (true) {
      int64_t p = next.fetch_add(1, std::memory_order_relaxed);
      if (p >= P || failed.load(std::memory_order_relaxed)) break;
      const int32_t* m = ch->meta.data() + p * 9;
      int64_t ylen = m[3], xlen = m[6];
      int32_t* row = rows.data() + p * (4 + pw);
      if (xlen > 0 && ylen > 0) {
        int64_t yb = 8 * (int64_t)m[0] + m[1] - wpad;
        int64_t yd = m[2], xb = m[4], xd = m[5];
        xbuf.resize(xlen);
        for (int64_t i = 0; i < xlen; ++i) xbuf[i] = reads[xb + xd * i];
        ybuf.resize(ylen);
        for (int64_t i = 0; i < ylen; ++i) {
          int64_t q = yb + yd * i;
          ybuf[i] = (q >= 0 && q < ref_len) ? ref_bytes[q] : 0;
        }
        if (swg_stream_row_adaptive(S, xbuf.data(), xlen, ybuf.data(), ylen,
                                    m[7], narrow_band, m[8], row, pw,
                                    &patches_local) != 0) {
          failed.store(true, std::memory_order_relaxed);
          break;
        }
      }
      scores[p] = row[0];
      mi[p] = row[1];
      mj[p] = row[2];
    }
    patches_total += patches_local;
  };
  std::atomic<int64_t> next(0);
  if (nthreads > 1 && P >= 64) {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < nthreads - 1; ++t)
      pool.emplace_back([&]() { dp_range(next); });
    dp_range(next);
    for (auto& th : pool) th.join();
  } else {
    dp_range(next);
  }
  if (failed.load()) {
    delete ch;
    return nullptr;
  }
  if (cert_patches) *cert_patches += patches_total.load();
  thermite_chunk_arbitrate(eh, ch, scores.data(), mi.data(), mj.data());
  int64_t rc = thermite_chunk_finalize(eh, ch, rows.data(), P, pw,
                                       ch->meta.data());
  if (rc != 0) {
    delete ch;
    return nullptr;
  }
  return ch;
}

// single-core entry (kept as the stable ABI bench.py's baseline uses)
void* thermite_chunk_align_cpu(void* eh, const uint8_t* reads,
                               int64_t n_reads, int64_t rpad,
                               const int64_t* read_lens,
                               int64_t problem_budget,
                               int64_t wpad, int64_t pw,
                               int64_t narrow_band, int64_t* cert_patches,
                               int64_t paired) {
  return thermite_chunk_align_cpu_mt(eh, reads, n_reads, rpad, read_lens,
                                     problem_budget, wpad, pw, narrow_band,
                                     cert_patches, paired, 1);
}

}  // extern "C"

// ==========================================================================
// Record emission (role of reference src/aln_writer.rs:118-358): SAM
// text lines or binary BAM record blobs straight from the finalize
// runs — the Python writers (io/sam.py, io/bam.py) remain the parity
// referees and byte-identical by test.
// ==========================================================================

namespace {

const char kRunCigar[6] = {'M', 'M', 'D', 'I', 'S', 'N'};
// 4-bit BAM base codes, index = position in "=ACMGRSVTWYHKDBN"
struct BamSeqTable {
  uint8_t code[256];
  BamSeqTable() {
    const char* a = "=ACMGRSVTWYHKDBN";
    std::memset(code, 15, sizeof(code));
    for (int i = 0; i < 16; ++i) code[(uint8_t)a[i]] = (uint8_t)i;
  }
};
const BamSeqTable kBamSeq;
struct CompTable {  // mirrors io/fastx.py _RC (IUPAC-aware)
  uint8_t c[256];
  CompTable() {
    const char* from = "ACGTUNacgtunRYSWKMBDHVryswkmbdhv";
    const char* to = "TGCAANtgcaanYRSWMKVHDByrswmkvhdb";
    for (int i = 0; i < 256; ++i) c[i] = (uint8_t)i;
    for (int i = 0; from[i]; ++i) c[(uint8_t)from[i]] = (uint8_t)to[i];
  }
};
const CompTable kComp;

inline void put_str(std::vector<uint8_t>& o, const char* s) {
  while (*s) o.push_back((uint8_t)*s++);
}
inline void put_bytes(std::vector<uint8_t>& o, const uint8_t* p, int64_t n) {
  o.insert(o.end(), p, p + n);
}
inline void put_int(std::vector<uint8_t>& o, int64_t v) {
  char buf[24];
  int n = snprintf(buf, sizeof(buf), "%lld", (long long)v);
  o.insert(o.end(), buf, buf + n);
}
inline void put_i32le(std::vector<uint8_t>& o, int32_t v) {
  o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 4);  // little-endian host
}
inline void put_u32le(std::vector<uint8_t>& o, uint32_t v) {
  o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 4);
}
inline void put_u16le(std::vector<uint8_t>& o, uint16_t v) {
  o.insert(o.end(), (uint8_t*)&v, (uint8_t*)&v + 2);
}

// CIGAR from RLE runs ((op<<32)|len, op 0..5 = M/Subst/D/I/SC/N):
// Subst maps to M; adjacent M/I/D merge (io/sam.py cigar_from_runs)
void cigar_merge(const int64_t* runs, int64_t n,
                 std::vector<std::pair<char, int64_t>>* out) {
  out->clear();
  for (int64_t i = 0; i < n; ++i) {
    char ch = kRunCigar[runs[i] >> 32];
    int64_t len = runs[i] & 0xFFFFFFFF;
    if (!out->empty() && out->back().first == ch &&
        (ch == 'M' || ch == 'I' || ch == 'D'))
      out->back().second += len;
    else
      out->emplace_back(ch, len);
  }
}

int mapq_of(int64_t n) {  // reference src/aln_writer.rs:326-340
  if (n <= 1) return 255;
  if (n >= 5) return 0;
  static const int q[5] = {0, 0, 3, 2, 1};
  return q[n];
}

int reg2bin(int64_t beg, int64_t end) {  // BAM spec
  --end;
  if (beg >> 14 == end >> 14) return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17) return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20) return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23) return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26) return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

struct StrRef { const uint8_t* p; int64_t n; };

inline StrRef blob_str(const Engine& E, const std::vector<int64_t>& off,
                       int64_t i) {
  return {E.str_blob.data() + off[i], off[i + 1] - off[i]};
}

// mate context for paired-end records (thermite_chunk_emit_paired);
// mirrors the SamRecord mate fields the Python writers serialize
// (io/sam.py SamRecord, io/bam.py encode_bam_record)
struct MateCtx {
  int32_t flag_or = 0;       // OR'd into FLAG (0x1/0x2/0x8/0x20/0x40/0x80)
  int64_t rnext = -9;        // -9 absent ('*'), -2 '=', else a refid
  int64_t pnext1 = 0;        // 1-based mate POS; 0 = unset
  int64_t tlen = 0;          // signed template length
  int64_t place_refid = -1;  // >=0: place an unmapped record here
  int64_t place_pos1 = 0;    //      (partner's coordinates)
};

// one PAF row (reference src/aln_writer.rs:32-115 semantics via
// io/paf.py): full (untruncated) query name, a trailing tab before the
// newline, and the match/block-length columns counting op ELEMENTS —
// a soft clip is 1 element regardless of length, an intron skip is 0
void emit_paf_record(const Engine& E, std::vector<uint8_t>& o,
                     const uint8_t* name, int64_t name_len,
                     int64_t seq_len, bool fwd_strand, int64_t refid,
                     int64_t ys, int64_t ye, int64_t xs, int64_t xe,
                     int64_t num_match, int64_t num_match_gap, int mapq) {
  put_bytes(o, name, name_len);
  o.push_back('\t');
  put_int(o, seq_len); o.push_back('\t');
  put_int(o, xs); o.push_back('\t');
  put_int(o, xe); o.push_back('\t');
  o.push_back(fwd_strand ? '+' : '-'); o.push_back('\t');
  StrRef rn = blob_str(E, E.ref_name_off, refid);
  put_bytes(o, rn.p, rn.n); o.push_back('\t');
  put_int(o, E.ref_len[refid]); o.push_back('\t');
  put_int(o, ys); o.push_back('\t');
  put_int(o, ye); o.push_back('\t');
  put_int(o, num_match); o.push_back('\t');
  put_int(o, num_match_gap); o.push_back('\t');
  put_int(o, mapq); o.push_back('\t');
  o.push_back('\n');
}

// one SAM text line (with trailing newline)
void emit_sam_record(const Engine& E, std::vector<uint8_t>& o,
                     const uint8_t* name, int64_t name_len,
                     const uint8_t* seq, int64_t seq_len,
                     const uint8_t* qual, int64_t qual_len,
                     bool mapped, bool fwd_strand, bool primary,
                     int64_t refid, int64_t pos1, int mapq,
                     const std::vector<std::pair<char, int64_t>>& cig,
                     int64_t score, int64_t nh, int64_t hi, int64_t nmm,
                     int type, int64_t tx, int64_t tx_ys,
                     const std::vector<std::pair<char, int64_t>>& tx_cig,
                     int64_t gene, bool strip_tags = false,
                     const MateCtx* mc = nullptr) {
  // name truncated at first space
  int64_t nl = 0;
  while (nl < name_len && name[nl] != ' ') ++nl;
  put_bytes(o, name, nl);
  o.push_back('\t');
  int flag = mapped ? ((fwd_strand ? 0 : 16) | (primary ? 0 : 256)) : 4;
  if (mc) flag |= mc->flag_or;
  put_int(o, flag);
  o.push_back('\t');
  // an unmapped mate with a mapped partner is PLACED at the partner's
  // coordinates (paired.py pair_records; samtools convention)
  const bool placed = !mapped && mc && mc->place_refid >= 0;
  if (mapped || placed) {
    StrRef rn = blob_str(E, E.ref_name_off, mapped ? refid : mc->place_refid);
    put_bytes(o, rn.p, rn.n);
  } else {
    o.push_back('*');
  }
  o.push_back('\t');
  put_int(o, mapped ? pos1 : placed ? mc->place_pos1 : 0);
  o.push_back('\t');
  put_int(o, mapq);
  o.push_back('\t');
  if (mapped) {
    for (auto& c : cig) { put_int(o, c.second); o.push_back(c.first); }
  } else {
    o.push_back('*');
  }
  o.push_back('\t');
  if (!mc || mc->rnext == -9) {
    put_str(o, "*\t0\t0");
  } else {
    if (mc->rnext == -2) {
      o.push_back('=');
    } else {
      StrRef rn = blob_str(E, E.ref_name_off, mc->rnext);
      put_bytes(o, rn.p, rn.n);
    }
    o.push_back('\t');
    put_int(o, mc->pnext1);
    o.push_back('\t');
    put_int(o, mc->tlen);
  }
  o.push_back('\t');
  if (seq_len == 0) {
    o.push_back('*');
  } else if (!mapped || fwd_strand) {
    put_bytes(o, seq, seq_len);
  } else {
    for (int64_t i = seq_len - 1; i >= 0; --i) o.push_back(kComp.c[seq[i]]);
  }
  o.push_back('\t');
  if (qual_len == 0) {
    o.push_back('*');
  } else if (!mapped || fwd_strand) {
    put_bytes(o, qual, qual_len);
  } else {
    for (int64_t i = qual_len - 1; i >= 0; --i) o.push_back(qual[i]);
  }
  if (mapped) {
    put_str(o, "\tAS:i:"); put_int(o, score);
    put_str(o, "\tNH:i:"); put_int(o, nh);
    put_str(o, "\tHI:i:"); put_int(o, hi);
    put_str(o, "\tnM:i:"); put_int(o, nmm);
    if (strip_tags) {  // embedding wrapper: no TX/GX/GN/RE
      o.push_back('\n');
      return;
    }
    if (type == A_EXONIC) {
      put_str(o, "\tTX:Z:");
      StrRef ti = blob_str(E, E.tx_id_off, tx);
      put_bytes(o, ti.p, ti.n);
      put_str(o, ",+"); put_int(o, tx_ys); o.push_back(',');
      for (auto& c : tx_cig) { put_int(o, c.second); o.push_back(c.first); }
      gene = E.tx_gene[tx];
    }
    if (type == A_EXONIC || type == A_INTRONIC) {
      put_str(o, "\tGX:Z:");
      StrRef gi = blob_str(E, E.gene_id_off, gene);
      put_bytes(o, gi.p, gi.n);
      put_str(o, "\tGN:Z:");
      StrRef gn = blob_str(E, E.gene_name_off, gene);
      put_bytes(o, gn.p, gn.n);
    }
    put_str(o, "\tRE:A:");
    o.push_back(type == A_EXONIC ? 'E' : type == A_INTRONIC ? 'N' : 'I');
  }
  o.push_back('\n');
}

// one binary BAM record (length-prefixed blob, io/bam.py encode_bam_record)
void emit_bam_record(const Engine& E, std::vector<uint8_t>& o,
                     const uint8_t* name, int64_t name_len,
                     const uint8_t* seq, int64_t seq_len,
                     const uint8_t* qual, int64_t qual_len,
                     bool mapped, bool fwd_strand, bool primary,
                     int64_t refid, int64_t pos1, int mapq,
                     const std::vector<std::pair<char, int64_t>>& cig,
                     int64_t score, int64_t nh, int64_t hi, int64_t nmm,
                     int type, int64_t tx, int64_t tx_ys,
                     const std::vector<std::pair<char, int64_t>>& tx_cig,
                     int64_t gene, bool strip_tags = false,
                     const MateCtx* mc = nullptr) {
  int64_t nl = 0;
  while (nl < name_len && name[nl] != ' ') ++nl;
  if (nl > 254) nl = 254;  // BAM l_read_name is uint8 (incl. NUL)
  const bool placed = !mapped && mc && mc->place_refid >= 0;
  int64_t eref = mapped ? refid : placed ? mc->place_refid : -1;
  int64_t pos0 = mapped ? pos1 - 1 : placed ? mc->place_pos1 - 1 : -1;
  int64_t ref_span = 0;
  for (auto& c : cig)
    if (c.first == 'M' || c.first == 'D' || c.first == 'N')
      ref_span += c.second;
  int bin = pos0 >= 0 ? reg2bin(pos0, pos0 + ref_span) : reg2bin(-1, 0);
  size_t start = o.size();
  put_i32le(o, 0);  // placeholder block_size
  put_i32le(o, eref >= 0 ? E.bam_ref[eref] : -1);
  put_i32le(o, (int32_t)pos0);
  o.push_back((uint8_t)(nl + 1));
  o.push_back((uint8_t)mapq);
  put_u16le(o, (uint16_t)bin);
  put_u16le(o, (uint16_t)(mapped ? cig.size() : 0));
  int flag = mapped ? ((fwd_strand ? 0 : 16) | (primary ? 0 : 256)) : 4;
  if (mc) flag |= mc->flag_or;
  put_u16le(o, (uint16_t)flag);
  put_i32le(o, (int32_t)seq_len);
  // next_refID / next_pos / tlen (io/bam.py encode_bam_record: '='
  // resolves to this record's own ref id; pnext is stored 0-based)
  int32_t nref = -1;
  if (mc && mc->rnext == -2)
    nref = eref >= 0 ? E.bam_ref[eref] : -1;
  else if (mc && mc->rnext >= 0)
    nref = E.bam_ref[mc->rnext];
  put_i32le(o, nref);
  put_i32le(o, (int32_t)((mc ? mc->pnext1 : 0) - 1));
  put_i32le(o, (int32_t)(mc ? mc->tlen : 0));
  put_bytes(o, name, nl);
  o.push_back(0);
  if (mapped)
    for (auto& c : cig)
      put_u32le(o, (uint32_t)((c.second << 4) |
                              (c.first == 'M'   ? 0
                               : c.first == 'I' ? 1
                               : c.first == 'D' ? 2
                               : c.first == 'N' ? 3
                                                : 4)));
  if (seq_len) {
    // nibble-pack (reverse-complemented on '-' strand)
    uint8_t cur = 0;
    int half = 0;
    for (int64_t i = 0; i < seq_len; ++i) {
      uint8_t b = (!mapped || fwd_strand) ? seq[i]
                                          : kComp.c[seq[seq_len - 1 - i]];
      uint8_t code = kBamSeq.code[b];
      if (half == 0) { cur = (uint8_t)(code << 4); half = 1; }
      else { o.push_back((uint8_t)(cur | code)); half = 0; }
    }
    if (half) o.push_back(cur);
    if (qual_len == seq_len) {
      for (int64_t i = 0; i < seq_len; ++i) {
        uint8_t q = (!mapped || fwd_strand) ? qual[i] : qual[qual_len - 1 - i];
        int v = (int)q - 33;
        o.push_back((uint8_t)(v < 0 ? 0 : v > 93 ? 93 : v));
      }
    } else {
      // absent or length-mismatched qual: 0xff fill (io/bam.py ditto)
      for (int64_t i = 0; i < seq_len; ++i) o.push_back(0xff);
    }
  }
  if (mapped) {
    auto tag_i = [&](const char* t, int64_t v) {
      put_str(o, t); o.push_back('i'); put_i32le(o, (int32_t)v);
    };
    tag_i("AS", score);
    tag_i("NH", nh);
    tag_i("HI", hi);
    tag_i("nM", nmm);
    if (strip_tags) {  // embedding wrapper: no TX/GX/GN/RE
      int32_t blk0 = (int32_t)(o.size() - start - 4);
      std::memcpy(o.data() + start, &blk0, 4);
      return;
    }
    if (type == A_EXONIC) {
      put_str(o, "TX"); o.push_back('Z');
      StrRef ti = blob_str(E, E.tx_id_off, tx);
      put_bytes(o, ti.p, ti.n);
      put_str(o, ",+");
      put_int(o, tx_ys);
      o.push_back(',');
      for (auto& c : tx_cig) { put_int(o, c.second); o.push_back(c.first); }
      o.push_back(0);
      gene = E.tx_gene[tx];
    }
    if (type == A_EXONIC || type == A_INTRONIC) {
      put_str(o, "GX"); o.push_back('Z');
      StrRef gi = blob_str(E, E.gene_id_off, gene);
      put_bytes(o, gi.p, gi.n);
      o.push_back(0);
      put_str(o, "GN"); o.push_back('Z');
      StrRef gn = blob_str(E, E.gene_name_off, gene);
      put_bytes(o, gn.p, gn.n);
      o.push_back(0);
    }
    put_str(o, "RE"); o.push_back('A');
    o.push_back(type == A_EXONIC ? 'E' : type == A_INTRONIC ? 'N' : 'I');
  }
  int32_t blk = (int32_t)(o.size() - start - 4);
  std::memcpy(o.data() + start, &blk, 4);
}

}  // namespace

extern "C" {

// Chunk read-block preparation in one native pass (replaces a Python
// per-read loop + a numpy 8-pass nibble pack that together cost
// ~6 us/read): uppercase each read into the zero-padded (rows, rpad)
// block, record lengths, and nibble-pack the whole block with the READ
// code LUT (A/C/G/T/N = 1..5, pad 0 -> 0, anything else 15 — matches
// ops/layout._READ_NIB_LUT / _read_codes bit for bit).  The nib
// layout mirrors pack_reads_nib_host: wpad zero BYTES before the
// block, 8 codes per int32 word, little-endian nibbles.
void thermite_prep_reads(const uint8_t* concat, const int64_t* offs,
                         int64_t n, int64_t rows, int64_t rpad,
                         uint8_t* pad_out, int64_t* lens_out) {
  int64_t L = rows * rpad;
  std::memset(pad_out, 0, (size_t)L);
  for (int64_t ri = 0; ri < n; ++ri) {
    const uint8_t* src = concat + offs[ri];
    int64_t len = offs[ri + 1] - offs[ri];
    if (len > rpad) len = rpad;
    lens_out[ri] = len;
    uint8_t* dst = pad_out + ri * rpad;
    for (int64_t i = 0; i < len; ++i) {
      uint8_t c = src[i];
      dst[i] = (c >= 'a' && c <= 'z') ? (uint8_t)(c - 32) : c;
    }
  }
}

// Nibble-pack a read block for upload (the C twin of
// ops/layout.pack_reads_nib_host; bit-identical by test).  Byte k
// of the padded stream (wpad zeros + block + trailing zeros) -> word
// k/8, nibble k%8, READ code LUT.
void thermite_nib_pack_reads(const uint8_t* block, int64_t L, int64_t wpad,
                             int32_t* nib_out, int64_t nib_words) {
  static uint8_t lut[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) lut[i] = 15;
    lut[0] = 0;
    const char* b = "ACGTN";
    for (int i = 0; i < 5; ++i) lut[(uint8_t)b[i]] = (uint8_t)(i + 1);
    init = true;
  }
  std::memset(nib_out, 0, (size_t)nib_words * 4);
  for (int64_t i = 0; i < L; ++i) {
    uint8_t c = block[i];
    if (!c) continue;  // code 0
    int64_t k = wpad + i;
    nib_out[k >> 3] |= (int32_t)((uint32_t)lut[c] << (4 * (k & 7)));
  }
}

void thermite_engine_set_strings(
    void* eh, const uint8_t* blob, int64_t blob_len,
    const int64_t* ref_name_off, int64_t n_refs,
    const int64_t* gene_id_off, const int64_t* gene_name_off, int64_t n_genes,
    const int64_t* tx_id_off, const int64_t* tx_gene, int64_t n_txs,
    const int32_t* bam_ref) {
  auto& E = *static_cast<Engine*>(eh);
  E.str_blob.assign(blob, blob + blob_len);
  E.ref_name_off.assign(ref_name_off, ref_name_off + n_refs + 1);
  E.gene_id_off.assign(gene_id_off, gene_id_off + n_genes + 1);
  E.gene_name_off.assign(gene_name_off, gene_name_off + n_genes + 1);
  E.tx_id_off.assign(tx_id_off, tx_id_off + n_txs + 1);
  E.tx_gene.assign(tx_gene, tx_gene + n_txs);
  E.bam_ref.assign(bam_ref, bam_ref + n_refs);
}

// FR pairing decision for an interleaved R1/R2 chunk (mirrors
// thermite_tpu_torch/align/paired.py select_pair/template_len/pair_records,
// the byte-identity referee; see that module for the pairing rules).
// `rescue` != 0 marks every pair with exactly ONE unmapped mate for
// the Python mate-rescue + splice path (rescue re-seeds the lost mate
// inside the partner's insert window — host-side by design).
void thermite_chunk_pair(void* eh, void* chh, int64_t max_insert,
                         int rescue) {
  auto& E = *static_cast<Engine*>(eh);
  auto& ch = *static_cast<Chunk*>(chh);
  const int64_t S = (int64_t)ch.selected.size() / S_NCOL;
  const int64_t R = ch.n_reads;
  ch.paired = true;
  ch.sel_off.assign(R + 1, 0);
  {
    // selected rows are read-ordered (arbitrate loops reads ascending)
    int64_t s = 0;
    for (int64_t r = 0; r < R; ++r) {
      ch.sel_off[r] = s;
      while (s < S && ch.selected[s * S_NCOL + S_READ] == r) ++s;
    }
    ch.sel_off[R] = s;
  }
  ch.p_chosen.assign(R, -1);
  ch.p_flag.assign(R, 0);
  ch.p_proper.assign(R, 0);
  ch.p_mrefid.assign(R, -1);
  ch.p_mpos1.assign(R, 0);
  ch.p_tlen.assign(R, 0);
  ch.p_skip.assign(R, 0);
  auto row = [&](int64_t s, int c) { return ch.selected[s * S_NCOL + c]; };
  // R is even by contract: paired builds cut only at pair boundaries
  constexpr int64_t kMaxCand = 64;  // paired.py _MAX_CANDIDATES
  for (int64_t p = 0; 2 * p + 1 < R; ++p) {
    const int64_t r1 = 2 * p, r2 = 2 * p + 1;
    const int64_t a0 = ch.sel_off[r1], n1 = ch.sel_off[r1 + 1] - a0;
    const int64_t b0 = ch.sel_off[r2], n2 = ch.sel_off[r2 + 1] - b0;
    if (rescue && (n1 > 0) != (n2 > 0)) {
      // exactly one mate unmapped: Python tries mate rescue, then
      // pair_records; the emit leaves a splice point for this pair
      ch.p_skip[r1] = ch.p_skip[r2] = 1;
      continue;
    }
    // select_pair: maximize (score sum, -i, -j) over proper combos;
    // ascending (i, j) iteration + strict > realizes the tie rule
    int64_t ci = n1 ? 0 : -1, cj = n2 ? 0 : -1;
    bool proper = false;
    if (n1 && n2) {
      int64_t best = INT64_MIN;
      const int64_t ni = std::min(n1, kMaxCand), nj = std::min(n2, kMaxCand);
      for (int64_t i = 0; i < ni; ++i) {
        const int64_t sa = a0 + i;
        const int64_t ra = E.ref_rank[row(sa, S_REFID)];
        const int sta = E.ref_strand[row(sa, S_REFID)];
        const int64_t ys_a = row(sa, S_YS), ye_a = row(sa, S_YE);
        for (int64_t j = 0; j < nj; ++j) {
          const int64_t sb = b0 + j;
          if (E.ref_rank[row(sb, S_REFID)] != ra) continue;
          if ((int)E.ref_strand[row(sb, S_REFID)] == sta) continue;
          const int64_t ys_b = row(sb, S_YS), ye_b = row(sb, S_YE);
          int64_t fs, fe, rs, re;
          if (sta) { fs = ys_a; fe = ye_a; rs = ys_b; re = ye_b; }
          else     { fs = ys_b; fe = ye_b; rs = ys_a; re = ye_a; }
          if (fs > re) continue;  // fwd mate starts past rev mate's end
          const int64_t tl = std::max(re, fe) - std::min(fs, rs);
          if (tl <= 0 || tl > max_insert) continue;
          const int64_t sum = row(sa, S_SCORE) + row(sb, S_SCORE);
          if (sum > best) { best = sum; ci = i; cj = j; proper = true; }
        }
      }
    }
    const int64_t sa = ci >= 0 ? a0 + ci : -1;
    const int64_t sb = cj >= 0 ? b0 + cj : -1;
    int64_t tl = 0;
    if (proper) {  // signed TLEN: outer span, + for the leftmost mate
      const int64_t s1 = row(sa, S_YS), e1 = row(sa, S_YE);
      const int64_t s2 = row(sb, S_YS), e2 = row(sb, S_YE);
      const int64_t span = std::max(e1, e2) - std::min(s1, s2);
      tl = (s1 < s2 || (s1 == s2 && e1 <= e2)) ? span : -span;
    }
    for (int m = 0; m < 2; ++m) {
      const int64_t r = m ? r2 : r1;
      const int64_t mine = m ? sb : sa, mate = m ? sa : sb;
      int32_t base = 0x1 | (m ? 0x80 : 0x40);  // PAIRED | READ1/READ2
      if (mate < 0) base |= 0x8;               // MATE_UNMAPPED
      else if (!E.ref_strand[row(mate, S_REFID)]) base |= 0x20;
      ch.p_chosen[r] = mine;
      ch.p_flag[r] = base;
      ch.p_proper[r] = proper ? 1 : 0;
      if (mate >= 0) {
        ch.p_mrefid[r] = row(mate, S_REFID);
        ch.p_mpos1[r] = row(mate, S_YS) + 1;
      }
      ch.p_tlen[r] = m ? -tl : tl;
    }
  }
}

int64_t thermite_chunk_n_splices(void* chh) {
  return (int64_t)static_cast<Chunk*>(chh)->splice_pair.size();
}
const int64_t* thermite_chunk_splice_pairs(void* chh) {
  return static_cast<Chunk*>(chh)->splice_pair.data();
}
const int64_t* thermite_chunk_splice_offs(void* chh) {
  return static_cast<Chunk*>(chh)->splice_off.data();
}

// Emit all records of a finalized chunk in read order (fmt 0 = SAM
// text, 1 = BAM record blobs; bit 8 set strips the TX/GX/GN/RE tags —
// the embedding wrapper surface, reference src/wrapper.rs:136-139).
// Returns the byte length (buffer via thermite_chunk_emit_buf), or -1
// if any selected needed the host fallback (caller uses the Python
// object path for the whole chunk).
int64_t thermite_chunk_emit(void* eh, void* chh, int fmt,
                            const uint8_t* names, const int64_t* name_off,
                            const uint8_t* seqs, const int64_t* seq_off,
                            const uint8_t* quals, const int64_t* qual_off) {
  const bool strip = (fmt & 0x100) != 0;
  fmt &= 0xff;
  auto& E = *static_cast<Engine*>(eh);
  auto& ch = *static_cast<Chunk*>(chh);
  int64_t S = (int64_t)ch.selected.size() / S_NCOL;
  for (int64_t s = 0; s < S; ++s)
    if (ch.fallback[s]) return -1;
  auto& o = ch.emit;
  o.clear();
  o.reserve(1 << 20);
  ch.splice_pair.clear();
  ch.splice_off.clear();
  std::vector<std::pair<char, int64_t>> cig, tx_cig;
  MateCtx mc;
  int64_t s = 0;
  for (int64_t r = 0; r < ch.n_reads; ++r) {
    int64_t s0, s1;
    if (ch.paired) {
      s0 = ch.sel_off[r];
      s1 = ch.sel_off[r + 1];
    } else {
      s0 = s;
      while (s < S && ch.selected[s * S_NCOL + S_READ] == r) ++s;
      s1 = s;
    }
    if (ch.paired && ch.p_skip[r]) {
      // Python splices this pair's records here (mate rescue path)
      if ((r & 1) == 0) {
        ch.splice_pair.push_back(r >> 1);
        ch.splice_off.push_back((int64_t)o.size());
      }
      continue;
    }
    int64_t nh = s1 - s0;
    const uint8_t* nm = names + name_off[r];
    int64_t nml = name_off[r + 1] - name_off[r];
    const uint8_t* sq = seqs + seq_off[r];
    int64_t sql = seq_off[r + 1] - seq_off[r];
    const uint8_t* ql = quals + qual_off[r];
    int64_t qll = qual_off[r + 1] - qual_off[r];
    if (nh == 0) {
      if (fmt == 2) continue;  // PAF has no unmapped records
      const MateCtx* mcp = nullptr;
      if (ch.paired) {
        mc = MateCtx{};
        mc.flag_or = ch.p_flag[r];
        if (ch.p_mrefid[r] >= 0) {
          // placed at the mapped partner's coordinates (paired.py
          // pair_records; keeps sorted-BAM pairs adjacent)
          mc.place_refid = ch.p_mrefid[r];
          mc.place_pos1 = ch.p_mpos1[r];
          mc.rnext = -2;
          mc.pnext1 = ch.p_mpos1[r];
        }
        mcp = &mc;
      }
      tx_cig.clear();
      cig.clear();
      if (fmt == 0)
        emit_sam_record(E, o, nm, nml, sq, sql, ql, qll, false, true, true,
                        0, 0, 255, cig, 0, 0, 0, 0, 0, -1, 0, tx_cig, -1,
                        strip, mcp);
      else
        emit_bam_record(E, o, nm, nml, sq, sql, ql, qll, false, true, true,
                        0, 0, 255, cig, 0, 0, 0, 0, 0, -1, 0, tx_cig, -1,
                        strip, mcp);
      continue;
    }
    int mq = mapq_of(nh);
    // paired: the chosen alignment emits first as primary, the rest in
    // original rank order (paired.py _reorder_primary)
    const int64_t chosen = ch.paired ? ch.p_chosen[r] : -1;
    for (int64_t i = 0; i < nh; ++i) {
      int64_t si;
      if (chosen >= 0) {
        if (i == 0) si = chosen;
        else si = (s0 + i - 1 < chosen) ? s0 + i - 1 : s0 + i;
      } else {
        si = s0 + i;
      }
      const int64_t* row = ch.selected.data() + si * S_NCOL;
      const int64_t* tk = ch.tasks.data() + row[S_TASK] * T_NCOL;
      if (fmt == 2) {
        // element-count accounting (codes 0..3 per-cell, 4 = SC as one
        // element, 5 = N skipped) — io/paf.py's runs fast path
        int64_t num_match = 0, num_match_gap = 0;
        for (int64_t k = ch.fin_off[si]; k < ch.fin_off[si + 1]; ++k) {
          int64_t code = ch.fin_runs[k] >> 32;
          int64_t ln = ch.fin_runs[k] & 0xFFFFFFFF;
          if (code == 0) num_match += ln;
          if (code < 4) num_match_gap += ln;
          else if (code == 4) num_match_gap += 1;
        }
        emit_paf_record(E, o, nm, nml, sql,
                        E.ref_strand[row[S_REFID]] != 0, row[S_REFID],
                        row[S_YS], row[S_YE], row[S_XS], row[S_XE],
                        num_match, num_match_gap, mq);
        continue;
      }
      cigar_merge(ch.fin_runs.data() + ch.fin_off[si],
                  ch.fin_off[si + 1] - ch.fin_off[si], &cig);
      int64_t nmm = 0;
      for (int64_t k = ch.fin_off[si]; k < ch.fin_off[si + 1]; ++k)
        if ((ch.fin_runs[k] >> 32) == 1) nmm += ch.fin_runs[k] & 0xFFFFFFFF;
      int type = (int)row[S_TYPE];
      int64_t tx = -1, tx_ys = 0;
      tx_cig.clear();
      if (type == A_EXONIC) {
        tx = tk[T_TXIDX];
        tx_ys = ch.tx_meta[si * 5 + 0];
        cigar_merge(ch.tx_runs.data() + ch.tx_off_runs[si],
                    ch.tx_off_runs[si + 1] - ch.tx_off_runs[si], &tx_cig);
      }
      bool fwd = E.ref_strand[row[S_REFID]] != 0;
      const MateCtx* mcp = nullptr;
      bool primary = row[S_PRIMARY] != 0;
      if (ch.paired) {
        primary = i == 0;  // rank-reordered (paired.py _reorder_primary)
        mc = MateCtx{};
        mc.flag_or = ch.p_flag[r];
        if (ch.p_proper[r] && i == 0) mc.flag_or |= 0x2;  // PROPER_PAIR
        if (ch.p_mrefid[r] >= 0) {
          // '=' iff the mate's chromosome NAME matches this record's
          // (ref_rank is the name-rank: fwd/rc copies share it)
          mc.rnext = E.ref_rank[ch.p_mrefid[r]] == E.ref_rank[row[S_REFID]]
                         ? -2 : ch.p_mrefid[r];
          mc.pnext1 = ch.p_mpos1[r];
          if (ch.p_proper[r] && i == 0) mc.tlen = ch.p_tlen[r];
        } else {
          // mate unmapped: it is placed at THIS mate's position, so
          // each record points at its own coordinates
          mc.rnext = -2;
          mc.pnext1 = row[S_YS] + 1;
        }
        mcp = &mc;
      }
      if (fmt == 0)
        emit_sam_record(E, o, nm, nml, sq, sql, ql, qll, true, fwd,
                        primary, row[S_REFID], row[S_YS] + 1, mq,
                        cig, row[S_SCORE], nh, i + 1, nmm, type, tx, tx_ys,
                        tx_cig, row[S_GENE], strip, mcp);
      else
        emit_bam_record(E, o, nm, nml, sq, sql, ql, qll, true, fwd,
                        primary, row[S_REFID], row[S_YS] + 1, mq,
                        cig, row[S_SCORE], nh, i + 1, nmm, type, tx, tx_ys,
                        tx_cig, row[S_GENE], strip, mcp);
    }
  }
  return (int64_t)o.size();
}

const uint8_t* thermite_chunk_emit_buf(void* chh) {
  return static_cast<Chunk*>(chh)->emit.data();
}

}  // extern "C"
