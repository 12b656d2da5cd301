// Multithreaded CPU Blake2b nonce search — the native work engine.
//
// The PyTorch port's own copy of the repository's native/blake2b_worker.cc
// (same C ABI: bw_abi_version, bw_work_value, bw_search_range), built into
// tpu_dpow_torch/native/_build/ by tpu_dpow_torch/backend/native_backend.py.
// The analog of the reference's vendored Rust/OpenCL `nano-work-server` CPU
// mode (reference client/bin, client/README.md:3,31): find an 8-byte nonce w
// such that blake2b(outlen=8, w_le || block_hash) interpreted little-endian
// is >= difficulty. Exposed as a C ABI for ctypes; no pybind11.
//
// The hot loop is a fully specialized single Blake2b compression: the
// message is one 128-byte block with m[0] = nonce, m[1..4] = block hash,
// m[5..15] = 0, t0 = 40, final flag set, and the 8-byte digest is exactly
// the little-endian h[0] after finalization — so the whole hash collapses
// to 12 unrolled G-rounds on 16 registers plus one XOR. Threads stride
// disjoint blocks of the search range and rendezvous on two atomics (found
// nonce, cancel flag), giving the same first-win + cancel semantics the
// reference gets from its OpenCL work items.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

// Parameter block for digest_size=8, fanout=1, depth=1: h0 = IV0 ^ 0x01010008.
constexpr uint64_t H0_POW = IV[0] ^ 0x01010008ULL;
constexpr uint64_t POW_MSG_LEN = 40;  // 8-byte nonce + 32-byte hash

constexpr uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64 - n));
}

#define G(a, b, c, d, x, y)        \
  do {                             \
    a = a + b + (x);               \
    d = rotr64(d ^ a, 32);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 24);         \
    a = a + b + (y);               \
    d = rotr64(d ^ a, 16);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 63);         \
  } while (0)

// One specialized PoW hash: returns the work value (LE u64 of the 8-byte
// digest) for `nonce` against message words m[1..4] (the block hash).
inline uint64_t pow_value(uint64_t nonce, const uint64_t hash_words[4]) {
  uint64_t m[16] = {nonce,         hash_words[0], hash_words[1],
                    hash_words[2], hash_words[3], 0,
                    0,             0,             0,
                    0,             0,             0,
                    0,             0,             0,
                    0};
  uint64_t v0 = H0_POW, v1 = IV[1], v2 = IV[2], v3 = IV[3];
  uint64_t v4 = IV[4], v5 = IV[5], v6 = IV[6], v7 = IV[7];
  uint64_t v8 = IV[0], v9 = IV[1], v10 = IV[2], v11 = IV[3];
  uint64_t v12 = IV[4] ^ POW_MSG_LEN;  // t0 = 40, t1 = 0
  uint64_t v13 = IV[5];
  uint64_t v14 = IV[6] ^ ~0ULL;  // final-block flag
  uint64_t v15 = IV[7];
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = SIGMA[r];
    G(v0, v4, v8, v12, m[s[0]], m[s[1]]);
    G(v1, v5, v9, v13, m[s[2]], m[s[3]]);
    G(v2, v6, v10, v14, m[s[4]], m[s[5]]);
    G(v3, v7, v11, v15, m[s[6]], m[s[7]]);
    G(v0, v5, v10, v15, m[s[8]], m[s[9]]);
    G(v1, v6, v11, v12, m[s[10]], m[s[11]]);
    G(v2, v7, v8, v13, m[s[12]], m[s[13]]);
    G(v3, v4, v9, v14, m[s[14]], m[s[15]]);
  }
  return H0_POW ^ v0 ^ v8;
}

#undef G

// ---- Multi-way SIMD search ------------------------------------------------
//
// Each Blake2b PoW hash is an independent 12-round dependency chain, so the
// wide registers parallelize across NONCES, not within a hash: lane i of
// every v-register carries the state for nonce0 + i (the blake2bp trick,
// minus the tree mode). GCC/Clang vector extensions keep this portable —
// the same source lowers to zmm (8 lanes, native vprorq rotates) under
// -mavx512f, ymm (4 lanes) under -mavx2, and compiles away entirely on
// other ISAs. One core of this class of x86 runs the 8-way path ~5x the
// scalar loop; the scalar loop remains both the tail handler and the
// no-SIMD fallback.
// A macro, not a constexpr: the #if guards below must see the value.
#if defined(__AVX512F__)
#define POW_LANES 8
#elif defined(__AVX2__)
#define POW_LANES 4
#else
#define POW_LANES 1
#endif

#if POW_LANES > 1

typedef uint64_t vu64 __attribute__((vector_size(POW_LANES * 8)));

inline vu64 vsplat(uint64_t x) {
  vu64 v;
  for (int i = 0; i < POW_LANES; i++) v[i] = x;
  return v;
}

inline vu64 vrotr(vu64 x, unsigned n) {
  return (x >> n) | (x << (64 - n));  // folds to vprorq on AVX-512
}

#define GV(a, b, c, d, x, y)       \
  do {                             \
    a = a + b + (x);               \
    d = vrotr(d ^ a, 32);          \
    c = c + d;                     \
    b = vrotr(b ^ c, 24);          \
    a = a + b + (y);               \
    d = vrotr(d ^ a, 16);          \
    c = c + d;                     \
    b = vrotr(b ^ c, 63);          \
  } while (0)

// POW_LANES work values at once: lane i = nonce0 + i.
inline void pow_value_w(uint64_t nonce0, const uint64_t hash_words[4],
                        uint64_t out[POW_LANES]) {
  vu64 m[16];
  for (int i = 0; i < POW_LANES; i++) m[0][i] = nonce0 + (uint64_t)i;
  m[1] = vsplat(hash_words[0]);
  m[2] = vsplat(hash_words[1]);
  m[3] = vsplat(hash_words[2]);
  m[4] = vsplat(hash_words[3]);
  for (int j = 5; j < 16; j++) m[j] = vsplat(0);
  vu64 v0 = vsplat(H0_POW), v1 = vsplat(IV[1]), v2 = vsplat(IV[2]),
       v3 = vsplat(IV[3]), v4 = vsplat(IV[4]), v5 = vsplat(IV[5]),
       v6 = vsplat(IV[6]), v7 = vsplat(IV[7]), v8 = vsplat(IV[0]),
       v9 = vsplat(IV[1]), v10 = vsplat(IV[2]), v11 = vsplat(IV[3]);
  vu64 v12 = vsplat(IV[4] ^ POW_MSG_LEN);
  vu64 v13 = vsplat(IV[5]);
  vu64 v14 = vsplat(IV[6] ^ ~0ULL);
  vu64 v15 = vsplat(IV[7]);
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = SIGMA[r];
    GV(v0, v4, v8, v12, m[s[0]], m[s[1]]);
    GV(v1, v5, v9, v13, m[s[2]], m[s[3]]);
    GV(v2, v6, v10, v14, m[s[4]], m[s[5]]);
    GV(v3, v7, v11, v15, m[s[6]], m[s[7]]);
    GV(v0, v5, v10, v15, m[s[8]], m[s[9]]);
    GV(v1, v6, v11, v12, m[s[10]], m[s[11]]);
    GV(v2, v7, v8, v13, m[s[12]], m[s[13]]);
    GV(v3, v4, v9, v14, m[s[14]], m[s[15]]);
  }
  vu64 value = vsplat(H0_POW) ^ v0 ^ v8;
  for (int i = 0; i < POW_LANES; i++) out[i] = value[i];
}

#undef GV

#endif  // POW_LANES > 1

struct SearchShared {
  std::atomic<uint64_t> winner{~0ULL};   // ~0 = none yet
  std::atomic<int> found{0};
  std::atomic<uint64_t> hashes{0};
  const volatile int32_t* cancel;       // host-owned flag, may be null
};

// The cancel word is written from a Python thread (ctypes c_int32); read it
// with a real atomic load — plain volatile access is a formal data race.
// The GCC/Clang builtin keeps the C ABI (no std::atomic in the signature).
inline bool cancel_requested(const volatile int32_t* c) {
  return c && __atomic_load_n(const_cast<const int32_t*>(c),
                              __ATOMIC_RELAXED) != 0;
}

// Hashes between checks of the found/cancel atomics: small enough for
// sub-millisecond cancel latency per thread, large enough to amortize.
constexpr uint64_t CHECK_STRIDE = 1 << 16;

void search_thread(const uint64_t hash_words[4], uint64_t difficulty,
                   uint64_t base, uint64_t count, unsigned tid,
                   unsigned nthreads, SearchShared* sh) {
  uint64_t done = 0;
  // Thread t scans blocks t, t+n, t+2n, ... of CHECK_STRIDE nonces. Block
  // count is computed without the blk*CHECK_STRIDE product the old loop
  // condition used, which wrapped for count close to 2^64 (ABI contract:
  // any [base, base+count) mod 2^64 is legal, even if the Python backend
  // only ever passes small chunks).
  const uint64_t nblocks = count / CHECK_STRIDE + (count % CHECK_STRIDE != 0);
  for (uint64_t blk = tid; blk < nblocks; blk += nthreads) {
    if (sh->found.load(std::memory_order_relaxed) ||
        cancel_requested(sh->cancel)) {
      break;
    }
    uint64_t lo = blk * CHECK_STRIDE;
    // count - lo never underflows (lo < count); the old lo+CHECK_STRIDE
    // comparison wrapped on the final block of a near-2^64 range.
    uint64_t hi = (count - lo > CHECK_STRIDE) ? lo + CHECK_STRIDE : count;
    uint64_t off = lo;
#if POW_LANES > 1
    // SIMD body: POW_LANES consecutive nonces per step; lanes checked in
    // ascending order so the reported hit is the block's lowest offset,
    // exactly like the scalar loop.
    // Two independent SIMD streams per iteration: the 12-round chain is
    // serial within a lane set, so a second in-flight set lets the
    // out-of-order core overlap chains and fill idle vector-port slots.
    for (; hi - off >= 2 * (uint64_t)POW_LANES; off += 2 * POW_LANES) {
      uint64_t vals[2 * POW_LANES];
      pow_value_w(base + off, hash_words, vals);
      pow_value_w(base + off + POW_LANES, hash_words, vals + POW_LANES);
      for (int i = 0; i < 2 * POW_LANES; i++) {
        if (vals[i] >= difficulty) {
          uint64_t expect = ~0ULL;
          sh->winner.compare_exchange_strong(expect, base + off + i);
          sh->found.store(1, std::memory_order_release);
          done += off - lo + i + 1;
          sh->hashes.fetch_add(done, std::memory_order_relaxed);
          return;
        }
      }
    }
    for (; hi - off >= (uint64_t)POW_LANES; off += POW_LANES) {
      uint64_t vals[POW_LANES];
      pow_value_w(base + off, hash_words, vals);
      for (int i = 0; i < POW_LANES; i++) {
        if (vals[i] >= difficulty) {
          uint64_t expect = ~0ULL;
          sh->winner.compare_exchange_strong(expect, base + off + i);
          sh->found.store(1, std::memory_order_release);
          done += off - lo + i + 1;
          sh->hashes.fetch_add(done, std::memory_order_relaxed);
          return;
        }
      }
    }
#endif
    for (; off < hi; off++) {
      uint64_t nonce = base + off;  // wraps mod 2^64, as specified
      if (pow_value(nonce, hash_words) >= difficulty) {
        uint64_t expect = ~0ULL;
        sh->winner.compare_exchange_strong(expect, nonce);
        sh->found.store(1, std::memory_order_release);
        done += off - lo + 1;
        sh->hashes.fetch_add(done, std::memory_order_relaxed);
        return;
      }
    }
    done += hi - lo;
  }
  sh->hashes.fetch_add(done, std::memory_order_relaxed);
}

}  // namespace

extern "C" {

// ABI version — bump on any signature change; checked by the ctypes loader.
int bw_abi_version(void) { return 1; }

// Work value of one nonce (for host-side validation / tests).
uint64_t bw_work_value(const uint8_t block_hash[32], uint64_t nonce) {
  uint64_t hw[4];
  std::memcpy(hw, block_hash, 32);  // Nano hashes feed in as raw LE words
  return pow_value(nonce, hw);
}

// Scan [base, base + count) (mod 2^64) with n_threads.
// Returns 1 = found (*nonce_out set), 0 = range exhausted, -1 = cancelled.
// *hashes_done (optional) receives the number of hashes actually evaluated.
// cancel (optional) is polled; set *cancel != 0 to abort from another thread.
int bw_search_range(const uint8_t block_hash[32], uint64_t difficulty,
                    uint64_t base, uint64_t count, int n_threads,
                    const volatile int32_t* cancel, uint64_t* nonce_out,
                    uint64_t* hashes_done) {
  uint64_t hw[4];
  std::memcpy(hw, block_hash, 32);
  if (n_threads < 1) n_threads = 1;
  SearchShared sh;
  sh.cancel = cancel;
  if (n_threads == 1 || count <= CHECK_STRIDE) {
    search_thread(hw, difficulty, base, count, 0, 1, &sh);
  } else {
    // tids 1..n-1 get OS threads; tid 0 runs on the calling thread (one
    // fewer spawn per chunk). A std::thread that fails to spawn (EAGAIN /
    // RLIMIT_NPROC) must NOT unwind across the C ABI into libffi —
    // std::terminate would kill the whole Python process — so spawn
    // failures degrade to running the missing tids inline instead.
    std::vector<std::thread> threads;
    int spawned = 0;
    try {
      threads.reserve(n_threads - 1);  // inside try: reserve can throw too
      for (int t = 1; t < n_threads; t++) {
        threads.emplace_back(search_thread, hw, difficulty, base, count,
                             (unsigned)t, (unsigned)n_threads, &sh);
        spawned++;
      }
    } catch (...) {
      // fall through: tids spawned+1..n-1 run inline below
    }
    search_thread(hw, difficulty, base, count, 0, (unsigned)n_threads, &sh);
    for (int t = spawned + 1; t < n_threads; t++) {
      search_thread(hw, difficulty, base, count, (unsigned)t,
                    (unsigned)n_threads, &sh);
    }
    for (auto& th : threads) th.join();
  }
  if (hashes_done) *hashes_done = sh.hashes.load();
  if (sh.found.load()) {
    if (nonce_out) *nonce_out = sh.winner.load();
    return 1;
  }
  return cancel_requested(cancel) ? -1 : 0;
}

}  // extern "C"
