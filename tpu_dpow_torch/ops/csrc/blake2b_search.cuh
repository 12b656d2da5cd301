// Blake2b compression specialized to the Nano proof-of-work rule.
//
//   work_value = LE_u64( blake2b(digest_size=8, nonce_le || block_hash) )
//
// The 40-byte message is one compression block: m[0] = nonce, m[1..4] = the
// block hash, m[5..15] = 0, byte counter t0 = 40, final flag set; the work
// value is the final h[0]. This is the arithmetic of the Pallas kernel's
// body (tpu_dpow/ops/blake2b.py::compress_h0) on native 64-bit words:
//
//   * every word is a uint64_t; rotr 32 is a swap of the halves, rotr
//     24/16/63 are shift pairs that nvcc lowers to funnel shifts;
//   * the 12 rounds are written out flat and SIGMA is only ever a template
//     argument, so every index into m[] and v[] is a compile-time constant
//     and both arrays live in registers;
//   * the adds of the eleven zero message words are dropped at compile time
//     (`if constexpr`), and the last round computes only the value flow into
//     v[0] and v[8] — the same pruning as compress_h0.
//
// The functions are __host__ __device__ under nvcc and plain inline C++
// elsewhere, so g++ compiles the same arithmetic for the CPU tests
// (tests/test_torch_package.py).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define B2_FN __host__ __device__ __forceinline__
#else
#define B2_FN static inline
#endif

namespace b2pow {

constexpr uint64_t IV0 = 0x6A09E667F3BCC908ULL;
constexpr uint64_t IV1 = 0xBB67AE8584CAA73BULL;
constexpr uint64_t IV2 = 0x3C6EF372FE94F82BULL;
constexpr uint64_t IV3 = 0xA54FF53A5F1D36F1ULL;
constexpr uint64_t IV4 = 0x510E527FADE682D1ULL;
constexpr uint64_t IV5 = 0x9B05688C2B3E6C1FULL;
constexpr uint64_t IV6 = 0x1F83D9ABFB41BD6BULL;
constexpr uint64_t IV7 = 0x5BE0CD19137E2179ULL;
// h[0] of a keyless instance with an 8-byte digest.
constexpr uint64_t H0_POW = IV0 ^ 0x01010000ULL ^ 8ULL;
constexpr uint64_t POW_MESSAGE_LEN = 40;

B2_FN uint64_t rotr32(uint64_t x) { return (x >> 32) | (x << 32); }
B2_FN uint64_t rotr24(uint64_t x) { return (x >> 24) | (x << 40); }
B2_FN uint64_t rotr16(uint64_t x) { return (x >> 16) | (x << 48); }
B2_FN uint64_t rotr63(uint64_t x) { return (x >> 63) | (x << 1); }

// How far a G is computed: FULL, or only through the second update of a
// (A2) or of c (C2) — the final round's pruning.
enum Stop { FULL = 0, A2 = 1, C2 = 2 };

// The G mixing function. X and Y are the SIGMA entries of this G; only
// m[0..4] are non-zero, so the add of a word with index >= 5 is not emitted.
template <int X, int Y, int STOP>
B2_FN void g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, const uint64_t (&m)[5]) {
  a = a + b;
  if constexpr (X < 5) a = a + m[X];
  d = rotr32(d ^ a);
  c = c + d;
  b = rotr24(b ^ c);
  a = a + b;
  if constexpr (Y < 5) a = a + m[Y];
  if constexpr (STOP != A2) {
    d = rotr16(d ^ a);
    c = c + d;
    if constexpr (STOP != C2) b = rotr63(b ^ c);
  }
}

#define B2_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  g<s0, s1, FULL>(v[0], v[4], v[8], v[12], m);                                          \
  g<s2, s3, FULL>(v[1], v[5], v[9], v[13], m);                                          \
  g<s4, s5, FULL>(v[2], v[6], v[10], v[14], m);                                         \
  g<s6, s7, FULL>(v[3], v[7], v[11], v[15], m);                                         \
  g<s8, s9, FULL>(v[0], v[5], v[10], v[15], m);                                         \
  g<s10, s11, FULL>(v[1], v[6], v[11], v[12], m);                                       \
  g<s12, s13, FULL>(v[2], v[7], v[8], v[13], m);                                        \
  g<s14, s15, FULL>(v[3], v[4], v[9], v[14], m);

// Work value of `nonce` against the block hash words m1..m4 (little-endian
// u64 words of the 32-byte hash).
B2_FN uint64_t pow_value(uint64_t nonce, uint64_t m1, uint64_t m2, uint64_t m3, uint64_t m4) {
  const uint64_t m[5] = {nonce, m1, m2, m3, m4};
  uint64_t v[16] = {H0_POW, IV1, IV2, IV3, IV4, IV5, IV6, IV7,
                    IV0,    IV1, IV2, IV3, IV4 ^ POW_MESSAGE_LEN, IV5, ~IV6, IV7};
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  B2_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  // Round 12 (SIGMA[11] = 14 10 4 8 9 15 13 6 1 12 0 2 11 7 5 3), pruned:
  // h[0] reads v[0] (diagonal G0's second a) and v[8] (diagonal G2's
  // second c). Columns 0 and 2 skip their last b; diagonals 1 and 3 write
  // nothing h[0] reads and are dropped.
  g<14, 10, C2>(v[0], v[4], v[8], v[12], m);
  g<4, 8, FULL>(v[1], v[5], v[9], v[13], m);
  g<9, 15, C2>(v[2], v[6], v[10], v[14], m);
  g<13, 6, FULL>(v[3], v[7], v[11], v[15], m);
  g<1, 12, A2>(v[0], v[5], v[10], v[15], m);
  g<11, 7, C2>(v[2], v[7], v[8], v[13], m);
  return H0_POW ^ v[0] ^ v[8];
}

#undef B2_ROUND

}  // namespace b2pow
