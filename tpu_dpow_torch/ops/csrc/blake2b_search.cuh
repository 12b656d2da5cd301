// Blake2b compression specialized to the Nano proof-of-work rule.
//
//   work_value = LE_u64( blake2b(digest_size=8, nonce_le || block_hash) )
//
// The 40-byte message is one compression block: m[0] = nonce, m[1..4] = the
// block hash, m[5..15] = 0, byte counter t0 = 40, final flag set; the work
// value is the final h[0]. This is the arithmetic of the Pallas kernel's
// body (tpu_dpow/ops/blake2b.py::compress_h0) on native 64-bit words:
//
//   * every word is a uint64_t; rotr 32 is a swap of the halves, rotr 63 a
//     pair of funnel shifts, and rotr 24 and 16 a funnel-shift pair on the
//     host and two FMA-pipe instructions a half on the card (below);
//   * the 12 rounds are written out flat and SIGMA is only ever a template
//     argument, so every index into m[] and v[] is a compile-time constant
//     and both arrays live in registers;
//   * the adds of the eleven zero message words are dropped at compile time
//     (`if constexpr`), and the last round computes only the value flow into
//     v[0] and v[8] — the same pruning as compress_h0.
//
// What bounds it on the H100. The body is 32-bit integer work on two pipes
// of 64 lanes per SM and clock each: the ALU pipe (LOP3, SHF, PRMT, IADD3)
// and the FMA pipe (IMAD and its forms, IDP). A hash needs 1,982 such
// instructions at least (dpowbench/roofline.py): 720 XORs, which only the
// ALU pipe has, 536 rotate halves and 726 add halves. Plain, nvcc put 1,687
// a nonce on the ALU pipe and 304 on the FMA pipe (the adds' high halves as
// IMAD.X), so the ALU pipe alone set the pace, at 57 % of the roofline.
// What the FMA pipe can take off it, as measured on the card (ptxas 12.9):
//
//   * IMAD, IMAD.X and IDP (dp4a, dp2a) issue at 64 lanes a clock beside
//     the ALU pipe's 64 (LOP3 with either: 128 a clock);
//   * IMAD.HI and IMAD.WIDE issue at 32 and slow the ALU pipe's work beside
//     them: a rotate half moved into them costs more than the funnel shift
//     it frees (rotr 63 as IMAD.HI + IMAD: the loop 4 % slower);
//   * an add's carry comes only from IADD3: ptxas splits mad.wide.u32 with
//     an addend, and mad.lo.cc, into a product and IADD3 + IMAD.X.
//
// So the rotates that move are the byte-aligned ones, each half as a dp4a
// or dp2a of its own word (the bytes that go down) plus an IMAD of the
// other (the bytes that go up):
//
//   rotr 24:  lo' = (lo >> 24) | (hi << 8)  = dp4a(lo, 0x01000000, 0) + hi * 2^8
//   rotr 16:  lo' = (lo >> 16) | (hi << 16) = dp2a.lo(lo, 0x0100, 0) + hi * 2^16
//
// (hi' likewise, with lo and hi swapped): two single-pass FMA-pipe
// instructions for each ALU instruction they free. rotr 63, the XORs and
// the adds' low halves stay on the ALU pipe. The scan loop then issues
// 1,324 ALU- and 1,028 FMA-pipe instructions a nonce (1,325 and 1,031 in
// the run kernel; tests/test_torch_package.py holds the budget on the
// card): the ALU pipe still sets the pace, now at 2,352 instructions a
// nonce that one dispatch a clock has to feed to both pipes.
//
// ptxas keeps these instructions as written, with the multipliers as
// literals: read from __constant__ words instead, the loop's SASS is the
// same. Round 0's column G1-G3 read no nonce and run once per row before the
// scan (on the uniform datapath, which has no IDP): they keep the plain
// form, since with the FMA form ptxas left part of them in the loop (+40
// ALU-pipe instructions a nonce).
//
// The functions are __host__ __device__ under nvcc and plain inline C++
// elsewhere, so g++ compiles the same arithmetic for the CPU tests
// (tests/test_torch_package.py): the host keeps plain rotations, and each
// FMA-pipe form is a host function too, held there against them.
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

// The FMA-pipe instructions the card's rotations use: PTX on the card, the
// same function of the operands on the host.
// mad.lo.u32: a * b + c (mod 2^32).
B2_FN uint32_t mad_lo(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return a * b + c;
#endif
}
// dp4a.u32.u32: c + the sum over i < 4 of byte i of a times byte i of b.
B2_FN uint32_t dp4a(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("dp4a.u32.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  for (int i = 0; i < 32; i += 8) c += ((a >> i) & 0xFFu) * ((b >> i) & 0xFFu);
  return c;
#endif
}
// dp2a.lo.u32.u32: c + the sum over i < 2 of 16-bit half i of a times byte
// i of b.
B2_FN uint32_t dp2a_lo(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("dp2a.lo.u32.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
#else
  return c + (a & 0xFFFFu) * (b & 0xFFu) + (a >> 16) * ((b >> 8) & 0xFFu);
#endif
}

// rotr 24 and rotr 16 from them: with `up` = 2^8 (2^16) and `down` the
// selector of the top byte (16-bit half), ROT24_* (ROT16_*), equal to
// rotr24 (rotr16) for every word.
constexpr uint32_t ROT24_UP = 1u << 8, ROT24_DOWN = 0x01000000u;
constexpr uint32_t ROT16_UP = 1u << 16, ROT16_DOWN = 0x0100u;
B2_FN uint64_t rotr24_fma(uint64_t x, uint32_t up, uint32_t down) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return mad_lo(hi, up, dp4a(lo, down, 0)) |
         static_cast<uint64_t>(mad_lo(lo, up, dp4a(hi, down, 0))) << 32;
}
B2_FN uint64_t rotr16_fma(uint64_t x, uint32_t up, uint32_t down) {
  const uint32_t lo = static_cast<uint32_t>(x), hi = static_cast<uint32_t>(x >> 32);
  return mad_lo(hi, up, dp2a_lo(lo, down, 0)) |
         static_cast<uint64_t>(mad_lo(lo, up, dp2a_lo(hi, down, 0))) << 32;
}

// The body's rotr 24 and 16: on the card through the FMA pipe where FMA
// is set, plain otherwise.
template <bool FMA>
B2_FN uint64_t rot24(uint64_t x) {
#ifdef __CUDA_ARCH__
  if constexpr (FMA) return rotr24_fma(x, ROT24_UP, ROT24_DOWN);
#endif
  return rotr24(x);
}
template <bool FMA>
B2_FN uint64_t rot16(uint64_t x) {
#ifdef __CUDA_ARCH__
  if constexpr (FMA) return rotr16_fma(x, ROT16_UP, ROT16_DOWN);
#endif
  return rotr16(x);
}

// How far a G is computed: FULL, or only through the second update of a
// (A2) or of c (C2) — the final round's pruning.
enum Stop { FULL = 0, A2 = 1, C2 = 2 };

// The G mixing function. X and Y are the SIGMA entries of this G; only
// m[0..4] are non-zero, so the add of a word with index >= 5 is not emitted.
// FMA: rotr 24 and 16 through the FMA pipe on the card.
template <int X, int Y, int STOP, bool FMA = true>
B2_FN void g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, const uint64_t (&m)[5]) {
  a = a + b;
  if constexpr (X < 5) a = a + m[X];
  d = rotr32(d ^ a);
  c = c + d;
  b = rot24<FMA>(b ^ c);
  a = a + b;
  if constexpr (Y < 5) a = a + m[Y];
  if constexpr (STOP != A2) {
    d = rot16<FMA>(d ^ a);
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
  // Round 0: the column G1-G3 read no nonce and are hoisted out of the
  // scan; they keep the plain form (see the note at the top).
  g<0, 1, FULL>(v[0], v[4], v[8], v[12], m);
  g<2, 3, FULL, false>(v[1], v[5], v[9], v[13], m);
  g<4, 5, FULL, false>(v[2], v[6], v[10], v[14], m);
  g<6, 7, FULL, false>(v[3], v[7], v[11], v[15], m);
  g<8, 9, FULL>(v[0], v[5], v[10], v[15], m);
  g<10, 11, FULL>(v[1], v[6], v[11], v[12], m);
  g<12, 13, FULL>(v[2], v[7], v[8], v[13], m);
  g<14, 15, FULL>(v[3], v[4], v[9], v[14], m);
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
