"""Blake2b compression specialized for the Nano proof-of-work rule, in PyTorch.

Counterpart of ``tpu_dpow/ops/blake2b.py`` + ``tpu_dpow/ops/u64.py``. Nano's
PoW: find an 8-byte nonce ``w`` such that

    work_value = LE_u64( blake2b(digest_size=8, w_le || block_hash) )
    work_value >= difficulty

The message is exactly 40 bytes (one compression block, keyless, 8-byte
digest), so the hash is a single compression with t0 = 40 and the final
flag set, and the work value is the final h[0] word.

The JAX package carries every 64-bit word as a (lo, hi) uint32 pair because
the TPU VPU is 32-bit. PyTorch has 64-bit integer lanes on both the CPU and
the GPU, but its unsigned dtypes have no add, shift or compare, so the plain
version here works on **int64** lanes holding the u64 bit pattern:

  * add wraps in two's complement, which is exactly u64 add;
  * ``>>`` is arithmetic, so every logical shift or rotate masks its result;
  * unsigned ``>=`` compares after flipping the sign bit of both sides.

This is the plain version of the CUDA kernel's arithmetic
(``ops/csrc/blake2b_search.cuh``): the CPU tests run it, and the chip check
holds the kernel against it on the card. Verified bit-exactly against
``hashlib.blake2b`` in tests/test_torch_blake2b.py.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

# Blake2b IV (RFC 7693 §2.6).
IV = (
    0x6A09E667F3BCC908,
    0xBB67AE8584CAA73B,
    0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1,
    0x510E527FADE682D1,
    0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B,
    0x5BE0CD19137E2179,
)

# Message schedule (RFC 7693 §2.7); Blake2b runs 12 rounds, rounds 10 and 11
# repeat permutations 0 and 1.
SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
)

# h[0] for a keyless, 8-byte-digest instance: IV[0] ^ 0x0101_0000 ^ digest_len.
POW_DIGEST_SIZE = 8
POW_MESSAGE_LEN = 40  # 8-byte nonce || 32-byte block hash
H0_POW = IV[0] ^ 0x01010000 ^ POW_DIGEST_SIZE

MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)  # int64 with only the sign bit set

# A message word: an int64 tensor, or None for a word that is constant zero
# (m[5..15] of the 40-byte PoW message) — its adds are skipped outright.
Word = Optional[torch.Tensor]


def to_i64(x: int) -> int:
    """u64 Python int → the int64 Python int with the same bit pattern."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def to_u64(x: int) -> int:
    """int64 bit pattern (Python int) → the u64 it encodes."""
    return int(x) & MASK64


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    """u64 rotate right on int64 lanes: the arithmetic >> is masked."""
    return ((x >> n) & ((1 << (64 - n)) - 1)) | (x << (64 - n))


def _g_prefix(
    v: List[torch.Tensor], a: int, b: int, c: int, d: int, x: Word, y: Word, stop: str
) -> None:
    """G computed only through the named output, written back in place.

    ``stop``: ``"full"`` is the complete G; ``"a2"`` stops after the second
    v[a] update; ``"c2"`` after the second v[c] update. Same pruning as
    ``tpu_dpow/ops/blake2b.py::_g_prefix``; the caller reads only the slots
    the chosen stop finalizes.
    """
    va = v[a] + v[b] if x is None else v[a] + v[b] + x
    vd = _rotr(v[d] ^ va, 32)
    vc = v[c] + vd
    vb = _rotr(v[b] ^ vc, 24)
    va = va + vb if y is None else va + vb + y
    if stop != "a2":
        vd = _rotr(vd ^ va, 16)
        vc = vc + vd
        if stop != "c2":
            vb = _rotr(vb ^ vc, 63)
    v[a], v[b], v[c], v[d] = va, vb, vc, vd


def _round(v: List[torch.Tensor], s: Sequence[int], m: Sequence[Word]) -> None:
    """One full Blake2b round: 4 column G's then 4 diagonal G's."""
    _g_prefix(v, 0, 4, 8, 12, m[s[0]], m[s[1]], "full")
    _g_prefix(v, 1, 5, 9, 13, m[s[2]], m[s[3]], "full")
    _g_prefix(v, 2, 6, 10, 14, m[s[4]], m[s[5]], "full")
    _g_prefix(v, 3, 7, 11, 15, m[s[6]], m[s[7]], "full")
    _g_prefix(v, 0, 5, 10, 15, m[s[8]], m[s[9]], "full")
    _g_prefix(v, 1, 6, 11, 12, m[s[10]], m[s[11]], "full")
    _g_prefix(v, 2, 7, 8, 13, m[s[12]], m[s[13]], "full")
    _g_prefix(v, 3, 4, 9, 14, m[s[14]], m[s[15]], "full")


def compress_h0(like: torch.Tensor, m: Sequence[Word], t0: int) -> torch.Tensor:
    """Blake2b compression of the PoW instance, specialized to h[0].

    ``like`` fixes the lanes' shape and device; ``m`` holds the 16 message
    words (None = constant zero). The final-block flag is always set. The
    last round computes only the value flow into v[0] and v[8] — the same
    trace-time pruning as ``tpu_dpow/ops/blake2b.py::compress_h0``.
    """
    h = [H0_POW] + list(IV[1:])
    init = h + list(IV)
    init[12] ^= t0
    init[14] ^= MASK64
    v = [torch.full_like(like, to_i64(c)) for c in init]
    for r in range(11):
        _round(v, SIGMA[r], m)
    s = SIGMA[11]
    _g_prefix(v, 0, 4, 8, 12, m[s[0]], m[s[1]], "c2")
    _g_prefix(v, 1, 5, 9, 13, m[s[2]], m[s[3]], "full")
    _g_prefix(v, 2, 6, 10, 14, m[s[4]], m[s[5]], "c2")
    _g_prefix(v, 3, 7, 11, 15, m[s[6]], m[s[7]], "full")
    _g_prefix(v, 0, 5, 10, 15, m[s[8]], m[s[9]], "a2")
    _g_prefix(v, 2, 7, 8, 13, m[s[12]], m[s[13]], "c2")
    return v[0] ^ v[8] ^ to_i64(h[0])


def hash_to_message_words(block_hash: bytes) -> np.ndarray:
    """32-byte block hash → the 4 fixed message words m[1..4], as uint32[8].

    Layout: [m1_lo, m1_hi, m2_lo, m2_hi, m3_lo, m3_hi, m4_lo, m4_hi] — the
    params-row layout both packages share.
    """
    if len(block_hash) != 32:
        raise ValueError(f"block hash must be 32 bytes, got {len(block_hash)}")
    words = np.frombuffer(block_hash, dtype="<u8")
    out = np.empty(8, dtype=np.uint32)
    out[0::2] = (words & 0xFFFFFFFF).astype(np.uint32)
    out[1::2] = (words >> 32).astype(np.uint32)
    return out


MsgWords = Union[torch.Tensor, Sequence[torch.Tensor]]


def pow_work_value(nonce: torch.Tensor, msg_words: MsgWords) -> torch.Tensor:
    """Work value for nonce(s) against a block hash, as int64 bit patterns.

    ``nonce`` is an int64 tensor of any shape holding u64 nonces;
    ``msg_words`` the 4 u64 words m[1..4] as int64 tensors broadcastable
    against it (a [..., 4] tensor or a sequence of 4). m[5..15] are zero
    and their adds are skipped.
    """
    m: List[Word] = [nonce] + [msg_words[..., i] if isinstance(msg_words, torch.Tensor)
                               else msg_words[i] for i in range(4)]
    m.extend([None] * 11)
    return compress_h0(nonce, m, POW_MESSAGE_LEN)


def geq_u64(a: torch.Tensor, b: Union[torch.Tensor, int]) -> torch.Tensor:
    """Unsigned a >= b on int64 bit patterns: flip both sign bits, compare."""
    return (a ^ _SIGN) >= (b ^ _SIGN)


def pow_meets_difficulty(
    nonce: torch.Tensor, msg_words: MsgWords, difficulty: Union[torch.Tensor, int]
) -> torch.Tensor:
    """Elementwise: does blake2b_8(nonce || hash) meet the difficulty?

    ``difficulty`` is an int64 bit pattern (tensor or Python int).
    """
    return geq_u64(pow_work_value(nonce, msg_words), difficulty)
