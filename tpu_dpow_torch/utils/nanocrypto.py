"""Host-side Nano protocol primitives — the rebuild's replacement for nanolib.

The port's own copy of ``tpu_dpow/utils/nanocrypto.py`` (stdlib only), kept
so that ``tpu_dpow_torch`` imports nothing of the JAX package.

The reference leans on the ``nanolib`` pip package (C-accelerated) for work
validation and difficulty math (reference server/dpow_server.py:52,130,
255-282,363-368; server/scripts/payouts.py:56-58). This module provides the
same capability surface in pure Python on top of ``hashlib.blake2b``:

  * work_value / validate_work      — the PoW acceptance rule
  * derive_work_difficulty          — multiplier → 64-bit difficulty
  * derive_work_multiplier          — difficulty → multiplier
  * validate_difficulty / validate_block_hash / validate_work_hex
  * account codec                   — nano_... address ↔ 32-byte public key,
                                      blake2b(5)-checksum verified
  * raw ↔ Nano denomination helpers — used by the payout CLI

Device-side validation of candidate nonces lives in ops/blake2b.py; this
module is the authoritative host check applied before anything is returned to
a service (mirroring the reference's final nanolib.validate_work at
server/dpow_server.py:363-368).
"""

from __future__ import annotations

import hashlib
import re
import struct
from decimal import Decimal, localcontext

# Nano mainnet send/base difficulty at the time of the reference snapshot
# (reference docs/specification.md:30).
BASE_DIFFICULTY = 0xFFFFFFC000000000
MAX_U64 = (1 << 64) - 1

# \Z, not $: '$' also matches before a trailing newline, so 'HASH\n' would
# validate and the newline would ride into store keys, winner locks, and
# wire payloads — two distinct keys (and winner elections) for one block.
_HASH_RE = re.compile(r"^[0-9A-Fa-f]{64}\Z")
_WORK_RE = re.compile(r"^[0-9A-Fa-f]{16}\Z")
_DIFFICULTY_RE = re.compile(r"^[0-9A-Fa-f]{1,16}\Z")

# Nano's base32 alphabet (no 0, 2, l, v).
_B32_ALPHABET = "13456789abcdefghijkmnopqrstuwxyz"
_B32_INDEX = {c: i for i, c in enumerate(_B32_ALPHABET)}

RAW_PER_NANO = 10**30


class InvalidWork(ValueError):
    pass


class InvalidBlockHash(ValueError):
    pass


class InvalidDifficulty(ValueError):
    pass


class InvalidMultiplier(ValueError):
    pass


class InvalidAccount(ValueError):
    pass


def validate_block_hash(block_hash: str) -> str:
    """64 hex chars; returns the uppercase canonical form."""
    if not isinstance(block_hash, str) or not _HASH_RE.match(block_hash):
        raise InvalidBlockHash(f"invalid block hash: {block_hash!r}")
    return block_hash.upper()


def validate_work_hex(work: str) -> str:
    """16 hex chars (8-byte nonce); returns lowercase canonical form."""
    if not isinstance(work, str) or not _WORK_RE.match(work):
        raise InvalidWork(f"invalid work: {work!r}")
    return work.lower()


def validate_difficulty(difficulty: str) -> str:
    """Hex string ≤16 chars; returns 16-char zero-padded lowercase form."""
    if not isinstance(difficulty, str) or not _DIFFICULTY_RE.match(difficulty):
        raise InvalidDifficulty(f"invalid difficulty: {difficulty!r}")
    return f"{int(difficulty, 16):016x}"


def work_value(block_hash: str, work: str) -> int:
    """LE-u64 of blake2b(digest_size=8, work_le || hash_bytes).

    Nano's convention: ``work`` hex encodes the nonce big-endian, but the
    hashed message takes it little-endian.
    """
    h = bytes.fromhex(validate_block_hash(block_hash))
    w = int(validate_work_hex(work), 16)
    digest = hashlib.blake2b(struct.pack("<Q", w) + h, digest_size=8).digest()
    return int.from_bytes(digest, "little")


def work_value_int(hash_bytes: bytes, nonce: int) -> int:
    """:func:`work_value` for a raw int nonce + raw 32-byte hash — the
    hot form planted-difficulty tests, demos and host-side brute loops
    use (no hex round trip, no validation)."""
    digest = hashlib.blake2b(
        struct.pack("<Q", nonce & 0xFFFFFFFFFFFFFFFF) + hash_bytes,
        digest_size=8,
    ).digest()
    return int.from_bytes(digest, "little")


def validate_work(block_hash: str, work: str, difficulty: int | str = BASE_DIFFICULTY) -> str:
    """Raise InvalidWork unless the work meets the difficulty; returns work."""
    if isinstance(difficulty, str):
        difficulty = int(validate_difficulty(difficulty), 16)
    work = validate_work_hex(work)
    if work_value(block_hash, work) < difficulty:
        raise InvalidWork(f"work {work} below difficulty {difficulty:016x}")
    return work


def derive_work_difficulty(multiplier: float, base_difficulty: int = BASE_DIFFICULTY) -> int:
    """difficulty such that expected work is ``multiplier`` × the base's.

    Nano rule: multiplier = (2^64 - base) / (2^64 - difficulty).
    """
    if not (multiplier > 0):
        raise InvalidMultiplier(f"multiplier must be > 0, got {multiplier}")
    diff = (1 << 64) - int(((1 << 64) - base_difficulty) / multiplier)
    if diff > MAX_U64:
        raise InvalidMultiplier(f"multiplier {multiplier} overflows difficulty")
    return max(diff, 1) & MAX_U64


def derive_work_multiplier(difficulty: int | str, base_difficulty: int = BASE_DIFFICULTY) -> float:
    if isinstance(difficulty, str):
        difficulty = int(validate_difficulty(difficulty), 16)
    return ((1 << 64) - base_difficulty) / ((1 << 64) - difficulty)


def expected_hashes(difficulty: int) -> float:
    """Expected blake2b evaluations per solution at a difficulty."""
    return (1 << 64) / ((1 << 64) - difficulty)


# --------------------------------------------------------------------------
# Account codec: nano_<52 chars pubkey><8 chars checksum>
# 260 bits encode the 256-bit public key (4 leading pad bits); the checksum is
# blake2b(digest_size=5) of the key, byte-reversed, in 40 bits.
# --------------------------------------------------------------------------


def _b32_encode(data: bytes, bits: int) -> str:
    value = int.from_bytes(data, "big")
    chars = []
    for shift in range(bits - 5, -5, -5):
        chars.append(_B32_ALPHABET[(value >> shift) & 0x1F])
    return "".join(chars)


def _b32_decode(text: str, bits: int) -> bytes:
    value = 0
    for c in text:
        try:
            value = (value << 5) | _B32_INDEX[c]
        except KeyError:
            raise InvalidAccount(f"invalid base32 char {c!r}")
    return value.to_bytes((bits + 7) // 8, "big")


def _checksum(pubkey: bytes) -> bytes:
    return hashlib.blake2b(pubkey, digest_size=5).digest()[::-1]


def encode_account(pubkey: bytes, prefix: str = "nano_") -> str:
    if len(pubkey) != 32:
        raise InvalidAccount(f"public key must be 32 bytes, got {len(pubkey)}")
    return prefix + _b32_encode(b"\x00" + pubkey, 260) + _b32_encode(_checksum(pubkey), 40)


def decode_account(account: str) -> bytes:
    """Validate an address (either nano_ or xrb_ prefix) → 32-byte public key."""
    if not isinstance(account, str):
        raise InvalidAccount("account must be a string")
    for prefix in ("nano_", "xrb_"):
        if account.startswith(prefix):
            body = account[len(prefix):]
            break
    else:
        raise InvalidAccount(f"unknown account prefix: {account[:8]!r}")
    if len(body) != 60:
        raise InvalidAccount(f"account body must be 60 chars, got {len(body)}")
    raw = _b32_decode(body[:52], 260)
    # 260 bits in a 33-byte container: the 4 pad bits are bits 256..259 —
    # the LOW nibble of byte 0 (the high nibble is structurally zero).
    # Rejecting nonzero padding makes the address encoding canonical: without
    # it every public key has 16 accepted spellings, and payout accounting
    # keyed on the address string could be split across aliases.
    if raw[0] & 0x0F:
        raise InvalidAccount("invalid account: nonzero padding bits")
    pubkey = raw[1:]
    if _b32_decode(body[52:], 40) != _checksum(pubkey):
        raise InvalidAccount(f"bad account checksum: {account}")
    return pubkey


def validate_account(account: str) -> str:
    """Validate → the CANONICAL nano_ spelling.

    xrb_ is accepted on input but never returned: reward accounting keys
    on the address string (client:{addr}, the clients set), so returning
    the input verbatim would split one worker's credit across two alias
    spellings — the same alias-splitting the codec's pad-bit rejection
    exists to prevent. Callers must use the return value.
    """
    decode_account(account)
    if account.startswith("xrb_"):
        return "nano_" + account[len("xrb_"):]
    return account


def is_valid_account(account: str) -> bool:
    try:
        decode_account(account)
        return True
    except InvalidAccount:
        return False


def nano_to_raw(amount: str | float | Decimal) -> int:
    with localcontext() as ctx:
        ctx.prec = 50
        return int(Decimal(str(amount)) * RAW_PER_NANO)


def raw_to_nano(raw: int) -> Decimal:
    # Default Decimal context is 28 significant digits; supply-scale raw
    # amounts have 39 — the payout CLI would display silently rounded
    # balances for the operator to confirm against exact raw sends.
    with localcontext() as ctx:
        ctx.prec = 50
        return Decimal(raw) / RAW_PER_NANO
