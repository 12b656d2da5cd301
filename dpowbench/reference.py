"""The plain reference: Nano's proof of work checked with hashlib alone.

A work string ``w`` (16 hex digits, the nonce as the hub serves it) is valid
for block hash ``h`` at threshold ``t`` when the little-endian u64 of
``blake2b(nonce_le || h, digest_size=8)`` is at least ``t``. This module
imports nothing of the port and takes nothing the port made but the answers
it judges.
"""

from __future__ import annotations

import hashlib


def work_value(block_hash: str, work: str) -> int:
    nonce = int(work, 16).to_bytes(8, "little")
    digest = hashlib.blake2b(nonce + bytes.fromhex(block_hash), digest_size=8).digest()
    return int.from_bytes(digest, "little")


def valid(block_hash: str, work, threshold: int) -> bool:
    """True only for a 16-hex-digit work string that meets ``threshold``."""
    if not isinstance(work, str) or len(work) != 16:
        return False
    try:
        return work_value(block_hash, work) >= threshold
    except ValueError:
        return False


def solve(block_hash: str, threshold: int, start: int = 0) -> str:
    """The lowest nonce from ``start`` whose work meets ``threshold`` (for
    tests, at small thresholds)."""
    h = bytes.fromhex(block_hash)
    nonce = start
    while True:
        digest = hashlib.blake2b(nonce.to_bytes(8, "little") + h, digest_size=8).digest()
        if int.from_bytes(digest, "little") >= threshold:
            return f"{nonce:016x}"
        nonce += 1
