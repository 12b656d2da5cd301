"""Port's Blake2b PoW arithmetic (int64 lanes) vs hashlib and the JAX package.

Inputs are seeded numpy arrays handed to both packages; the tolerance is
bit-exact everywhere (integer hashing).
"""

import hashlib
import struct

import jax
import numpy as np
import torch

from tpu_dpow.ops import blake2b as jax_blake2b
from tpu_dpow_torch.ops import blake2b

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

MASK64 = (1 << 64) - 1


def ref_work_value(nonce: int, block_hash: bytes) -> int:
    d = hashlib.blake2b(struct.pack("<Q", nonce) + block_hash, digest_size=8).digest()
    return int.from_bytes(d, "little")


def i64(values: np.ndarray) -> torch.Tensor:
    """uint64 numpy → int64 tensor with the same bits."""
    return torch.from_numpy(np.array(values, dtype=np.uint64).view(np.int64))


def u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def msg_words(block_hash: bytes) -> torch.Tensor:
    return i64(np.frombuffer(block_hash, dtype="<u8"))


def test_constants_match_jax_package():
    assert blake2b.IV == jax_blake2b.IV
    assert blake2b.SIGMA == jax_blake2b.SIGMA
    assert blake2b.H0_POW == jax_blake2b.H0_POW
    assert blake2b.POW_MESSAGE_LEN == jax_blake2b.POW_MESSAGE_LEN


def test_hash_to_message_words_matches_jax_package():
    rng = np.random.default_rng(5)
    for _ in range(8):
        h = rng.bytes(32)
        np.testing.assert_array_equal(
            blake2b.hash_to_message_words(h), jax_blake2b.hash_to_message_words(h)
        )


def test_rotr_all_used_amounts():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 64, size=64, dtype=np.uint64)
    for n in (16, 24, 32, 63, 1, 7, 33, 48):
        got = u64(blake2b._rotr(i64(x), n))
        want = (x >> np.uint64(n)) | (x << np.uint64(64 - n))
        np.testing.assert_array_equal(got, want, err_msg=f"rotr {n}")


def test_geq_u64_edges():
    vals = [0, 1, 0xFFFFFFFF, 0x100000000, 1 << 63, (1 << 63) - 1,
            0xFFFFFFFF00000000, MASK64]
    a = i64(np.array([x for x in vals for _ in vals], dtype=np.uint64))
    b = i64(np.array([y for _ in vals for y in vals], dtype=np.uint64))
    got = blake2b.geq_u64(a, b).numpy()
    want = np.array([x >= y for x in vals for y in vals])
    np.testing.assert_array_equal(got, want)
    # A Python-int difficulty goes through the same sign flip.
    for d in vals:
        got = blake2b.geq_u64(a[: len(vals)], blake2b.to_i64(d)).numpy()
        np.testing.assert_array_equal(got, np.array([vals[0] >= d] * len(vals)))


def test_pow_work_value_scalar_golden():
    """tests/test_blake2b.py's scalar vectors (seed 2): hashlib and the JAX
    package's pow_work_value, on the same seeded hashes and nonces."""
    rng = np.random.default_rng(2)
    hashes, nonces = [], []
    for _ in range(50):
        hashes.append(rng.bytes(32))
        nonces.append(
            int(rng.integers(0, 1 << 63, dtype=np.uint64)) * 2 + int(rng.integers(0, 2))
        )
    nonce_arr = np.array(nonces, dtype=np.uint64)
    msgs = np.stack([np.frombuffer(h, dtype="<u8") for h in hashes])
    got = u64(blake2b.pow_work_value(i64(nonce_arr), i64(msgs)))
    want = np.array([ref_work_value(n, h) for n, h in zip(nonces, hashes)], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)

    words = np.stack([jax_blake2b.hash_to_message_words(h) for h in hashes])  # [50, 8]
    lo = (nonce_arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (nonce_arr >> np.uint64(32)).astype(np.uint32)
    jlo, jhi = jax.jit(lambda lo, hi, w: jax_blake2b.pow_work_value(
        (lo, hi), [w[:, i] for i in range(8)]))(lo, hi, words)
    jax_vals = np.asarray(jhi).astype(np.uint64) << np.uint64(32) | np.asarray(jlo)
    np.testing.assert_array_equal(got, jax_vals)


def test_pow_work_value_batched_golden():
    """tests/test_blake2b.py's batched vectors (seed 3): one hash, [4, 128]
    nonces, broadcast message words."""
    rng = np.random.default_rng(3)
    block_hash = rng.bytes(32)
    nonces = rng.integers(0, 1 << 64, size=(4, 128), dtype=np.uint64)
    got = u64(blake2b.pow_work_value(i64(nonces), msg_words(block_hash)))
    want = np.array(
        [[ref_work_value(int(n), block_hash) for n in row] for row in nonces], dtype=np.uint64
    )
    np.testing.assert_array_equal(got, want)


def test_compress_h0_pruning_matches_hashlib_on_edge_nonces():
    """The final-round-pruned compression on nonces at the limb and sign
    boundaries (seed 7 hashes)."""
    rng = np.random.default_rng(7)
    edges = [0, 1, 0xFFFFFFFF, 0x100000000, (1 << 63) - 1, 1 << 63, MASK64 - 1, MASK64]
    for _ in range(6):
        block_hash = rng.bytes(32)
        got = u64(blake2b.pow_work_value(i64(np.array(edges, dtype=np.uint64)),
                                         msg_words(block_hash)))
        want = [ref_work_value(n, block_hash) for n in edges]
        np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))


def test_pow_meets_difficulty_matches_reference_rule():
    rng = np.random.default_rng(4)
    block_hash = rng.bytes(32)
    nonces = rng.integers(0, 1 << 64, size=64, dtype=np.uint64)
    vals = np.array([ref_work_value(int(n), block_hash) for n in nonces], dtype=np.uint64)
    difficulty = int(np.sort(vals)[32])  # the median: both outcomes occur
    ok = blake2b.pow_meets_difficulty(i64(nonces), msg_words(block_hash),
                                      blake2b.to_i64(difficulty))
    np.testing.assert_array_equal(ok.numpy(), vals >= np.uint64(difficulty))
