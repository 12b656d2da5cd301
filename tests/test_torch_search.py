"""Port's chunk search vs the JAX package's XLA path and Pallas kernel.

The same seeded rows, packed by either package, go through
``tpu_dpow_torch``'s plain search (and the CUDA wrapper's CPU route) and
through ``tpu_dpow``'s ``search_chunk_batch`` and
``pallas_search_chunk_batch(..., interpret=True)``. Bit-exact throughout.
"""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dpow.ops import pallas_kernel
from tpu_dpow.ops import search as jax_search
from tpu_dpow_torch.ops import cuda_kernel, search

# The suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding out the others on the same cores.
torch.set_num_threads(1)

MAX_U64 = (1 << 64) - 1
EASY = 0xFFF0000000000000  # ~1 in 4096 nonces


def ref_value(nonce: int, h: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(struct.pack("<Q", nonce & MAX_U64) + h, digest_size=8).digest(),
        "little",
    )


def seeded_rows(seed: int) -> list:
    """(hash, difficulty, base): 2 pads, a 2^32 and a 2^64 carry, easy rows
    and one dry row."""
    rng = np.random.default_rng(seed)
    return [
        (rng.bytes(32), 0, int(rng.integers(0, 1 << 62))),  # pad
        (bytes(32), 0, 0),  # pad, as the engines pack it
        (rng.bytes(32), EASY, (5 << 32) - 100),  # crosses 2^32
        (rng.bytes(32), EASY, MAX_U64 - 100),  # crosses 2^64
        (rng.bytes(32), 0xFFFC000000000000, int(rng.integers(0, 1 << 62))),
        (rng.bytes(32), MAX_U64, int(rng.integers(0, 1 << 62))),  # dry
    ]


def pack_both(rows) -> tuple:
    mine = np.stack([search.pack_params(h, d, b) for h, d, b in rows])
    theirs = np.stack([jax_search.pack_params(h, d, b) for h, d, b in rows])
    return mine, theirs


def plain(rows_u32: np.ndarray, span: int) -> np.ndarray:
    return search.offsets_to_numpy(
        search.search_chunk_batch(search.params_from_numpy(rows_u32), chunk_size=span)
    )


def brute_first(h: bytes, difficulty: int, base: int, window: int):
    for off in range(window):
        if ref_value(base + off, h) >= difficulty:
            return off
    return None


def test_pack_params_byte_identical():
    rng = np.random.default_rng(11)
    cases = [(bytes(32), 0, 0), (bytes(32), MAX_U64, MAX_U64)]
    cases += [
        (rng.bytes(32), int(rng.integers(0, 1 << 63)) * 2 + 1, int(rng.integers(0, 1 << 63)) * 2)
        for _ in range(16)
    ]
    mine, theirs = pack_both(cases)
    assert mine.dtype == theirs.dtype == np.uint32
    assert mine.tobytes() == theirs.tobytes()
    assert search.PARAMS_LEN == jax_search.PARAMS_LEN
    assert (search.DIFF_LO, search.DIFF_HI, search.BASE_LO, search.BASE_HI) == (
        jax_search.DIFF_LO, jax_search.DIFF_HI, jax_search.BASE_LO, jax_search.BASE_HI)
    assert search.SENTINEL == jax_search.SENTINEL


def test_params_bit_view_roundtrip():
    mine, _ = pack_both(seeded_rows(1))
    t = search.params_from_numpy(mine)
    assert t.dtype == torch.int32 and t.shape == mine.shape
    assert t.numpy().view(np.uint32).tobytes() == mine.tobytes()
    assert search.offsets_to_numpy(torch.tensor([-1, 0, 7], dtype=torch.int32)).tolist() == [
        0xFFFFFFFF, 0, 7]


def test_plain_matches_jax_xla_path_and_brute_force():
    rows = seeded_rows(2)
    mine, theirs = pack_both(rows)
    span = 8192
    got = plain(mine, span)
    want = np.asarray(jax_search.search_chunk_batch(jnp.asarray(theirs), chunk_size=span))
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == 0  # pads hit at offset 0
    assert got[-1] == search.SENTINEL
    for (h, d, b), off in zip(rows[2:4], got[2:4]):
        assert off == brute_first(h, d, b, int(off) + 1)
        assert b + int(off) > (5 << 32 if b < 1 << 63 else MAX_U64)  # crossed


@pytest.mark.parametrize("sub,it,nb,grp", [(8, 4, 1, 1), (8, 4, 3, 2), (8, 2, 2, 1)])
def test_plain_and_wrapper_match_pallas_interpret(sub, it, nb, grp):
    """The CUDA wrapper's CPU route (the plain version) against the Pallas
    kernel in interpret mode, single- and multi-window grids."""
    rows = seeded_rows(3 + nb)
    mine, theirs = pack_both(rows)
    span = cuda_kernel.window(sub, it, nb, grp)
    want = np.asarray(pallas_kernel.pallas_search_chunk_batch(
        jnp.asarray(theirs), sublanes=sub, iters=it, nblocks=nb, group=grp, interpret=True,
    ))
    got = search.offsets_to_numpy(cuda_kernel.cuda_search_chunk_batch(
        search.params_from_numpy(mine), sublanes=sub, iters=it, nblocks=nb, group=grp,
    ))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain(mine, span), want)


def test_single_row_wrapper_matches_pallas_single():
    rows = seeded_rows(9)
    mine, theirs = pack_both(rows)
    for i in (2, 3, 4):
        want = int(pallas_kernel.pallas_search_chunk(
            jnp.asarray(theirs[i]), sublanes=8, iters=4, interpret=True))
        got = cuda_kernel.cuda_search_chunk(search.params_from_numpy(mine[i]), sublanes=8, iters=4)
        assert int(search.offsets_to_numpy(got)) == want
        single = search.search_chunk(search.params_from_numpy(mine[i]), chunk_size=4096)
        assert int(search.offsets_to_numpy(single)) == want


def test_plain_lane_budget_does_not_change_result():
    """The plain scan walks the window in slices; any slice size gives the
    lowest offset."""
    mine, _ = pack_both(seeded_rows(4))
    params = search.params_from_numpy(mine)
    want = search.search_chunk_batch(params, chunk_size=3000)
    for lanes in (97, 1000, 1 << 20):
        got = search.search_chunk_batch(params, chunk_size=3000, lanes=lanes)
        assert torch.equal(got, want), lanes


def test_geometry_checks_match_pallas():
    with pytest.raises(ValueError):
        cuda_kernel.window(1024, 1 << 16)  # one tile window >= 2^31
    with pytest.raises(ValueError):
        cuda_kernel.window(32, 1024, 1 << 9)  # total window >= 2^31
    with pytest.raises(ValueError):
        cuda_kernel.window(8, 6, 1, 4)  # iters not a multiple of group
    params = jnp.asarray(jax_search.pack_params(bytes(32), EASY, 0))
    with pytest.raises(ValueError):
        pallas_kernel.pallas_search_chunk(params, sublanes=1024, iters=1 << 16, interpret=True)
    assert cuda_kernel.window(32, 1024, 8, 8) == 1 << 25
    assert cuda_kernel.window(8, 16) == pallas_kernel.chunk_size(8, 16)


def test_wrapper_refuses_other_devices_and_bad_rows():
    meta = torch.zeros((1, search.PARAMS_LEN), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        cuda_kernel.cuda_search_chunk_batch(meta, sublanes=8, iters=2)
    with pytest.raises(ValueError):
        search.search_chunk_batch(torch.zeros((2, 11), dtype=torch.int32), chunk_size=8)
    with pytest.raises(TypeError):
        search.search_chunk_batch(torch.zeros((2, 12), dtype=torch.int64), chunk_size=8)


def test_nonces_from_offsets_and_advance_base_match_jax():
    rows = seeded_rows(5)
    mine, theirs = pack_both(rows)
    offs = np.array([0, 5, 100, 4000, 0xFFFFFFFF, 77], dtype=np.uint32)
    lo, hi = search.nonces_from_offsets(
        search.params_from_numpy(mine), torch.from_numpy(offs.view(np.int32).copy())
    )
    jlo, jhi = jax_search.nonces_from_offsets(jnp.asarray(theirs), jnp.asarray(offs))
    np.testing.assert_array_equal(search.offsets_to_numpy(lo), np.asarray(jlo))
    np.testing.assert_array_equal(search.offsets_to_numpy(hi), np.asarray(jhi))
    for delta in (0, 1000, 0xFFFFFFFF):
        adv = search.advance_base_batch(search.params_from_numpy(mine), delta)
        want = np.asarray(jax_search.advance_base_batch(jnp.asarray(theirs), delta))
        assert adv.numpy().view(np.uint32).tobytes() == want.tobytes()


def test_work_hex_convention():
    assert search.work_hex_from_nonce(0x123456789ABCDEF0) == "123456789abcdef0"
    assert search.work_hex_from_nonce(5) == "0000000000000005"
