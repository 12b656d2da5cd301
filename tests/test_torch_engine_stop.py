"""Mid-launch row stops of plain chunked launches (``TorchWorkBackend.
_stop_rows``), on the CPU, through a fake chunked launcher on the card.

The fake stands in for ``_launch`` of a chunked engine on one card: each
launch computes the plain version's results, opens its stop channel with a
stopper that records every write, waits until the test releases it, then
closes the channel with made-up ``scanned`` counts for the rows it had
stopped. The test releases launches so that every later launch in the FIFO
is open when the head is applied, and compares each seeded run with the
same run where no row is ever stopped:

* a solve applied from launch k stops exactly the rows of the launches
  after k in the FIFO that carry the job, while their channel is open, and
  no row of launch k or of an earlier one; pad rows and other jobs' rows
  are never written; a cancel stops the job's rows in every open launch;
* no stop is written once a launch's channel is closed (a launch that
  returned before its predecessor was applied is not stopped);
* a stopped row counts its ``scanned`` nonces, at most its span, into
  ``dpow_engine_hashes_total`` and ``dpow_engine_wasted_hashes_total``
  under its cause, in place of what its out word would have said, and
  ``dpow_engine_rows_stopped_total`` counts the stops;
* every job gets the same work, from the same sequence of launches, as in
  the run without stops, and the launch spans carry the stop counts.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from tpu_dpow_torch import obs
from tpu_dpow_torch.backend import WorkCancelled
from tpu_dpow_torch.backend.torch_backend import TorchWorkBackend, _RowStops
from tpu_dpow_torch.models import WorkRequest
from tpu_dpow_torch.ops import search

torch.set_num_threads(1)

MASK64 = (1 << 64) - 1
# 2^14 expected nonces: a CPU launch of 8,192 misses with p 0.61, so a
# pipelined successor re-packs a job still in flight.
DIFF = 0xFFFC000000000000


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def made_up_scanned(row: int, span: int) -> int:
    """What the fake card says a stopped row ran; some rows claim more than
    the span, which the engine caps."""
    return span // 2 + 1000 * row


class Stopper:
    """Records each stop write of one launch, and whether the launch's
    channel was still open."""

    def __init__(self, card, seq, params):
        self.card, self.seq, self.params = card, seq, params
        self.closed = False

    def stop(self, row):
        self.card.writes.append({
            "seq": self.seq, "row": row, "words": self.params[row, :8].copy(),
            "diff": int(self.params[row, search.DIFF_LO]) | int(self.params[row, search.DIFF_HI]) << 32,
            "cause": self.card.cause, "applying": self.card.applying, "late": self.closed,
        })

    def drain(self):
        pass


class FakeCard:
    def __init__(self, b):
        self.real = b._launch
        self.lock = threading.Lock()
        self.gates, self.opened, self.seqs = {}, set(), {}
        self.writes, self.cause, self.applying = [], None, None
        self.savings = {"solved": 0, "cancelled": 0}
        self.chunk = b.chunk

    def gate(self, stops) -> threading.Event:
        with self.lock:
            return self.gates.setdefault(id(stops), threading.Event())

    def launch(self, params, steps, slot=0, devices=None, stops=None):
        assert isinstance(stops, _RowStops)
        lo, hi = self.real(params, steps, slot, devices)
        stopper = Stopper(self, self.seqs[id(stops)], params)
        stops.open(stopper)
        with self.lock:
            self.opened.add(id(stops))
        assert self.gate(stops).wait(30)
        span = self.chunk * steps
        scanned = np.array([made_up_scanned(r, span) for r in range(params.shape[0])], np.uint32)
        stops.close(scanned)
        stopper.closed = True
        for r in stops.rows:
            # What the row counts when it is not stopped: its span if dry,
            # else the offset of its hit plus one.
            nonce = (int(hi[r]) << 32) | int(lo[r])
            base = (int(params[r, search.BASE_HI]) << 32) | int(params[r, search.BASE_LO])
            plain = span if nonce == MASK64 else ((nonce - base) & MASK64) + 1
            cause = next(w["cause"] for w in self.writes
                         if w["seq"] == self.seqs[id(stops)] and w["row"] == r)
            self.savings[cause] += plain - min(int(scanned[r]), span)
        return lo, hi


def counters() -> dict:
    snap = obs.snapshot()
    return {
        "hashes": snap["dpow_engine_hashes_total"]["series"].get("torch", 0.0),
        **{f"wasted_{c}": snap["dpow_engine_wasted_hashes_total"]["series"].get(f"torch,{c}", 0.0)
           for c in ("solved", "cancelled")},
        **{f"stopped_{c}": snap["dpow_engine_rows_stopped_total"]["series"].get(f"torch,{c}", 0.0)
           for c in ("solved", "cancelled")},
    }


async def serve(seed, pipeline, order, stop, cancel_first):
    """One seeded run; returns its works, its dispatch sequence, the fake
    card, the counter deltas and the launch spans' stop counts."""
    b = TorchWorkBackend(device="cpu", pipeline=pipeline)
    await b.setup()
    b._row_stops = True  # as on the card: every chunked launch has a channel
    card = FakeCard(b)
    b._launch = card.launch
    dispatched = []
    real_dispatch, real_stop, real_apply = b._dispatch_next, b._stop_rows, b._apply_results

    def dispatch(inflight=0):
        rec = real_dispatch(inflight)
        if rec is not None:
            card.seqs[id(rec.stops)] = len(dispatched)
            dispatched.append((rec, [j.block_hash for j in rec.jobs], list(rec.bases)))
        return rec

    def stop_rows(job, cause):
        # Exactly the open later launches' rows of this job, as the FIFO
        # stands now.
        want = sorted(
            (card.seqs[id(r.stops)], i) for r in b._inflight for i, j in enumerate(r.jobs)
            if j is job and id(r.stops) in card.opened and r.stops.scanned is None
        )
        n = len(card.writes)
        card.cause = cause
        if stop:
            real_stop(job, cause)
        got = sorted((w["seq"], w["row"]) for w in card.writes[n:])
        assert got == (want if stop else [])

    def apply(rec, lo, hi):
        card.applying = card.seqs[id(rec.stops)]
        try:
            real_apply(rec, lo, hi)
        finally:
            card.applying = None

    b._dispatch_next, b._stop_rows, b._apply_results = dispatch, stop_rows, apply
    rng = np.random.default_rng(seed)
    reqs = [(rng.bytes(32).hex().upper(), int(rng.integers(0, 1 << 62))) for _ in range(5)]
    before = counters()
    ring_before = len(obs.get_tracer().ring())
    tasks = [asyncio.ensure_future(b.generate(WorkRequest(h, DIFF, nonce_range=(base, 0))))
             for h, base in reqs]
    cancelled = False
    try:
        while not all(t.done() for t in tasks) or b._inflight:
            await asyncio.sleep(0.002)
            fifo = list(b._inflight)
            if not fifo or not all(id(r.stops) in card.opened for r in fifo):
                continue
            if cancel_first and not cancelled:
                # Every launch in flight carries the job and is open.
                cancelled = True
                await b.cancel(reqs[0][0])
            head = fifo[0]
            if card.gate(head.stops).is_set():
                continue  # released: waiting for its apply
            if order == "successor_first" and len(fifo) > 1:
                for r in fifo[1:]:
                    card.gate(r.stops).set()
                if not all(r.thread_done.is_set() for r in fifo[1:]):
                    continue
            card.gate(head.stops).set()
        works = {}
        for (h, _), t in zip(reqs, tasks):
            try:
                works[h] = t.result()
            except WorkCancelled:
                works[h] = None
    finally:
        for ev in list(card.gates.values()):
            ev.set()
        await b.close()
    after = counters()
    spans = [s for s in obs.get_tracer().ring()[ring_before:] if s[0] == "launch"]
    return {
        "works": works, "card": card, "spans": spans,
        "sequence": [(hs, bs) for _r, hs, bs in dispatched],
        "delta": {k: after[k] - before[k] for k in after},
        "stops": {card.seqs[id(r.stops)]: set(r.stops.rows) for r, _h, _b in dispatched},
        "jobs": {card.seqs[id(r.stops)]: hs for r, hs, _b in dispatched},
    }


@pytest.mark.parametrize("seed,pipeline,order,cancel_first", [
    (2040, 2, "in_order", False),
    (7, 3, "in_order", False),
    (11, 2, "successor_first", False),
    (2040, 2, "in_order", True),
])
def test_stops_reach_exactly_the_later_rows_and_count_what_they_ran(
        seed, pipeline, order, cancel_first):
    with_stops = run(serve(seed, pipeline, order, True, cancel_first))
    without = run(serve(seed, pipeline, order, False, cancel_first))
    card = with_stops["card"]

    # The same launches, in the same order, give every job the same work.
    assert with_stops["sequence"] == without["sequence"]
    assert with_stops["works"] == without["works"]
    assert without["card"].writes == []

    for w in card.writes:
        assert not w["late"], "a stop was written after the launch's channel closed"
        assert w["diff"] != 0, "a pad row was stopped"
        job_hash = with_stops["jobs"][w["seq"]][w["row"]]
        assert np.array_equal(w["words"], search.pack_params(bytes.fromhex(job_hash), 0, 0)[:8])
        if w["cause"] == "solved":
            # Only launches after the one whose solve is being applied.
            assert w["applying"] is not None and w["seq"] > w["applying"]
        else:
            assert w["cause"] == "cancelled" and w["applying"] is None
    by_cause = {c: sum(w["cause"] == c for w in card.writes) for c in ("solved", "cancelled")}
    if order == "successor_first":
        # Every launch returned, and closed its channel, before the one
        # ahead of it was applied, though some carried a job solved there.
        assert card.writes == [] and with_stops["delta"]["wasted_solved"] > 0
    else:
        assert by_cause["solved"] > 0
    assert (by_cause["cancelled"] > 0) == cancel_first

    d, d0 = with_stops["delta"], without["delta"]
    for c in ("solved", "cancelled"):
        assert d[f"stopped_{c}"] == by_cause[c]
        assert d0[f"stopped_{c}"] == 0
        assert d[f"wasted_{c}"] == d0[f"wasted_{c}"] - card.savings[c]
    assert d["hashes"] == d0["hashes"] - sum(card.savings.values())
    assert sum(card.savings.values()) != 0 or not card.writes

    # Each launch span carries the rows stopped in it.
    assert sorted(s[6]["stopped"] for s in with_stops["spans"]) == sorted(
        len(rows) for rows in with_stops["stops"].values())
    assert all(s[6]["stopped"] == 0 for s in without["spans"])


def test_a_closed_channel_takes_no_stop():
    stops = _RowStops()
    calls = []

    class Rec:
        def stop(self, row):
            calls.append(row)

        def drain(self):
            calls.append("drain")

    assert not stops.stop(0)  # not open yet
    stops.open(Rec())
    assert stops.stop(1) and not stops.stop(1)
    stops.close(np.array([0, 5], np.uint32))
    assert not stops.stop(0)
    assert calls == [1, "drain"] and stops.rows == {1}
    assert stops.scanned.tolist() == [0, 5]


def test_no_channel_off_the_card_or_off_the_plain_chunked_path():
    assert TorchWorkBackend(device="cpu")._row_stops is False
    assert TorchWorkBackend(device="cpu", run_mode="persistent")._row_stops is False
    assert TorchWorkBackend(device="cpu", devices=1)._row_stops is False
    assert TorchWorkBackend(device="cpu", mesh_devices=1)._row_stops is False
