"""The open-loop scheduler and the drivers that speak the real faces.

:class:`OpenLoopDriver` walks an arrival schedule on the injectable
``resilience.Clock`` and fires every request AT ITS INTENDED TIME whether
or not earlier ones have answered — outcomes never influence arrivals
(the defining property of an open loop). Each in-flight request is a
retained task with its own patience watchdog (the simulated service's
timeout) and optional early abandon (the population's cancel behavior).

Request issue is delegated to a pluggable async callable so the same
scheduler drives three very different targets:

  * :class:`HttpPostDriver` — ``POST /service/`` round-robin across the
    faces of N real replica processes, with failover: a face that refuses
    connections is benched for a cooldown and its request retried on the
    next face (what a production client does when a replica dies);
  * :class:`WsDriver` — the ``/service_ws/`` websocket face, a pool of
    long-lived connections with id-correlated replies;
  * :class:`InprocDriver` — direct ``service_handler`` calls for
    FakeClock tier-1 smokes and the sanitizer (no sockets, so a whole
    open-loop run is deterministic and sub-second).

One safety valve, loudly accounted: past ``max_inflight`` outstanding
requests the driver records arrivals as ``shed_client`` instead of
issuing them (an unbounded backlog against a dead stack would otherwise
eat the generator's memory). A capture with nonzero ``shed_client`` is
labeled degraded by the capture that ran it — it means the measured system
was so far past saturation that even the generator gave up.
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import Dict, Iterable, List, Optional, Sequence

from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from .arrival import Arrival
from .population import RequestSpec
from .recorder import OpenLoopRecorder

logger = get_logger("tpu_dpow_torch.loadgen")

#: slack added to the service's own timeout before the driver-side
#: watchdog concludes "timeout" (the server answers its own deadline
#: first in a healthy run; the watchdog only catches lost replies)
TIMEOUT_GRACE = 2.0


def classify_response(status: Optional[int], data: object) -> str:
    """Map one service-face reply onto a recorder outcome."""
    if not isinstance(data, dict):
        return "error"
    if (status == 429) or data.get("busy"):
        return "busy"
    if "work" in data:
        return "ok"
    if data.get("timeout"):
        return "timeout"
    return "error"


class OpenLoopDriver:
    def __init__(
        self,
        issue,
        recorder: OpenLoopRecorder,
        *,
        population,
        clock: Optional[Clock] = None,
        max_inflight: int = 20000,
    ):
        self.issue = issue
        self.recorder = recorder
        self.population = population
        self.clock = clock or SystemClock()
        self.max_inflight = max_inflight
        self._tasks: set = set()
        self.issued = 0
        self.shed_client = 0

    async def run(self, schedule: Iterable[Arrival]) -> dict:
        """Walk the schedule to exhaustion, then drain in-flight work.
        Returns the recorder summary (no SLO grading — callers grade)."""
        start = self.recorder.begin()
        for arrival in schedule:
            due = start + arrival.t
            delay = due - self.clock.time()
            if delay > 0:
                await self.clock.sleep(delay)
            if len(self._tasks) >= self.max_inflight:
                self.shed_client += 1
                self.recorder.done(arrival.t, "shed_client", issued=False)
                continue
            spec = self.population.spec(arrival)
            task = asyncio.ensure_future(self._conclude(spec))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            self.issued += 1
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)
        return self.recorder.summary()

    async def _conclude(self, spec: RequestSpec) -> None:
        self.recorder.issued(spec.intended_t)
        issue_task = asyncio.ensure_future(self._issue(spec))
        # The abandon point (population cancel behavior) or the patience
        # watchdog, whichever is sooner, bounds every in-flight request —
        # both on the injectable clock.
        if spec.cancel_after is not None:
            bound, bound_outcome = spec.cancel_after, "cancelled"
        else:
            bound, bound_outcome = spec.timeout + TIMEOUT_GRACE, "timeout"
        guard = asyncio.ensure_future(self.clock.sleep(bound))
        try:
            await asyncio.wait(
                {issue_task, guard}, return_when=asyncio.FIRST_COMPLETED
            )
            if issue_task.done():
                exc = issue_task.exception()
                outcome = "error" if exc is not None else issue_task.result()
            else:
                issue_task.cancel()
                await asyncio.gather(issue_task, return_exceptions=True)
                outcome = bound_outcome
        finally:
            guard.cancel()
            await asyncio.gather(guard, return_exceptions=True)
        self.recorder.done(spec.intended_t, outcome)

    async def _issue(self, spec: RequestSpec) -> str:
        try:
            return await self.issue(spec)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.debug("issue failed for %s", spec.service, exc_info=True)
            return "error"


class ConfirmFeed:
    """Open-loop block-confirmation stream: the node-websocket side of the
    workload, paced exactly like the request side. Each schedule arrival
    becomes one :meth:`ServicePopulation.confirm_spec` confirmation,
    BROADCAST to every handler — in production every replica subscribes
    the node's websocket and hears every confirmation; the ring-ownership
    gate inside ``block_arrival_handler`` is what keeps exactly one of
    them precaching, and that is precisely the behavior a multi-replica
    capture must exercise rather than simulate away."""

    def __init__(
        self,
        handlers,
        population,
        *,
        clock: Optional[Clock] = None,
    ):
        self.handlers = (
            list(handlers) if isinstance(handlers, (list, tuple)) else [handlers]
        )
        self.population = population
        self.clock = clock or SystemClock()
        self.issued = 0

    async def run(self, schedule: Iterable[Arrival]) -> int:
        start = self.clock.time()
        for arrival in schedule:
            due = start + arrival.t
            delay = due - self.clock.time()
            if delay > 0:
                await self.clock.sleep(delay)
            spec = self.population.confirm_spec(arrival)
            for handler in self.handlers:
                try:
                    await handler(spec.hash, spec.account, spec.previous)
                except Exception:
                    logger.debug(
                        "confirmation feed failed for %s", spec.account,
                        exc_info=True,
                    )
            self.issued += 1
        return self.issued


# ---------------------------------------------------------------------------
# HTTP POST face
# ---------------------------------------------------------------------------


class HttpPostDriver:
    """POST /service/ across N replica faces with failover.

    ``faces`` are base URLs (``http://127.0.0.1:5030``). A face whose
    connection is refused is benched for ``face_cooldown`` seconds and
    the request retries the next face — so killing or retiring a replica
    mid-capture costs a retry, not a recorded error, exactly like a
    production client with a server list.
    """

    def __init__(
        self,
        faces: Sequence[str],
        *,
        clock: Optional[Clock] = None,
        face_cooldown: float = 3.0,
        session=None,
    ):
        if not faces:
            raise ValueError("need at least one face URL")
        self.faces = list(faces)
        self.clock = clock or SystemClock()
        self.face_cooldown = face_cooldown
        self._dead_until: Dict[str, float] = {}
        self._rr = itertools.count()
        self._session = session
        self.retries = 0

    def _ensure_session(self):
        # sync on purpose: no await between the None-check and the
        # assignment, so concurrent request tasks cannot double-create
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def close(self) -> None:
        # detach-then-await (docs/resilience.md concurrency idioms)
        session, self._session = self._session, None
        if session is not None:
            await session.close()

    def set_faces(self, faces: Sequence[str]) -> None:
        """Replace the face list (the autoscaler added/retired replicas)."""
        self.faces = list(faces)

    async def __call__(self, spec: RequestSpec) -> str:
        import aiohttp

        session = self._ensure_session()
        body = {
            "user": spec.service,
            "api_key": spec.api_key,
            "hash": spec.hash,
            "timeout": spec.timeout,
        }
        start = next(self._rr)
        faces = self.faces
        now = self.clock.time()
        candidates = [
            faces[(start + i) % len(faces)] for i in range(len(faces))
        ]
        live = [f for f in candidates if self._dead_until.get(f, 0.0) <= now]
        saw_draining = False
        for face in live or candidates:  # all benched: try anyway
            try:
                async with session.post(
                    face + "/service/",
                    json=body,
                    timeout=aiohttp.ClientTimeout(total=spec.timeout + TIMEOUT_GRACE),
                ) as resp:
                    data = await resp.json(content_type=None)
                if (
                    isinstance(data, dict)
                    and data.get("busy")
                    and data.get("reason") == "draining"
                ):
                    # the replica is retiring, not overloaded: bench the
                    # face and fail over like any production client
                    # dpowlint: disable=DPOW801 — last-writer-wins cooldown stamp; any interleaving writes a valid bench time
                    self._dead_until[face] = (
                        self.clock.time() + self.face_cooldown
                    )
                    self.retries += 1
                    saw_draining = True
                    continue
                return classify_response(resp.status, data)
            except asyncio.TimeoutError:
                return "timeout"
            except aiohttp.ClientError:
                # face down (refused / reset mid-retire): bench + failover.
                # dpowlint: disable=DPOW801 — last-writer-wins cooldown stamp; any interleaving writes a valid bench time
                self._dead_until[face] = self.clock.time() + self.face_cooldown
                self.retries += 1
                continue
        # every face answered the busy contract (all draining): the
        # system REFUSED, it did not fail — book it as busy, not error
        return "busy" if saw_draining else "error"


# ---------------------------------------------------------------------------
# websocket face
# ---------------------------------------------------------------------------


class WsDriver:
    """/service_ws/ with a pool of long-lived connections per face and
    id-correlated replies (the ws face is request/response over one
    socket; the ``id`` field is the protocol's own correlator)."""

    def __init__(
        self,
        faces: Sequence[str],
        *,
        clock: Optional[Clock] = None,
        conns_per_face: int = 2,
    ):
        if not faces:
            raise ValueError("need at least one ws face URL")
        self.faces = list(faces)  # e.g. ws://127.0.0.1:5035
        self.clock = clock or SystemClock()
        self.conns_per_face = conns_per_face
        self._session = None
        self._conns: List[dict] = []
        self._rr = itertools.count()
        self._ids = itertools.count(1)

    async def start(self) -> None:
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession()
        for face in self.faces:
            for _ in range(self.conns_per_face):
                await self._open(face)

    async def _open(self, face: str) -> Optional[dict]:
        import aiohttp

        try:
            ws = await self._session.ws_connect(face + "/service_ws/")
        except aiohttp.ClientError:
            return None
        conn = {"face": face, "ws": ws, "pending": {}, "reader": None}
        reader = asyncio.ensure_future(self._read(conn))
        conn["reader"] = reader
        self._conns.append(conn)
        return conn

    async def _read(self, conn: dict) -> None:
        import aiohttp

        ws = conn["ws"]
        try:
            async for msg in ws:
                if msg.type != aiohttp.WSMsgType.TEXT:
                    continue
                try:
                    data = json.loads(msg.data)
                except json.JSONDecodeError:
                    continue
                fut = conn["pending"].pop(data.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(data)
        finally:
            # the socket died: fail every reply still owed on it
            if conn in self._conns:
                self._conns.remove(conn)
            for fut in conn["pending"].values():
                if not fut.done():
                    fut.set_exception(ConnectionError("ws face closed"))
            conn["pending"].clear()

    async def __call__(self, spec: RequestSpec) -> str:
        if not self._conns:
            await self.start()
            if not self._conns:
                return "error"
        conn = self._conns[next(self._rr) % len(self._conns)]
        rid = next(self._ids)
        fut = asyncio.get_running_loop().create_future()
        conn["pending"][rid] = fut
        try:
            await conn["ws"].send_json({
                "user": spec.service,
                "api_key": spec.api_key,
                "hash": spec.hash,
                "timeout": spec.timeout,
                "id": rid,
            })
            data = await fut
        except (ConnectionError, RuntimeError):
            return "error"
        finally:
            # also on CancelledError (the driver's patience watchdog /
            # abandon path): a long soak must not accrete dead futures
            # in the long-lived connection's pending table
            conn["pending"].pop(rid, None)
        return classify_response(None, data)

    async def close(self) -> None:
        # detach-then-await: nothing new boards a list we are tearing down
        conns, self._conns = list(self._conns), []
        for conn in conns:
            reader = conn["reader"]
            try:
                await conn["ws"].close()
            except Exception:
                pass
            if reader is not None:
                reader.cancel()
                await asyncio.gather(reader, return_exceptions=True)
        session, self._session = self._session, None
        if session is not None:
            await session.close()


# ---------------------------------------------------------------------------
# in-process face (FakeClock smokes, sanitizer)
# ---------------------------------------------------------------------------


class InprocDriver:
    """Direct ``service_handler`` calls — the whole open loop with zero
    sockets, so FakeClock tests advance a 'minute' of traffic in
    milliseconds. Accepts one handler or a list (round-robin 'replicas')."""

    def __init__(self, handlers):
        self.handlers = list(handlers) if isinstance(handlers, (list, tuple)) else [handlers]
        self._rr = itertools.count()

    async def __call__(self, spec: RequestSpec) -> str:
        from ..sched import Busy
        from ..server.exceptions import (
            InvalidRequest,
            RequestTimeout,
            RetryRequest,
        )

        handler = self.handlers[next(self._rr) % len(self.handlers)]
        try:
            data = await handler({
                "user": spec.service,
                "api_key": spec.api_key,
                "hash": spec.hash,
                "timeout": spec.timeout,
            })
        except RequestTimeout:
            return "timeout"
        except Busy:
            return "busy"
        except (InvalidRequest, RetryRequest):
            return "error"
        return classify_response(None, data)
