"""Actuators: the controller's levers, from no-op logging to real fleets.

Three implementations of one tiny contract — ``await apply(action)`` —
so the controller/journal pair never knows what world it is driving:

  * :class:`LogActuator` — journal-only mode (observe a production
    system before trusting it with levers);
  * :class:`HttpControlActuator` — pushes the shed / horizon levers to
    every live replica's ``POST /control/`` face (the internal upcheck
    port, next to /metrics);
  * :class:`ReplicaFleetActuator` — the full thing: spawns real
    ``python -m tpu_dpow_torch.server`` replica processes and retires them
    with the drain contract — POST ``{"drain": true}`` (the face starts
    answering busy, so open-loop clients fail over), wait until the
    replica's window shows zero in-flight dispatches, then SIGINT (the
    server's clean-shutdown path: the replica LEAVES the ring, so peers
    rebalance immediately instead of burning a ttl on takeover), SIGKILL
    only past a deadline. Every timer rides the injectable Clock.

Scale-up is deliberately asymmetric: a spawned replica serves as soon as
its face binds — there is nothing to drain INTO a new process.
"""

from __future__ import annotations

import asyncio
import signal as _signal
from typing import Callable, Dict, List, Optional

from .. import obs
from ..resilience.clock import Clock, SystemClock
from ..utils.logging import get_logger
from .controller import SCALE_DOWN, SCALE_UP, SET_HORIZON, SHED_OFF, SHED_ON, Action

logger = get_logger("tpu_dpow_torch.autoscale")


class LogActuator:
    """Decisions are journaled and logged, nothing is touched."""

    def __init__(self):
        self.applied: List[Action] = []

    async def apply(self, action: Action) -> None:
        self.applied.append(action)
        logger.info("autoscale decision (not actuated): %s — %s",
                    action.kind, action.reason)


class HttpControlActuator:
    """POSTs the shed / horizon levers to every face's /control/."""

    def __init__(self, faces: List[str], *, session=None, timeout: float = 3.0):
        self.faces = list(faces)  # http://host:upcheck_port
        self.timeout = timeout
        self._session = session

    def set_faces(self, faces: List[str]) -> None:
        self.faces = list(faces)

    def _ensure_session(self):
        # sync on purpose: no await between the None-check and the
        # assignment (dpowlint DPOW801)
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def _post(self, face: str, body: dict) -> bool:
        import aiohttp

        self._ensure_session()
        try:
            async with self._session.post(
                face + "/control/", json=body,
                timeout=aiohttp.ClientTimeout(total=self.timeout),
            ) as resp:
                return resp.status == 200
        except Exception:
            logger.warning("control POST to %s failed", face, exc_info=True)
            return False

    async def broadcast(self, body: dict) -> int:
        ok = 0
        for face in list(self.faces):
            ok += 1 if await self._post(face, body) else 0
        return ok

    async def apply(self, action: Action) -> None:
        if action.kind == SHED_ON:
            await self.broadcast({"precache_shed": True})
        elif action.kind == SHED_OFF:
            await self.broadcast({"precache_shed": False})
        elif action.kind == SET_HORIZON:
            await self.broadcast({"fleet_horizon": action.value or 0.0})
        # scale actions are a fleet concern; this actuator ignores them

    async def close(self) -> None:
        # detach-then-await (docs/resilience.md concurrency idioms)
        session, self._session = self._session, None
        if session is not None:
            await session.close()


class ReplicaFleetActuator:
    """Spawn/retire replica server processes; route the other levers to
    an :class:`HttpControlActuator` over the live upcheck faces.

    ``spawn_spec(i)`` describes replica slot i:
        {"cmd": [...argv...], "service_url": ..., "upcheck_url": ...}
    Slots 0..n-1 are filled in order; retire takes the highest slot
    (never slot 0 — someone must host the broker in --inproc_broker
    topologies).
    """

    def __init__(
        self,
        spawn_spec: Callable[[int], dict],
        *,
        clock: Optional[Clock] = None,
        drain_timeout: float = 20.0,
        stop_timeout: float = 10.0,
        poll_interval: float = 0.5,
        on_change: Optional[Callable[[List[dict]], None]] = None,
        session=None,
    ):
        self.spawn_spec = spawn_spec
        self.clock = clock or SystemClock()
        self.drain_timeout = drain_timeout
        self.stop_timeout = stop_timeout
        self.poll_interval = poll_interval
        self.on_change = on_change
        self._session = session
        # serializes every fleet mutation: the controller's cooldown
        # already spaces actions out, but a slow drain overlapping the
        # next scale decision must not race the member table
        self._lock = asyncio.Lock()
        #: slot -> {"proc": Process|None, "spec": dict}
        self.members: Dict[int, dict] = {}
        self.control = HttpControlActuator([], session=session)
        reg = obs.get_registry()
        self._m_replicas = reg.gauge(
            "dpow_autoscale_replicas_actual",
            "Replica processes the actuator currently runs")
        self._m_scale_ops = reg.counter(
            "dpow_autoscale_scale_ops_total",
            "Replica processes spawned/retired, by op and result",
            ("op", "result"))

    # -- membership bookkeeping ----------------------------------------

    def adopt(self, slot: int, proc, spec: dict) -> None:
        """Register an externally spawned replica (the bench starts the
        initial fleet itself; the actuator scales from there)."""
        self.members[slot] = {"proc": proc, "spec": spec}
        self._changed()

    def live_specs(self) -> List[dict]:
        return [self.members[s]["spec"] for s in sorted(self.members)]

    def _changed(self) -> None:
        self._m_replicas.set(float(len(self.members)))
        self.control.set_faces(
            [spec["upcheck_url"] for spec in self.live_specs()]
        )
        if self.on_change is not None:
            self.on_change(self.live_specs())

    # -- scale levers ---------------------------------------------------

    async def scale_to(self, n: int) -> None:
        n = max(1, int(n))
        async with self._lock:
            while len(self.members) < n:
                await self._spawn(self._next_slot())
            while len(self.members) > n:
                await self._retire(max(self.members))

    def _next_slot(self) -> int:
        slot = 0
        while slot in self.members:
            slot += 1
        return slot

    async def _spawn(self, slot: int) -> None:
        spec = self.spawn_spec(slot)
        logger.info("autoscale: spawning replica slot %d: %s",
                    slot, " ".join(spec["cmd"]))
        try:
            proc = await asyncio.create_subprocess_exec(
                *spec["cmd"],
                stdout=asyncio.subprocess.DEVNULL,
                stderr=asyncio.subprocess.DEVNULL,
            )
        except OSError:
            logger.error("spawn of replica slot %d failed", slot, exc_info=True)
            self._m_scale_ops.inc(1, "spawn", "error")
            return
        self.members[slot] = {"proc": proc, "spec": spec}
        self._m_scale_ops.inc(1, "spawn", "ok")
        # wait (bounded) for the face to come up so callers can use it
        deadline = self.clock.time() + self.drain_timeout
        while self.clock.time() < deadline:
            if await self._upcheck(spec["upcheck_url"]):
                break
            await self.clock.sleep(self.poll_interval)
        self._changed()

    async def _upcheck(self, upcheck_url: str) -> bool:
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession()
        try:
            async with self._session.get(
                upcheck_url + "/upcheck/",
                timeout=aiohttp.ClientTimeout(total=2.0),
            ) as resp:
                return resp.status == 200
        except Exception:
            return False

    async def _inflight(self, upcheck_url: str) -> Optional[float]:
        """The replica's own in-flight dispatch count, from its page."""
        import aiohttp

        from .signals import parse_metrics_page

        if self._session is None:
            self._session = aiohttp.ClientSession()
        try:
            async with self._session.get(
                upcheck_url + "/metrics",
                timeout=aiohttp.ClientTimeout(total=2.0),
            ) as resp:
                if resp.status != 200:
                    return None
                page = parse_metrics_page(await resp.text())
            return page["inflight"]
        except Exception:
            return None

    async def _retire(self, slot: int) -> None:
        if slot == 0:
            logger.warning("refusing to retire replica slot 0")
            return
        # pop-is-the-claim, before any await: a concurrent pass can never
        # double-retire one slot (dpowlint DPOW801)
        member = self.members.pop(slot, None)
        if member is None:
            logger.warning("replica slot %d is not a member", slot)
            return
        spec, proc = member["spec"], member["proc"]
        upcheck = spec["upcheck_url"]
        logger.info("autoscale: retiring replica slot %d (drain first)", slot)
        # retiring face drops out of the control fan-out immediately
        self._changed()
        # 1. drain: the face stops accepting (answers busy), clients fail
        #    over; in-flight dispatches finish normally
        await self.control._post(upcheck, {"drain": True})
        deadline = self.clock.time() + self.drain_timeout
        while self.clock.time() < deadline:
            inflight = await self._inflight(upcheck)
            if inflight is not None and inflight <= 0:
                break
            await self.clock.sleep(self.poll_interval)
        else:
            logger.warning(
                "replica slot %d still holds dispatches past the drain "
                "deadline; stopping anyway (supervisor republish and ring "
                "takeover cover the remainder)", slot,
            )
        # 2. SIGINT = the clean-shutdown path (replica LEAVES the ring)
        result = "ok"
        if proc is None:
            # an ADOPTED member (spawned out of band): drain its face and
            # stand down — its process lifecycle belongs to whoever
            # started it
            logger.info(
                "replica slot %d was externally managed: face drained; "
                "stop its process out of band", slot,
            )
        if proc is not None and proc.returncode is None:
            proc.send_signal(_signal.SIGINT)
            try:
                await asyncio.wait_for(proc.wait(), timeout=self.stop_timeout)
            except asyncio.TimeoutError:
                logger.warning("replica slot %d ignored SIGINT; killing", slot)
                proc.kill()
                await proc.wait()
                result = "killed"
        self._m_scale_ops.inc(1, "retire", result)

    # -- the Actuator contract ------------------------------------------

    async def apply(self, action: Action) -> None:
        if action.kind == SCALE_UP and action.value is not None:
            await self.scale_to(int(action.value))
        elif action.kind == SCALE_DOWN and action.value is not None:
            await self.scale_to(int(action.value))
        else:
            await self.control.apply(action)

    async def close(self, *, stop_processes: bool = False) -> None:
        if stop_processes:
            async with self._lock:
                await self._stop_all()
        await self.control.close()
        session, self._session = self._session, None
        if session is not None:
            await session.close()

    async def _stop_all(self) -> None:
        while self.members:
            member = self.members.pop(max(self.members))
            proc = member["proc"]
            if proc is not None and proc.returncode is None:
                proc.send_signal(_signal.SIGINT)
                try:
                    await asyncio.wait_for(proc.wait(), timeout=self.stop_timeout)
                except asyncio.TimeoutError:
                    proc.kill()
                    await proc.wait()
