"""DpowClient: the worker that joins the swarm and feeds the GPU.

Semantic port of reference client/dpow_client.py onto this framework's
transport + backend seams:

  * subscriptions per work preference: ``work/{type}`` at QoS 0,
    ``cancel/{type}`` at QoS 1, ``client/{payout}`` at QoS 1, with a
    persistent session so cancels queue across drops (reference :137-147);
  * startup gate — refuse to run without a live server heartbeat within
    2 s (reference :115-123);
  * heartbeat staleness watchdog — alarm after 10 s of silence, recover
    silently when the server returns (reference :167-179);
  * results published to ``result/{type}`` as ``hash,work,payout``
    (reference send_work_result :38-39);
  * on transport error: sleep and reconnect (reference :189-197).
"""

from __future__ import annotations

import asyncio
import json
import time
import traceback
from collections import OrderedDict
from typing import Optional

from .. import obs
from ..backend import WorkBackend, get_backend
from ..models import WorkRequest, WorkType
from ..resilience.clock import Clock, SystemClock
from ..transport import Message, QOS_0, QOS_1, Transport
from ..transport import wire
from ..transport.mqtt_codec import encode_result_payload
from ..utils import nanocrypto as nc
from ..utils.logging import get_logger
from .config import ClientConfig
from .work_handler import WorkHandler

logger = get_logger("tpu_dpow_torch.client")


class DpowClient:
    def __init__(
        self,
        config: ClientConfig,
        transport: Transport,
        backend: Optional[WorkBackend] = None,
        clock: Optional[Clock] = None,
    ):
        self.config = config
        self.transport = transport
        # Injectable time (resilience/clock.py): every worker timer — the
        # announce heartbeat, the staleness watchdog, reconnect backoff —
        # must be FakeClock-drivable or chaos tests silently skip it.
        self.clock = clock or SystemClock()
        if backend is None:
            # Inside the broker_connect phase (amain builds the client
            # first): a span of its own shows the engine object's share,
            # torch's import and the CUDA runtime's start included.
            t0 = time.perf_counter()
            backend = self._build_backend(config)
            obs.get_tracer().record("engine_object", t0, time.perf_counter(),
                                    cat="startup", thread="startup")
        # The handler's in-flight cap must exceed the engine's batch size or
        # the batched launch can never fill (the queue would starve it at 8
        # like the reference's one-at-a-time worker dialogue); 2x keeps the
        # next pack full while results are being reported. Derive from the
        # RESOLVED backend so an injected engine's batch size wins over the
        # config default.
        concurrency = config.work_concurrency or 2 * getattr(backend, "max_batch", 4)
        self.work_handler = WorkHandler(
            backend, self._send_result, concurrency=concurrency
        )
        self.last_heartbeat: Optional[float] = None
        self._server_online = True
        # Fleet identity (tpu_dpow/fleet/): announced on fleet/announce,
        # and the suffix of this worker's private sharded-dispatch lane
        # work/{type}/{worker_id}.
        self.worker_id = config.resolve_worker_id()
        # Hashes whose work arrived as a binary v1 frame: the result is
        # replied in the codec the dispatch spoke (the sender of a v1 frame
        # has proven it parses v1 — no other negotiation channel exists for
        # the result direction). Bounded LRU so cancelled dispatches can
        # never accumulate.
        self._v1_dispatched: "OrderedDict[str, None]" = OrderedDict()
        self._tasks: list = []
        self._metrics_runner = None
        self.metrics_port: Optional[int] = None  # bound port once serving
        self.stats = {"works_accepted": 0, "latest_stats": None}
        reg = obs.get_registry()
        self._tracer = obs.get_tracer()
        self._m_work_received = reg.counter(
            "dpow_client_work_received_total",
            "Work messages received off the broker, by type", ("work_type",))
        self._m_results_published = reg.counter(
            "dpow_client_results_published_total",
            "Solved results published to the broker", ("work_type",))
        # Heartbeat watchdog, scrapeable: before this the staleness alarm
        # was a single log line — a fleet dashboard could not tell a quiet
        # worker from one whose server link died minutes ago.
        self._m_heartbeat_stale = reg.gauge(
            "dpow_client_heartbeat_stale_seconds",
            "Seconds since the last server heartbeat while past the "
            "staleness budget (0 while the feed is healthy)")
        self._m_stale_transitions = reg.counter(
            "dpow_client_heartbeat_stale_transitions_total",
            "Times the server heartbeat went from live to stale")

    # -- wiring ---------------------------------------------------------

    @staticmethod
    def _backend_kwargs(config: ClientConfig, name: str) -> dict:
        """Per-backend knobs: the device, batching, fan, mesh and run-mode
        knobs are the torch engine's (0 = its own auto default), the worker
        URI the subprocess backend's; native takes neither."""
        kwargs = {}
        if name == "subprocess":
            kwargs["uri"] = config.worker_uri
        elif name == "torch":
            kwargs["device"] = config.device
            kwargs["max_batch"] = config.max_batch
            kwargs["mesh_devices"] = config.mesh_devices
            kwargs["devices"] = config.devices
            kwargs["device_shard"] = config.device_shard
            if config.run_steps > 0:
                kwargs["run_steps"] = config.run_steps
            kwargs["run_mode"] = config.run_mode
            if config.control_poll_steps > 0:
                kwargs["control_poll_steps"] = config.control_poll_steps
            if config.device_suspect_after > 0:
                kwargs["device_suspect_after"] = config.device_suspect_after
            kwargs["device_probe_interval"] = config.device_probe_interval
            if config.pipeline > 0:
                kwargs["pipeline"] = config.pipeline
            kwargs["step_ladder"] = config.step_ladder
            if config.shared_steps_cap > 0:
                kwargs["shared_steps_cap"] = config.shared_steps_cap
        return kwargs

    @classmethod
    def _build_backend(cls, config: ClientConfig) -> WorkBackend:
        """The configured engine — or, with --backend_fallback, the whole
        failover chain behind per-engine circuit breakers
        (resilience/failover.py): a primary that errors or hangs trips its
        breaker and the fallback serves, instead of every request dying
        with the reference's log-and-drop."""
        names = [config.backend] + config.fallback_names
        if len(names) == 1:
            return get_backend(names[0], **cls._backend_kwargs(config, names[0]))
        from ..resilience import FailoverBackend

        return FailoverBackend(
            [(n, get_backend(n, **cls._backend_kwargs(config, n))) for n in names],
            failure_threshold=config.breaker_failures,
            reset_timeout=config.breaker_reset,
            hang_timeout=config.backend_hang_timeout,
        )

    async def _send_result(self, request: WorkRequest, work: str) -> None:
        trace_id = self._tracer.id_for(request.block_hash)
        payload = None
        version = "v0"
        if self.config.codec == "v1" and request.block_hash in self._v1_dispatched:
            del self._v1_dispatched[request.block_hash]
            try:
                payload = wire.encode_result(
                    request.block_hash, work, self.config.payout_address,
                    trace_id,
                )
                version = "v1"
            except ValueError:
                payload = None  # malformed field: reply legacy instead
        if payload is None:
            payload = encode_result_payload(
                request.block_hash, work, self.config.payout_address, trace_id
            )
        await self.transport.publish(
            f"result/{request.work_type.value}", payload, qos=QOS_0
        )
        wire.count_encoded(version, "result")
        self._m_results_published.inc(1, request.work_type.value)
        self._tracer.mark_hash(request.block_hash, "result")

    async def setup(self) -> None:
        # Start-up phases (obs/trace.py): each mark ends one; the engine
        # marks cuda_context, kernels and self_test inside its setup(). The
        # clock opens in amain at the process's start, or here.
        tracer = self._tracer
        tracer.startup_begin()
        await self.transport.connect()
        tracer.startup_mark("broker_connect")
        await self.transport.subscribe("heartbeat", qos=QOS_0)
        # Startup gate: a heartbeat must arrive promptly or the server is
        # down and there is no point joining (reference :115-123).
        try:
            await asyncio.wait_for(
                self._await_first_heartbeat(), timeout=self.config.startup_heartbeat_wait
            )
        except asyncio.TimeoutError:
            raise ConnectionError(
                "Server is offline (no heartbeat within "
                f"{self.config.startup_heartbeat_wait}s)"
            )
        # Re-arm the watchdog: a reconnect after a long outage starts from
        # a PROVEN-live feed (the heartbeat above), so the stale state and
        # its gauge must clear here, not linger until the first loop tick.
        self._server_online = True
        self._m_heartbeat_stale.set(0.0)
        tracer.startup_mark("heartbeat_wait")
        for work_type in self.config.work_type.topics:
            await self.transport.subscribe(f"work/{work_type}", qos=QOS_0)
            await self.transport.subscribe(f"cancel/{work_type}", qos=QOS_1)
            if self.config.fleet:
                # Private sharded-dispatch lane (docs/fleet.md): ranged
                # work assignments land here; the broadcast subscription
                # above stays — the server falls back to it whenever the
                # fleet registry is too small or stale.
                await self.transport.subscribe(
                    f"work/{work_type}/{self.worker_id}", qos=QOS_0
                )
        if self.config.payout_address:
            await self.transport.subscribe(
                f"client/{self.config.payout_address}", qos=QOS_1
            )
        tracer.startup_mark("subscribe")
        await self.work_handler.start()
        tracer.startup_mark("self_test")
        if self.config.fleet:
            await self._announce()
        tracer.startup_mark("announce")
        await self._start_metrics_app()
        tracer.startup_mark("metrics_app")
        phases = tracer.startup_done()
        if phases is not None:
            # One line with every phase: an untraced run's split stays in
            # the worker's log.
            logger.info(
                "start-up %.3f s: %s", sum(phases.values()),
                ", ".join(f"{p} {s:.3f}" for p, s in phases.items()),
            )
        # One startup line (reference client logs its connection status): a
        # healthy worker is otherwise silent until the first stats snapshot,
        # indistinguishable from one wedged in setup. Credentials stripped —
        # the URI carries the broker password.
        uri = self.config.server_uri.split("@")[-1]
        logger.info(
            "connected to %s; serving %s; %s backend ready",
            uri,
            ", ".join(f"work/{t}" for t in self.config.work_type.topics),
            self.config.backend,
        )

    async def _start_metrics_app(self) -> None:
        """Serve GET /metrics and GET /spans for this worker
        (config.metrics_port >= 0; 0 binds an ephemeral port, recorded in
        self.metrics_port). The server scrapes its upcheck port; a worker
        fleet scrapes here — engine batch occupancy, H/s, queue depth,
        per-stage spans, and the launch spans on the Unix clock."""
        if self.config.metrics_port < 0 or self._metrics_runner is not None:
            return
        from aiohttp import web

        app = web.Application()
        obs.add_metrics_route(app, process="worker")
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, self.config.metrics_host, self.config.metrics_port)
        await site.start()
        if self._metrics_runner is not None:
            # A concurrent starter won the slot while we were binding
            # (dpowlint DPOW801): one metrics endpoint per client — ours
            # must go, or the loser's runner leaks its socket forever.
            await runner.cleanup()
            return
        self._metrics_runner = runner
        self.metrics_port = site._server.sockets[0].getsockname()[1]
        logger.info("metrics served on :%d/metrics", self.metrics_port)

    async def _announce(self, bye: bool = False) -> None:
        """Publish this worker's capability record to the fleet registry
        (fleet/registry.py). QoS 1: a join must not evaporate into a
        server blip the way QoS-0 work messages may."""
        if bye:
            payload = {"v": 1, "id": self.worker_id, "bye": True}
        else:
            payload = {
                "v": 1,
                "id": self.worker_id,
                "backend": self.config.backend,
                "concurrency": self.work_handler.concurrency,
                "hashrate": self.config.declared_hashrate,
                "work": self.config.work_type.topics,
            }
            if self.config.codec == "v1":
                # Wire-codec capability bit (transport/wire.py): the server
                # sends this worker's lane binary v1 frames only after
                # seeing it here. Omitted under --codec v0 — and a legacy
                # server simply ignores the extra key.
                payload["codec"] = wire.V1
        await self.transport.publish(
            "fleet/announce", json.dumps(payload), qos=QOS_1
        )

    async def _announce_loop(self) -> None:
        """Re-announce on an interval — the fleet heartbeat. A worker that
        stops ticking ages out of the registry (server fleet_worker_ttl)
        and its in-flight shards are re-covered onto the rest of the
        fleet."""
        while True:
            await self.clock.sleep(self.config.fleet_announce_interval)
            try:
                await self._announce()
            except Exception as e:
                logger.warning("fleet announce failed: %s", e)

    async def _await_first_heartbeat(self) -> None:
        async for msg in self.transport.messages():
            if msg.topic == "heartbeat":
                self.last_heartbeat = self.clock.time()
                return

    # -- message dispatch (reference :97-105) ---------------------------

    async def handle_message(self, msg: Message) -> None:
        topic = msg.topic
        if topic == "heartbeat":
            self.last_heartbeat = self.clock.time()
        elif topic.startswith("work/"):
            # work/{type} (broadcast) or work/{type}/{worker_id} (this
            # worker's sharded-dispatch lane) — the type is segment 1
            # either way, and we only ever subscribe our own lane.
            await self.handle_work(topic.split("/")[1], msg.payload)
        elif topic.startswith("cancel/"):
            await self.work_handler.queue_cancel(msg.payload.strip())
        elif topic.startswith("client/"):
            self.handle_stats(msg.payload)

    async def handle_work(self, work_type: str, payload: str) -> None:
        """One work message, either wire generation. A binary v1 frame may
        be a BATCH (the coordinator packs everything a lane gets per flush
        into one publish); the items unbatch here into the existing
        queue_work API one at a time, so the engine sees no difference."""
        try:
            items = wire.decode_work_any(payload)
        except ValueError as e:
            logger.warning("could not parse work message %.120r: %s", payload, e)
            return
        is_v1 = wire.wire_version(payload) == wire.V1
        for block_hash, difficulty, trace_id, nonce_range in items:
            try:
                request = WorkRequest(
                    # v0 parses to a 16-hex string, v1 to a native int
                    # (wire.WorkItem); WorkRequest canonicalizes the hash.
                    block_hash=block_hash,
                    difficulty=(
                        int(difficulty, 16) if isinstance(difficulty, str)
                        else difficulty
                    ),
                    work_type=WorkType(work_type),
                    # Sharded-dispatch assignment (fleet/planner.py): the
                    # engine pins its scan base to the shard start. A legacy
                    # build of this client parses the same payload and simply
                    # never sees the field — it races the full space.
                    nonce_range=nonce_range,
                )
            except (ValueError, nc.InvalidBlockHash, nc.InvalidDifficulty) as e:
                logger.warning("bad work item in %.120r: %s", payload, e)
                continue
            self._m_work_received.inc(1, work_type)
            if is_v1 and self.config.codec == "v1":
                # Under --codec v0 the reply-in-kind marker is dead state
                # (_send_result never consumes it) — skip the bookkeeping.
                self._v1_dispatched[request.block_hash] = None
                self._v1_dispatched.move_to_end(request.block_hash)
                while len(self._v1_dispatched) > 4096:
                    self._v1_dispatched.popitem(last=False)
            if trace_id is not None:
                self._tracer.alias(request.block_hash, trace_id)
            self._tracer.mark_hash(request.block_hash, "dispatch")
            await self.work_handler.queue_work(request)

    def handle_stats(self, payload: str) -> None:
        """Server acknowledgment of accepted work (reference :87-95)."""
        try:
            stats = json.loads(payload)
        except json.JSONDecodeError:
            return
        if "error" in stats:
            logger.error("server reported: %s", stats["error"])
            return
        self.stats["works_accepted"] += 1
        self.stats["latest_stats"] = stats
        logger.info(
            "work accepted (total precache=%s ondemand=%s, rewarded for %s)",
            stats.get("precache"), stats.get("ondemand"), stats.get("block_rewarded"),
        )

    # -- loops ----------------------------------------------------------

    async def _message_loop(self) -> None:
        async for msg in self.transport.messages():
            try:
                await self.handle_message(msg)
            except Exception:
                logger.error("message handling failed:\n%s", traceback.format_exc())

    def _heartbeat_tick(self, now: float) -> None:
        """One watchdog evaluation (split from the loop so tests drive it
        with synthetic clocks instead of sleeping through real seconds).
        Logs once per fresh→stale transition; the gauge tracks the live
        silence while stale and pins to 0 on recovery, so the alarm both
        raises and CLEARS on a dashboard."""
        if self.last_heartbeat is None:
            return
        silence = now - self.last_heartbeat
        stale = silence > self.config.heartbeat_timeout
        self._m_heartbeat_stale.set(silence if stale else 0.0)
        if stale and self._server_online:
            self._server_online = False
            self._m_stale_transitions.inc()
            logger.warning(
                "server heartbeat lost (%.0fs); connection may be dead", silence
            )
        elif not stale and not self._server_online:
            self._server_online = True
            logger.info("server heartbeat recovered")

    async def _heartbeat_check_loop(self) -> None:
        """Staleness watchdog (reference :167-179)."""
        while True:
            await self.clock.sleep(1.0)
            self._heartbeat_tick(self.clock.time())

    def start_loops(self) -> None:
        self._tasks = [
            asyncio.ensure_future(self._message_loop()),
            asyncio.ensure_future(self._heartbeat_check_loop()),
            asyncio.ensure_future(self._engine_stats_loop()),
        ]
        if self.config.fleet:
            self._tasks.append(asyncio.ensure_future(self._announce_loop()))

    async def _engine_stats_loop(self, interval: float = 60.0) -> None:
        """Periodic one-line operator snapshot: handler counters (queued /
        deduped / solved / cancelled / errors — the dedup rate shows how
        often server re-announcements were absorbed) plus engine totals.
        The reference's worker only ever logs per-work lines; rates need
        external scraping there."""
        while True:
            await self.clock.sleep(interval)
            backend = self.work_handler.backend
            logger.info(
                "engine stats: %s | device hashes=%s solutions=%s",
                self.work_handler.stats,
                getattr(backend, "total_hashes", "n/a"),
                getattr(backend, "total_solutions", "n/a"),
            )

    async def run(self) -> None:
        """Full lifecycle incl. error→sleep→reconnect (reference :156-197)."""
        first = True
        while True:
            try:
                # Startup gate: the FIRST setup() failure (no broker, no
                # heartbeat) fails fast — don't retry-loop a misconfig.
                # Re-setups after a lost connection retry like any outage.
                await self.setup()
            except asyncio.CancelledError:
                raise
            except Exception:
                if first:
                    raise
                logger.error("reconnect setup failed; retrying in %.0fs:\n%s",
                             self.config.reconnect_delay, traceback.format_exc())
                await self.close(reconnecting=True)
                await self.clock.sleep(self.config.reconnect_delay)
                continue
            first = False
            try:
                self.start_loops()
                # FIRST_COMPLETED, not gather: the heartbeat watchdog runs
                # forever, so gathering would hang after _message_loop ends
                # cleanly (transport retries exhausted → iterator closes) —
                # a zombie worker that never reconnects. Any loop finishing
                # means the connection is gone; once up, every failure mode
                # reconnects rather than exiting.
                done, _ = await asyncio.wait(
                    self._tasks, return_when=asyncio.FIRST_COMPLETED
                )
                for t in done:
                    t.result()  # surface a crashed loop's exception
                raise RuntimeError("transport message stream ended")
            except asyncio.CancelledError:
                # gather() cancelled its children on outer cancel; wait()
                # does not — tear the loops down so a cancelled run() does
                # not leave a headless client mining in the background.
                for t in self._tasks:
                    t.cancel()
                raise
            except Exception:
                logger.error("client crashed; reconnecting in %.0fs:\n%s",
                             self.config.reconnect_delay, traceback.format_exc())
                await self.close(reconnecting=True)
                await self.clock.sleep(self.config.reconnect_delay)

    async def close(self, reconnecting: bool = False) -> None:
        if self.config.fleet and not reconnecting and self.transport.connected:
            # Clean goodbye: the registry drops our liveness now instead
            # of aging it out, so the very next dispatch does not shard
            # onto a corpse. The crash-reconnect path must NOT say goodbye
            # — we are back within reconnect_delay, and a bye would churn
            # a needless re-cover of our in-flight shards.
            try:
                await self._announce(bye=True)
            except Exception:
                pass
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        metrics_runner, self._metrics_runner = self._metrics_runner, None
        if metrics_runner is not None:
            await metrics_runner.cleanup()
            self.metrics_port = None
        if self.work_handler._started:
            await self.work_handler.stop()
        await self.transport.close()
