"""Broker core: sessions, subscriptions, QoS-1 queues — transport-agnostic.

One Broker instance serves both the in-process endpoints (transport/inproc.py)
and TCP connections (transport/tcp.py); a deployment can mix them, e.g. the
server attached in-process and remote workers over TCP.

Session semantics follow what the reference depends on from Mosquitto:
  * clean_session=False retains a client's subscriptions and queues its
    QoS-1 messages while it is disconnected, replaying them on reconnect
    (reference client/dpow_client.py:109 relies on this for cancel/# and
    client/# delivery across drops);
  * QoS 0 messages to disconnected sessions are dropped;
  * per-session inbound queues are bounded — overflow drops oldest QoS-0
    first (a slow consumer must not wedge the broker).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from .. import obs
from ..utils.logging import get_logger
from . import AuthError, Message, QOS_1, TransportError, User, topic_matches

logger = get_logger("tpu_dpow_torch.transport")

MAX_QUEUE = 10_000
MAX_OFFLINE_QUEUE = 1_000


@dataclass
class Session:
    client_id: str
    username: str
    clean: bool
    subscriptions: Dict[str, int] = field(default_factory=dict)  # pattern → qos
    queue: Optional[asyncio.Queue] = None  # None while disconnected
    offline: list = field(default_factory=list)  # queued QoS-1 while offline
    connected_at: float = field(default_factory=time.monotonic)
    # Has THIS connection already been warned about (one overflow log per
    # connection, not one per shed message — a wedged consumer at depth
    # 10k would otherwise emit a log line per publish).
    overflow_warned: bool = False

    def matches(self, topic: str) -> Optional[int]:
        """Highest QoS among matching subscriptions, or None."""
        best = None
        for pattern, qos in self.subscriptions.items():
            if topic_matches(pattern, topic):
                best = qos if best is None else max(best, qos)
        return best


class Broker:
    """Topic router with auth, ACLs and persistent sessions."""

    def __init__(self, users: Optional[Dict[str, User]] = None):
        self.users = users  # None → open broker (tests)
        self.sessions: Dict[str, Session] = {}
        self.stats = {"published": 0, "delivered": 0, "dropped": 0, "denied": 0}
        # Registry mirror of the routing counters + the session inventory
        # the /upcheck/broker JSON page exposes, now scrapeable.
        reg = obs.get_registry()
        self._m_messages = reg.counter(
            "dpow_broker_messages_total",
            "Broker routing events (published/delivered/dropped/denied)",
            ("event",))
        self._m_sessions = reg.gauge(
            "dpow_broker_sessions", "Known sessions (durable ones included)")
        self._m_connected = reg.gauge(
            "dpow_broker_connected_sessions", "Sessions with a live connection")
        # Queue-full sheds used to vanish into the aggregate "dropped"
        # count; a single slow client's backlog was indistinguishable from
        # offline-session QoS-0 drops. Per-client so the wedged one is
        # nameable (label cardinality is bounded by the registry fold).
        self._m_queue_full = reg.counter(
            "dpow_broker_queue_full_drops_total",
            "Messages shed because a connected client's inbound queue was "
            "full, by client", ("client",))

    def _count(self, event: str, n: int = 1) -> None:
        self.stats[event] += n
        self._m_messages.inc(n, event)

    def _sync_session_gauges(self) -> None:
        self._m_sessions.set(len(self.sessions))
        self._m_connected.set(
            sum(1 for s in self.sessions.values() if s.queue is not None)
        )

    # -- connection lifecycle -----------------------------------------

    def authenticate(self, username: str, password: str) -> User:
        if self.users is None:
            return User(password="")
        user = self.users.get(username)
        if user is None or user.password != password:
            raise AuthError(f"bad credentials for {username!r}")
        return user

    def attach(
        self, client_id: str, username: str, password: str, clean_session: bool = True
    ) -> Session:
        self.authenticate(username, password)
        session = self.sessions.get(client_id)
        if session is not None and session.queue is not None:
            # Session takeover (same client_id reconnects while the old
            # connection lingers, e.g. a NAT-dropped socket): kick the old
            # pump with a poison pill so the new connection owns the
            # session — mosquitto likewise disconnects the prior client.
            try:
                session.queue.put_nowait(None)
            except asyncio.QueueFull:
                pass
        if (
            session is None
            or clean_session
            or session.clean
            or session.username != username
        ):
            # Fresh state also when a DIFFERENT user presents this client_id:
            # a durable session's subscriptions and offline queue must never
            # transfer across accounts (they were ACL-checked as the old user).
            session = Session(client_id=client_id, username=username, clean=clean_session)
            self.sessions[client_id] = session
        session.username = username
        if session.queue is not None:
            # Takeover with undelivered messages still queued: QoS-1 ones
            # must survive into the new connection (at-least-once), not die
            # with the old pump. Drain is safe against the old pump — both
            # run on the event loop thread and the pump is parked in get().
            # Null the queue first so the salvage lands in offline (replayed
            # into the NEW queue just below), not back into the dying one.
            old_queue, session.queue = session.queue, None
            self._salvage(session, old_queue)
            # The drain above also consumed the takeover poison pill put
            # a few statements earlier (attach is synchronous throughout,
            # so the old pump cannot have seen it yet) — re-arm it, or the
            # old connection's pump re-parks on the orphaned queue and the
            # stale connection outlives the takeover (forever at keepalive
            # 0, the NAT-drop case the pill exists for).
            old_queue.put_nowait(None)
        session.queue = asyncio.Queue(maxsize=MAX_QUEUE)
        session.overflow_warned = False  # fresh connection, fresh warning
        # Replay QoS-1 messages queued while this session was offline (or
        # salvaged from a taken-over/detached connection), oldest first.
        for msg in session.offline:
            self._enqueue(session, msg)
        session.offline.clear()
        self._sync_session_gauges()
        return session

    def detach(self, session: Session, queue: Optional[asyncio.Queue] = None) -> None:
        if queue is not None and session.queue is not queue:
            # Stale detach from a taken-over connection: the session now
            # belongs to a newer connection — don't null ITS queue.
            return
        if session.queue is not None:
            # QoS-1 messages the pump never got to send survive the
            # disconnect for durable sessions (the same at-least-once
            # promise Mosquitto keeps; QoS-0 and clean sessions drop).
            # Queue nulled first so the salvage lands in offline.
            old_queue, session.queue = session.queue, None
            self._salvage(session, old_queue)
        session.queue = None
        # Only drop the registry entry if it is still THIS session: after a
        # clean-session takeover the id maps to the new connection's Session,
        # which must keep receiving messages.
        if session.clean and self.sessions.get(session.client_id) is session:
            self.sessions.pop(session.client_id, None)
        self._sync_session_gauges()

    def _salvage(self, session: Session, queue: asyncio.Queue) -> None:
        """Move a dying queue's undelivered QoS-1 messages into the
        session's offline list (durable sessions only)."""
        kept = []
        while True:
            try:
                msg = queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if msg is None:
                continue  # poison pill from an earlier takeover
            if msg.qos >= QOS_1 and not session.clean:
                kept.append(msg)
            else:
                self._count("dropped")
        if kept:
            self.requeue(session, kept)

    def requeue(self, session: Session, messages: list) -> None:
        """Return QoS-1 messages for redelivery (sent-but-unacked from a
        protocol face, or undelivered remnants via _salvage).

        Oldest-first ``messages`` are PREPENDED to the offline list — they
        predate anything published after the disconnect — and marked dup,
        matching Mosquitto's retransmission flag. If the session already
        reattached (takeover finished before the old face's teardown ran),
        deliver straight into the live queue instead.
        """
        redeliveries = [
            Message(topic=m.topic, payload=m.payload, qos=m.qos, dup=True)
            for m in messages
        ]
        if session.queue is not None:
            for msg in redeliveries:
                self._enqueue(session, msg)
            return
        if session.clean:
            self._count("dropped", len(redeliveries))
            return
        session.offline[:0] = redeliveries
        overflow = len(session.offline) - MAX_OFFLINE_QUEUE
        if overflow > 0:
            # Same shed policy as publish(): drop oldest first.
            del session.offline[:overflow]
            self._count("dropped", overflow)

    # -- pub/sub -------------------------------------------------------

    def user_for(self, session: Session) -> User:
        if self.users is None:
            return User(password="")
        user = self.users.get(session.username)
        if user is None:
            # Removed from the ACL table mid-session (durable sessions
            # outlive ACL edits): deny-all, never KeyError — a raw KeyError
            # here would escape the AuthError handling in every caller
            # (publish/subscribe crash the connection task, delivery aborts
            # for all later targets).
            return User(password="", acl_pub=(), acl_sub=())
        return user

    def subscribe(self, session: Session, pattern: str, qos: int) -> None:
        if not self.user_for(session).may_subscribe(pattern):
            self._count("denied")
            raise AuthError(f"{session.username!r} may not subscribe {pattern!r}")
        session.subscriptions[pattern] = qos

    def unsubscribe(self, session: Session, pattern: str) -> None:
        session.subscriptions.pop(pattern, None)

    def publish(self, session: Optional[Session], topic: str, payload: str, qos: int) -> None:
        if session is not None and not self.user_for(session).may_publish(topic):
            self._count("denied")
            raise AuthError(f"{session.username!r} may not publish to {topic!r}")
        self._count("published")
        for target in list(self.sessions.values()):
            sub_qos = target.matches(topic)
            if sub_qos is None:
                continue
            if self.users is not None and not self.user_for(target).may_receive(topic):
                # Per-message read ACL, as mosquitto enforces it: a
                # subscription that slipped past (or predates) the
                # subscribe-time check — or belongs to a user since removed
                # from the ACL table — still never leaks messages.
                self._count("denied")
                continue
            # Effective QoS = min(publish qos, subscription qos), per MQTT.
            eff = min(qos, sub_qos)
            msg = Message(topic=topic, payload=payload, qos=eff)
            if target.queue is None:
                if eff >= QOS_1 and not target.clean:
                    target.offline.append(msg)
                    if len(target.offline) > MAX_OFFLINE_QUEUE:
                        target.offline.pop(0)
                        self._count("dropped")
                else:
                    self._count("dropped")
                continue
            self._enqueue(target, msg)

    def _enqueue(self, target: Session, msg: Message) -> None:
        try:
            target.queue.put_nowait(msg)
            self._count("delivered")
        except asyncio.QueueFull:
            # Shed load: drop the oldest queued message to admit the new
            # one. QoS-1 messages shed here break at-least-once for a
            # CONNECTED-but-wedged client — count it where it can be seen.
            try:
                target.queue.get_nowait()
            except asyncio.QueueEmpty:
                pass
            target.queue.put_nowait(msg)
            self._count("dropped")
            self._m_queue_full.inc(1, target.client_id)
            if not target.overflow_warned:
                target.overflow_warned = True
                logger.warning(
                    "client %r inbound queue full (%d); shedding oldest "
                    "messages — reported once per connection, see "
                    "dpow_broker_queue_full_drops_total for the count",
                    target.client_id, MAX_QUEUE,
                )
