"""FaultyTransport: fault injection at the pub/sub seam.

Wraps any :class:`~tpu_dpow_torch.transport.Transport` and consults the schedule
on both directions:

  op "publish"  (subject: topic) — drop / delay / duplicate / disconnect
                before the message reaches the broker: the QoS-0
                publish-into-the-void failure the supervisor must heal;
  op "deliver"  (subject: topic) — drop / delay / duplicate / reorder on
                the inbound side: one endpoint's flaky last hop, without
                touching what every other session sees.

Delays run on the injected clock, so chaos tests never sleep for real.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from ..transport import Message, QOS_0, Transport, TransportError
from .schedule import DELAY, DISCONNECT, DROP, DUPLICATE, REORDER, FaultSchedule


class FaultyTransport(Transport):
    def __init__(self, inner: Transport, schedule: FaultSchedule, *, clock=None):
        from ..resilience.clock import SystemClock

        self.inner = inner
        self.schedule = schedule
        self.clock = clock or SystemClock()

    async def connect(self) -> None:
        await self.inner.connect()

    async def subscribe(self, pattern: str, qos: int = QOS_0) -> None:
        await self.inner.subscribe(pattern, qos)

    async def close(self) -> None:
        await self.inner.close()

    @property
    def connected(self) -> bool:
        return self.inner.connected

    async def publish(self, topic: str, payload: str, qos: int = QOS_0) -> None:
        rule = self.schedule.decide("publish", topic)
        if rule is not None:
            if rule.action == DROP:
                return
            if rule.action == DISCONNECT:
                raise TransportError(f"chaos: injected disconnect on {topic}")
            if rule.action == DELAY:
                await self.clock.sleep(rule.delay)
            if rule.action == DUPLICATE:
                await self.inner.publish(topic, payload, qos)
        await self.inner.publish(topic, payload, qos)

    async def messages(self) -> AsyncIterator[Message]:
        held: Optional[Message] = None  # one-deep reorder buffer
        async for msg in self.inner.messages():
            rule = self.schedule.decide("deliver", msg.topic)
            action = rule.action if rule is not None else None
            if action == DROP:
                continue
            if action == DELAY:
                await self.clock.sleep(rule.delay)
            if action == REORDER and held is None:
                held = msg  # deliver AFTER the next message
                continue
            yield msg
            if action == DUPLICATE:
                yield msg
            if held is not None:
                out, held = held, None
                yield out
        if held is not None:
            yield held
