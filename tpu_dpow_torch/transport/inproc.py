"""In-process transport endpoints over a shared Broker.

The test seam the reference never had (SURVEY.md §4: "multi-node testing is
done against the real broker with real clients") — and a deployment mode
where server + worker share one process and the work pipeline never leaves
Python except to enter the GPU.
"""

from __future__ import annotations

import asyncio
import itertools
from typing import AsyncIterator, Optional

from . import Message, QOS_0, Transport, TransportError
from .broker import Broker, Session

_ids = itertools.count()


class InProcTransport(Transport):
    def __init__(
        self,
        broker: Broker,
        *,
        username: str = "",
        password: str = "",
        client_id: Optional[str] = None,
        clean_session: bool = True,
    ):
        self.broker = broker
        self.username = username
        self.password = password
        self.client_id = client_id or f"inproc-{next(_ids)}"
        self.clean_session = clean_session
        self._session: Optional[Session] = None

    async def connect(self) -> None:
        self._session = self.broker.attach(
            self.client_id, self.username, self.password, self.clean_session
        )
        self._queue = self._session.queue  # the queue THIS connect installed

    @property
    def connected(self) -> bool:
        return self._session is not None and self._session.queue is not None

    def _require(self) -> Session:
        if self._session is None or self._session.queue is None:
            raise TransportError("not connected")
        return self._session

    async def publish(self, topic: str, payload: str, qos: int = QOS_0) -> None:
        self.broker.publish(self._require(), topic, payload, qos)

    async def subscribe(self, pattern: str, qos: int = QOS_0) -> None:
        self.broker.subscribe(self._require(), pattern, qos)

    async def messages(self) -> AsyncIterator[Message]:
        self._require()
        queue = self._queue  # captured: a session takeover owns a new one
        while True:
            # CancelledError must propagate: callers wrap this iterator in
            # wait_for and rely on cancellation actually cancelling.
            msg = await queue.get()
            if msg is None:  # close()/takeover sentinel
                break
            yield msg

    async def close(self) -> None:
        if self._session is not None:
            queue = self._queue
            self.broker.detach(self._session, queue)
            if queue is not None:
                # Wake any consumer blocked in messages().
                try:
                    queue.put_nowait(None)
                except asyncio.QueueFull:
                    pass
            self._session = None
