"""Domain model for proof-of-work requests flowing through the engine.

Counterpart of ``tpu_dpow/models/work.py``: the request and result types
the backend and the work server pass around. The server-side difficulty
policy (``DifficultyModel``) stays with the JAX package's server stack,
which this slice does not port.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from ..utils import nanocrypto as nc


class WorkType(str, enum.Enum):
    """Work urgency classes (reference docs/specification.md:7-9)."""

    PRECACHE = "precache"
    ONDEMAND = "ondemand"
    ANY = "any"  # client-side subscription choice only

    @property
    def topics(self) -> list[str]:
        if self is WorkType.ANY:
            return [WorkType.PRECACHE.value, WorkType.ONDEMAND.value]
        return [self.value]


@dataclass(frozen=True)
class WorkRequest:
    """One unit of searchable work: a block hash at a difficulty.

    ``nonce_range`` is a sharded-dispatch assignment: ``(start, length)``
    with length 0 meaning the full 2^64 span. It is a SOFT hint — the engine
    starts its scan at ``start`` instead of a random decorrelating base and
    may scan past the end rather than stall on a shard that holds no
    solution.
    """

    block_hash: str  # 64 uppercase hex chars
    difficulty: int  # u64 threshold
    work_type: WorkType = WorkType.ONDEMAND
    nonce_range: Optional[tuple] = None  # (start u64, length u64; 0 = 2^64)

    def __post_init__(self):
        object.__setattr__(self, "block_hash", nc.validate_block_hash(self.block_hash))
        if not (0 < self.difficulty <= nc.MAX_U64):
            raise nc.InvalidDifficulty(f"difficulty out of range: {self.difficulty}")
        if self.nonce_range is not None:
            start, length = self.nonce_range
            if not (0 <= start <= nc.MAX_U64) or not (0 <= length <= nc.MAX_U64):
                raise ValueError(f"nonce range out of u64: {self.nonce_range}")
            object.__setattr__(self, "nonce_range", (int(start), int(length)))

    @property
    def difficulty_hex(self) -> str:
        return f"{self.difficulty:016x}"

    @property
    def multiplier(self) -> float:
        return nc.derive_work_multiplier(self.difficulty)

    @property
    def hash_bytes(self) -> bytes:
        return bytes.fromhex(self.block_hash)


@dataclass(frozen=True)
class WorkResult:
    """A solved nonce for a request, with attribution for rewards."""

    block_hash: str
    work: str  # 16 hex chars, big-endian nonce per Nano convention
    client: Optional[str] = None  # payout account of the solving worker
    work_type: WorkType = WorkType.ONDEMAND

    def value(self) -> int:
        return nc.work_value(self.block_hash, self.work)

    def validate(self, difficulty: int) -> None:
        nc.validate_work(self.block_hash, self.work, difficulty)
