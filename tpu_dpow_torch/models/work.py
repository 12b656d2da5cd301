"""Domain model for proof-of-work requests flowing through the engine.

Counterpart of ``tpu_dpow/models/work.py``: the request and result types
the backend, the work server and the hub pass around, and the hub's
difficulty policy (``DifficultyModel``).
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


@dataclass
class DifficultyModel:
    """Server-side difficulty policy.

    Unlike the reference — which ships with FORCE_ONLY_BASE_DIFFICULTY=True,
    neutering its own multiplier subsystem (reference dpow_server.py:39-40,
    273-282, "some outstanding bugs") — multipliers here are first-class.
    """

    base_difficulty: int = nc.BASE_DIFFICULTY
    max_multiplier: float = 5.0
    # Reuse precached work when its difficulty is at least this fraction of
    # the requested multiplier (reference dpow_server.py:37).
    precache_reuse_fraction: float = 0.8

    def resolve(
        self,
        difficulty_hex: Optional[str] = None,
        multiplier: Optional[float] = None,
    ) -> int:
        """Resolve a service request's difficulty/multiplier fields → u64.

        Mirrors reference dpow_server.py:250-282: explicit difficulty wins
        over multiplier; both are validated against max_multiplier (out of
        range raises InvalidMultiplier); absent both, the base applies.
        """
        if difficulty_hex is not None:
            difficulty = int(nc.validate_difficulty(difficulty_hex), 16)
            mult = nc.derive_work_multiplier(difficulty, self.base_difficulty)
            if mult > self.max_multiplier or mult < 1.0 / self.max_multiplier:
                raise nc.InvalidMultiplier(
                    f"difficulty {difficulty_hex} outside allowed multiplier range "
                    f"[{1.0 / self.max_multiplier}, {self.max_multiplier}]"
                )
            return difficulty
        if multiplier is not None:
            multiplier = float(multiplier)
            if multiplier > self.max_multiplier or multiplier < 1.0 / self.max_multiplier:
                raise nc.InvalidMultiplier(
                    f"multiplier {multiplier} outside allowed range"
                )
            return nc.derive_work_difficulty(multiplier, self.base_difficulty)
        return self.base_difficulty

    def precache_usable(self, precached_difficulty: int, requested_difficulty: int) -> bool:
        """Is stored precache work strong enough for this request?"""
        got = nc.derive_work_multiplier(precached_difficulty, self.base_difficulty)
        want = nc.derive_work_multiplier(requested_difficulty, self.base_difficulty)
        return got >= self.precache_reuse_fraction * want
