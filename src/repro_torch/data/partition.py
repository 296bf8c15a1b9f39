"""Logical dataset partitions (metadata only — the dataset is never
physically split, exactly as EDL §4.3: partitioning records names/offsets).

A partition is a contiguous range of sample indices. For the dynamic
pipeline, ``d`` — the number of logical partitions — is chosen much larger
than any plausible *physical* worker count while keeping each partition
large enough for high-bandwidth sequential reads; a physical worker streams
through many partitions per epoch. The virtual-worker pipeline reuses the
same splitter with ``d = n_virtual``: there each partition is one virtual
worker's fixed sample block, and ``virtual_block`` maps a physical worker
to the contiguous run of virtual workers it hosts at the current data
parallelism.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Partition:
    pid: int
    start: int          # first sample index
    count: int          # number of samples

    @property
    def end(self) -> int:
        return self.start + self.count


@dataclasses.dataclass
class PartitionAssignment:
    """What the leader hands a worker on ``next_assignment()``: partition
    metadata plus the offset to resume from (non-zero when re-assigning a
    partially processed partition returned by a gracefully exiting
    worker)."""
    partition: Partition
    offset: int = 0     # samples already consumed within the partition

    @property
    def remaining(self) -> int:
        return self.partition.count - self.offset


def make_partitions(n_samples: int, d: int) -> list[Partition]:
    """Split [0, n_samples) into d nearly-equal contiguous partitions."""
    assert 0 < d <= n_samples
    base, rem = divmod(n_samples, d)
    parts, start = [], 0
    for i in range(d):
        cnt = base + (1 if i < rem else 0)
        parts.append(Partition(i, start, cnt))
        start += cnt
    return parts


# ------------------------------------------ virtual -> physical mapping
def virtual_block(worker_index: int, dp: int, n_virtual: int) -> range:
    """The contiguous block of virtual workers that physical worker
    ``worker_index`` (of ``dp``) hosts. Deterministic and purely a function
    of (worker_index, dp, n_virtual): after any resize the new mapping is
    recomputed from scratch — no virtual worker is ever lost or duplicated
    (property-tested in tests/test_virtual.py)."""
    if not 1 <= dp <= n_virtual:
        raise ValueError(f"dp={dp} must be in [1, n_virtual={n_virtual}]")
    if n_virtual % dp:
        raise ValueError(f"dp={dp} must divide n_virtual={n_virtual}")
    if not 0 <= worker_index < dp:
        raise ValueError(f"worker_index={worker_index} not in [0, {dp})")
    local = n_virtual // dp
    return range(worker_index * local, (worker_index + 1) * local)


def virtual_blocks(dp: int, n_virtual: int) -> list[range]:
    """All ``dp`` blocks, in physical-worker order. Their concatenation is
    exactly ``range(n_virtual)`` — the fixed virtual order every reduction
    and batch assembly follows, regardless of dp."""
    return [virtual_block(w, dp, n_virtual) for w in range(dp)]
