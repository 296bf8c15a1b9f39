"""Worker membership + liveness (EDL §4.1): the leader infers liveness from
the per-mini-batch gradient-sync requests — no explicit heartbeats. A worker
that has not synced for ``miss_threshold`` steps while the job progressed is
declared failed (input to §4.2 failure recovery).

Also hosts the straggler detector (§5.2): a worker whose per-mini-batch time
exceeds ``ratio`` x the median for ``window`` consecutive mini-batches.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import deque


@dataclasses.dataclass
class WorkerInfo:
    worker_id: str
    slice_index: int            # which data-parallel slice it owns
    last_sync_step: int = -1
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=64))


class Membership:
    def __init__(self, *, miss_threshold: int = 3):
        self.workers: dict[str, WorkerInfo] = {}
        self.miss_threshold = miss_threshold

    def register(self, worker_id: str, slice_index: int, *,
                 at_step: int = 0):
        """``at_step`` is the job step the worker joined at: registration
        counts as its first sync, so a slice added by a mid-run scale-out
        is not flagged dead in the window before its first mini-batch
        (``last_sync_step`` defaulting to -1 made any join after step
        ``miss_threshold`` look instantly dead)."""
        self.workers[worker_id] = WorkerInfo(worker_id, slice_index,
                                             last_sync_step=at_step)

    def remove(self, worker_id: str):
        self.workers.pop(worker_id, None)

    def sync(self, worker_id: str, step: int, step_time: float):
        w = self.workers[worker_id]
        w.last_sync_step = step
        w.step_times.append(step_time)

    def dead_workers(self, current_step: int) -> list[str]:
        return [w.worker_id for w in self.workers.values()
                if current_step - w.last_sync_step > self.miss_threshold]

    @property
    def parallelism(self) -> int:
        return len(self.workers)


class StragglerDetector:
    """EDL default: per-mini-batch time > 1.2x the cross-worker median for
    10 consecutive mini-batches."""

    def __init__(self, *, ratio: float = 1.2, window: int = 10):
        self.ratio = ratio
        self.window = window
        self._strikes: dict[str, int] = {}

    def observe(self, step_times: dict[str, float]) -> list[str]:
        """Feed one mini-batch's per-worker times; returns workers that just
        crossed the consecutive-strike threshold."""
        if len(step_times) < 2:
            return []
        med = statistics.median(step_times.values())
        flagged = []
        for wid, t in step_times.items():
            if t > self.ratio * med:
                self._strikes[wid] = self._strikes.get(wid, 0) + 1
                if self._strikes[wid] == self.window:
                    flagged.append(wid)
            else:
                self._strikes[wid] = 0
        return flagged

    def reset(self, worker_id: str):
        self._strikes.pop(worker_id, None)
