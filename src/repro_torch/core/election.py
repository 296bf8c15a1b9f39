"""Leader election / discovery (EDL §4.1).

Every worker runs this procedure whenever the leader is unknown: query
``leader/<job>`` in the coordination store; if void or expired, CAS your own
address in and become the leader. The leader refreshes its lease; on expiry
all workers are notified (watch) and re-run election.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.coordination import CoordinationStore

DEFAULT_TTL = 10.0


@dataclasses.dataclass
class ElectionResult:
    leader_id: str
    is_self: bool
    attempts: int


class LeaderElection:
    def __init__(self, store: CoordinationStore, job_handle: str,
                 worker_id: str, *, ttl: float = DEFAULT_TTL):
        self.store = store
        self.key = f"leader/{job_handle}"
        self.worker_id = worker_id
        self.ttl = ttl

    def elect(self) -> ElectionResult:
        """CAS-based election: first writer wins; losers discover the winner."""
        attempts = 0
        while True:
            attempts += 1
            cur = self.store.get(self.key)
            if cur is not None:
                return ElectionResult(cur, cur == self.worker_id, attempts)
            if self.store.cas(self.key, None, self.worker_id, ttl=self.ttl):
                return ElectionResult(self.worker_id, True, attempts)
            # lost the race — loop re-reads the winner

    def refresh(self) -> bool:
        """Leader lease keep-alive; False means leadership was lost."""
        return self.store.refresh(self.key, self.ttl)

    def resign(self):
        """Graceful leader hand-off (scale-in of the leader): erase the
        address so the next election can proceed immediately (§4.2)."""
        if self.store.get(self.key) == self.worker_id:
            self.store.delete(self.key)

    def watch_expiry(self, callback: Callable[[], None]):
        def cb(_key, value):
            if value is None:
                callback()
        self.store.watch(self.key, cb)
