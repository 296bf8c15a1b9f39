"""etcd/ZooKeeper stand-in: a compare-and-swap KV store with TTL leases and
watch callbacks — the exact primitive set EDL's leader election (§4.1) needs.

The interface is deliberately etcd-shaped (cas / lease / watch) so a real
etcd3 client can replace it in a multi-controller deployment without touching
election or scaling logic. A virtual clock is injectable for deterministic
tests of lease expiry.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable


class CoordinationStore:
    def __init__(self, clock: Callable[[], float] | None = None):
        self._clock = clock or time.monotonic
        self._lock = threading.RLock()
        self._data: dict[str, Any] = {}
        self._leases: dict[str, float] = {}     # key -> expiry time
        self._watchers: dict[str, list[Callable[[str, Any], None]]] = {}
        self.stats = {"cas": 0, "get": 0, "put": 0}

    # ------------------------------------------------------------- helpers
    def _expire_locked(self, key: str) -> bool:
        """Drop the key if its lease lapsed. Returns True if expired."""
        exp = self._leases.get(key)
        if exp is not None and self._clock() >= exp:
            self._data.pop(key, None)
            self._leases.pop(key, None)
            self._notify(key, None)
            return True
        return False

    def _notify(self, key: str, value):
        for cb in self._watchers.get(key, []):
            cb(key, value)

    # ------------------------------------------------------------------ API
    def get(self, key: str):
        with self._lock:
            self.stats["get"] += 1
            self._expire_locked(key)
            return self._data.get(key)

    def put(self, key: str, value, *, ttl: float | None = None):
        with self._lock:
            self.stats["put"] += 1
            self._data[key] = value
            if ttl is not None:
                self._leases[key] = self._clock() + ttl
            else:
                self._leases.pop(key, None)
            self._notify(key, value)

    def cas(self, key: str, expected, new, *, ttl: float | None = None
            ) -> bool:
        """Atomic compare-and-swap (the leader-election transaction)."""
        with self._lock:
            self.stats["cas"] += 1
            self._expire_locked(key)
            if self._data.get(key) != expected:
                return False
            self._data[key] = new
            if ttl is not None:
                self._leases[key] = self._clock() + ttl
            else:
                # mirror put(): a ttl-less write is durable — a stale lease
                # left by the previous writer must not expire the new value
                self._leases.pop(key, None)
            self._notify(key, new)
            return True

    def refresh(self, key: str, ttl: float) -> bool:
        """Lease keep-alive; fails if the key expired (leader must re-elect)."""
        with self._lock:
            if self._expire_locked(key) or key not in self._data:
                return False
            self._leases[key] = self._clock() + ttl
            return True

    def delete(self, key: str):
        with self._lock:
            self._data.pop(key, None)
            self._leases.pop(key, None)
            self._notify(key, None)

    def watch(self, key: str, callback: Callable[[str, Any], None]):
        with self._lock:
            self._watchers.setdefault(key, []).append(callback)

    def sweep(self):
        """Expire all lapsed leases (tests / timer tick)."""
        with self._lock:
            for key in list(self._leases):
                self._expire_locked(key)
