"""TelemetryBus — one emit path, pluggable sinks.

Producers (executor, compile service, fault injector, serving tier) call
``bus.emit(event)`` and never know where the bytes go. Sinks are tiny
append-only consumers:

  RingSink      — bounded in-memory window (the default; what tests and
                  ``cluster_bench --report`` read back);
  JsonlSink     — durable one-JSON-object-per-line stream (``--metrics-out``);
                  also accepts *raw* records (periodic metric snapshots)
                  so one file carries the whole run;
  CallbackSink  — fan out to arbitrary code (the Brain's future hook).

``emit`` is thread-safe: compile-service ticket transitions fire from
worker threads while the executor's round loop emits scheduling events.
A sink failure never breaks the producer — observability must not be
able to take down training — but is counted in ``dropped`` so silent
loss is detectable.
"""
from __future__ import annotations

import collections
import json
import threading

from repro_torch.obs.events import TelemetryEvent


class RingSink:
    """Keep the last ``capacity`` events in memory."""

    def __init__(self, capacity: int = 4096):
        self.ring: collections.deque = collections.deque(maxlen=capacity)

    def emit(self, event: TelemetryEvent):
        self.ring.append(event)

    def events(self) -> list[TelemetryEvent]:
        return list(self.ring)

    def close(self):
        pass


class JsonlSink:
    """Append every record to ``path``, one JSON object per line. Events
    serialize as ``{"type": "event", ...envelope...}``; raw records (metric
    snapshots) pass through with their own ``type``."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def emit(self, event: TelemetryEvent):
        self.emit_raw({"type": "event", **event.to_dict()})

    def emit_raw(self, record: dict):
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()


class CallbackSink:
    def __init__(self, fn):
        self.fn = fn

    def emit(self, event: TelemetryEvent):
        self.fn(event)

    def close(self):
        pass


class TelemetryBus:
    """Fan one event out to every sink, under a lock (emitters live on
    several threads). ``emit_raw`` reaches only sinks that can carry
    non-event records (JsonlSink)."""

    def __init__(self, sinks=()):
        self.sinks = list(sinks)
        self._lock = threading.Lock()
        self.emitted = 0
        self.dropped = 0        # sink failures (never raised to producers)

    def add_sink(self, sink):
        with self._lock:
            self.sinks.append(sink)

    def emit(self, event: TelemetryEvent):
        with self._lock:
            self.emitted += 1
            for sink in self.sinks:
                try:
                    sink.emit(event)
                except Exception:
                    self.dropped += 1

    def emit_raw(self, record: dict):
        with self._lock:
            for sink in self.sinks:
                fn = getattr(sink, "emit_raw", None)
                if fn is None:
                    continue
                try:
                    fn(record)
                except Exception:
                    self.dropped += 1

    def events(self) -> list[TelemetryEvent]:
        """The first ring sink's window (the common read-back path)."""
        with self._lock:
            for sink in self.sinks:
                if isinstance(sink, RingSink):
                    return sink.events()
        return []

    def close(self):
        with self._lock:
            for sink in self.sinks:
                try:
                    sink.close()
                except Exception:
                    self.dropped += 1
