"""Metrics registry — counters, gauges, histograms with Prometheus text
exposition (format 0.0.4) and JSON snapshots.

Stdlib-only by design: the driver's optional ``--prom-port`` endpoint
must not drag a client library into the image. Families are registered
once by name; labelled children are materialized on first touch, so the
executor's hot path is a dict lookup + float add under one small lock.

Canonical names (see docs/observability.md for the full table):

  edl_pool_devices_total / edl_pool_devices_free / edl_pool_utilization
  edl_capacity_lost_devices       devices condemned and removed (chaos)
  edl_jobs{state=...}             tenants per lifecycle state
  edl_rounds_total / edl_steps_total / edl_goodput_steps_per_round
  edl_events_total{op=...}        every legacy/bus event, by op
  edl_queue_wait_rounds           admission wait (arrival -> first grant)
  edl_stop_window_ms / edl_prep_ms / edl_adjust_e2e_ms   per switch
  edl_slo_attainment              serving tier, when present
"""
from __future__ import annotations

import json
import threading

# default buckets are in MILLISECONDS, spanning the sub-ms stop windows
# (PR 8's ~0.2 ms claim must land in a resolvable bucket) up to
# checkpoint-scale seconds
DEFAULT_BUCKETS_MS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                      50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def _label_str(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + inner + "}"


class _Family:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names=()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values, **kv):
        if kv:
            values = tuple(kv[n] for n in self.label_names)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.label_names}, got {key}")
        with self._lock:
            child = self.children.get(key)
            if child is None:
                child = self.children[key] = self._new_child()
            return child

    def _default(self):
        return self.labels()


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0):
        self.value += amount


class Counter(_Family):
    kind = "counter"
    _new_child = _CounterChild

    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def expose(self) -> list[str]:
        return [f"{self.name}{_label_str(self.label_names, key)} "
                f"{_fmt(c.value)}"
                for key, c in sorted(self.children.items())]

    def snapshot(self):
        if not self.label_names:
            return self._default().value
        return {",".join(k): c.value for k, c in self.children.items()}


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float):
        self.value = float(value)

    def inc(self, amount: float = 1.0):
        self.value += amount


class Gauge(_Family):
    kind = "gauge"
    _new_child = _GaugeChild

    def set(self, value: float):
        self._default().set(value)

    def expose(self) -> list[str]:
        return [f"{self.name}{_label_str(self.label_names, key)} "
                f"{_fmt(g.value)}"
                for key, g in sorted(self.children.items())]

    def snapshot(self):
        if not self.label_names:
            return self._default().value
        return {",".join(k): g.value for k, g in self.children.items()}


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        v = float(value)
        self.sum += v
        self.count += 1
        # per-bucket tallies; exposition cumulates (Prometheus semantics)
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                break


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help, label_names=(),
                 buckets=DEFAULT_BUCKETS_MS):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float):
        self._default().observe(value)

    def expose(self) -> list[str]:
        lines = []
        for key, h in sorted(self.children.items()):
            cum = 0
            for edge, n in zip(h.buckets, h.counts):
                cum += n
                labels = _label_str(self.label_names + ("le",),
                                    key + (_fmt(edge),))
                lines.append(f"{self.name}_bucket{labels} {cum}")
            labels = _label_str(self.label_names + ("le",), key + ("+Inf",))
            lines.append(f"{self.name}_bucket{labels} {h.count}")
            ls = _label_str(self.label_names, key)
            lines.append(f"{self.name}_sum{ls} {_fmt(h.sum)}")
            lines.append(f"{self.name}_count{ls} {h.count}")
        return lines

    def snapshot(self):
        def one(h):
            return {"count": h.count, "sum": h.sum,
                    "buckets": dict(zip(map(_fmt, h.buckets), h.counts))}
        if not self.label_names:
            return one(self._default())
        return {",".join(k): one(h) for k, h in self.children.items()}


class MetricsRegistry:
    """Get-or-create families by name; one registry per Observability."""

    def __init__(self):
        self._lock = threading.Lock()
        self.families: dict[str, _Family] = {}

    def _get(self, cls, name, help, label_names, **kw):
        with self._lock:
            fam = self.families.get(name)
            if fam is None:
                fam = self.families[name] = cls(name, help, label_names,
                                                **kw)
            elif not isinstance(fam, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}")
            return fam

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS_MS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def exposition(self) -> str:
        """Prometheus text format 0.0.4."""
        lines = []
        for name in sorted(self.families):
            fam = self.families[name]
            body = fam.expose()
            if not body:
                continue
            lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            lines.extend(body)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-serializable view of every family (the periodic JSONL
        snapshot record)."""
        out = {name: fam.snapshot()
               for name, fam in sorted(self.families.items())
               if fam.children}
        json.dumps(out)     # guarantee the contract at the source
        return out
