"""Span tracing for parallelism adjustments — make the stop window
*inspectable*, not just asserted.

Every committed resize/reshape becomes a well-nested span tree derived
from its ``ScalingRecord`` timestamps (the controller and the tracer
share the monotonic clock, so span edges are exact, not re-measured):

  <op> a->b                 t_request .. t_switch_end   (the whole verb)
    plan                    t_request .. t_prep_start   (admission)
    prep                    t_prep_start .. t_prep_end  (background build;
                                                         cache_hit in args)
    drain                   t_prep_end .. t_switch_start (training continues)
      staged_reshard        t_stage_* window, when the draining mini-batch
                            overlapped the state move (PR 8)
    stop_window             t_switch_start .. t_switch_end (training paused)
    commit                  instant at t_switch_end

Checkpoint saves, fault recoveries and serving reclaims get flat spans
on the same timeline. ``chrome_trace()`` exports the Trace Event JSON
that chrome://tracing and Perfetto load directly — "X" complete events
in microseconds, one track (tid) per job — with ``baseTimeNanoseconds``
on the epoch clock, as ``torch.profiler`` writes it, so the file can be
laid over a profiler trace of the same run.

``span(name)`` is the step path's own span: inside
``ElasticTrainer.step`` the ``edl.*`` ranges (step, data, forward,
backward, recompute, update, sync) open a ``torch.profiler``
``record_function`` while a profiler records, and nothing otherwise,
nor inside a context prep's warm-up.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

import torch

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range called ``name`` while a
    profiler records on this thread (autograd's threads inherit the
    flag), so the range lands in the profiler's trace on its own clock;
    otherwise a shared no-op context, at the cost of one flag check. The
    profiler is the switch: nothing else turns the spans on. A context
    prep's warm-up (``LAUNCHES.warming()``) runs the step's functions on
    zeros and opens no span, so the step's phases hold the step's work
    alone."""
    if torch._C._autograd._profiler_enabled():
        # imported here: kernels.launches imports this module
        from repro_torch.kernels.launches import LAUNCHES
        if not LAUNCHES.is_warming():
            return torch.profiler.record_function(name)
    return _NOOP


class Tracer:
    """Collects spans as plain dicts ``{name, cat, tid, t0, t1, args}``
    with ``t0``/``t1`` in tracer-clock seconds (monotonic by default —
    the same clock the ScalingController stamps its records with)."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        # the epoch time of the clock's zero, taken once
        self.epoch_ns = time.time_ns() - round(clock() * 1e9)
        self.spans: list[dict] = []
        self.instants: list[dict] = []
        self._lock = threading.Lock()

    def add_span(self, name: str, t0: float, t1: float, *,
                 tid: str = "cluster", cat: str = "obs", **args) -> dict:
        span = {"name": name, "cat": cat, "tid": tid,
                "t0": float(t0), "t1": float(max(t0, t1)), "args": args}
        with self._lock:
            self.spans.append(span)
        return span

    def instant(self, name: str, *, t: float | None = None,
                tid: str = "cluster", cat: str = "obs", **args):
        mark = {"name": name, "cat": cat, "tid": tid,
                "t": self.clock() if t is None else float(t), "args": args}
        with self._lock:
            self.instants.append(mark)
        return mark

    @contextlib.contextmanager
    def span(self, name: str, *, tid: str = "cluster", cat: str = "obs",
             **args):
        t0 = self.clock()
        try:
            yield
        finally:
            self.add_span(name, t0, self.clock(), tid=tid, cat=cat, **args)

    # ------------------------------------------------- adjustment trees
    def record_adjustment(self, tid: str, rec) -> dict:
        """Derive the nested span tree of one committed switch from its
        ``ScalingRecord``. Because every edge comes from the record's own
        timestamps, the stop_window span's duration IS ``rec.stop_time``
        — the trace can never disagree with the benchmark numbers."""
        label = f"{rec.op} {rec.from_p}->{rec.to_p}"
        if (rec.from_mp, rec.to_mp) != (1, 1):
            label += f" (mp {rec.from_mp}->{rec.to_mp})"
        root = self.add_span(label, rec.t_request, rec.t_switch_end,
                             tid=tid, cat="adjust",
                             cache_hit=rec.compile_cache_hit,
                             steps_during_prep=rec.steps_during_prep)
        self.add_span("plan", rec.t_request, rec.t_prep_start,
                      tid=tid, cat="adjust")
        self.add_span("prep", rec.t_prep_start, rec.t_prep_end,
                      tid=tid, cat="adjust",
                      cache_hit=rec.compile_cache_hit)
        self.add_span("drain", rec.t_prep_end, rec.t_switch_start,
                      tid=tid, cat="adjust")
        t_stage = (getattr(rec, "t_stage_start", 0.0),
                   getattr(rec, "t_stage_end", 0.0))
        if t_stage[1] > 0.0:
            self.add_span("staged_reshard", t_stage[0], t_stage[1],
                          tid=tid, cat="adjust",
                          bytes_moved=rec.bytes_moved_overlapped)
        # the port's own count: the bytes a switch that was not staged
        # copied inside its stop (none for a staged one, nor in the
        # reference's records)
        in_stop = getattr(rec, "bytes_moved_in_stop", 0)
        self.add_span("stop_window", rec.t_switch_start, rec.t_switch_end,
                      tid=tid, cat="adjust",
                      **({"bytes_moved": in_stop} if in_stop else {}))
        self.instant("commit", t=rec.t_switch_end, tid=tid, cat="adjust",
                     switch_step=rec.switch_step)
        return root

    # ------------------------------------------------------ exporters
    def chrome_trace(self) -> dict:
        """Trace Event Format (Perfetto / chrome://tracing): "X" complete
        events plus "i" instants, timestamps rebased to the earliest span
        and converted to microseconds. ``baseTimeNanoseconds`` is that
        span's epoch time, as in ``torch.profiler``'s export: an event's
        ``ts + baseTimeNanoseconds / 1e3`` is its epoch time in µs."""
        with self._lock:
            spans = [dict(s) for s in self.spans]
            instants = [dict(m) for m in self.instants]
        t_base = min([s["t0"] for s in spans] +
                     [m["t"] for m in instants], default=0.0)
        out = []
        # sort so a parent (longer, earlier-starting) precedes its
        # children — viewers nest contained "X" events automatically
        for s in sorted(spans, key=lambda s: (s["t0"], -(s["t1"] - s["t0"]))):
            out.append({"ph": "X", "name": s["name"], "cat": s["cat"],
                        "pid": 1, "tid": s["tid"],
                        "ts": (s["t0"] - t_base) * 1e6,
                        "dur": (s["t1"] - s["t0"]) * 1e6,
                        "args": s["args"]})
        for m in instants:
            out.append({"ph": "i", "name": m["name"], "cat": m["cat"],
                        "pid": 1, "tid": m["tid"], "s": "t",
                        "ts": (m["t"] - t_base) * 1e6, "args": m["args"]})
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.epoch_ns + round(t_base * 1e9)}

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
