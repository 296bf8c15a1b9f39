"""repro_torch.obs — cluster-wide observability: telemetry bus, span tracing,
metrics registry.

One ``Observability`` object per run wires the three pillars together
and is handed to the ``ClusterExecutor`` (``obs=``):

  * every executor event (and fault-injector outcome, compile-service
    ticket transition, checkpoint/serving lifecycle event) is mirrored
    onto the typed ``TelemetryBus`` — ring buffer always, JSONL stream
    when ``telemetry_out`` is set;
  * every committed parallelism adjustment becomes a nested span tree on
    the ``Tracer`` (plan/prep/drain/staged-reshard/stop-window/commit),
    exported as a Chrome-trace/Perfetto file when ``trace_out`` is set;
  * the ``MetricsRegistry`` samples pool/job/goodput gauges every round,
    optionally served as Prometheus text on ``prom_port`` (stdlib HTTP,
    loopback only) and snapshotted into the JSONL stream every
    ``metrics_every`` rounds.

Everything here is fire-and-forget from the producers' point of view:
observability failures are counted, never raised into the round loop.
"""
from __future__ import annotations

import threading
import time

from repro_torch.obs.bus import CallbackSink, JsonlSink, RingSink, TelemetryBus
from repro_torch.obs.events import (KIND_ADJUST, KIND_COMPILE, KIND_FAULT,
                              SCHEMA_VERSION, TelemetryEvent,
                              validate_event)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer

__all__ = ["Observability", "TelemetryBus", "TelemetryEvent", "Tracer",
           "MetricsRegistry", "RingSink", "JsonlSink", "CallbackSink",
           "SCHEMA_VERSION", "validate_event"]

_QUEUE_WAIT_BUCKETS = (0.5, 1, 2, 4, 8, 16, 32, 64, 128, 256)


class Observability:
    """The per-run facade the executor (and driver flags) talk to."""

    def __init__(self, *, telemetry_out: str | None = None,
                 trace_out: str | None = None,
                 prom_port: int | None = None,
                 ring: int = 4096, metrics_every: int = 5,
                 clock=time.monotonic):
        self.telemetry_out = telemetry_out
        self.trace_out = trace_out
        self.metrics_every = max(1, int(metrics_every))
        sinks = [RingSink(ring)]
        if telemetry_out:
            sinks.append(JsonlSink(telemetry_out))
        self.bus = TelemetryBus(sinks)
        self.tracer = Tracer(clock=clock)
        self.metrics = MetricsRegistry()
        self._closed = False
        self._lock = threading.Lock()
        m = self.metrics
        self._m_events = m.counter(
            "edl_events_total", "telemetry events by op", labels=("op",))
        self._m_rounds = m.counter(
            "edl_rounds_total", "executor scheduling rounds")
        self._m_pool_total = m.gauge(
            "edl_pool_devices_total", "devices in the cluster pool")
        self._m_pool_free = m.gauge(
            "edl_pool_devices_free", "devices currently unallocated")
        self._m_util = m.gauge(
            "edl_pool_utilization", "fraction of pool devices allocated")
        self._m_lost = m.gauge(
            "edl_capacity_lost_devices",
            "devices condemned and removed from the cluster")
        self._m_jobs = m.gauge(
            "edl_jobs", "tenants by lifecycle state", labels=("state",))
        self._m_steps = m.gauge(
            "edl_steps_total", "training steps completed, all tenants")
        self._m_goodput = m.gauge(
            "edl_goodput_steps_per_round",
            "aggregate training steps per scheduling round")
        self._m_slo = m.gauge(
            "edl_slo_attainment",
            "serving-tier p99 SLO attainment (1.0 = no breaches)")
        self._m_queue_wait = m.histogram(
            "edl_queue_wait_rounds",
            "admission wait from arrival to first grant, in rounds",
            buckets=_QUEUE_WAIT_BUCKETS)
        self._m_stop = m.histogram(
            "edl_stop_window_ms",
            "committed switches' stop window (training paused)")
        self._m_prep = m.histogram(
            "edl_prep_ms", "committed switches' background context prep")
        self._m_e2e = m.histogram(
            "edl_adjust_e2e_ms",
            "committed switches' request-to-commit latency")
        self._prom_server = None
        self.prom_port = None
        if prom_port is not None:
            self._start_prom(prom_port)

    # --------------------------------------------------------- bus facade
    def emit(self, kind: str, name: str, *, round: int | None = None,
             job: str | None = None, jid: int | None = None, **data):
        self.bus.emit(TelemetryEvent(kind=kind, name=name, round=round,
                                     job=job, jid=jid, data=data))

    def events(self) -> list[TelemetryEvent]:
        return self.bus.events()

    def records(self) -> list[dict]:
        """The ring's events as JSONL-equivalent records — what
        ``obs.report`` renders when no file was written."""
        return [{"type": "event", **e.to_dict()} for e in self.events()]

    # ------------------------------------------------- executor callbacks
    def on_executor_event(self, legacy: dict):
        """Mirror one legacy ``executor.events`` dict onto the bus, 1:1."""
        self.bus.emit(TelemetryEvent.from_legacy(legacy))
        self._m_events.labels(legacy["op"]).inc()
        if legacy.get("tier") == "serving" or legacy["op"] == "slo_breach":
            # serving engines commit instantly (no ScalingRecord to span
            # over), so reclaims and breaches land as instant markers on
            # the tenant's trace track instead
            self.tracer.instant(legacy["op"],
                                tid=legacy.get("job") or "pool",
                                cat="serving", round=legacy.get("round"))

    def on_adjustment(self, ex, job, rec):
        """A committed switch: span tree + latency histograms + one
        ``adjust`` event carrying the full ScalingRecord summary. Fires
        from ``ScalingController.complete()`` via the listener the
        executor attaches at admission."""
        name = job.spec.name
        self.tracer.record_adjustment(name, rec)
        self._m_prep.observe(rec.prep_time * 1e3)
        self._m_stop.observe(rec.stop_time * 1e3)
        self._m_e2e.observe(rec.e2e_time * 1e3)
        self.emit(KIND_ADJUST, rec.op, round=getattr(ex, "round", None),
                  job=name, jid=job.jid, **rec.summary())

    def on_queue_wait(self, rounds: float):
        self._m_queue_wait.observe(rounds)

    def on_compile_event(self, name: str, ticket):
        """Compile-service ticket transition (fires on worker threads)."""
        self.emit(KIND_COMPILE, name, key=repr(ticket.key),
                  priority=ticket.priority, owner=repr(ticket.owner),
                  speculative=ticket.speculative)

    def on_fault(self, ex, name: str, **data):
        self.emit(KIND_FAULT, name, round=getattr(ex, "round", None),
                  **data)

    def sample(self, ex):
        """Per-round metrics pass, driven from the executor loop."""
        free, total = len(ex.free), ex.n_gpus
        self._m_rounds.inc()
        self._m_pool_total.set(total)
        self._m_pool_free.set(free)
        self._m_util.set((total - free) / total if total else 0.0)
        self._m_lost.set(ex.capacity_lost)
        states: dict[str, int] = {}
        steps = 0
        for job in ex.jobs.values():
            states[job.state.name.lower()] = \
                states.get(job.state.name.lower(), 0) + 1
            steps += job.steps_done
        for state, n in states.items():
            self._m_jobs.labels(state).set(n)
        self._m_steps.set(steps)
        self._m_goodput.set(steps / max(1, ex.round + 1))
        served = breaches = 0
        for job in ex.jobs.values():
            if getattr(job, "tier", "training") == "serving":
                served += job.rounds_served
                breaches += job.slo_breaches
        if served:
            self._m_slo.set(1.0 - breaches / served)
        if ex.round % self.metrics_every == 0:
            self.bus.emit_raw({"type": "metrics", "round": ex.round,
                               "ts": time.time(),
                               "snapshot": self.metrics.snapshot()})

    # ------------------------------------------------------- prometheus
    def _start_prom(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        obs = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                body = obs.metrics.exposition().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # no request spam on stderr
                pass

        self._prom_server = ThreadingHTTPServer(("127.0.0.1", port),
                                                Handler)
        self.prom_port = self._prom_server.server_address[1]
        th = threading.Thread(target=self._prom_server.serve_forever,
                              daemon=True, name="obs-prom")
        th.start()

    # --------------------------------------------------------- lifecycle
    def close(self):
        """Flush/export everything. Idempotent — the driver closes on the
        normal path and again from error handling without harm."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self.trace_out:
            self.tracer.save(self.trace_out)
        if self._prom_server is not None:
            self._prom_server.shutdown()
            self._prom_server.server_close()
        self.bus.close()
