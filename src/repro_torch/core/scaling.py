"""Scaling state machine + event records (EDL §4.2).

Scaling operations commit sequentially: a request arriving while another is in
flight gets RETRY (the paper's behaviour). Each operation is decomposed into
the paper's cost phases so benchmarks can reproduce Fig 5/6/8:

  context-prep   — background executable build for the target parallelism
                   (stop-free: training continues throughout)
  topo-switch    — swap to the new mesh/executable at the scheduled step
  model-broadcast— reshard the train state onto the new mesh

``stop_time`` counts only the wall time existing workers are actually paused
(topo-switch + broadcast); ``e2e_time`` includes the hidden preparation.
"""
from __future__ import annotations

import dataclasses
import enum
import time


class Phase(enum.Enum):
    IDLE = "idle"
    PREPARING = "preparing"
    SCHEDULED = "scheduled"


class Busy(Exception):
    """RETRY: a scaling operation is already in flight (paper §3.1)."""


@dataclasses.dataclass
class ScalingRecord:
    op: str         # scale_out | scale_in | migrate | reshape | stop_resume
    from_p: int
    to_p: int
    t_request: float = 0.0
    t_prep_start: float = 0.0
    t_prep_end: float = 0.0
    t_switch_start: float = 0.0
    t_switch_end: float = 0.0
    steps_during_prep: int = 0  # stop-free evidence: training kept going
    switch_step: int = -1
    # model-parallel degree across the switch (reshape trades from_p
    # data-parallel replicas of from_mp devices for to_p of to_mp)
    from_mp: int = 1
    to_mp: int = 1
    # reshape.plan_reshard accounting for the state move at commit
    reshard_bytes_moved: int = 0
    reshard_bytes_kept: int = 0
    # adjustment-overhead pipeline provenance: was the exec handle already
    # in the per-trainer cache at request time (prefetched / revisited
    # shape — prep collapses to a cache lookup), and under which key
    compile_cache_hit: bool = False
    exec_cache_key: tuple | None = None
    # bytes whose device_put started BEFORE the stop window opened
    # (overlapped with the draining mini-batch); 0 = the whole state move
    # ran inside the stop
    bytes_moved_overlapped: int = 0
    # bytes the commit copied inside the stop window when the switch was
    # not staged (same-card copies of kept boxes included); 0 when staged.
    # The port's own: not in summary(), which the reference's records
    # match; the Tracer's stop_window span carries it as bytes_moved
    bytes_moved_in_stop: int = 0
    # staged-reshard window (overlapped state move issued by the draining
    # mini-batch, see elastic_runtime._stage_switch); both 0.0 when the
    # switch took the in-stop move instead
    t_stage_start: float = 0.0
    t_stage_end: float = 0.0

    @property
    def prep_time(self) -> float:
        return self.t_prep_end - self.t_prep_start

    @property
    def stop_time(self) -> float:
        return self.t_switch_end - self.t_switch_start

    @property
    def e2e_time(self) -> float:
        return self.t_switch_end - self.t_request

    def summary(self) -> dict:
        out = {"op": self.op, "from_p": self.from_p, "to_p": self.to_p,
               "prep_s": round(self.prep_time, 4),
               "stop_s": round(self.stop_time, 4),
               "e2e_s": round(self.e2e_time, 4),
               "steps_during_prep": self.steps_during_prep,
               "switch_step": self.switch_step,
               "cache_hit": self.compile_cache_hit}
        if self.exec_cache_key is not None:
            # JSON-safe: (p, mp, (device ids...)) -> flat list
            p, mp, devs = self.exec_cache_key
            out["exec_cache_key"] = [p, mp, list(devs)]
        if (self.from_mp, self.to_mp) != (1, 1):
            out.update(from_mp=self.from_mp, to_mp=self.to_mp,
                       reshard_bytes_moved=self.reshard_bytes_moved,
                       reshard_bytes_kept=self.reshard_bytes_kept,
                       bytes_moved_overlapped=self.bytes_moved_overlapped)
        if self.t_stage_end > 0.0:
            out["stage_s"] = round(self.t_stage_end - self.t_stage_start, 4)
        return out


@dataclasses.dataclass
class SwitchPlan:
    target_p: int
    record: ScalingRecord
    switch_step: int = -1       # set when prep completes (t_cur + k)
    ready: bool = False
    exec_handle: object = None  # (mesh, compiled fns, shardings)
    exiting: tuple = ()         # worker ids leaving (scale-in / migrate)
    dead_exiting: tuple = ()    # subset of exiting that CRASHED: their data
                                # partitions release via release(dead=True)
                                # (replay from the original offset) instead
                                # of a graceful remainder hand-back
    joining: tuple = ()
    release_devices: bool = False   # hand freed devices back at commit
                                    # (cluster executor's reclaim path)
    # overlapped state move: the draining mini-batch stages the reshard —
    # destination buffers (double-buffered against the live state) whose
    # device_put was issued before the stop window opened. ``staged_from``
    # pins the exact state object the staging read; a commit over any
    # other state falls back to the in-stop move.
    staged_state: object = None
    staged_from: object = None


class ScalingController:
    """Sequential admission + phase tracking for one job."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.phase = Phase.IDLE
        self.plan: SwitchPlan | None = None
        self.history: list[ScalingRecord] = []
        # observability hooks fired with the finished record at complete()
        # — AFTER the controller is back to IDLE, so a listener that
        # inspects (or even requests) scaling sees a consistent machine
        self.listeners: list = []

    def admit(self, op: str, from_p: int, to_p: int) -> SwitchPlan:
        if self.phase is not Phase.IDLE:
            raise Busy(f"scaling {self.plan.record.op} in flight")
        rec = ScalingRecord(op, from_p, to_p, t_request=self.clock())
        self.plan = SwitchPlan(to_p, rec)
        self.phase = Phase.PREPARING
        rec.t_prep_start = self.clock()
        return self.plan

    def prepared(self, switch_step: int, exec_handle):
        assert self.phase is Phase.PREPARING
        self.plan.record.t_prep_end = self.clock()
        self.plan.switch_step = switch_step
        self.plan.record.switch_step = switch_step
        self.plan.exec_handle = exec_handle
        self.plan.ready = True
        self.phase = Phase.SCHEDULED

    def begin_switch(self):
        assert self.phase is Phase.SCHEDULED
        self.plan.record.t_switch_start = self.clock()

    def complete(self) -> ScalingRecord:
        rec = self.plan.record
        rec.t_switch_end = self.clock()
        self.history.append(rec)
        self.plan = None
        self.phase = Phase.IDLE
        for fn in list(self.listeners):
            fn(rec)
        return rec

    def abort(self):
        self.plan = None
        self.phase = Phase.IDLE
