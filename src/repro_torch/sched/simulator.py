"""Discrete-event multi-tenant GPU cluster simulator.

Jobs demand ``total_samples`` of work; a job allocated p device groups
(data-parallel replicas of ``mp`` devices each — ``mp=1`` for plain
data-parallel tenants) progresses at ``throughput(model, p)`` samples/s.
The cluster size ``n_gpus`` and attained service are in devices; policies
(sched.base) convert between the two via ``group_size``. Parallelism
changes cost:

  * EDL            — stop-free: existing GPUs lose only ``edl_stop_s``
                     (default 0.5 s); newly added GPUs additionally pay
                     ``context_prep_s`` before contributing (that loss is
                     inevitable, §6.1).
  * stop-resume    — ALL GPUs idle for ``context_prep_s`` on every change.

The scheduler (Tiresias / Elastic-Tiresias / static) is a pluggable policy
called on every event; it returns the new allocation map. Job progress and
all policy throughput queries go through ONE pluggable
``repro_torch.sched.throughput.ThroughputModel`` (default: the analytic Fig-1
curves), exposed to policies as ``view.throughput_model``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable

from repro_torch.sched.throughput import AnalyticModel, ThroughputModel


@dataclasses.dataclass
class Job:
    jid: int
    model: str
    requested_p: int        # in device GROUPS (data-parallel replicas)
    total_samples: float
    arrival: float
    inelastic: bool = False
    mp: int = 1             # devices per group (model-parallel degree)
    mp_auto: bool = False   # policies may RESHAPE the degree live
    # serving tier (Aryl-style): a non-empty ``trace`` makes this a
    # serving tenant — request rates, one entry per ``trace_dt`` seconds
    # of sim time (replayed modulo), turned into replica demand through
    # ``replica_capacity`` (requests one replica clears per round).
    # Serving-aware policies fund ``desired_p(now)`` before training.
    tier: str = "training"
    trace: tuple = ()
    trace_dt: float = 30.0
    replica_capacity: float = 1.0
    min_replicas: int = 1
    # runtime state
    alloc: int = 0          # groups currently held
    remaining: float = 0.0
    attained_gpu_s: float = 0.0     # Tiresias service metric
    start_time: float | None = None
    finish_time: float | None = None
    frozen_until: float = 0.0       # scaling overhead window

    def __post_init__(self):
        self.remaining = self.total_samples
        # the shape the demand was quoted at (``mp`` mutates on reshape)
        self.requested_mp = self.mp
        if self.trace and self.tier == "training":
            self.tier = "serving"

    def desired_p(self, now: float) -> int:
        """Serving-tier replica demand at sim time ``now`` (the wall
        clock, unlike the live tier's served-rounds index — the simulator
        has no per-tenant wave loop to count)."""
        if not self.trace:
            return self.requested_p
        rate = self.trace[int(now // self.trace_dt) % len(self.trace)]
        if self.replica_capacity <= 0:
            raise ValueError(f"job {self.jid}: replica_capacity must be "
                             f"> 0")
        need = int(-(-rate // self.replica_capacity))  # ceil
        return max(self.min_replicas, need)


@dataclasses.dataclass
class ScalingCosts:
    edl_stop_s: float = 0.5
    context_prep_s: float = 35.0    # stop-resume full restart / new-worker prep
    mode: str = "edl"               # edl | stop_resume
    # reshape context-prep priced SEPARATELY from the stop window (the
    # measured split: benchmarks/scaling_overhead.py records a ~ms stop
    # but seconds of context prep per transition). A (p, mp) shape the job
    # has not run before pays this once — the first-visit COLD compile;
    # revisited shapes are warm (the exec-handle / persistent compile
    # cache). 0.0 keeps the pre-split pricing (golden schedules
    # untouched); load the measured value via ``from_overhead_bench``.
    reshape_prep_s: float = 0.0

    @classmethod
    def from_overhead_bench(cls, path: str | None = None,
                            **kw) -> "ScalingCosts":
        """Price the simulator from the measured prep/stop split recorded
        by ``benchmarks/scaling_overhead.py`` in
        ``experiments/bench_overhead.json`` (cold transition: ``prep_s``
        -> reshape_prep_s, ``stop_s`` -> edl_stop_s). Falls back to the
        dataclass defaults when the artifact is absent."""
        import json
        import os
        if path is None:
            path = os.path.join(os.path.dirname(__file__), "..", "..",
                                "..", "experiments", "bench_overhead.json")
        try:
            with open(path) as f:
                cold = json.load(f)["transitions"]["cold_reshape"]
            kw.setdefault("reshape_prep_s", float(cold["prep_s"]))
            kw.setdefault("edl_stop_s", max(float(cold["stop_s"]), 1e-4))
        except (OSError, KeyError, ValueError):
            pass
        return cls(**kw)


class ClusterSimulator:
    def __init__(self, n_gpus: int, jobs: list[Job], policy,
                 *, costs: ScalingCosts | None = None, quantum: float = 30.0,
                 t_end: float = 10e6,
                 throughput_model: ThroughputModel | None = None):
        self.n_gpus = n_gpus
        self.throughput_model = throughput_model or AnalyticModel()
        self.jobs = {j.jid: j for j in jobs}
        self.policy = policy
        self.costs = costs or ScalingCosts()
        self.quantum = quantum
        self.t_end = t_end
        self.now = 0.0
        self.pending: list[Job] = []
        self.running: dict[int, Job] = {}
        self.finished: list[Job] = []
        self.events: list[tuple[float, int, str, int]] = []
        self._seq = 0
        self.utilization_log: list[tuple[float, int, float]] = []
        self._arrivals_left = len(jobs)
        # (dp, mp) shapes each job has already compiled for — a reshape
        # onto a seen shape is warm (no reshape_prep_s), mirroring the
        # live trainer's exec-handle cache
        self._shapes_seen: dict[int, set] = {j.jid: set() for j in jobs}
        for j in jobs:
            self._push(j.arrival, "arrival", j.jid)

    # ----------------------------------------------------------- event queue
    def _push(self, t: float, kind: str, jid: int = -1):
        self._seq += 1
        heapq.heappush(self.events, (t, self._seq, kind, jid))

    # ----------------------------------------------------------- mechanics
    def _advance_progress(self, dt: float):
        if dt <= 0:
            return
        for j in self.running.values():
            eff_dt = dt
            if j.frozen_until > self.now - dt:
                eff_dt = max(0.0, self.now - j.frozen_until)
            if j.alloc > 0 and eff_dt > 0:
                j.remaining -= \
                    self.throughput_model.throughput(j, j.alloc) * eff_dt
            # service is device-seconds: an mp=2 group burns 2 GPU·s per s
            j.attained_gpu_s += j.alloc * j.mp * dt
        used = sum(j.alloc * j.mp for j in self.running.values())
        eff = sum(self._job_eff(j) for j in self.running.values())
        self.utilization_log.append((self.now, used, eff))

    def _job_eff(self, j: Job) -> float:
        """Effective DEVICES delivering work (utilization log units)."""
        tm = self.throughput_model
        return j.alloc * j.mp * tm.efficiency(j, j.alloc) if j.alloc else 0.0

    def _apply_alloc(self, new_alloc: dict[int, int]):
        from repro_torch.sched.base import normalize_target
        for jid, target in new_alloc.items():
            j = self.jobs[jid]
            p, mp = normalize_target(j, target)
            old = j.alloc
            if p == old and mp == j.mp:
                continue
            if p == 0:          # preempted
                j.alloc = 0
                self.running.pop(jid, None)
                if j.remaining > 0 and j not in self.pending:
                    self.pending.append(j)
                continue
            # a reshape re-meshes the job: progress continues at the new
            # shape once the (stop-free-priced) switch window passes —
            # throughput queries read j.mp, so flipping it here is the
            # whole simulated state move
            reshaped = mp != j.mp
            seen = self._shapes_seen.setdefault(jid, set())
            cold = (p, mp) not in seen
            seen.add((p, mp))
            j.mp = mp
            if old == 0:
                self.pending = [x for x in self.pending if x.jid != jid]
                self.running[jid] = j
                if j.start_time is None:
                    j.start_time = self.now
                j.frozen_until = self.now + self.costs.context_prep_s \
                    if self.costs.mode == "stop_resume" else self.now
                # fresh placement always pays prep on the new GPUs; with EDL
                # there are no existing GPUs to keep running, so model it as
                # the job starting after a prep delay on either mode:
                j.frozen_until = self.now + min(self.costs.context_prep_s, 5.0)
            else:               # resize
                if self.costs.mode == "stop_resume":
                    j.frozen_until = self.now + self.costs.context_prep_s
                else:
                    # stop-free: the stop window — plus, for a re-mesh
                    # onto a shape this job never compiled, the measured
                    # cold context-prep (priced separately from the stop;
                    # revisited shapes ride the warm cache for free)
                    prep = (self.costs.reshape_prep_s
                            if reshaped and cold else 0.0)
                    j.frozen_until = self.now + prep + self.costs.edl_stop_s
            j.alloc = p
            self._schedule_completion(j)

    def _schedule_completion(self, j: Job):
        if j.alloc <= 0 or j.remaining <= 0:
            return
        lead = max(j.frozen_until - self.now, 0.0)
        t_done = self.now + lead + \
            j.remaining / self.throughput_model.throughput(j, j.alloc)
        self._push(t_done, "maybe_done", j.jid)

    # -------------------------------------------------------------- driver
    def run(self):
        last_t = 0.0
        self._tick_pending = False
        while self.events:
            t, _, kind, jid = heapq.heappop(self.events)
            if t > self.t_end:
                break
            self.now = t
            self._advance_progress(t - last_t)
            last_t = t
            if kind == "arrival":
                self.pending.append(self.jobs[jid])
                self._arrivals_left -= 1
            elif kind == "maybe_done":
                j = self.jobs[jid]
                if j.finish_time is not None or j.alloc <= 0:
                    continue        # stale wake-up
                if j.remaining <= 1e-6:
                    j.finish_time = self.now
                    j.alloc = 0
                    self.running.pop(jid, None)
                    self.finished.append(j)
                else:               # progress was slowed by a resize window
                    self._schedule_completion(j)
                    continue
            elif kind == "tick":
                self._tick_pending = False
            new_alloc = self.policy(self)
            if new_alloc:
                self._apply_alloc(new_alloc)
            # ticks drive re-scheduling (compaction/expansion/starvation);
            # with nothing pending and no arrivals ahead they are no-ops —
            # skipping them removes the O(makespan/quantum) idle-tail events
            if self.running and not self._tick_pending and \
                    (self.pending or self._arrivals_left):
                self._push(self.now + self.quantum, "tick")
                self._tick_pending = True
        return self.stats()

    # ------------------------------------------------------------- results
    def stats(self) -> dict:
        jcts = [j.finish_time - j.arrival for j in self.finished]
        jcts.sort()
        if not jcts:
            return {"finished": 0}
        import numpy as np
        return {
            "finished": len(jcts),
            "mean_jct": float(np.mean(jcts)),
            "median_jct": float(np.median(jcts)),
            "p95_jct": float(np.percentile(jcts, 95)),
            "makespan": max(j.finish_time for j in self.finished),
        }
