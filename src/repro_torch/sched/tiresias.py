"""Tiresias (Gu et al., NSDI'19) and Elastic-Tiresias (EDL §5.1).

Tiresias: discretized two-dimensional attained service (priority groups
G0..Gk with service quanta); shortest-job-first-like, preemptive, starvation
guard. Jobs run at their requested parallelism or wait. A running job that
loses its GPUs to a higher-priority arrival gets a 0 target — on the live
executor that is a real checkpoint-stop preemption (demotion to the queue),
not a clamp; the parked job keeps its attained service and is re-admitted
from the saved state once it wins GPUs again.

Allocations are in device GROUPS (sched.base: one group = one
data-parallel replica = ``group_size(job)`` devices), budgets in devices:
admitting an mp=2 tenant at ``requested_p`` groups spends ``2 *
requested_p`` devices, compaction frees ``mp`` devices per group removed
from a donor, and expansion grants a group only while it still fits the
idle-device budget. ``attained_gpu_s`` is device-seconds, so an mp=2
tenant burns through its quanta twice as fast as an mp=1 tenant at equal
group count — big tenants demote sooner, exactly as Tiresias intends.

Elastic-Tiresias adds two rules:
  R1 Compaction — when > N jobs wait, scale running jobs in (never below
     ceil(r * requested_p) groups, never jobs in G0) to free GPUs for the
     head of the queue, choosing removals that maximize the GPU-efficiency
     gain.
  R2 Expansion — when GPUs idle and nothing waits, greedily give +1 group
     to the job with the largest marginal throughput gain per device,
     while positive.

Live reparallelization extends the elastic variant for mp=AUTO tenants
(jobs that do not pin their model-parallel degree): a tenant whose full
request no longer fits is admitted at the best (groups, mp) shape of the
devices that ARE free instead of being fully preempted (pool-shape-driven
repacking), and a final pass re-factorizes every auto tenant's device
budget through ``sched.base.best_shape`` — emitting ``(groups, mp)``
tuple targets the executor turns into RESHAPE verbs. Comm-bound tenants
compact onto denser model-parallel meshes under pressure and expand back
to plain data parallelism when the budget returns.

Policies take a *view* (repro_torch.sched.base): the discrete-event simulator and
the live multi-tenant executor expose the same interface, so the identical
policy object drives simulated ticks or real ElasticTrainer scaling calls.
R1's efficiency gains and R2's marginal throughput gains are answered by
``view.throughput_model`` — analytic curves on the simulator, live measured
curves on an executor running a MeasuredModel.
"""
from __future__ import annotations

import math

from repro_torch.sched.base import best_shape, group_size, requested_devices, \
    reserve_serving, reshape_targets, throughput_model_of


class Tiresias:
    def __init__(self, quanta=(500.0, 10_000.0), starvation_s: float = 3600.0,
                 elastic: bool = False, N: int = 10, r: float = 0.5):
        self.quanta = quanta
        self.starvation_s = starvation_s
        self.elastic = elastic
        self.N = N
        self.r = r

    # ------------------------------------------------------------ priority
    def group_of(self, job) -> int:
        for g, q in enumerate(self.quanta):
            if job.attained_gpu_s < q:
                return g
        return len(self.quanta)

    def _priority_key(self, view, job):
        # the guard covers every job currently WITHOUT GPUs: never-started
        # arrivals and preempted-parked jobs alike — a demoted job evicted
        # by a stream of fresh G0 arrivals must eventually be promoted, or
        # full preemption would let it starve on disk forever
        starved = (job.alloc == 0 and
                   view.now - job.arrival > self.starvation_s)
        return (0 if starved else self.group_of(job), job.arrival)

    # ------------------------------------------------------------ schedule
    def __call__(self, view) -> dict[int, int]:
        alloc: dict[int, int] = {}
        # serving tenants outrank every priority group: their trace
        # demand is latency-bound, not service-accounted, so it comes off
        # the top (sched.base.reserve_serving — the reclaim-priority
        # rule) and Tiresias runs its G0..Gk machinery on the remainder
        jobs, free = reserve_serving(view, alloc)
        jobs.sort(key=lambda j: self._priority_key(view, j))
        tm = throughput_model_of(view) if self.elastic else None
        waiting = []
        for j in jobs:
            # requested footprint is quoted in DEVICES at the SUBMITTED
            # shape (shape-invariant): live-mp groups of a reshaped auto
            # tenant could over- OR under-state the request (a 1-device
            # job parked at mp=4 must not claim a whole 4-device group)
            gs = group_size(j)
            req_mp = int(getattr(j, "requested_mp", 0) or gs)
            need = requested_devices(j)
            if free >= need:
                # a tenant whose live shape drifted from the submitted one
                # gets an explicit-shape target back toward it (the shape
                # pass may re-factorize); everyone else keeps plain groups
                alloc[j.jid] = (j.requested_p if req_mp == gs
                                else (j.requested_p, req_mp))
                free -= need
                continue
            if tm is not None and getattr(j, "mp_auto", False) \
                    and not j.inelastic and free > 0:
                # pool-shape-driven repacking (elastic only): an mp=auto
                # job whose full request no longer fits is admitted at
                # the best shape of the devices that ARE free — a running
                # 4 x mp=1 tenant squeezed by a fresh arrival compacts
                # onto e.g. (1, mp=2) instead of being fully preempted
                p2, mp2 = best_shape(tm, j, min(free, need))
                if p2 >= 1:
                    alloc[j.jid] = (p2, mp2)
                    free -= p2 * mp2
                    continue
            alloc[j.jid] = 0
            waiting.append(j)

        if self.elastic:
            alloc, free = self._compact(tm, jobs, alloc, free, waiting)
            alloc = self._expand(tm, jobs, alloc, free, waiting)
            # mp re-targets (R3, the RESHAPE rule): each mp=auto job's
            # final device budget is re-factorized into its best shape —
            # compaction squeezes comm-bound tenants onto denser
            # model-parallel meshes, expansion returns them to plain data
            # parallelism when the budget comes back
            alloc = reshape_targets(tm, jobs, alloc)
        return alloc

    # -------------------------------------------------------- speculation
    def likely_shapes(self, view, job) -> list[tuple[int, int]]:
        """The shapes this policy's own rules actually emit for ``job`` —
        the compile-prefetch hook (sched.base.likely_next_shapes). In
        emission order (most likely first): R2 expansion (+1 group at the
        live degree), R1 compaction (down toward the QoS floor, one group
        at a time — the next compaction step, then the floor itself), the
        submitted shape (re-admission / drift-correction target), and for
        mp=auto elastic tenants the best re-factorizations of those
        budgets (the R3 reshape pass)."""
        gs = group_size(job)
        floor = max(1, math.ceil(self.r * requested_devices(job) / gs))
        shapes = [(job.alloc + 1, gs), (job.alloc - 1, gs), (floor, gs)]
        req_mp = int(getattr(job, "requested_mp", 0) or gs)
        shapes.append((job.requested_p, req_mp))
        if self.elastic and getattr(job, "mp_auto", False):
            tm = throughput_model_of(view)
            for budget in ((job.alloc + 1) * gs, max(1, job.alloc - 1) * gs):
                shapes.append(best_shape(tm, job, budget))
        return shapes

    # ---------------------------------------------------------------- R1
    def _compact(self, tm, jobs, alloc, free, waiting):
        if len(waiting) <= self.N:
            return alloc, free
        for pending in list(waiting):
            need = requested_devices(pending)                  # in devices
            # scan running jobs (lowest priority first), shrink until the
            # pending job fits; respect G0-protection and the QoS floor.
            donors = sorted(
                (j for j in jobs
                 if isinstance(alloc.get(j.jid, 0), int)
                 and alloc.get(j.jid, 0) > 0
                 and not j.inelastic and self.group_of(j) > 0),
                key=lambda j: -self.group_of(j))
            for d in donors:
                # QoS floor in live-shape groups (device-denominated, so a
                # reshaped donor's floor tracks its submitted footprint)
                floor = max(1, math.ceil(
                    self.r * requested_devices(d) / group_size(d)))
                while alloc[d.jid] > floor and free < need:
                    # remove the group whose removal gains the most
                    # efficiency (one group = group_size(d) devices)
                    p = alloc[d.jid]
                    gain = tm.efficiency(d, p - 1) - tm.efficiency(d, p)
                    if gain < 0 and free > 0:
                        break   # shrinking would hurt; try next donor
                    alloc[d.jid] -= 1
                    free += group_size(d)
                if free >= need:
                    break
            if free >= need:
                # admit at the SUBMITTED shape (explicit tuple when the
                # parked shape drifted) so exactly ``need`` devices are
                # spent — live-mp group rounding could oversubscribe
                gs_p = group_size(pending)
                req_mp = int(getattr(pending, "requested_mp", 0) or gs_p)
                alloc[pending.jid] = (
                    pending.requested_p if req_mp == gs_p
                    else (pending.requested_p, req_mp))
                free -= need
                waiting.remove(pending)
        return alloc, free

    # ---------------------------------------------------------------- R2
    def _expand(self, tm, jobs, alloc, free, waiting):
        if waiting:
            return alloc
        while free > 0:
            best, best_gain = None, 0.0
            for j in jobs:
                p, mp = alloc.get(j.jid, 0), group_size(j)
                # jobs already holding a squeezed-shape tuple target sit
                # this round out; the shape pass re-factorizes them later
                if not isinstance(p, int) or p == 0 \
                        or j.inelastic or mp > free:
                    continue
                s_p = tm.throughput(j, p)
                # relative gain per DEVICE: an mp=2 group must out-gain two
                # single-device grants before it wins the idle budget
                gain = (tm.throughput(j, p + 1) - s_p) / s_p / mp
                if gain > best_gain:
                    best, best_gain = j, gain
            if best is None:
                break
            alloc[best.jid] += 1
            free -= group_size(best)
        return alloc


def ElasticTiresias(**kw) -> Tiresias:
    return Tiresias(elastic=True, **kw)
