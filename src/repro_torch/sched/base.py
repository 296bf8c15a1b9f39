"""The ONE scheduling interface shared by the discrete-event simulator and
the live cluster executor (repro_torch.cluster.executor).

A *policy* is a callable ``policy(view) -> {jid: p}`` returning the target
allocation for every alive job. Allocations are counted in **device
groups** — one group is one data-parallel replica of the job, occupying
``mp = group_size(job)`` physical devices (the job's model-parallel
degree). For the common ``mp == 1`` tenant a group IS a device and the map
reads exactly as before; for an mp>1 tenant a target of ``p`` claims
``p * mp`` devices. Policies budget in devices, allocate in groups. The
``view`` is anything exposing:

  view.n_gpus   — cluster size in DEVICES (the budget policies spend)
  view.now      — monotonically increasing clock (seconds for the simulator,
                  scheduling rounds for the live executor — units only need
                  to be consistent with the policy's time parameters)
  view.running  — dict jid -> job (currently allocated jobs)
  view.pending  — list of jobs waiting for GPUs
  view.throughput_model
                — the repro_torch.sched.throughput.ThroughputModel answering
                  every t(p)/efficiency query (optional: views that omit it
                  get a shared AnalyticModel via ``throughput_model_of``)

and each job exposing: ``jid, model, requested_p, arrival, inelastic,
attained_gpu_s, alloc, start_time, finish_time`` — ``requested_p`` and
``alloc`` in groups (data-parallel replicas) — plus optionally ``mp``
(devices per group; absent means 1, see ``group_size``).
``attained_gpu_s`` stays in device-seconds: an mp=2 tenant consumes service
twice as fast as an mp=1 tenant at the same group count, which is exactly
how Tiresias should see it. ``model`` names an analytic profile the
ThroughputModel can use as prior; policies never query curves directly —
all throughput reasoning goes through the view's model (whose ``p``
argument is likewise in data-parallel replicas), so a live executor
scheduling from MEASURED curves and the simulator scheduling from analytic
ones run the identical policy code.

Both ``repro_torch.sched.simulator.Job`` and ``repro_torch.cluster.job.ClusterJob``
satisfy this, so Tiresias / Elastic-Tiresias / MaxThroughput / StaticPolicy
drive simulated ticks and real ElasticTrainers unchanged.

Allocation semantics: a target of 0 for a RUNNING job is a full preemption.
The live executor checkpoint-stops the job (all of its devices return to
the pool) and parks it; parked jobs re-appear in ``view.pending`` with
their attained service and original arrival intact, so policies treat them
as re-admittable demand exactly like never-started arrivals. Policies never
see a job whose checkpoint save is still in flight — its devices are not
reclaimable until the save lands.
"""
from __future__ import annotations

from repro_torch.sched.throughput import default_model


def group_size(job) -> int:
    """Devices per allocation grant: the job's model-parallel degree.
    Jobs that predate the device-group refactor (plain test stand-ins)
    simply have no ``mp`` attribute and allocate single devices."""
    return int(getattr(job, "mp", 1) or 1)


# the shapes an mp=auto tenant may be reshaped through; filtered per query
# by what the pool and the job's batch divisibility admit
AUTO_MP_OPTIONS = (1, 2, 4)


def mp_options(job) -> tuple[int, ...]:
    """The model-parallel degrees a policy may target for this job: the
    auto ladder for mp=auto tenants, the pinned degree for everyone else."""
    if getattr(job, "mp_auto", False):
        opts = {group_size(job), *AUTO_MP_OPTIONS}
        return tuple(sorted(opts))
    return (group_size(job),)


def requested_devices(job) -> int:
    """The job's requested footprint in DEVICES — shape-invariant: quoted
    at the submitted degree even after a reshape changed the live one."""
    mp = int(getattr(job, "requested_mp", 0) or group_size(job))
    return job.requested_p * mp


def normalize_target(job, target) -> tuple[int, int]:
    """One policy-target format for the executors: ``(groups, mp)``.
    Plain integer targets (every pre-reshape policy) keep the job's
    current degree; reshape-aware policies emit explicit tuples."""
    if isinstance(target, tuple):
        return int(target[0]), max(1, int(target[1]))
    return int(target), group_size(job)


def best_shape(tm, job, devices: int, *,
               options: tuple[int, ...] | None = None) -> tuple[int, int]:
    """The highest-throughput ``(groups, mp)`` factorization of a device
    budget, per the view's ThroughputModel — the ONE place reshape-aware
    policies turn a device count into a shape. Ties (and everything
    within half a percent) go to the LOWER mp: plain data parallelism is
    operationally simpler and keeps rigid-prior behavior for jobs whose
    shapes price identically. Group counts must divide the job's global
    batch (``job.feasible_p`` when the job has one). Returns ``(0, min
    option)`` when not even one group fits ``devices``."""
    feasible = getattr(job, "feasible_p", lambda p: p)
    opts = options if options is not None else mp_options(job)
    best = None             # (throughput, mp, p)
    for mp in sorted(opts):
        p = feasible(devices // mp)
        if p < 1:
            continue
        thr = tm.throughput(job, p, mp)
        if best is None or thr > best[0] * 1.005:
            best = (thr, mp, p)
    if best is None:
        return 0, min(opts)
    return best[2], best[1]


def likely_next_shapes(policy, view, job, *, limit: int = 3
                       ) -> list[tuple[int, int]]:
    """The speculative-prefetch hook: the ``(groups, mp)`` shapes this
    policy is LIKELY to target next for ``job`` — what the executor's
    compile service warms on idle host threads so a later committed
    resize/RESHAPE finds its executable already built.

    Policies that know their own moves expose ``likely_shapes(view, job)``
    (Tiresias: the ±1-group compaction/expansion targets and the QoS
    floor; MaxThroughput: the water-filling neighbors — plus, for mp=auto
    tenants, the ``best_shape`` re-factorizations of those budgets).
    Policies without the hook get a generic neighborhood: ±1 group at the
    live degree, and the best shape of the current device budget at the
    other mp options. Predictions are free to be wrong — a prefetch that
    never commits only cost idle host time, and a re-plan cancels shapes
    that leave this set before they compile.

    Returns feasible, deduplicated shapes, current shape excluded,
    capped at ``limit``."""
    hook = getattr(policy, "likely_shapes", None)
    shapes = list(hook(view, job)) if hook is not None \
        else _default_likely_shapes(view, job)
    feasible = getattr(job, "feasible_p", lambda p: p)
    cur = (job.alloc, group_size(job))
    out: list[tuple[int, int]] = []
    for p, mp in shapes:
        p, mp = int(p), max(1, int(mp))
        p = min(p, view.n_gpus // mp) if mp <= view.n_gpus else 0
        p = feasible(p)
        if p >= 1 and (p, mp) != cur and (p, mp) not in out:
            out.append((p, mp))
        if len(out) >= limit:
            break
    return out


def _default_likely_shapes(view, job) -> list[tuple[int, int]]:
    """Generic neighborhood for policies without a ``likely_shapes``
    hook: the ±1-group resizes every elastic policy actually emits, and
    (for mp=auto tenants) the re-factorizations of the current budget."""
    gs = group_size(job)
    shapes = [(job.alloc + 1, gs), (job.alloc - 1, gs)]
    if getattr(job, "mp_auto", False):
        tm = throughput_model_of(view)
        budget = max(job.alloc, 1) * gs
        for opt in mp_options(job):
            if opt != gs:
                shapes.append(best_shape(tm, job, budget, options=(opt,)))
    return shapes


def throughput_model_of(view):
    """The ThroughputModel the view's owner schedules with. Views that
    predate the seam (plain stand-ins in tests) fall back to the shared
    default AnalyticModel — the pre-refactor behavior."""
    model = getattr(view, "throughput_model", None)
    return model if model is not None else default_model()


def alive_jobs(view) -> list:
    """All jobs still needing service, running first then pending."""
    return [j for j in list(view.running.values()) + list(view.pending)
            if j.finish_time is None]


def tier_of(job) -> str:
    """"serving" for serving tenants, "training" for everything else
    (including plain test stand-ins that predate tiers)."""
    return str(getattr(job, "tier", "training"))


def serving_demand(job, now) -> int:
    """A serving tenant's instantaneous replica demand: its trace-driven
    ``desired_p`` when it has one, else its requested floor."""
    desired = getattr(job, "desired_p", None)
    return int(desired(now)) if callable(desired) else int(job.requested_p)


def reserve_serving(view, alloc: dict, *, headroom: int = 0) -> tuple:
    """The reclaim-priority rule, shared by every serving-aware policy:
    serving tenants are latency-bound, so their CURRENT trace demand is
    funded before any training job sees the budget. On a demand spike
    this is what evaporates training loans first — the training policy
    runs on a smaller budget, its water level drops, and the executor's
    shrink-before-grow action ordering turns the difference into
    stop-free loan reclaims that fund the serving grants (checkpoint-park
    only when even the floors no longer fit). On a lull the demand
    shrinks instead, and the budget left over becomes training loans.

    Mutates ``alloc`` with the serving targets (arrival order, partial
    grants when the pool is short, ``headroom`` extra groups per tenant
    when affordable) and returns ``(training_jobs, remaining_devices)``
    for the training-side pass."""
    budget = view.n_gpus
    training = []
    for j in sorted(alive_jobs(view), key=lambda j: (j.arrival, j.jid)):
        if tier_of(j) != "serving":
            training.append(j)
            continue
        gs = group_size(j)
        want = serving_demand(j, view.now) + headroom
        take = max(0, min(want, budget // gs))
        feasible = getattr(j, "feasible_p", None)
        if feasible is not None:
            take = feasible(take)
        alloc[j.jid] = take
        budget -= take * gs
    return training, budget


class StaticPolicy:
    """Non-elastic baseline: FIFO admission at exactly ``requested_p``
    groups; running jobs are never resized (EDL §4.3's static-allocation
    strawman at the cluster level). An mp>1 job is admitted only when
    ``requested_p * mp`` devices are free."""

    def __call__(self, view) -> dict[int, int]:
        alloc: dict[int, int] = {}
        free = view.n_gpus
        for j in sorted(alive_jobs(view), key=lambda j: j.arrival):
            if j.alloc > 0:                 # keep whatever it has
                alloc[j.jid] = j.alloc
                free -= j.alloc * group_size(j)
        for j in sorted(alive_jobs(view), key=lambda j: j.arrival):
            if j.alloc == 0:
                need = j.requested_p * group_size(j)
                take = j.requested_p if free >= need else 0
                alloc[j.jid] = take
                free -= take * group_size(j)
        return alloc


class MaxThroughput:
    """Throughput-maximizing allocator (water-filling over marginal gains).

    Admission floor first — alive jobs in arrival order get 1 group each
    (inelastic jobs: exactly ``requested_p`` groups or nothing) — then the
    remaining device budget goes, one group at a time, to the elastic job
    with the largest marginal throughput gain **per device**, while that
    gain exceeds ``min_gain`` samples/s/device. Dividing the marginal gain
    by ``group_size(job)`` is what packs mixed-mp tenants correctly: an
    mp=2 tenant's extra replica must beat TWO single-device grants to
    mp=1 competitors before it wins the budget, and a tenant whose group
    no longer fits in the leftover devices simply drops out of the
    water-filling round.
    Alive includes preempted-and-parked jobs (they sit in ``view.pending``),
    so a checkpointed tenant re-enters through the same admission floor as
    a fresh arrival; a floor that no longer fits emits 0 — a real
    checkpoint-stop preemption on the live executor.

    Grants above a job's requested parallelism are transient-resource
    loans: the next rebalance reclaims them automatically as soon as a
    newly arrived job's floor (or a better marginal use) needs the GPUs.

    Marginal gains come from ``view.throughput_model``: on a live executor
    running a MeasuredModel, the water level reflects each job's MEASURED
    scaling curve — a tenant whose real curve knees earlier than its
    analytic prior loses the marginal GPU to a better scaler.

    mp=auto tenants get a final SHAPE pass: whatever device budget the
    water-filling left them is re-factorized into the highest-throughput
    ``(groups, mp)`` via ``best_shape`` — emitted as a tuple target, which
    the live executor turns into a RESHAPE verb (and the simulator into a
    re-mesh). A comm-bound tenant squeezed to half its devices under pool
    pressure typically compacts onto a denser model-parallel shape; when
    the budget comes back, the same pass expands it back to plain data
    parallelism.

    Works on the simulator and the live executor alike (sched.base view
    interface).
    """

    def __init__(self, *, min_gain: float = 0.0, max_per_job: int | None = None):
        self.min_gain = min_gain
        self.max_per_job = max_per_job      # cap in groups per job

    def likely_shapes(self, view, job) -> list[tuple[int, int]]:
        """Prefetch hook (likely_next_shapes): water-filling moves one
        group at a time, so the ±1-group neighbors are exactly the next
        reachable targets — plus their best re-factorizations for
        mp=auto tenants (the reshape_targets pass runs on every call)."""
        gs = group_size(job)
        shapes = [(job.alloc + 1, gs), (job.alloc - 1, gs)]
        if getattr(job, "mp_auto", False):
            tm = throughput_model_of(view)
            for budget in ((job.alloc + 1) * gs, max(1, job.alloc - 1) * gs):
                shapes.append(best_shape(tm, job, budget))
        return shapes

    def __call__(self, view) -> dict[int, int]:
        tm = throughput_model_of(view)
        alloc: dict[int, int] = {}
        # serving tier first (reclaim priority): trace demand is funded
        # off the top; training floors + water-filling spend the rest —
        # so a spike drains the water level (loans) before any floor
        jobs, free = reserve_serving(view, alloc)
        jobs.sort(key=lambda j: (j.arrival, j.jid))
        for j in jobs:
            groups = j.requested_p if j.inelastic else 1
            need = groups * group_size(j)
            take = groups if free >= need else 0
            alloc[j.jid] = take
            free -= take * group_size(j)
        cap = self.max_per_job or view.n_gpus
        while free > 0:
            best, best_gain = None, self.min_gain
            for j in jobs:
                p, mp = alloc[j.jid], group_size(j)
                if p == 0 or p >= cap or j.inelastic or mp > free:
                    continue
                gain = (tm.throughput(j, p + 1) - tm.throughput(j, p)) / mp
                if gain > best_gain:
                    best, best_gain = j, gain
            if best is None:
                break
            alloc[best.jid] += 1
            free -= group_size(best)
        return reshape_targets(tm, jobs, alloc)


def reshape_targets(tm, jobs, alloc: dict) -> dict:
    """The mp re-target pass shared by the reshape-aware policies: each
    mp=auto job's allocated DEVICE budget is re-factorized into its
    best ``(groups, mp)`` shape. Targets whose shape differs from the
    job's live one become tuples — ``normalize_target`` on the executor
    side reads either form; rigid (and inelastic) jobs pass through
    untouched, so a policy over a reshape-free workload emits exactly
    what it always did."""
    for j in jobs:
        target = alloc.get(j.jid, 0)
        if (not getattr(j, "mp_auto", False) or j.inelastic
                or isinstance(target, tuple) or target <= 0):
            continue
        budget = target * group_size(j)
        p2, mp2 = best_shape(tm, j, budget)
        if p2 >= 1 and (p2, mp2) != (target, group_size(j)):
            alloc[j.jid] = (p2, mp2)
    return alloc
