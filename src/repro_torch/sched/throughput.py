"""Pluggable throughput models t(p) — the ONE seam every scheduling layer
queries for "how fast does this job run at parallelism p?".

``p`` is ALWAYS counted in data-parallel replicas (device groups), never
raw devices: an mp=2 tenant at p=2 runs 2 replicas on 4 devices, and both
its analytic prior and its measured curve are functions of the replica
count — which is what the live trainer's ``trainer.p`` reports and what
``observe``/``ingest`` feed back. Policies that need the device cost of a
replica multiply by ``sched.base.group_size(job)`` themselves; the model
stays blind to packing.

Policies (MaxThroughput water-filling, Elastic-Tiresias marginal gain), the
discrete-event simulator, and workload generators all consume a
``ThroughputModel`` instead of hard-coded curves:

  * ``AnalyticModel`` — the paper's Fig-1 shape: throughput grows
    sublinearly with p (ring-allreduce communication), per-GPU efficiency
    decays, and large models (VGG) even lose absolute throughput past a
    knee.  Profiles approximate tf_cnn_benchmarks models (the paper's
    workload pool):

        step_time(p)  = t_compute + 2 (p-1)/p * model_bytes / bw + c_lat p
        throughput(p) = p * per_gpu_batch / step_time(p)

  * ``MeasuredModel`` — EDL §5.2 made real: a per-job profile store fed by
    FREE observations (every live mini-batch's measured step time at the
    job's current parallelism) blended with ``core.profiling.profile()``
    scale-in sweep data, falling back to a scale-calibrated analytic prior
    for parallelisms nobody has visited yet.  A job whose measured curve
    knees earlier than its analytic prior really loses GPUs to a better
    scaler.

Views (simulator / live executor) expose the model as
``view.throughput_model``; policies reach it through
``repro_torch.sched.base.throughput_model_of(view)`` and never import the curves
directly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    t_compute: float        # s per per-GPU batch (forward+backward)
    model_gb: float         # parameter bytes in GB
    per_gpu_batch: int
    bw_gbps: float = 12.0   # effective allreduce bandwidth GB/s
    latency_s: float = 0.002
    # model-parallel split tax: fraction of the (already mp-way-divided)
    # compute lost to intra-layer collectives per extra model shard. Big
    # comm-bound models (vgg*) come out ahead at mp>1 on the same device
    # count — their gradient allreduce shrinks by 1/mp — while small
    # compute-bound models (googlenet, alexnet) prefer plain data
    # parallelism; that asymmetry is what makes RESHAPE decisions real.
    mp_overhead: float = 0.15


PROFILES: dict[str, ModelProfile] = {p.name: p for p in [
    ModelProfile("alexnet", 0.020, 0.24, 512),
    ModelProfile("vgg16", 0.180, 0.55, 64),
    ModelProfile("vgg19", 0.210, 0.57, 64),
    ModelProfile("resnet50", 0.120, 0.10, 64),
    ModelProfile("resnet101", 0.200, 0.17, 64),
    ModelProfile("resnet152", 0.280, 0.23, 64),
    ModelProfile("inception3", 0.160, 0.10, 64),
    ModelProfile("inception4", 0.300, 0.17, 64),
    ModelProfile("googlenet", 0.060, 0.03, 128),
]}


def _profile_name(job) -> str:
    """Accept either a job object (``.model`` names its analytic profile)
    or a bare profile-name string (workload generators, tests)."""
    return job if isinstance(job, str) else job.model


def _mp_of(job, mp: int | None) -> int:
    """Resolve the model-parallel degree of a query: an explicit ``mp``
    wins (policies probing alternative shapes); otherwise the job's own
    degree (bare profile-name strings and plain jobs are mp=1)."""
    if mp is not None:
        return max(1, int(mp))
    return max(1, int(getattr(job, "mp", 1) or 1))


class ThroughputModel:
    """The t(p, mp) interface every scheduling layer queries.

    ``job`` is a scheduling-view job object (``.model`` names an analytic
    profile; ``.jid``, when present, keys per-job measured curves) or a
    bare profile-name string.

    Every query takes an optional ``mp`` — the model-parallel degree of
    the shape being asked about. Omitted, it defaults to the JOB'S OWN
    degree (1 for strings and plain jobs), so pre-reshape callers read the
    same numbers as before; reshape-aware policies pass ``mp`` explicitly
    to price alternative ``(p, mp)`` factorizations of a device budget.

      throughput(job, p, mp)  — samples/s at p replicas of mp devices
                                (0.0 at p <= 0)
      step_time(job, p, mp)   — seconds per mini-batch at that shape
      efficiency(job, p, mp)  — per-replica throughput at p, normalized by
                                the best per-replica point of the SAME-mp
                                curve (the paper's GPU-efficiency metric)
      observe(job, p, t, mp=) — feed back one measured step time (free
                                observation from a live mini-batch); a
                                no-op on models that do not learn

    Models that can additionally bulk-load ``core.profiling.profile()``
    sweep results define ``ingest(job, table)`` — its *absence* is how the
    executor knows sweeping would be wasted on this model.
    """

    max_p: int = 64

    def throughput(self, job, p: int, mp: int | None = None) -> float:
        raise NotImplementedError

    def step_time(self, job, p: int, mp: int | None = None) -> float:
        raise NotImplementedError

    def efficiency(self, job, p: int, mp: int | None = None) -> float:
        mp = _mp_of(job, mp)
        best = max(self.throughput(job, q, mp) / q
                   for q in range(1, self.max_p + 1))
        return (self.throughput(job, p, mp) / p) / best

    def observe(self, job, p: int, step_time: float, *,
                samples: int | None = None, mp: int | None = None) -> None:
        pass


class AnalyticModel(ThroughputModel):
    """The static analytic curves (paper Fig 1), stateless per job: every
    job with the same profile name shares one curve.  ``best_per_gpu`` is
    memoized per instance — safe because analytic curves never change
    (unlike the measured model, where a module-global name-keyed cache
    would go stale the moment an observation lands)."""

    def __init__(self, profiles: dict[str, ModelProfile] | None = None,
                 *, max_p: int = 64):
        self.profiles = dict(profiles) if profiles is not None else PROFILES
        self.max_p = max_p
        self._best: dict[object, float] = {}

    def step_time(self, job, p: int, mp: int | None = None) -> float:
        m = self.profiles[_profile_name(job)]
        mp = _mp_of(job, mp)
        if mp == 1:
            # the pre-reshape formula, op for op — the golden simulator
            # regressions pin these floats bit-for-bit
            # (1 + p/16): ring contention / cross-machine hop penalty —
            # gives the paper's Fig-1 VGG knee (stops scaling past ~8)
            comm = (2.0 * (p - 1) / p * m.model_gb / m.bw_gbps
                    * (1.0 + p / 16.0) + m.latency_s * p)
            return m.t_compute + (comm if p > 1 else 0.0)
        # mp-way model split: compute and gradient-allreduce bytes both
        # divide by mp, taxed by the intra-layer collective overhead plus
        # one latency hop per model shard
        compute = m.t_compute / mp * (1.0 + m.mp_overhead * (mp - 1))
        comm = (2.0 * (p - 1) / p * (m.model_gb / mp) / m.bw_gbps
                * (1.0 + p / 16.0) + m.latency_s * p) if p > 1 else 0.0
        return compute + comm + m.latency_s * mp

    def throughput(self, job, p: int, mp: int | None = None) -> float:
        """samples/s at p replicas (weak scaling: per-replica batch
        constant — an mp=2 replica steps the same batch as an mp=1 one,
        just faster/slower per ``step_time``)."""
        if p <= 0:
            return 0.0
        m = self.profiles[_profile_name(job)]
        return p * m.per_gpu_batch / self.step_time(job, p, mp)

    def best_per_gpu(self, job, mp: int | None = None) -> float:
        name, mp = _profile_name(job), _mp_of(job, mp)
        key = name if mp == 1 else (name, mp)
        if key not in self._best:
            self._best[key] = max(self.throughput(name, p, mp) / p
                                  for p in range(1, self.max_p + 1))
        return self._best[key]

    def efficiency(self, job, p: int, mp: int | None = None) -> float:
        """The paper's GPU efficiency: t(p)/p over the best per-GPU t,
        within the same-mp curve."""
        mp = _mp_of(job, mp)
        return (self.throughput(job, p, mp) / p) / self.best_per_gpu(job, mp)


class MeasuredModel(ThroughputModel):
    """Per-job measured t(p) curves with an analytic prior fallback.

    The store keys on ``job.jid`` when present (two tenants running the
    same architecture can scale differently — stragglers, data skew), else
    on the profile name.  Two data sources blend into one curve per job:

      * free observations — ``observe(job, p, step_time)`` from every live
        mini-batch, EMA-smoothed per parallelism;
      * sweep data — ``ingest(job, table)`` bulk-loads a
        ``core.profiling.ProfileTable`` from a scale-in sweep, entering the
        same EMA stream (a sweep seeds points free observations then
        refine).

    Queries at a visited p return the blended measurement.  Unvisited p
    falls back to the analytic prior *rescaled* by the mean measured/prior
    ratio over visited points, so a marginal-gain comparison between a
    measured point and a predicted one stays in one unit system; with no
    observations at all the model IS its prior.

    Curves are kept PER SHAPE: observations at ``(p, mp)`` land in the
    job's mp-specific curve (a reshaped job re-learns its new shape
    instead of polluting the old one). A query at an unvisited mp borrows
    the calibration ratio measured at the job's other shapes — the
    measured/prior scale of a tenant transfers across shapes even though
    the curve itself does not.
    """

    def __init__(self, prior: ThroughputModel | None = None, *,
                 ema: float = 0.3, max_p: int = 64):
        self.prior = prior if prior is not None else AnalyticModel()
        self.ema = ema
        self.max_p = max_p
        self._curves: dict[object, dict[int, float]] = {}  # (key,mp)->p->thr
        self._counts: dict[object, dict[int, int]] = {}
        self._versions: dict[object, int] = {}      # base key -> total obs
        # per-key memos, invalidated by observation count ("version"): a
        # name-keyed module cache would go stale, but within one version
        # the curve cannot have changed
        self._calib: dict[object, tuple[int, float]] = {}
        self._best: dict[object, tuple[int, float]] = {}

    # ------------------------------------------------------------- store
    def _base_key(self, job):
        jid = getattr(job, "jid", None)
        return _profile_name(job) if jid is None else (jid,
                                                       _profile_name(job))

    def _key(self, job, mp: int | None = None):
        return (self._base_key(job), _mp_of(job, mp))

    def _batch_of(self, job, p: int) -> float:
        """Samples per step: the live job's constant global batch when
        known, else the prior's weak-scaling per-GPU batch at p."""
        batch = getattr(getattr(job, "spec", None), "global_batch", None)
        if batch is None:
            name = _profile_name(job)
            per_gpu = (self.prior.profiles[name].per_gpu_batch
                       if hasattr(self.prior, "profiles") else 1)
            batch = p * per_gpu
        return float(batch)

    def _record(self, job, p: int, thr: float, mp: int | None = None):
        if p <= 0 or thr <= 0:
            return
        key = self._key(job, mp)
        curve = self._curves.setdefault(key, {})
        counts = self._counts.setdefault(key, {})
        old = curve.get(p)
        curve[p] = thr if old is None else \
            (1.0 - self.ema) * old + self.ema * thr
        counts[p] = counts.get(p, 0) + 1
        self._versions[key[0]] = self._versions.get(key[0], 0) + 1

    def observe(self, job, p: int, step_time: float, *,
                samples: int | None = None, mp: int | None = None) -> None:
        if p <= 0 or not step_time or step_time <= 0:
            return
        n = float(samples) if samples is not None else self._batch_of(job, p)
        self._record(job, p, n / step_time, mp)

    def ingest(self, job, table, *, mp: int | None = None) -> None:
        """Bulk-load a ``core.profiling.ProfileTable`` sweep result (a
        re-sweep of an already-ingested job enters the same EMA stream —
        stale curves re-blend toward the fresh measurements)."""
        for p, point in table.items():
            self._record(job, p, point.throughput, mp)

    def n_observations(self, job, mp: int | None = None) -> dict[int, int]:
        return dict(self._counts.get(self._key(job, mp), {}))

    def curve(self, job, mp: int | None = None) -> dict[int, float]:
        """The raw measured samples/s per visited parallelism (a copy)."""
        return dict(self._curves.get(self._key(job, mp), {}))

    # ------------------------------------------------------------ queries
    def _version(self, key) -> int:
        """Observation count across ALL of the job's shapes (maintained
        incrementally — memo checks sit inside policy inner loops): a
        cross-shape-borrowed calibration must refresh when any shape
        learns something new."""
        return self._versions.get(key[0], 0)

    def _ratios(self, job, key) -> list[float]:
        mp = key[1]
        return [thr / prior
                for p, thr in self._curves.get(key, {}).items()
                if (prior := self.prior.throughput(job, p, mp)) > 0]

    def _calibration(self, job, key) -> float:
        version = self._version(key)
        hit = self._calib.get(key)
        if hit is not None and hit[0] == version:
            return hit[1]
        ratios = self._ratios(job, key)
        if not ratios:
            # nothing measured at THIS shape yet: borrow the measured/prior
            # scale from the job's other shapes (a tenant 2x slower than
            # its prior at mp=1 is a better guess than the raw prior when
            # pricing its first mp=2 target)
            base = key[0]
            for other in self._curves:
                if other[0] == base and other != key:
                    ratios.extend(self._ratios(job, other))
        c = sum(ratios) / len(ratios) if ratios else 1.0
        self._calib[key] = (version, c)
        return c

    def throughput(self, job, p: int, mp: int | None = None) -> float:
        if p <= 0:
            return 0.0
        key = self._key(job, mp)
        curve = self._curves.get(key)
        if curve and p in curve:
            return curve[p]
        base = key[0]
        if not curve and not any(k[0] == base for k in self._curves):
            return self.prior.throughput(job, p, key[1])
        return self._calibration(job, key) * \
            self.prior.throughput(job, p, key[1])

    def efficiency(self, job, p: int, mp: int | None = None) -> float:
        """Per-GPU throughput at p over the best per-GPU point of the
        blended same-mp curve; the O(max_p) best scan is memoized per
        curve version so Tiresias's per-GPU inner loops stay cheap."""
        key = self._key(job, mp)
        version = self._version(key)
        hit = self._best.get(key)
        if hit is not None and hit[0] == version:
            best = hit[1]
        else:
            best = max(self.throughput(job, q, key[1]) / q
                       for q in range(1, self.max_p + 1))
            self._best[key] = (version, best)
        return (self.throughput(job, p, key[1]) / p) / best

    def step_time(self, job, p: int, mp: int | None = None) -> float:
        thr = self.throughput(job, p, mp)
        return self._batch_of(job, p) / thr if thr > 0 else float("inf")


_DEFAULT_ANALYTIC = AnalyticModel()


def default_model() -> AnalyticModel:
    """The ONE process-wide AnalyticModel used wherever no model is
    supplied (views predating the seam, workload sizing, the module-level
    convenience functions) — shared so its best-per-GPU memo stays warm."""
    return _DEFAULT_ANALYTIC


def step_time(name: str, p: int) -> float:
    """Analytic step time (module-level convenience; scheduling code goes
    through the view's ThroughputModel instead)."""
    return _DEFAULT_ANALYTIC.step_time(name, p)


def throughput(name: str, p: int) -> float:
    """Analytic samples/s (module-level convenience)."""
    return _DEFAULT_ANALYTIC.throughput(name, p)


def efficiency(name: str, p: int) -> float:
    """Analytic GPU efficiency (module-level convenience)."""
    return _DEFAULT_ANALYTIC.efficiency(name, p)
