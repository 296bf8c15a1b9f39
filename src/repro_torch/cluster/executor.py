"""Multi-tenant elastic cluster executor — the paper's §6 scenarios on LIVE
jobs instead of simulated ticks.

Runs N concurrent ``ElasticTrainer`` jobs against ONE shared device pool
(the port's logical slots, ``devices.Slot``: several may share a card),
round-robin at mini-batch granularity (one scheduling *round* = one
mini-batch per running job). Every ``resched_every`` rounds a pluggable
policy — the same Tiresias / Elastic-Tiresias / MaxThroughput / Static
callables that drive the discrete-event simulator — returns a target
allocation map, which is diffed into real elastic actions:

  shrink  — graceful ``release_devices`` scale-in, stop-free: the job keeps
            stepping through context prep and the freed devices return to
            the executor pool when the switch commits at a batch boundary;
  grow    — ``grant_devices`` scale-out onto free pool devices. A grant
            beyond the job's requested parallelism is a transient-resource
            LOAN (§6.2): the pool stays fully utilized and the next
            rebalance reclaims the loan on demand via graceful scale-in;
  start   — a pending job is admitted (trainer built) once enough devices
            are free — typically funded by another job's shrink. If the job
            carries a checkpoint handle this is a RE-ADMISSION: the saved
            optimizer/model/data-pipeline state is restored onto whatever
            devices the policy granted this time;
  preempt — a 0-GPU target for a running job checkpoint-stops it
            (core.stop_resume): the save runs in the background while the
            job's devices stay in its pool, then the trainer is torn down,
            ALL devices come home, and the job is parked PREEMPTED — it
            re-enters the pending queue as re-admittable demand;
  migrate — straggler-triggered (§5.2): workers flagged by the job's
            StragglerDetector are cycled out in one fused switch;
  reshape — live reparallelization (repro_torch.reshape): a policy target
            whose model-parallel degree differs from an mp=auto job's live one
            trades data-parallel for model-parallel degree stop-free at a
            mini-batch boundary. The device delta settles against the
            pool: a footprint-growing reshape is funded from free devices
            up front (or parked as a want), a footprint-shrinking one
            returns the surplus when the switch commits — the same
            ownership-transfer discipline as grants and reclaims. A
            re-admission of a parked mp=auto job may likewise restore its
            checkpoint onto a different degree than it was saved at.

Policies reason about t(p) through the executor's pluggable
``throughput_model`` (sched.throughput): with the default AnalyticModel
they schedule from the paper's static curves; with a MeasuredModel every
mini-batch's measured step time becomes a free observation at the job's
current parallelism, and the opt-in ``profile_sweeps`` mode additionally
runs EDL §5.2 scale-in sweeps on transient idle devices to prefill whole
curves — so allocation decisions follow what jobs really do, not what
their profile name predicts.

Allocation unit — the DEVICE GROUP: a job with ``model_parallel = mp``
trains on a 2-D ``(data, model)`` mesh and every grant, reclaim, loan,
preemption and re-admission moves whole mp-sized groups (one data-parallel
replica each). Policies count groups (their allocation maps are in
replicas, ``sched.base.group_size`` gives the device cost); the executor
converts at the pool boundary — popping ``groups * mp`` devices on a
grant, asking the trainer for ``groups`` slices on a release — so a
4-device mp=2 tenant and four 1-device mp=1 tenants pack the same pool
under the same policy arithmetic.

Device conservation — running jobs' pools, plus devices held by in-flight
preemption checkpoints, plus the free pool equals the cluster size — is
asserted after every round IN DEVICES (``ClusterJob.devices_held``, not
group counts); devices move ownership only synchronously (grant), at a
commit boundary (release/finish), or when a checkpoint save lands
(preempt), so the invariant is exact even with scale operations and
checkpoints in flight.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.cluster.job import ClusterJob, JobSpec, JobState, \
    make_cluster_job
from repro_torch.cluster.policy import plan_actions
from repro_torch.core.scaling import Busy, Phase
from repro_torch.devices import as_slots, default_pool
from repro_torch.sched.base import normalize_target


def enable_compile_cache(path: str) -> str:
    """Opt-in persistent cache of what the port compiles, its CUDA kernel
    libraries (``kernels/build.py``): they are built into ``path`` (created
    here) and looked up there from now on, so they survive preempt/re-admit
    teardowns, fresh checkouts and whole reruns, where the default
    ``build/kernels`` lives in the checkout. A library is rebuilt only when
    the hash of its source and nvcc flags, which its file name carries,
    changes. The port compiles nothing per topology (the reference's cache
    holds XLA executables; a topology's prep here warms the kernels), so
    that is all the cache holds. Returns ``str(path)``."""
    import os

    from repro_torch.kernels import build
    os.makedirs(path, exist_ok=True)
    build.set_build_dir(path)
    return str(path)


def default_trainer_factory(spec: JobSpec, devices: list, *,
                            smoke: bool = True):
    """Build the live engine owning exactly ``devices``: an ElasticTrainer
    for training specs (a whole number of mp-sized groups, each one
    data-parallel replica of the ``(data, model)`` layout), a replicated
    inference engine for serving-tier specs; each on the spec's arch at its
    SMOKE width as the reference's factory does, and ``smoke=False`` builds
    the full CONFIG."""
    if getattr(spec, "tier", "training") == "serving":
        from repro_torch.cluster.serving import make_serving_engine
        return make_serving_engine(spec, devices, smoke=smoke)
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.optim import adamw
    cfg = get_config(spec.arch, smoke=smoke)
    return ElasticTrainer(
        cfg, global_batch=spec.global_batch, seq_len=spec.seq_len,
        init_parallelism=len(devices) // spec.model_parallel,
        model_parallel=spec.model_parallel, optimizer=adamw(spec.lr),
        n_samples=spec.n_samples, d_partitions=spec.d_partitions,
        job_handle=spec.name, seed=spec.seed, devices=devices,
        virtual_workers=spec.virtual_workers, time_allowance_s=0.1)


class DiskCheckpointer:
    """Preemption backend for real ElasticTrainers.

    Protocol (anything implementing it can drive the executor's
    preemption lifecycle — the fast tests substitute an in-memory fake):

      begin(job)     — start persisting the running trainer's state; must
                       not block the executor loop (here: a background
                       thread running core.stop_resume.checkpoint_save).
      done(job)      — True once the save landed (re-raises any save error).
      teardown(job)  — drop the stopped trainer's state/executables and
                       return ALL of its devices.
      restore(job, trainer) — load the saved state into a freshly built
                       trainer on the newly granted device set.
      wait(job, timeout) — optional: block until the save lands (or the
                       timeout passes). Without it the executor falls back
                       to polling ``done`` with a short sleep.
      discard(job)   — optional: drop the saved state once the job can
                       never be re-admitted again (it finished).
    """

    def __init__(self, root: str | None = None):
        self.root = root

    def begin(self, job: ClusterJob):
        import tempfile
        from repro_torch.core.stop_resume import checkpoint_save
        if job.checkpoint is None:
            job.checkpoint = tempfile.mkdtemp(
                prefix=f"edl_preempt_{job.spec.name}_", dir=self.root)
        job._ckpt_error = None

        def run():
            try:
                checkpoint_save(job.trainer, job.checkpoint)
            except BaseException as e:      # surfaced by done()
                job._ckpt_error = e
        job._ckpt_thread = threading.Thread(target=run, daemon=True)
        job._ckpt_thread.start()

    def done(self, job: ClusterJob) -> bool:
        t = job._ckpt_thread
        if t is not None and t.is_alive():
            return False
        if t is not None:
            t.join()
            job._ckpt_thread = None
        err = getattr(job, "_ckpt_error", None)
        if err is not None:
            raise err
        return True

    def wait(self, job: ClusterJob, timeout: float = 60.0):
        t = job._ckpt_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def teardown(self, job: ClusterJob) -> list:
        from repro_torch.core.stop_resume import teardown_trainer
        return teardown_trainer(job.trainer)

    def restore(self, job: ClusterJob, trainer):
        from repro_torch.core.stop_resume import resume_from_checkpoint
        resume_from_checkpoint(trainer, job.checkpoint)

    def discard(self, job: ClusterJob):
        """Drop the job's checkpoint directory (job finished — the saved
        state can never be re-admitted again)."""
        import shutil
        if job.checkpoint is not None:
            shutil.rmtree(job.checkpoint, ignore_errors=True)
            job.checkpoint = None


class ClusterExecutor:
    """Drives N tenants on one device pool under a scheduling policy.

    Exposes the sched-view protocol (``n_gpus`` / ``now`` / ``running`` /
    ``pending``) so policies written for the simulator run unchanged.
    Parked (PREEMPTED) jobs sit in ``pending`` — policies see them as
    re-admittable demand with their attained service and original arrival
    intact. Jobs mid-checkpoint are in neither view: their devices are not
    yet reclaimable and they cannot be stepped, so the policy simply does
    not reason about them until the save lands.
    """

    def __init__(self, specs: list[JobSpec], policy, *, devices=None,
                 resched_every: int = 4, trainer_factory=None,
                 prep_yield_s: float = 0.15,
                 serialize_prep: bool | None = None,
                 compile_service=None, compile_workers: int = 2,
                 prefetch_shapes: bool = False, prefetch_limit: int = 2,
                 checkpointer=None, throughput_model=None,
                 profile_sweeps: bool = False, profile_steps: int = 3,
                 profile_ttl: float | None = None,
                 compile_cache: str | None = None,
                 faults=None, ckpt_max_retries: int = 3,
                 obs=None):
        # set FIRST: close()/__del__ must be safe even if construction
        # fails partway (e.g. the infeasible-mp ValueError below)
        self._closed = False
        # observability facade (repro_torch.obs.Observability): every legacy
        # event is mirrored onto its typed bus, committed switches become
        # span trees, and the round loop drives its metrics sampling
        self.obs = obs
        if compile_cache:
            enable_compile_cache(compile_cache)
        if devices is None:
            devices = default_pool(1)
        elif any(isinstance(d, (str, torch.device)) for d in devices):
            # plain devices become slots with identities, so two slots of
            # one card are two slots
            devices = as_slots(devices)
        if throughput_model is None:
            from repro_torch.sched.throughput import AnalyticModel
            throughput_model = AnalyticModel()
        for s in specs:
            if s.model_parallel > len(devices):
                raise ValueError(
                    f"{s.name}: model_parallel={s.model_parallel} is "
                    f"infeasible on a {len(devices)}-device pool — even "
                    f"one group cannot be granted")
        # the model policies consume via the view (sched.base); every
        # mini-batch feeds it a free observation, and with profile_sweeps
        # idle devices prefill whole curves via scale-in sweeps
        self.throughput_model = throughput_model
        self.profile_sweeps = profile_sweeps
        self.profile_steps = profile_steps
        # staleness TTL in scheduling rounds: None sweeps each job at most
        # once per lifetime (the pre-TTL behavior); a finite TTL re-sweeps
        # a job once its measured curve ages out — curves drift as data,
        # interference or the job's own shape change, and MeasuredModel
        # EMA-blends the re-sweep over the stale curve
        self.profile_ttl = profile_ttl
        self._profiled: dict[int, float] = {}   # jid -> round last swept
        self.devices = list(devices)
        self.n_gpus = len(self.devices)
        self.free: list = list(self.devices)
        self.policy = policy
        self.resched_every = resched_every
        self.trainer_factory = trainer_factory or default_trainer_factory
        self.prep_yield_s = prep_yield_s
        # adjustment-overhead pipeline: context preps run as priority
        # tickets in ONE bounded CompileService pool — committed switches
        # outrank speculative prefetches, pending shapes are cancellable,
        # and every job's prep makes progress concurrently. The pool bound
        # is what protects small hosts now; the legacy cluster-wide
        # ``serialize_prep=True`` boolean (one prep at a time, everything
        # else re-planned later) remains available as an explicit opt-out
        # and disables the service.
        self.serialize_prep = bool(serialize_prep)
        if serialize_prep or compile_service is False:
            self.compile_service = None
        elif compile_service is not None:
            self.compile_service = compile_service
        else:
            from repro_torch.core.compile_service import CompileService
            self.compile_service = CompileService(workers=compile_workers)
        if self.obs is not None and self.compile_service is not None \
                and self.compile_service.on_event is None:
            self.compile_service.on_event = self.obs.on_compile_event
        self.prefetch_shapes = prefetch_shapes and \
            self.compile_service is not None
        self.prefetch_limit = prefetch_limit
        self.checkpointer = checkpointer or DiskCheckpointer()
        self.jobs = {jid: make_cluster_job(jid, s)
                     for jid, s in enumerate(specs)}
        self.pending: list[ClusterJob] = []
        self.running: dict[int, ClusterJob] = {}
        self.checkpointing: dict[int, ClusterJob] = {}
        self.finished: list[ClusterJob] = []
        self._to_arrive = sorted(self.jobs.values(),
                                 key=lambda j: (j.arrival, j.jid))
        self._wants: dict[int, tuple[int, int]] = {}  # jid -> (groups, mp)
        self.round = 0
        self.events: list[dict] = []
        # ------------------------------------------- fault tolerance state
        # faults: a repro_torch.chaos FaultPlan (or prebuilt FaultInjector)
        # replayed against this run — kill/revocation/ckpt-crash events
        self.injector = None
        if faults is not None:
            from repro_torch.chaos import FaultInjector, FaultPlan
            self.injector = (faults if isinstance(faults, FaultInjector)
                             else FaultInjector(faults))
        self.n_gpus_initial = self.n_gpus
        # device ids condemned (dead worker's group / revoked capacity):
        # still owned by their job until the recovery commits — they count
        # toward conservation — but the moment they come home they leave
        # the cluster instead of rejoining the free pool
        self._condemned: set = set()
        self._deferred_revocations: list[tuple[int | None, int]] = []
        self._crash_next_ckpt = False       # armed by crash_checkpoint
        self.ckpt_max_retries = ckpt_max_retries
        self._ckpt_retries: dict[int, int] = {}
        self.workers_killed = 0
        self.devices_revoked = 0
        self.capacity_lost = 0              # devices actually removed
        self.ckpt_retry_total = 0
        self.recovery_latencies: list[float] = []

    # the policy-view clock: scheduling rounds (see sched.base on units)
    @property
    def now(self) -> float:
        return float(self.round)

    # ------------------------------------------------------------- events
    def _event(self, op: str, job: ClusterJob | None, from_p: int,
               to_p: int, devices=None, loaned: int | None = None,
               mp: int | None = None, **extra):
        """Log one allocation event. ``job=None`` is a pool-level event
        (e.g. a free-pool revocation) and must pass ``mp`` explicitly —
        EVERY event carries the event-time mp so mixed-mp loan accounting
        (``stats()["max_loaned"]``) converts groups to devices exactly,
        never through a silent default."""
        if mp is None:
            mp = job.mp         # from_p/to_p/loaned are GROUP counts
        if loaned is None:
            loaned = max(0, to_p - job.requested_p) if job is not None else 0
        e = {
            "round": self.round, "op": op,
            "job": job.spec.name if job is not None else None,
            "jid": job.jid if job is not None else None,
            "from_p": from_p, "to_p": to_p, "mp": mp, "loaned": loaned}
        if devices is not None:
            e["devices"] = [getattr(d, "id", d) for d in devices]
        if job is not None and getattr(job, "tier", "training") == "serving":
            e.setdefault("tier", "serving")
        e.update(extra)
        self.events.append(e)
        if self.obs is not None:
            self.obs.on_executor_event(e)

    @staticmethod
    def _dev_id(d):
        return getattr(d, "id", d)

    def _return_devices(self, freed: list) -> list:
        """Route EVERY device hand-back to the pool through here: devices
        condemned in the meantime (a dead worker's group, revoked
        capacity) leave the cluster instead of rejoining ``free`` — dead
        capacity must not fund the next grant. Shrinking ``n_gpus`` at
        the same moment keeps the conservation assert exact and lets the
        policies (which read ``view.n_gpus`` fresh every call) budget
        against the smaller pool from the next reschedule on."""
        gone = [d for d in freed if self._dev_id(d) in self._condemned]
        kept = [d for d in freed if self._dev_id(d) not in self._condemned]
        if gone:
            ids = {self._dev_id(d) for d in gone}
            self._condemned -= ids
            self.devices = [d for d in self.devices
                            if self._dev_id(d) not in ids]
            self.n_gpus -= len(gone)
            self.capacity_lost += len(gone)
        self.free.extend(kept)
        return kept

    def _note_recovered(self, job: ClusterJob, mode: str):
        """Close a fault's recovery-latency window: the first ownership
        transfer after detection (stop-free release commit, or the
        checkpoint landing) is when the cluster is whole again."""
        t0 = getattr(job, "_fault_t0", None)
        if t0 is None:
            return
        job._fault_t0 = None
        lat = time.monotonic() - t0
        self.recovery_latencies.append(lat)
        if self.obs is not None:
            # t0 and the tracer share the monotonic clock: the span IS
            # the recovery-latency window, not a re-measurement of it
            self.obs.tracer.add_span("recovery", t0, time.monotonic(),
                                     tid=job.spec.name, cat="fault",
                                     mode=mode)
        self._event("recovered", job, job.alloc, job.alloc, loaned=0,
                    mode=mode, latency_s=round(lat, 4))

    def _on_devices_released(self, trainer, freed: list):
        """ElasticTrainer hand-off hook: a release_devices scale-in (or a
        loan reclaim, or a footprint-shrinking RESHAPE) COMMITTED; the
        devices come home to the pool. The event is logged here — at
        ownership transfer — not at request time, so the event order
        reflects which devices actually funded which grants. A reshape's
        surplus logs as ``reshape_release`` (the shape change itself was
        logged by the ``reshape`` event); inventing a scale_in transition
        in the NEW shape's units would corrupt the allocation trace."""
        self._return_devices(freed)
        job = self.jobs.get(getattr(trainer, "_cluster_jid", -1))
        if job is None:
            return
        if getattr(trainer, "_releasing_op", None) == "reshape":
            self._event("reshape_release", job, job.alloc, job.alloc,
                        devices=freed, loaned=0)
        else:
            self._event("scale_in", job, job.alloc + len(freed) // job.mp,
                        job.alloc, devices=freed)
        self._note_recovered(job, "stop_free")

    # ---------------------------------------------------------- admission
    def _admit_arrivals(self):
        while self._to_arrive and self._to_arrive[0].arrival <= self.now:
            job = self._to_arrive.pop(0)
            # jobs launch at their requested parallelism when it fits;
            # otherwise they queue and the policy decides (compaction
            # etc.). A serving tenant admits at its CURRENT trace demand
            # instead — its requested_p is a reservation, not an ask.
            desired = getattr(job, "desired_p", None)
            want = (job.feasible_p(desired(self.now))
                    if desired is not None else job.requested_p)
            if want >= 1 and len(self.free) >= want * job.mp:
                self._start(job, want)
            else:
                self.pending.append(job)

    def _start(self, job: ClusterJob, p: int, mp: int | None = None):
        """Admit ``job`` on ``p`` mp-sized device groups from the free
        pool. When the job carries a checkpoint handle this is a
        re-admission: the fresh trainer (possibly on a different device
        set / parallelism — and, for an mp=auto tenant, a different
        model-parallel degree than the checkpoint was saved at; the
        restore reshards along a reshape plan) is restored from the saved
        state before it takes its first step."""
        mp = mp or job.mp
        devs = [self.free.pop(0) for _ in range(p * mp)]
        trainer = job.launch(devs, self.trainer_factory, mp=mp)
        trainer.on_devices_released = self._on_devices_released
        trainer._cluster_jid = job.jid
        if self.compile_service is not None:
            # route this trainer's background preps through the shared
            # priority queue (fakes simply never read the attribute)
            trainer.compile_service = self.compile_service
        if self.obs is not None:
            self.obs.on_queue_wait(self.now - job.arrival)
            ctrl = getattr(trainer, "controller", None)
            if isinstance(getattr(ctrl, "listeners", None), list):
                # every committed switch of this trainer becomes a span
                # tree + latency observations (plain protocol fakes and
                # serving engines have no listener surface: skipped)
                ctrl.listeners.append(
                    lambda rec, job=job:
                        self.obs.on_adjustment(self, job, rec))
        if job in self.pending:
            self.pending.remove(job)
        readmit = job.checkpoint is not None
        if readmit:
            self.checkpointer.restore(job, trainer)
        self.running[job.jid] = job
        self._wants.pop(job.jid, None)
        self._event("readmit" if readmit else "scale_out", job, 0, p,
                    devices=devs)

    # --------------------------------------------------------- preemption
    def _preempt(self, job: ClusterJob):
        """RUNNING -> CHECKPOINTING: stop scheduling the job and start
        persisting its state. Its devices stay in the trainer's pool until
        the save lands (pending-checkpoint accounting in the conservation
        assert), so a slow checkpoint can never double-fund a grant."""
        del self.running[job.jid]
        self._wants.pop(job.jid, None)
        job.begin_checkpoint()
        if getattr(job, "stateless", False):
            # stateless tenants (serving replicas) have nothing to save:
            # skip the checkpointer, send every device home NOW, park the
            # job re-admittable. Same state machine, zero-length
            # CHECKPOINTING window.
            p = job.alloc
            freed = list(job.trainer.devices)
            job.trainer.devices = []
            self._return_devices(freed)
            job.park()
            self.pending.append(job)
            self._event("preempt", job, p, 0, devices=freed,
                        stateless=True)
            self._note_recovered(job, "stateless")
            return
        job._ckpt_t0 = time.monotonic()
        self.checkpointer.begin(job)
        self.checkpointing[job.jid] = job
        self._event("checkpoint", job, job.alloc, job.alloc)
        if self._ckpt_done(job):            # synchronous checkpointer
            self._finalize_preempt(job)

    def _ckpt_done(self, job: ClusterJob) -> bool:
        """``checkpointer.done`` with crash containment: a save that died
        mid-flight (its thread raised — or the chaos injector armed a
        crash) is logged and RETRIED — the trainer's state is still live
        on its devices, so nothing is lost but time. The retry budget
        bounds a persistently-failing save; exhausting it re-raises (the
        pre-existing fail-loud behavior, now with the attempts on
        record). Devices never move on the failure path, so conservation
        is untouched."""
        try:
            ok = self.checkpointer.done(job)
            err = None
            if ok and self._crash_next_ckpt:
                self._crash_next_ckpt = False
                ok, err = False, RuntimeError(
                    "injected fault: checkpoint save crashed mid-flight")
        except BaseException as e:
            ok, err = False, e
        if err is None:
            return ok
        n = self._ckpt_retries.get(job.jid, 0) + 1
        self._ckpt_retries[job.jid] = n
        self.ckpt_retry_total += 1
        self._event("checkpoint_failed", job, job.alloc, job.alloc,
                    loaned=0, error=repr(err), attempt=n)
        if n > self.ckpt_max_retries:
            raise err
        self.checkpointer.begin(job)
        return False

    def _finalize_preempt(self, job: ClusterJob):
        """CHECKPOINTING -> PREEMPTED: the save landed. Tear the trainer
        down, return ALL devices to the pool, and park the job back in the
        pending queue as re-admittable demand."""
        p = job.alloc
        freed = self.checkpointer.teardown(job)
        self._return_devices(freed)
        t0 = getattr(job, "_ckpt_t0", None)
        if self.obs is not None and t0 is not None:
            # begin -> landed, retries included (the save's full shadow)
            self.obs.tracer.add_span("checkpoint_save", t0,
                                     time.monotonic(), tid=job.spec.name,
                                     cat="checkpoint",
                                     retries=self._ckpt_retries.get(
                                         job.jid, 0))
        job._ckpt_t0 = None
        self._ckpt_retries.pop(job.jid, None)
        job.park()
        del self.checkpointing[job.jid]
        self.pending.append(job)
        self._event("preempt", job, p, 0, devices=freed)
        self._note_recovered(job, "checkpoint")

    def _collect_checkpoints(self):
        for jid in list(self.checkpointing):
            job = self.checkpointing[jid]
            if self._ckpt_done(job):
                self._finalize_preempt(job)

    def _await_checkpoint(self):
        """Nothing can step until a save lands: block on the in-flight
        checkpoint instead of burning scheduling rounds at zero wall time
        — the round counter is the policy clock, so spinning it would
        distort arrival/JCT accounting and can exhaust max_rounds in
        microseconds while the save thread has barely started."""
        job = next(iter(self.checkpointing.values()))
        wait = getattr(self.checkpointer, "wait", None)
        if wait is not None:
            wait(job, 60.0)
        else:
            time.sleep(0.01)    # poll-only checkpointer still in flight

    # --------------------------------------------------------- scheduling
    def _prep_in_flight(self) -> bool:
        return any(j.trainer.controller.phase is not Phase.IDLE
                   for j in self.running.values())

    def _reschedule(self):
        alloc = self.policy(self)
        for act in plan_actions(self.jobs, alloc, self.n_gpus):
            job = self.jobs[act.jid]
            if act.kind == "preempt":
                # no compile involved, so exempt from the one-prep rule;
                # a job mid-switch is skipped and re-planned next resched
                if act.jid in self.running and \
                        job.trainer.controller.phase is Phase.IDLE:
                    self._preempt(job)
                continue
            if self.serialize_prep and self._prep_in_flight():
                # one context-prep at a time cluster-wide: concurrent
                # background compiles starve each other on small hosts and
                # none ever reaches its switch step; the skipped action is
                # re-planned at the next reschedule
                break
            if act.kind == "scale_in":
                cur = job.alloc
                try:
                    job.trainer.release_devices(cur - act.target_p)
                except Busy:
                    continue        # a switch is in flight; next resched
                self._wants.pop(act.jid, None)
                # the scale_in event logs in _on_devices_released at commit
            elif act.kind == "reshape":
                if act.jid in self.running and \
                        not self._reshape(job, act.target_p, act.target_mp):
                    # a footprint-growing reshape short on free devices
                    # waits like any grow — satisfied when devices free up
                    self._wants[act.jid] = (act.target_p, act.target_mp)
            else:                   # start / scale_out: wait for devices
                self._wants[act.jid] = act.shape(job)
        # drop stale wants for jobs the policy no longer wants to grow —
        # including an explicit 0 target for a parked job (a revoked
        # re-admission must not launch later against the current decision)
        for jid in list(self._wants):
            job = self.jobs[jid]
            target = normalize_target(job, alloc.get(jid, 0))[0]
            if target <= 0 or job.finish_time is not None:
                del self._wants[jid]

    def _reshape(self, job: ClusterJob, p: int, mp: int) -> bool:
        """Issue the RESHAPE verb against a running job: re-mesh it from
        its live ``(alloc, mp)`` to ``(p, mp)``, settling the device delta
        against the pool — extra devices are granted up front (ownership
        moves now, the stop-free switch commits at a batch boundary),
        surplus devices come home through ``on_devices_released`` when
        the switch commits. Returns False only when a footprint-growing
        reshape is short on free devices (the caller parks it as a want);
        Busy trainers swallow the attempt and are re-planned at the next
        reschedule."""
        trainer = job.trainer
        cur_d, new_d = job.devices_held, p * mp
        grant = []
        if new_d > cur_d:
            if len(self.free) < new_d - cur_d:
                return False
            grant = [self.free.pop(0) for _ in range(new_d - cur_d)]
        from_p, from_mp = job.alloc, job.mp
        try:
            trainer.reshape(p, mp, new_devices=grant or None, release=True)
        except (Busy, ValueError):
            self.free = grant + self.free
            return True         # a switch is in flight; next resched
        job.n_reshapes += 1
        # the shape-change record; a shrink's freed devices are logged by
        # the release hook when the switch commits (ownership transfer),
        # a growth's grant moves ownership here and rides on this event
        self._event("reshape", job, from_p, p, loaned=0,
                    devices=grant if grant else None,
                    from_mp=from_mp, to_mp=mp)
        return True

    def _satisfy_wants(self):
        """Grant free devices toward wanted growth in whole mp-sized
        groups, FIFO by arrival — this is where one job's scale-in (or
        preemption) funds another's scale-out, a parked job's
        re-admission, or a waiting footprint-growing reshape. Leftover
        devices smaller than a job's group size stay free rather than
        being parked uselessly in its pool."""
        for jid in sorted(self._wants,
                          key=lambda i: (self.jobs[i].arrival, i)):
            job, (target, mp) = self.jobs[jid], self._wants[jid]
            if job.trainer is None:
                if len(self.free) >= target * mp and not (
                        self.serialize_prep and self._prep_in_flight()):
                    self._start(job, target, mp)    # foreground compile
                continue
            if mp != job.mp:    # a parked reshape waiting for devices
                if job.trainer.controller.phase is not Phase.IDLE or (
                        self.serialize_prep and self._prep_in_flight()):
                    continue
                if self._reshape(job, target, mp):
                    del self._wants[jid]
                continue
            cur = job.alloc
            if target <= cur:
                del self._wants[jid]
                continue
            take = min(target - cur, len(self.free) // job.mp)
            # a PARTIAL grant must itself land on a feasible parallelism
            # (global batch divisibility), not just the final target
            take = job.feasible_p(cur + take) - cur
            if take < 1 or job.trainer.controller.phase is not Phase.IDLE:
                continue
            if self.serialize_prep and self._prep_in_flight():
                continue        # grants compile too; one prep at a time
            devs = [self.free.pop(0) for _ in range(take * job.mp)]
            try:
                job.trainer.grant_devices(devs)
            except (Busy, ValueError):
                self.free = devs + self.free
                continue
            self._event("scale_out", job, cur, cur + take, devices=devs)
            if cur + take >= target:
                del self._wants[jid]

    # ------------------------------------------------ speculative prefetch
    def _prefetch_shapes(self):
        """Warm the exec caches with the policy's LIKELY-NEXT shapes
        (sched.base.likely_next_shapes) on idle host threads: a later
        committed RESHAPE/resize that lands on a prefetched shape finds a
        warm handle and its prep collapses to a cache lookup. Tickets are
        SPECULATIVE — any committed prep outranks them in the service
        queue — and a shape that leaves the likely set is cancelled
        before a worker picks it up (re-plan obsolescence)."""
        svc = self.compile_service
        from repro_torch.sched.base import likely_next_shapes
        for jid, job in list(self.running.items()):
            trainer = job.trainer
            build = getattr(trainer, "_build_exec", None)
            if build is None:       # protocol fakes have no executables
                continue
            owner = ("spec", jid)
            keep = set()
            shapes = likely_next_shapes(self.policy, self, job,
                                        limit=self.prefetch_limit)
            for p, mp in shapes:
                need, held = p * mp, job.devices_held
                if need <= held:
                    devs = trainer.devices
                elif need - held <= len(self.free):
                    # the device prefix a growth grant would produce:
                    # grants append free devices in pool order
                    devs = list(trainer.devices) + self.free[:need - held]
                else:
                    continue        # infeasible right now; not likely
                key = trainer._exec_key(p, mp, devs)
                keep.add(key)
                if key in trainer._exec_cache:
                    continue
                from repro_torch.core.compile_service import PRIO_SPECULATIVE
                devs = list(devs)
                svc.submit(key, lambda b=build, p=p, mp=mp, d=devs:
                           b(p, mp, devices=d),
                           priority=PRIO_SPECULATIVE, owner=owner)
            svc.cancel_owner(owner, keep=keep)

    # ----------------------------------------------- failures & revocation
    def _devices_of(self, trainer, wids) -> list:
        """The device groups currently backing ``wids``: worker i of the
        live mesh owns ``devices[i*mp:(i+1)*mp]`` (positional — both the
        real trainer and the test fakes keep that correspondence)."""
        mp = int(getattr(trainer, "model_parallel", 1) or 1)
        out = []
        for w in wids:
            if w in trainer.worker_ids:
                i = trainer.worker_ids.index(w)
                out.extend(trainer.devices[i * mp:(i + 1) * mp])
        return out

    def _detect_failures(self):
        """Leader-side dead-worker detection (EDL §4.1): a worker that
        missed ``miss_threshold`` gradient-syncs while its job progressed
        is dead. Runs every round after stepping; trainers without a
        membership surface (plain fakes) are skipped."""
        for job in list(self.running.values()):
            trainer = job.trainer
            membership = getattr(trainer, "membership", None)
            if membership is None:
                continue
            dead = [w for w in membership.dead_workers(
                        getattr(trainer, "step_idx", 0))
                    if w in trainer.worker_ids]
            if dead:
                self._recover_dead(job, dead)

    def _recover_dead(self, job: ClusterJob, dead: list[str]):
        """Recovery state machine: detection -> condemn the dead groups ->
        stop-free ``handle_failure`` scale-in (attained service intact,
        training never stops) -> checkpoint-stop fallback when the
        survivor shape is infeasible (``feasible_p`` = 0 after the batch /
        n_virtual clamp) or the trainer cannot scale in. The dead devices
        leave the cluster when they come home (``_return_devices``); a
        mid-switch trainer defers one round and retries."""
        trainer = job.trainer
        # a worker stays in _dead_pending until the commit actually takes
        # it out of worker_ids: the stop-free switch spans rounds, and
        # detection keeps flagging the (still-present) corpse during prep
        # — without this filter every prep round would re-count the same
        # kill and emit duplicate worker_dead events
        pending = {w for w in (getattr(job, "_dead_pending", None) or set())
                   if w in trainer.worker_ids}
        job._dead_pending = pending
        new = [w for w in dead if w not in pending]
        if new:
            job._dead_pending = pending | set(new)
            job._fault_t0 = time.monotonic()
            self.workers_killed += len(new)
            doomed = self._devices_of(trainer, new)
            self._condemned.update(self._dev_id(d) for d in doomed)
            self._event("worker_dead", job, job.alloc, job.alloc,
                        devices=doomed, loaned=0, workers=list(new),
                        steps_done=job.steps_done)
        if trainer.controller.phase is not Phase.IDLE:
            return                          # switch in flight; next round
        dead = sorted(job._dead_pending)
        target = job.feasible_p(job.alloc - len(dead))
        if target >= 1 and hasattr(trainer, "handle_failure"):
            try:
                trainer.handle_failure(dead, release=True)
            except Busy:
                return                      # raced a new op; next round
            except ValueError:
                pass                        # infeasible: checkpoint-stop
            else:
                return      # pending clears itself once the commit lands
        job._dead_pending = set()
        self._preempt(job)                  # park with service preserved

    def revoke_devices(self, n_devices: int = 1, *,
                       jid: int | None = None) -> int:
        """Revoke ``n_devices`` from the cluster WITHOUT warning (spot /
        transient capacity reclaim, the flip side of Aryl-style loans).
        Free devices vanish first; the remainder is reclaimed from
        running jobs — stop-free ``release_devices`` when a feasible
        survivor shape exists, checkpoint-preempt otherwise — with the
        revoked devices condemned so they leave the pool at the commit.
        ``jid`` pins the victim job (trace replay); by default the
        largest running job donates. Returns the number of devices
        removed or condemned; a shortfall (everything is parked or
        mid-switch) is re-attempted every round until satisfied."""
        taken = 0
        if jid is None and self.free:
            grab = min(n_devices, len(self.free))
            devs = [self.free.pop() for _ in range(grab)]
            ids = {self._dev_id(d) for d in devs}
            self.devices = [d for d in self.devices
                            if self._dev_id(d) not in ids]
            self.n_gpus -= grab
            self.capacity_lost += grab
            self.devices_revoked += grab
            taken += grab
            self._event("revoke", None, 0, 0, devices=devs, loaned=0,
                        mp=1, source="free_pool")
        while taken < n_devices:
            victims = [j for j in self.running.values()
                       if (jid is None or j.jid == jid)
                       and j.trainer.controller.phase is Phase.IDLE]
            if not victims:
                self._deferred_revocations.append((jid, n_devices - taken))
                break
            victim = max(victims, key=lambda j: (j.devices_held, -j.jid))
            got = self._revoke_from(victim, n_devices - taken)
            if not got:
                self._deferred_revocations.append((jid, n_devices - taken))
                break
            taken += got
        return taken

    def _revoke_from(self, job: ClusterJob, want: int) -> int:
        """Reclaim up to ``want`` devices from one running job, in whole
        mp-sized groups. The revoked groups are condemned NOW — ownership
        transfers at the commit (or when the preemption save lands), and
        ``_return_devices`` removes them from the cluster then."""
        trainer = job.trainer
        mp = job.mp
        groups = min(-(-want // mp), job.alloc)     # ceil, capped
        if groups < 1:
            return 0
        target = job.feasible_p(job.alloc - groups)
        doomed = trainer.devices[-groups * mp:]
        self._condemned.update(self._dev_id(d) for d in doomed)
        self.devices_revoked += len(doomed)
        self._event("revoke", job, job.alloc,
                    target if target >= 1 else 0, devices=doomed,
                    loaned=0, steps_done=job.steps_done)
        job._fault_t0 = time.monotonic()
        if target >= 1:
            try:
                trainer.release_devices(job.alloc - target)
            except (Busy, ValueError):
                self._preempt(job)      # can't shrink live: park instead
        else:
            # infeasible survivor set (e.g. the n_virtual % p clamp):
            # checkpoint-stop; re-admission restores onto the smaller pool
            self._preempt(job)
        return len(doomed)

    def _retry_deferred_revocations(self):
        deferred, self._deferred_revocations = \
            self._deferred_revocations, []
        for jid, n in deferred:
            if jid is not None and (jid not in self.jobs or
                                    self.jobs[jid].finish_time is not None):
                continue                # target gone; revocation moot
            self.revoke_devices(n, jid=jid)

    # ----------------------------------------------------------- profiling
    def _maybe_profile(self):
        """Opt-in EDL §5.2: when devices sit idle, run ONE scale-in
        profiling sweep (core.profiling.profile) on a not-yet-swept running
        job, temporarily loaning it the idle devices, and feed the measured
        curve into the throughput model. The sweep is synchronous and
        blocking (opt-in for exactly that reason); its mini-batches are
        real training work but do not count toward the job's total_steps —
        profiling must not fast-forward the schedule. Only models that can
        ``ingest`` sweep tables (MeasuredModel) are worth sweeping for.

        With a finite ``profile_ttl`` a job becomes sweep-eligible AGAIN
        once its last sweep is ``profile_ttl`` rounds old: measured curves
        drift (data distribution, co-tenant interference, a reshape onto a
        new shape), and the re-sweep re-ingests into the model's EMA
        stream, re-blending the stale curve toward current reality."""
        ingest = getattr(self.throughput_model, "ingest", None)
        if ingest is None or not self.free:
            return
        if self.serialize_prep and self._prep_in_flight():
            return      # a sweep compiles every topology it visits
        from repro_torch.core.profiling import profile
        for jid in sorted(self.running,
                          key=lambda i: (self.jobs[i].arrival, i)):
            job = self.jobs[jid]
            last = self._profiled.get(jid)
            fresh = last is not None and (
                self.profile_ttl is None or
                self.now - last < self.profile_ttl)
            if fresh or job.spec.inelastic or \
                    getattr(job, "tier", "training") == "serving":
                continue    # inelastic tenants are NEVER resized, not
                            # even transiently for a measurement; serving
                            # replicas scale linearly by construction
            if job.remaining_steps <= 2 * self.profile_steps:
                continue    # about to finish: a sweep would cost more
                            # wall-clock than its curve could ever repay
            trainer = job.trainer
            if trainer.controller.phase is not Phase.IDLE:
                continue
            cur = job.alloc
            max_p = job.feasible_p(min(cur + len(self.free) // job.mp,
                                       self.n_gpus // job.mp))
            if max_p <= cur:
                continue    # too few idle devices to learn anything NEW
                            # right now; retry when more free up
            devs = [self.free.pop(0) for _ in range((max_p - cur) * job.mp)]
            try:
                trainer.grant_devices(devs)
            except (Busy, ValueError):
                self.free = devs + self.free
                continue
            # ownership transferred: on the event log like any grant, so
            # replay auditors see the sweep's devices granted before the
            # sweep's scale-in steps free them (or, on an aborted sweep,
            # before the next rebalance reclaims the leftover loan)
            self._event("profile_grant", job, cur, max_p, devices=devs)
            trainer.wait_for_scaling()
            try:
                table = profile(trainer, cur, max_p,
                                steps_per_p=self.profile_steps,
                                release=True, restore_p=cur)
            except (Busy, ValueError):
                # a switch was still in flight mid-sweep (slow background
                # compile): abort the sweep. The borrowed devices stay in
                # the job's pool as a plain transient loan — conservation
                # holds, and the next rebalance reclaims them via the
                # normal scale-in path; the sweep retries a later round
                continue
            ingest(job, table)
            self._profiled[jid] = self.now
            self._event("profile", job, max_p, cur,
                        loaned=max(0, max_p - job.requested_p))
            break       # at most one sweep per round

    # ------------------------------------------------------------ stepping
    def _step_job(self, job: ClusterJob):
        trainer = job.trainer
        m = trainer.step()
        if m is None:               # epoch boundary; commit if scheduled
            if trainer.controller.phase is Phase.SCHEDULED:
                trainer._commit_switch()
            return
        job.on_step(m, self.now)
        if m.get("slo_breach"):
            # serving tier: this round's tail latency blew the tenant's
            # SLO — the under-provisioning signal reclaim priority exists
            # to close. On the event log so ordering is testable.
            self._event("slo_breach", job, job.alloc, job.alloc, loaned=0,
                        p99_ms=m.get("p99_ms"), slo_ms=m.get("slo_ms"),
                        requests=m.get("requests"))
        # free observation (EDL §5.2): every live mini-batch's measured
        # step time at the job's CURRENT shape feeds the model the
        # policies schedule from — a no-op on the analytic model
        self.throughput_model.observe(
            job, int(m.get("p", trainer.p)), m.get("step_time", 0.0),
            mp=getattr(trainer, "model_parallel", None))
        flagged = [w for w in getattr(trainer, "_flagged_stragglers", [])
                   if w in trainer.worker_ids]
        if flagged and trainer.controller.phase is Phase.IDLE \
                and trainer.p > len(flagged):
            try:
                trainer.migrate(victims=flagged, block=False)
            except (Busy, ValueError):
                pass
            else:
                job.n_migrations += len(flagged)
                self._event("migrate", job, trainer.p, trainer.p)
        if job.steps_done >= job.spec.total_steps:
            self._finish(job)

    def _finish(self, job: ClusterJob):
        job.finish_time = self.now
        # an in-flight context prep still reads trainer.devices from its
        # worker; let it land before the pool takes the devices back —
        # and stop speculating about a job that no longer has a future
        if self.compile_service is not None:
            self.compile_service.cancel_owner(("spec", job.jid))
        join = getattr(job.trainer, "join_prep", None)
        if join is not None:
            join(120)
        p = job.alloc
        freed = list(job.trainer.devices)
        self._return_devices(freed)
        job.trainer.devices = []
        job.state = JobState.FINISHED
        del self.running[job.jid]
        self._wants.pop(job.jid, None)
        if job.checkpoint is not None:      # preempted earlier: the parked
            discard = getattr(self.checkpointer, "discard", None)
            if discard is not None:         # state is now unreachable
                discard(job)
        self.finished.append(job)
        self._event("finish", job, p, 0, devices=freed)

    def _assert_conserved(self):
        """Every device is in exactly one place: a live job's pool, a
        mid-checkpoint job's pool (held until the save lands), or free.
        Counted in DEVICES (``devices_held``), not groups — a leaked
        half-group would be invisible to group arithmetic."""
        live = sum(j.devices_held for j in self.jobs.values()
                   if j.jid not in self.checkpointing)
        pending_ckpt = sum(j.devices_held
                           for j in self.checkpointing.values())
        assert live + pending_ckpt + len(self.free) == self.n_gpus, \
            (f"device leak: {live} live + {pending_ckpt} checkpointing "
             f"+ {len(self.free)} free != {self.n_gpus}")

    # -------------------------------------------------------------- driver
    def run(self, *, max_rounds: int = 10_000) -> dict:
        try:
            while (self.running or self.pending or self.checkpointing
                   or self._to_arrive) and self.round < max_rounds:
                self._admit_arrivals()
                self._collect_checkpoints()
                if self.injector is not None:
                    self.injector.tick(self)
                self._retry_deferred_revocations()
                if self.round and self.round % self.resched_every == 0:
                    self._reschedule()
                self._satisfy_wants()
                if self.prefetch_shapes and \
                        self.round % self.resched_every == 0:
                    self._prefetch_shapes()
                if self.profile_sweeps:
                    self._maybe_profile()
                for job in list(self.running.values()):
                    self._step_job(job)
                self._detect_failures()
                if not self.running and self.checkpointing:
                    self._await_checkpoint()
                self._assert_conserved()
                if self.obs is not None:
                    self.obs.sample(self)
                self._prep_yield()
                self.round += 1
        except BaseException:
            # contained shutdown on the error path: join prep/save threads
            # best-effort so a thread still inside a context prep cannot
            # outlive the run and mask the real error
            self._drain_prep_threads()
            try:
                self._drain_checkpoints()
            except BaseException:
                pass
            raise
        self._drain_prep_threads()
        self._drain_checkpoints()
        return self.stats()

    def _prep_yield(self):
        """Cooperative yield: background context preps share the host's
        cores with training; on small hosts back-to-back steps can starve
        an in-flight compile. Unlike the old fixed ``sleep(prep_yield_s)``
        — which kept burning a full quantum every round even after the
        prep had landed — this WAITS on the prep itself (ticket or
        thread) and returns the moment the handle is ready, re-checking
        the phase so an already-prepared job costs nothing."""
        if not self.prep_yield_s:
            return
        deadline = time.monotonic() + self.prep_yield_s
        for job in list(self.running.values()):
            trainer = job.trainer
            if trainer.controller.phase is not Phase.PREPARING:
                continue        # prepared (or idle) since the step ran:
                                # no quantum owed for this job
            left = deadline - time.monotonic()
            if left <= 0:
                break
            join = getattr(trainer, "join_prep", None)
            if join is not None:
                join(left)
            else:               # opaque prep (test fakes): legacy sleep
                time.sleep(left)

    def _drain_prep_threads(self):
        """Join any context prep still running in the background, so no
        prep thread outlives the run inside a CUDA call. Speculative
        prefetch tickets are cancelled (pending) or awaited (running) the
        same way."""
        for job in self.jobs.values():
            join = getattr(job.trainer, "join_prep", None)
            if join is not None:
                join(120)
            else:
                t = getattr(job.trainer, "_prep_thread", None)
                if t is not None and t.is_alive():
                    t.join(timeout=120)
        if self.compile_service is not None:
            for jid, job in list(self.jobs.items()):
                # only jobs with no future stop speculating (_finish
                # already cancelled finished jobs' tickets); a live job's
                # pending prefetches build during the drain instead —
                # their handles land in the exec cache and run() is
                # re-enterable, so cancelling them would race the loop
                # exit against the worker pool and discard queued work
                if job.finish_time is not None or job.trainer is None:
                    self.compile_service.cancel_owner(("spec", jid))
            self.compile_service.drain(120)

    def _drain_checkpoints(self):
        """Land in-flight checkpoint saves at loop exit so parked state is
        durable and the final stats see every landed device as free. A save
        that is still not done after the wait timeout stays CHECKPOINTING —
        its devices remain accounted to the job, never leaked."""
        wait = getattr(self.checkpointer, "wait", None)
        if wait is not None:
            for job in list(self.checkpointing.values()):
                wait(job, 120.0)
        self._collect_checkpoints()

    def close(self):
        """Discard every job's on-disk checkpoint state. Checkpoint handles
        live only in this process, so once the executor will not be run()
        again nothing can ever re-admit a parked job — without this, runs
        ending with PREEMPTED jobs (or max_rounds exhaustion) leak
        full-model state dumps in the checkpoint root. run() itself stays
        re-enterable; call close() only when done with the executor.

        Idempotent: a second call (an explicit close followed by
        ``__del__``/atexit, or error-path cleanup after a failed run)
        returns immediately instead of re-draining the compile-service
        threads."""
        if self._closed:
            return
        self._closed = True
        if self.compile_service is not None:
            self.compile_service.shutdown()
        discard = getattr(self.checkpointer, "discard", None)
        if discard is None:
            return
        for job in self.jobs.values():
            if job.checkpoint is not None:
                discard(job)

    def __del__(self):
        # best-effort last-resort cleanup; anything can be missing at
        # interpreter shutdown (half-built executor, torn-down modules)
        try:
            self.close()
        except BaseException:
            pass

    # ------------------------------------------------------------- results
    def stats(self) -> dict:
        jcts = [j.finish_time - j.arrival for j in self.finished]
        out = {
            "policy": type(self.policy).__name__,
            "throughput_model": type(self.throughput_model).__name__,
            "n_gpus": self.n_gpus,
            "rounds": self.round,
            "profile_sweeps": sum(1 for e in self.events
                                  if e["op"] == "profile"),
            "finished": len(self.finished),
            "unfinished": len(self.jobs) - len(self.finished),
            "mean_jct": (sum(jcts) / len(jcts)) if jcts else None,
            "makespan": max((j.finish_time for j in self.finished),
                            default=None),
            # event "loaned" is in groups; the stat reports peak DEVICES on
            # loan so mixed-mp loans compare in one unit. Every event
            # carries its event-time mp (_event enforces it), so this is a
            # strict lookup — a silent mp=1 default would under-count an
            # mp>1 tenant's loan
            "max_loaned": max((e["loaned"] * e["mp"]
                               for e in self.events), default=0),
            "preemptions": sum(1 for e in self.events
                               if e["op"] == "preempt"),
            "readmissions": sum(1 for e in self.events
                                if e["op"] == "readmit"),
            "reshapes": sum(1 for e in self.events
                            if e["op"] == "reshape"),
            # fault-tolerance accounting (all zero on a fault-free run)
            "n_gpus_initial": self.n_gpus_initial,
            "capacity_lost": self.capacity_lost,
            "workers_killed": self.workers_killed,
            "devices_revoked": self.devices_revoked,
            "checkpoint_retries": self.ckpt_retry_total,
            "recoveries": len(self.recovery_latencies),
            "mean_recovery_latency_s": (
                round(sum(self.recovery_latencies) /
                      len(self.recovery_latencies), 4)
                if self.recovery_latencies else None),
            "faults_pending": (len(self.injector.pending)
                               if self.injector is not None else 0),
            "conserved": True,      # run() asserts it every round
            "compile_service": (self.compile_service.stats()
                                if self.compile_service is not None
                                else None),
            "jobs": [self.jobs[jid].summary() for jid in sorted(self.jobs)],
            "events": self.events,
        }
        # serving-tier SLO accounting (absent on training-only runs)
        serving = [j for j in self.jobs.values()
                   if getattr(j, "tier", "training") == "serving"]
        if serving:
            served = sum(j.rounds_served for j in serving)
            breaches = sum(j.slo_breaches for j in serving)
            out["rounds_served"] = served
            out["slo_breaches"] = breaches
            out["slo_attainment"] = (round(1.0 - breaches / served, 4)
                                     if served else None)
        return out
