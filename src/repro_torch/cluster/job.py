"""Cluster-level job objects: the executor's unit of scheduling.

``JobSpec`` is what a tenant submits; ``ClusterJob`` wraps the spec plus the
live ``ElasticTrainer`` (created lazily when the job is first admitted) and
exposes the scheduling-view attributes (repro_torch.sched.base) so the same
policy objects that drive the discrete-event simulator drive live jobs.

Preemption state machine (driven by the executor)::

    PENDING ──launch──▶ RUNNING ──begin_checkpoint──▶ CHECKPOINTING
                          ▲                                │
                          │                              park
                       launch                              ▼
                    (re-admission,                     PREEMPTED
                  restore from ckpt) ◀─────────────────────┘
    RUNNING ──finish──▶ FINISHED

A CHECKPOINTING job still OWNS its devices (they stay in the trainer's pool
until the checkpoint save lands, keeping cluster-wide device conservation
exact); a PREEMPTED job owns nothing but keeps its checkpoint handle, its
accumulated ``steps_done`` / ``attained_gpu_s``, and its original arrival
time — so re-admission priority and Tiresias service accounting survive the
round trip through disk.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import ClassVar


def feasible_parallelism(global_batch: int, target: int,
                         n_virtual: int = 0) -> int:
    """Largest parallelism <= target the live trainer can actually run at
    (the global batch must divide evenly across the data-parallel
    replicas — ``target`` is in GROUPS, not devices); 0 when target < 1.
    Deterministic tenants additionally require p to divide their fixed
    virtual-worker count ``n_virtual`` (contiguous equal blocks at every
    shape). The ONE implementation of the feasibility clamp — ClusterJob,
    workload spec synthesis, and anything sizing grants all share it."""
    if target < 1:
        return 0
    p = target
    while global_batch % p or (n_virtual and n_virtual % p):
        p -= 1
    return p


class JobState(enum.Enum):
    PENDING = "pending"             # arrived, never launched
    RUNNING = "running"             # live trainer stepping
    CHECKPOINTING = "checkpointing"  # preempted; save in flight, owns devices
    PREEMPTED = "preempted"         # parked on disk, re-admittable demand
    FINISHED = "finished"


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant's elastic training job.

    ``requested_p`` is in device GROUPS (data-parallel replicas);
    ``model_parallel`` is the devices-per-group size — the model axis of
    the trainer's 2-D ``(data, model)`` mesh. The executor grants,
    reclaims, loans and preempts whole groups: an mp=2 tenant at p
    replicas owns ``2 p`` devices. ``profile`` names an analytic scaling
    profile in repro_torch.sched.throughput.PROFILES — the *prior* the
    executor's ThroughputModel starts from (a MeasuredModel overrides it
    per-job as live observations and profiling sweeps land); the actual
    training workload is the (transformer) ``arch`` config.

    ``tier`` distinguishes tenant classes: training specs build
    ``ClusterJob`` + ``ElasticTrainer``; serving specs
    (``repro_torch.cluster.serving.ServingSpec``, tier "serving") build
    ``ServingJob`` + a replicated inference engine.
    """
    tier: ClassVar[str] = "training"
    name: str
    requested_p: int
    total_steps: int
    profile: str = "resnet50"
    arch: str = "edl-paper"
    global_batch: int = 12
    seq_len: int = 64
    arrival: float = 0.0        # executor-clock units (scheduling rounds)
    inelastic: bool = False
    model_parallel: int = 1     # devices per group (the mesh's model axis)
    # mp=auto (spec grammar ``:mp=auto``): the tenant does not pin its
    # model-parallel degree — policies may RESHAPE it live, trading
    # data-parallel for model-parallel (``model_parallel`` is then only
    # the launch shape). Rigid tenants keep their degree for life.
    mp_auto: bool = False
    lr: float = 1e-3
    n_samples: int = 1 << 10
    d_partitions: int = 16
    seed: int = 0
    # deterministic elasticity (spec grammar ``:vw=K`` or ``:vw=auto``):
    # a fixed virtual-worker count decouples the trajectory from the
    # physical shape — every resize/reshape/preemption the scheduler
    # applies leaves the tenant's loss trajectory bitwise-identical to the
    # fixed-shape run. 0 disables (dynamic pipeline); "auto" sizes it to
    # the max feasible dp of the launch device set — preemptible tenants
    # should pin an explicit K instead (a re-admission may launch on a
    # different pool, and the checkpoint restore enforces the same K).
    virtual_workers: int | str = 0

    def __post_init__(self):
        if self.model_parallel < 1:
            raise ValueError(f"{self.name}: model_parallel must be >= 1, "
                             f"got {self.model_parallel}")
        if self.requested_p < 1:
            raise ValueError(f"{self.name}: requested_p must be >= 1, "
                             f"got {self.requested_p}")
        # reject an infeasible vw at SUBMISSION, not at launch deep inside
        # the executor's scheduling round
        vw = self.virtual_workers
        if isinstance(vw, str):
            if vw != "auto":
                raise ValueError(f"{self.name}: virtual_workers must be an "
                                 f"int or 'auto', got {vw!r}")
        elif vw < 0:
            raise ValueError(f"{self.name}: virtual_workers must be >= 0, "
                             f"got {vw}")
        elif vw and self.global_batch % vw:
            raise ValueError(f"{self.name}: global batch "
                             f"{self.global_batch} not divisible by "
                             f"virtual_workers={vw}")


class ClusterJob:
    """Executor-side state of one job. Satisfies the policy view protocol
    (jid/model/requested_p/arrival/inelastic/attained_gpu_s/alloc/
    start_time/finish_time)."""

    tier = "training"      # serving tenants override (ServingJob)
    stateless = False      # True -> park without a checkpoint

    def __init__(self, jid: int, spec: JobSpec):
        self.jid = jid
        self.spec = spec
        self.trainer = None
        self._mp = spec.model_parallel  # live degree while no trainer exists
        self.state = JobState.PENDING
        self.steps_done = 0
        self.attained_gpu_s = 0.0       # Tiresias service metric
        self.start_time: float | None = None
        self.finish_time: float | None = None
        self.n_migrations = 0
        self.n_preemptions = 0
        self.n_reshapes = 0
        self.checkpoint = None          # opaque handle (dir path on disk)
        self.last_loss: float | None = None
        self.last_step: int | None = None
        self._ckpt_thread = None        # set by the executor's checkpointer

    # ------------------------------------------------- policy view protocol
    @property
    def model(self) -> str:
        return self.spec.profile

    @property
    def requested_p(self) -> int:
        return self.spec.requested_p

    @property
    def arrival(self) -> float:
        return self.spec.arrival

    @property
    def inelastic(self) -> bool:
        return self.spec.inelastic

    @property
    def mp(self) -> int:
        """Devices per allocation group (sched.base.group_size) — the
        job's LIVE model-parallel degree. Follows the trainer across
        RESHAPE commits; a parked job remembers the shape it last ran at
        (its checkpoint restores onto any shape regardless)."""
        if self.trainer is not None:
            return int(getattr(self.trainer, "model_parallel",
                               self._mp) or self._mp)
        return self._mp

    @property
    def mp_auto(self) -> bool:
        """May policies re-target this job's model-parallel degree?"""
        return self.spec.mp_auto

    @property
    def requested_mp(self) -> int:
        """The degree ``requested_p`` was quoted at (the submitted shape) —
        ``requested_p * requested_mp`` is the job's requested DEVICES no
        matter what shape it currently runs at."""
        return self.spec.model_parallel

    @property
    def devices_held(self) -> int:
        """Devices this job currently OWNS (its whole pool — during an
        in-flight release OR an in-flight preemption checkpoint they still
        count here until the switch commits / the save lands, which is what
        keeps cluster-wide conservation exact)."""
        return len(self.trainer.devices) if self.trainer is not None else 0

    @property
    def alloc(self) -> int:
        """Allocation in GROUPS (data-parallel replicas) — the unit every
        policy reasons in. ``devices_held`` is the device-denominated twin
        the conservation assert counts."""
        return self.devices_held // self.mp

    @property
    def remaining_steps(self) -> int:
        return max(0, self.spec.total_steps - self.steps_done)

    # ------------------------------------------------------------ lifecycle
    def launch(self, devices: list, trainer_factory, *,
               mp: int | None = None):
        """Build the live trainer on ``devices`` (a whole number of
        mp-sized groups). Used both for first admission and for
        re-admission after a preemption (the executor restores the
        checkpoint into the fresh trainer right after). ``mp`` overrides
        the launch shape for mp=auto tenants — a re-admission may restore
        onto a DIFFERENT model-parallel degree than the checkpoint was
        written with (the factory sees a spec with the chosen degree; the
        submitted spec is untouched)."""
        assert self.trainer is None, f"{self.spec.name} already launched"
        assert self.state in (JobState.PENDING, JobState.PREEMPTED), \
            f"cannot launch from {self.state}"
        mp = int(mp) if mp else self.spec.model_parallel
        assert mp == self.spec.model_parallel or self.spec.mp_auto, \
            f"{self.spec.name} is mp-rigid; cannot launch at mp={mp}"
        assert len(devices) % mp == 0, \
            (f"{self.spec.name}: {len(devices)} devices is not a whole "
             f"number of mp={mp} groups")
        spec = (self.spec if mp == self.spec.model_parallel else
                dataclasses.replace(self.spec, model_parallel=mp))
        self._mp = mp
        self.trainer = trainer_factory(spec, list(devices))
        self.state = JobState.RUNNING
        return self.trainer

    def begin_checkpoint(self):
        """RUNNING -> CHECKPOINTING: the job stops stepping; its devices
        stay in the trainer's pool until the save lands."""
        assert self.state is JobState.RUNNING, self.state
        self.state = JobState.CHECKPOINTING

    def park(self):
        """CHECKPOINTING -> PREEMPTED: the save landed and the trainer was
        torn down; the job owns nothing but its checkpoint handle (and the
        memory of the shape it last ran at)."""
        assert self.state is JobState.CHECKPOINTING, self.state
        self._mp = self.mp
        self.trainer = None
        self.state = JobState.PREEMPTED
        self.n_preemptions += 1

    def feasible_p(self, target: int) -> int:
        """Largest group count <= target the job can actually run at (the
        global batch must divide across the replicas; a deterministic
        tenant's p must also divide its virtual-worker count). 0 means
        full preemption: the executor checkpoint-stops the job and
        re-admits it later."""
        nv = self.spec.virtual_workers
        if self.trainer is not None:
            nv = getattr(self.trainer, "n_virtual", 0)
        return feasible_parallelism(self.spec.global_batch, target,
                                    nv if isinstance(nv, int) else 0)

    def on_step(self, metrics: dict, now: float):
        if self.start_time is None:
            self.start_time = now
        self.steps_done += 1
        # Tiresias service is DEVICE-seconds (an mp=2 group burns 2x)
        self.attained_gpu_s += self.devices_held * metrics.get("step_time",
                                                               0.0)
        self.last_loss = metrics.get("loss")
        self.last_step = metrics.get("step")

    def summary(self) -> dict:
        return {
            "name": self.spec.name, "jid": self.jid,
            "profile": self.spec.profile,
            "state": self.state.value,
            "requested_p": self.spec.requested_p,
            "model_parallel": self.spec.model_parallel,
            "mp_now": self.mp,
            "mp_auto": self.spec.mp_auto,
            "steps_done": self.steps_done,
            "attained_gpu_s": round(self.attained_gpu_s, 3),
            "arrival": self.arrival, "start": self.start_time,
            "finish": self.finish_time,
            "jct": (None if self.finish_time is None
                    else self.finish_time - self.arrival),
            "final_loss": self.last_loss,
            "final_step": self.last_step,
            "migrations": self.n_migrations,
            "preemptions": self.n_preemptions,
            "reshapes": self.n_reshapes,
        }


def make_cluster_job(jid: int, spec: JobSpec) -> ClusterJob:
    """Build the executor-side job object for ``spec``, dispatching on the
    spec's tenant tier (lazy import: serving is optional machinery the
    training-only paths never pay for)."""
    if getattr(spec, "tier", "training") == "serving":
        from repro_torch.cluster.serving import ServingJob
        return ServingJob(jid, spec)
    return ClusterJob(jid, spec)
