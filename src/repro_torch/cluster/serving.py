"""Serving tenants: the cluster's second tenant class (Aryl-style tier).

A ``ServingJob`` is a replicated inference model whose allocation unit is
the same mp-sized device group training tenants use, but whose demand is
not a fixed ``requested_p`` — it is driven by a request-rate traffic
trace (``repro_torch.sched.traffic``) through a per-replica capacity, and its
health metric is a p99 wave latency against an SLO rather than a loss.

The tier composes with the existing executor machinery instead of
duplicating it:

- **Engines look like trainers.** A serving engine exposes the trainer
  surface the executor already drives (``step`` / ``grant_devices`` /
  ``release_devices`` / ``membership`` / ``handle_failure`` / ...), so
  grants, loans, reclaims, revocations, chaos kills and conservation
  asserts all work untouched. One ``step()`` = one scheduling round of
  request waves; its metrics carry ``p99_ms`` / ``slo_breach`` instead
  of a loss.
- **Preemption is stateless.** A replica holds no training state, so a
  0-replica target (or an infeasible survivor shape after a kill) parks
  the job WITHOUT a checkpoint: ``ServingJob.stateless`` makes the
  executor skip the checkpointer and return the devices immediately —
  the park/readmit state machine is otherwise identical.
- **Demand replays by rounds served** (``steps_done``), not wall clock:
  a parked or delayed tenant resumes the trace where it left off, so
  fake-level tests and fault replays are deterministic under scheduling
  jitter, and a parked job's spike demand is still visible to policies
  through ``desired_p``.

``SyntheticServingEngine`` is the deterministic fixed-wave-latency
engine (fake/chaos tests, simulator-grade benches); ``LiveServingEngine``
runs real ``serve_batch`` waves (repro_torch.core.serving) on the model
config and measures wave latency from wall clock. Unlike the reference's,
which leaves its arrays on JAX's default device, the live engine keeps its
params and prompts on the slot of its first replica and moves them when
that replica leaves.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import ClassVar

import torch

from repro_torch.cluster.job import ClusterJob, JobSpec
from repro_torch.core.membership import Membership
from repro_torch.core.scaling import Phase
from repro_torch.devices import Slot, resolve_device
from repro_torch.models.params import tree_map
from repro_torch.sched.traffic import replicas_for


@dataclasses.dataclass(frozen=True)
class ServingSpec(JobSpec):
    """One serving tenant. ``requested_p`` is its RESERVED replica count
    (grants above it are accounted as loans *to* the tenant, mirroring
    training loans); the instantaneous demand comes from ``trace``.

    ``trace`` holds request rates, one entry per served round, replayed
    modulo its length. ``replica_capacity`` is requests one replica
    serves per wave (0 -> ``global_batch``); demand at rate r is
    ``ceil(r / capacity)`` replicas clamped to
    [``min_replicas``, ``max_replicas``] (``max_replicas`` 0 -> bounded
    only by the pool; ``min_replicas`` 0 allows scale-to-zero through a
    stateless park). ``wave_ms`` is the synthetic engine's per-wave
    latency; the live engine measures it instead."""
    tier: ClassVar[str] = "serving"
    trace: tuple = (1.0,)
    slo_ms: float = 250.0
    replica_capacity: int = 0
    min_replicas: int = 1
    max_replicas: int = 0
    prompt_len: int = 8
    gen_len: int = 4
    wave_ms: float = 20.0

    def __post_init__(self):
        super().__post_init__()
        if not self.trace:
            raise ValueError(f"{self.name}: empty traffic trace")
        if min(self.trace) < 0:
            raise ValueError(f"{self.name}: negative request rate in trace")
        if self.slo_ms <= 0:
            raise ValueError(f"{self.name}: slo_ms must be > 0, "
                             f"got {self.slo_ms}")
        if self.wave_ms <= 0:
            raise ValueError(f"{self.name}: wave_ms must be > 0, "
                             f"got {self.wave_ms}")
        if self.min_replicas < 0 or self.max_replicas < 0:
            raise ValueError(f"{self.name}: replica bounds must be >= 0")
        if self.max_replicas and self.max_replicas < max(1,
                                                         self.min_replicas):
            raise ValueError(f"{self.name}: max_replicas "
                             f"{self.max_replicas} below min_replicas")
        if self.prompt_len < 1 or self.gen_len < 1:
            raise ValueError(f"{self.name}: prompt_len and gen_len must "
                             f"be >= 1")
        if self.mp_auto:
            raise ValueError(f"{self.name}: serving tenants are mp-rigid "
                             f"(a replica's group size is its model)")
        if self.virtual_workers:
            raise ValueError(f"{self.name}: virtual_workers is a training "
                             f"determinism knob; serving replicas are "
                             f"stateless")

    @property
    def capacity(self) -> int:
        """Requests one replica serves per wave."""
        return self.replica_capacity or self.global_batch

    def rate_at(self, k: int) -> float:
        """Request rate at served-round ``k`` (trace replays modulo)."""
        return self.trace[int(k) % len(self.trace)]

    def demand(self, k: int) -> int:
        """Replica demand at served-round ``k``: enough replicas to serve
        the rate in one wave, clamped to the tenant's bounds."""
        want = replicas_for(self.rate_at(k), self.capacity)
        want = max(self.min_replicas, want)
        if self.max_replicas:
            want = min(want, self.max_replicas)
        return want


class ServingJob(ClusterJob):
    """Executor-side serving tenant. Same policy-view surface as a
    training ``ClusterJob`` plus the serving extras policies key on:
    ``tier``, ``desired_p`` (trace-driven demand), ``stateless`` (no
    checkpoint on park), and SLO accounting (``slo_breaches`` /
    ``slo_attainment`` fed from engine step metrics)."""

    tier = "serving"
    stateless = True                # park without a checkpoint

    def __init__(self, jid: int, spec: ServingSpec):
        super().__init__(jid, spec)
        self.rounds_served = 0
        self.slo_breaches = 0
        self.last_p99_ms: float | None = None
        self._lull_round_seen: float | None = None

    def feasible_p(self, target: int) -> int:
        """Replicas are independent — any non-negative count is runnable
        (no batch-divisibility clamp); only the spec's max bound applies."""
        t = max(0, int(target))
        if self.spec.max_replicas:
            t = min(t, self.spec.max_replicas)
        return t

    def desired_p(self, now: float | None = None) -> int:
        """Current replica demand. Indexed by rounds SERVED, so a parked
        tenant still shows the demand of the next trace entry it will
        serve — that is what lets a spike pull a parked tenant back in.

        Scale-to-zero corner (``min_replicas=0``): a zero-rate entry
        needs no replicas, so a PARKED tenant consumes it as the cluster
        round passes (at most one entry per round, keyed on ``now`` so
        repeated policy calls in one round are idempotent) — otherwise
        the frozen trace index would hold the tenant hostage on a lull
        entry forever. A trace that ENDS in zero-rate entries therefore
        leaves the tenant parked rather than finished."""
        if (self.trainer is None and now is not None
                and now != self._lull_round_seen
                and self.steps_done < self.spec.total_steps
                and self.spec.demand(self.steps_done) == 0):
            self.steps_done += 1
            self._lull_round_seen = now
        return self.spec.demand(self.steps_done)

    def launch(self, devices: list, trainer_factory, *,
               mp: int | None = None):
        """Re-admission resumes the trace where the park left off: the
        fresh engine's wave counter starts at the rounds already served."""
        trainer = super().launch(devices, trainer_factory, mp=mp)
        if hasattr(trainer, "served_offset"):
            trainer.served_offset = self.steps_done
        return trainer

    def on_step(self, metrics: dict, now: float):
        super().on_step(metrics, now)
        self.rounds_served += 1
        if metrics.get("slo_breach"):
            self.slo_breaches += 1
        if metrics.get("p99_ms") is not None:
            self.last_p99_ms = float(metrics["p99_ms"])

    @property
    def slo_attainment(self) -> float | None:
        """Fraction of served rounds whose p99 met the SLO."""
        if not self.rounds_served:
            return None
        return 1.0 - self.slo_breaches / self.rounds_served

    def summary(self) -> dict:
        out = super().summary()
        out.update(tier="serving", rounds_served=self.rounds_served,
                   slo_breaches=self.slo_breaches,
                   slo_ms=self.spec.slo_ms,
                   slo_attainment=(None if self.slo_attainment is None
                                   else round(self.slo_attainment, 4)),
                   last_p99_ms=self.last_p99_ms)
        return out


class _IdleController:
    """Serving engines have no stop-free switch protocol — every resize
    commits instantly — so the scaling phase is permanently IDLE."""
    phase = Phase.IDLE


class ServingEngineBase:
    """Trainer-shaped replicated inference engine.

    Owns ``p = len(devices) // mp`` replicas; replica i holds devices
    ``[i*mp:(i+1)*mp]`` (the executor's positional worker<->group
    correspondence). Liveness rides the same ``Membership`` surface the
    elastic trainer uses, so chaos ``kill_worker`` and leader-side
    dead-worker detection work on serving replicas unchanged.

    ``step()`` serves one scheduling round: the tenant's trace rate is
    cleared in ``ceil(r / (p * capacity))`` sequential waves, so
    ``p99_ms = waves * wave_ms`` — under-provisioned replicas queue
    requests into extra waves and the tail latency breaches the SLO.
    Subclasses supply the wave latency (fixed or measured).
    """

    def __init__(self, spec: ServingSpec, devices: list):
        mp = spec.model_parallel
        assert devices and len(devices) % mp == 0, \
            f"{spec.name}: {len(devices)} devices at mp={mp}"
        self.spec = spec
        self.model_parallel = mp
        self.devices = list(devices)
        self.controller = _IdleController()
        self.on_devices_released = None
        self.injected_delay: dict = {}
        self._flagged_stragglers: list = []
        self.metrics_log: list = []
        self.step_count = 0             # waves-served rounds on THIS engine
        self.served_offset = 0          # trace position at launch (job side)
        self.step_idx = 0               # liveness clock for Membership
        self.failed_workers: set = set()
        self.membership = Membership()
        self._rebuild_membership()

    # -------------------------------------------------- trainer view surface
    @property
    def p(self) -> int:
        return len(self.devices) // self.model_parallel

    @property
    def global_batch(self) -> int:
        return self.spec.global_batch

    @property
    def worker_ids(self) -> list[str]:
        return [f"s{i}" for i in range(self.p)]

    def _rebuild_membership(self):
        self.membership = Membership()
        for i, wid in enumerate(self.worker_ids):
            self.membership.register(wid, i, at_step=self.step_idx)
        self.failed_workers &= set(self.worker_ids)

    # ------------------------------------------------------------- the round
    def _wave_ms(self, rate: float) -> float:
        raise NotImplementedError

    def step(self) -> dict:
        self.step_idx += 1
        for wid in self.worker_ids:
            if wid not in self.failed_workers:
                self.membership.sync(wid, self.step_idx, 0.0)
        k = self.served_offset + self.step_count
        rate = self.spec.rate_at(k)
        live = max(1, self.p - len(self.failed_workers))
        waves = int(math.ceil(rate / (live * self.spec.capacity))) \
            if rate > 0 else 0
        wave_ms = self._wave_ms(rate)
        p99 = waves * wave_ms
        breach = rate > 0 and p99 > self.spec.slo_ms
        self.step_count += 1
        m = {"step": self.step_count, "p": self.p,
             "step_time": waves * wave_ms / 1e3,
             "requests": rate, "waves": waves, "p99_ms": round(p99, 3),
             "slo_ms": self.spec.slo_ms, "slo_breach": breach}
        self.metrics_log.append(m)
        return m

    # ------------------------------------------------------ elasticity verbs
    def grant_devices(self, new_devices: list):
        assert len(new_devices) % self.model_parallel == 0
        self.devices.extend(new_devices)
        self._rebuild_membership()

    def release_devices(self, n: int):
        """Drop the last ``n`` replica groups instantly (stateless — no
        draining protocol) and hand their devices home."""
        assert 0 < n < self.p, f"release {n} of {self.p} replicas"
        freed = self.devices[-n * self.model_parallel:]
        self.devices = self.devices[:-n * self.model_parallel]
        self._rebuild_membership()
        if self.on_devices_released is not None:
            self.on_devices_released(self, list(freed))
        return list(freed)

    def scale_in(self, n: int):
        return self.release_devices(n)

    def wait_for_scaling(self):
        pass

    def migrate(self, *a, **kw):
        pass

    def throughput(self) -> float:
        """Requests served per round at the current replica count."""
        return self.p * self.spec.capacity

    # ------------------------------------------------------- failure surface
    def inject_worker_failure(self, wid: str):
        if wid not in self.worker_ids:
            raise LookupError(wid)
        self.failed_workers.add(wid)
        # ancient sync: detection fires as soon as the liveness window
        # passes, same as the chaos fake trainer
        self.membership.sync(wid, -10 ** 9, 0.0)

    def handle_failure(self, dead: list[str], *, release: bool = True,
                       block: bool = False):
        """Stop-free replica scale-in: drop the dead replicas, keep the
        survivors serving. Raises ValueError when no replica survives —
        the executor then parks the tenant (stateless) instead."""
        dead = [w for w in dead if w in self.worker_ids]
        if not dead:
            return
        target = self.p - len(dead)
        if target < 1:
            raise ValueError("no surviving replica")
        mp = self.model_parallel
        keep, freed = [], []
        for i, wid in enumerate(self.worker_ids):
            group = self.devices[i * mp:(i + 1) * mp]
            (freed if wid in dead else keep).extend(group)
        self.devices = keep
        self.failed_workers.clear()
        self._rebuild_membership()
        if release and self.on_devices_released is not None:
            self.on_devices_released(self, list(freed))
        return list(freed)


class SyntheticServingEngine(ServingEngineBase):
    """Deterministic engine: every wave takes exactly ``spec.wave_ms``.
    The fake/chaos suites and trace studies run on this — latency is a
    pure function of (trace, replicas), so assertions are exact."""

    def _wave_ms(self, rate: float) -> float:
        return self.spec.wave_ms


class LiveServingEngine(ServingEngineBase):
    """Real engine: serves one measured ``serve_batch`` wave per round on
    the tenant's model config and prices the round's p99 from it
    (queueing model: ``waves * measured_wave_ms``). One warm-up wave runs
    at construction (replica warm-up — model loading is a grant-time cost,
    not billed to request latency).

    The params (from a ``torch.Generator`` seeded with ``spec.seed``) and
    the prompts (``spec.seed + 1``) lie on the device of the first
    replica's slot (``devices.Slot.device``), and move with it when a
    release or a failure drops that replica. SMOKE width by default, as the
    reference's; ``smoke=False`` builds the full CONFIG."""

    def __init__(self, spec: ServingSpec, devices: list, *,
                 smoke: bool = True):
        if spec.model_parallel != 1:
            raise ValueError(f"{spec.name}: live serving replicas are "
                             f"single-device (mp=1)")
        super().__init__(spec, devices)
        from repro_torch.configs import get_config
        from repro_torch.core.serving import make_decode_fn, serve_batch
        from repro_torch.models import model as M

        self._cfg = get_config(spec.arch, smoke=smoke)
        self._decode = make_decode_fn(self._cfg)
        self._serve = serve_batch
        self._home = self._first_slot_device()
        self._params = M.init_params(
            self._cfg, torch.Generator().manual_seed(spec.seed), self._home)
        self._prompts = torch.randint(
            0, self._cfg.vocab, (spec.global_batch, spec.prompt_len),
            generator=torch.Generator().manual_seed(spec.seed + 1),
            dtype=torch.int32).to(self._home)
        self._serve(self._cfg, self._params, self._prompts, spec.gen_len,
                    decode=self._decode)      # warm-up wave
        self._last_wave_ms = spec.wave_ms

    def _first_slot_device(self) -> torch.device:
        d = self.devices[0]
        return d.device if isinstance(d, Slot) else resolve_device(d)

    def _follow_first_replica(self):
        """Move the params and prompts to the first replica's slot when it
        changed."""
        home = self._first_slot_device()
        if home != self._home:
            self._params = tree_map(lambda t: t.to(home), self._params)
            self._prompts = self._prompts.to(home)
            self._home = home

    def release_devices(self, n: int):
        freed = super().release_devices(n)
        self._follow_first_replica()
        return freed

    def handle_failure(self, dead: list[str], *, release: bool = True,
                       block: bool = False):
        freed = super().handle_failure(dead, release=release, block=block)
        self._follow_first_replica()
        return freed

    def _wave_ms(self, rate: float) -> float:
        if rate <= 0:
            return self._last_wave_ms
        t0 = time.monotonic()
        self._serve(self._cfg, self._params, self._prompts,
                    self.spec.gen_len, decode=self._decode)
        self._last_wave_ms = max(1e-3, (time.monotonic() - t0) * 1e3)
        return self._last_wave_ms


def make_serving_engine(spec: ServingSpec, devices: list,
                        *, smoke: bool = True):
    """Engine factory the executor's default trainer factory dispatches
    to for serving-tier specs: the live engine, ``smoke`` its width. A
    caller that wants the synthetic engine builds it directly."""
    return LiveServingEngine(spec, devices, smoke=smoke)
