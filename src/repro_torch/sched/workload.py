"""Workload generators.

* ``synthetic_16()`` — the paper's §6.3 synthetic workload: one 4-GPU job
  submitted every 30 s until 16 jobs, models drawn from the tf_cnn_benchmarks
  pool; cluster of 32 GPUs.
* ``philly_like()`` — a Philly-trace-shaped workload (the real Microsoft
  trace is not redistributable/offline): job sizes follow the paper's
  reported distribution (20th pct 85 GPU*s, 90th pct 58,330 GPU*s — a
  log-normal fit), Poisson arrivals with a diurnal load factor, GPU counts
  in {1,2,4,8,16} skewed small. Documented in EXPERIMENTS.md.
* ``to_cluster_specs()`` — map either trace onto LIVE executor JobSpecs
  (service in mini-batch steps, arrivals in scheduling rounds), so the
  arrival patterns that previously only fed the simulator drive real
  ElasticTrainers through ``repro_torch.launch.cluster --workload``.

Job sizing uses the same pluggable ThroughputModel the schedulers consume
(``model=`` parameter; default analytic), so a workload scaled for an
analytic t(p) and the policies scheduling it agree on units.

Both generators take ``mp_choices`` — a tuple of model-parallel degrees
drawn per job — to synthesize MIXED-mp tenant populations (the
multi-dimensional packing scenario): with ``mp_choices=(1, 2)`` roughly
half the tenants demand 2-device groups, and ``to_cluster_specs`` carries
the drawn mp onto the live ``JobSpec.model_parallel``. The choice
``"auto"`` draws an mp=AUTO tenant instead — it launches data-parallel
but policies may RESHAPE its degree live (``JobSpec.mp_auto``), so
``mp_choices=(1, "auto")`` yields a population where roughly half the
tenants are reparallelizable.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sched.simulator import Job
from repro_torch.sched.throughput import PROFILES, ThroughputModel, default_model

MODELS = list(PROFILES)


def _draw_mp(rng, mp_choices) -> tuple[int, bool]:
    """One (mp, mp_auto) draw. No rng stream is consumed for a
    single-choice tuple — the golden simulator regressions pin the
    pre-group random stream bit-for-bit."""
    choice = (mp_choices[rng.integers(len(mp_choices))]
              if len(mp_choices) > 1 else mp_choices[0])
    if choice == "auto":
        return 1, True
    return int(choice), False


def synthetic_16(*, seed: int = 0, n_jobs: int = 16, interval: float = 30.0,
                 default_p: int = 4, mp_choices: tuple[int | str, ...] = (1,),
                 model: ThroughputModel | None = None) -> list[Job]:
    tm = model or default_model()
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n_jobs):
        name = MODELS[rng.integers(len(MODELS))]
        # ~6 minutes of work at the default parallelism
        samples = tm.throughput(name, default_p) * rng.uniform(240, 480)
        mp, auto = _draw_mp(rng, mp_choices)
        jobs.append(Job(i, name, default_p, samples, arrival=i * interval,
                        mp=mp, mp_auto=auto))
    return jobs


def philly_like(*, seed: int = 0, n_jobs: int = 400, mean_iat: float = 18.0,
                mp_choices: tuple[int | str, ...] = (1,),
                model: ThroughputModel | None = None) -> list[Job]:
    tm = model or default_model()
    rng = np.random.default_rng(seed)
    # log-normal GPU*s job sizes: 20th pct ~ 85, 90th pct ~ 58,330
    # solve: mu + 0.8416 s... ln(85)=4.44 at z=-0.8416; ln(58330)=10.97 at
    # z=1.2816 -> s = (10.97-4.44)/2.123 = 3.075; mu = 4.44 + 0.8416*3.075
    s, mu = 3.075, 7.03
    jobs, t = [], 0.0
    for i in range(n_jobs):
        t += rng.exponential(mean_iat) * (0.5 + abs(np.sin(t / 7200.0)))
        gpu_seconds = float(np.exp(mu + s * rng.standard_normal()))
        gpu_seconds = float(np.clip(gpu_seconds, 30.0, 4e6))
        p = int(rng.choice([1, 1, 1, 2, 2, 4, 4, 8, 16],
                           p=[.3, .15, .1, .15, .1, .08, .06, .04, .02]))
        name = MODELS[rng.integers(len(MODELS))]
        samples = tm.throughput(name, p) * (gpu_seconds / p)
        mp, auto = _draw_mp(rng, mp_choices)
        jobs.append(Job(i, name, p, samples, arrival=t, mp=mp,
                        mp_auto=auto))
    return jobs


def to_cluster_specs(jobs: list[Job], *, devices: int = 4, batch: int = 12,
                     steps: tuple[int, int] = (4, 20), seq_len: int = 64,
                     n_samples: int = 1 << 10, d_partitions: int = 16,
                     arrival_scale: float | None = None,
                     model: ThroughputModel | None = None) -> list:
    """Rescale simulator Jobs onto live-executor JobSpecs.

    Trace shape is preserved, magnitudes are not: per-job service time
    (samples / t(requested_p), in trace seconds) maps log-linearly onto the
    ``steps`` range of real mini-batches, arrivals map onto scheduling
    rounds (``arrival_scale`` trace-seconds per round; default spreads the
    trace over ~2 rounds per job), and requested parallelism is clipped to
    the device pool and the global-batch divisibility the trainer enforces.

    A trace job's model-parallel degree (``Job.mp``) survives onto the
    spec: the requested GROUP count is clipped so ``p * mp`` fits the
    pool, and an mp too large for the pool degrades to 1 (the tenant runs
    data-parallel rather than being unrunnable).
    """
    from repro_torch.cluster.job import JobSpec, feasible_parallelism
    tm = model or default_model()
    lo, hi = steps
    service = [j.total_samples / max(tm.throughput(j.model,
                                                   max(1, j.requested_p)),
                                     1e-9) for j in jobs]
    lsvc = np.log(np.maximum(service, 1e-9))
    lmin, lmax = float(lsvc.min()), float(lsvc.max())
    t0 = min(j.arrival for j in jobs)
    if arrival_scale is None:
        span = max(j.arrival for j in jobs) - t0
        arrival_scale = max(span / (2.0 * max(len(jobs) - 1, 1)), 1e-9)
    specs = []
    for j, ls in zip(jobs, lsvc):
        z = 0.0 if lmax <= lmin else (float(ls) - lmin) / (lmax - lmin)
        mp = j.mp if 1 <= j.mp <= devices else 1
        specs.append(JobSpec(
            name=f"j{j.jid}", profile=j.model,
            requested_p=feasible_parallelism(
                batch, max(1, min(j.requested_p, devices // mp))),
            total_steps=int(round(lo + z * (hi - lo))),
            arrival=round(float(j.arrival - t0) / arrival_scale, 2),
            inelastic=j.inelastic, model_parallel=mp,
            mp_auto=getattr(j, "mp_auto", False), global_batch=batch,
            seq_len=seq_len, n_samples=n_samples,
            d_partitions=d_partitions, seed=j.jid))
    return specs
