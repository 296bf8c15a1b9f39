"""The port's serving tier (``repro_torch.cluster.serving``) against the
reference's: twins of ``tests/test_serving.py`` and of the serving cases of
``tests/test_chaos.py``.

Each executor scenario runs in both packages, each with its own executor,
policies and ``SyntheticServingEngine`` beside the reference suites' fake
trainer bound to that package's ``Phase`` and ``Membership`` (as
``test_torch_cluster.py`` binds it). The reference test's assertions are
made on the port's run, and its ``events`` and ``stats()`` must be ``==``
the reference's, leaving out only the wall-clock recovery latencies. The
live twin runs ``python -m repro_torch.launch.cluster --device cpu`` with
SMOKE models on the reference's trace.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import pytest

pytest.importorskip("torch")

import repro.cluster.job as ref_job
import repro.cluster.serving as ref_serving
import repro.launch.cluster as ref_launch
import repro.sched.base as ref_sched_base
import repro.sched.serving as ref_sched_serving
import repro.sched.simulator as ref_simulator
import repro.sched.traffic as ref_traffic
import repro_torch.cluster.job as port_job
import repro_torch.cluster.serving as port_serving
import repro_torch.launch.cluster as port_launch
import repro_torch.sched.base as port_sched_base
import repro_torch.sched.serving as port_sched_serving
import repro_torch.sched.simulator as port_simulator
import repro_torch.sched.traffic as port_traffic
from test_cluster import FakeCheckpointer, FakeTrainer, _find
from test_torch_cluster import PORT as PORT_CLUSTER
from test_torch_cluster import REF as REF_CLUSTER
from test_torch_cluster import fake_for, without_wall_clock

ROOT = os.path.join(os.path.dirname(__file__), "..")


def package(base, serving, job, sched_base, sched_serving, simulator,
            traffic, launch):
    """``test_torch_cluster``'s namespace of one package, with its serving
    tier added."""
    return types.SimpleNamespace(
        **vars(base), ServingSpec=serving.ServingSpec,
        ServingJob=serving.ServingJob,
        SyntheticServingEngine=serving.SyntheticServingEngine,
        make_cluster_job=job.make_cluster_job, JobState=job.JobState,
        reserve_serving=sched_base.reserve_serving,
        CrossTierPolicy=sched_serving.CrossTierPolicy, SimJob=simulator.Job,
        traffic=traffic, parse_jobs=launch.parse_jobs)


REF = package(REF_CLUSTER, ref_serving, ref_job, ref_sched_base,
              ref_sched_serving, ref_simulator, ref_traffic, ref_launch)
PORT = package(PORT_CLUSTER, port_serving, port_job, port_sched_base,
               port_sched_serving, port_simulator, port_traffic, port_launch)


# --------------------------------------------------------------- fake layer
def plain_fake_for(pkg):
    """The reference's ``FakeTrainer``, its controller's phase taken from
    ``pkg``."""
    class Controller:
        phase = pkg.Phase.IDLE

    class Fake(FakeTrainer):
        def __init__(self, spec, devices):
            super().__init__(spec, devices)
            self.controller = Controller()
    return Fake


def serving_factory(pkg, *, chaos=False):
    """Tier dispatch mirroring the executor's default factory: serving
    specs get ``pkg``'s synthetic engine, training specs the fake (the
    chaos fake, with its liveness surface, for fault runs)."""
    training = fake_for(pkg) if chaos else plain_fake_for(pkg)

    def factory(spec, devices):
        if getattr(spec, "tier", "training") == "serving":
            return pkg.SyntheticServingEngine(spec, devices)
        return training(spec, devices)
    return factory


def executor(pkg, specs, policy, *, devices=4, resched_every=2,
             faults=None):
    return pkg.ClusterExecutor(
        specs, policy, devices=list(range(devices)),
        resched_every=resched_every,
        trainer_factory=serving_factory(pkg, chaos=faults is not None),
        checkpointer=FakeCheckpointer(), faults=faults)


def run_twins(scenario, *, by_round=False, rounds=60, observe=None):
    """Run the executor ``scenario(pkg)`` builds in both packages for
    ``rounds``; with ``by_round`` one round at a time, the ledger asserted
    and ``observe(ex)`` called on the port's after each, stopping once the
    serving tenant finishes. The ``events`` and ``stats()`` must be
    ``==``. Returns the port's executor and stats."""
    runs = []
    for pkg in (REF, PORT):
        ex = scenario(pkg)
        if by_round:
            while ex.round < rounds and \
                    ex.jobs[0].state is not pkg.JobState.FINISHED:
                ex.run(max_rounds=ex.round + 1)
                _assert_ledger(ex)
                if observe is not None and pkg is PORT:
                    observe(ex)
            stats = ex.stats()
        else:
            stats = ex.run(max_rounds=rounds)
        runs.append((ex, without_wall_clock(
            {"events": ex.events, "stats": stats})))
    (_, want), (ex, got) = runs
    assert want["events"]
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
    return ex, ex.stats()


def _assert_ledger(ex):
    """Every device is in exactly one place."""
    live = sum(j.devices_held for j in ex.jobs.values())
    assert live + len(ex.free) == ex.n_gpus, \
        f"leak: {live} held + {len(ex.free)} free != {ex.n_gpus}"


# --------------------------------------------------------- trace synthesis
def test_traffic_synthesis_is_deterministic_and_bounded():
    t = PORT.traffic
    assert t.flat(5, rate=3.0) == (3.0,) * 5
    d = t.diurnal(24, period=24, base=2.0, peak=10.0)
    assert d == REF.traffic.diurnal(24, period=24, base=2.0, peak=10.0)
    assert d[0] == pytest.approx(2.0)
    assert max(d) == pytest.approx(10.0) and min(d) >= 2.0 - 1e-9
    n = t.diurnal(24, period=24, base=2.0, peak=10.0, noise=0.2, seed=7)
    assert n != d and n == REF.traffic.diurnal(24, period=24, base=2.0,
                                               peak=10.0, noise=0.2, seed=7)
    assert min(n) >= 0.0
    s = t.spike(10, at=3, width=2, base=1.0, peak=9.0)
    assert s == (1.0, 1.0, 1.0, 9.0, 9.0, 1.0, 1.0, 1.0, 1.0, 1.0)
    for bad in (lambda: t.flat(0), lambda: t.diurnal(8, period=1),
                lambda: t.diurnal(8, base=5.0, peak=1.0),
                lambda: t.spike(8, width=0)):
        with pytest.raises(ValueError):
            bad()


def test_parse_trace_literals_kinds_and_errors():
    t = PORT.traffic
    assert t.parse_trace("4/8/12", rounds=99) == (4.0, 8.0, 12.0)
    assert t.parse_trace("5", rounds=99) == (5.0,)
    assert t.parse_trace("diurnal", rounds=8, period=4, base=1.0,
                         peak=9.0) == REF.traffic.diurnal(
        8, period=4, base=1.0, peak=9.0)
    assert t.parse_trace("flat", rounds=3, rate=2.0) == (2.0, 2.0, 2.0)
    with pytest.raises(ValueError, match="unknown trace"):
        t.parse_trace("sawtooth", rounds=8)


def test_replicas_for_arithmetic():
    r = PORT.traffic.replicas_for
    assert [r(x, 4) for x in (0.0, 4.0, 4.1, 12.0)] == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        r(1.0, 0)


# ------------------------------------------------------------ spec + demand
def test_serving_spec_validation_and_demand_clamps():
    S = PORT.ServingSpec
    kw = dict(trace=(0.0, 4.0, 9.0, 40.0), replica_capacity=4,
              min_replicas=1, max_replicas=3)
    s = S("api", 2, 20, **kw)
    assert dataclasses.asdict(s) == dataclasses.asdict(
        REF.ServingSpec("api", 2, 20, **kw))
    assert s.tier == "serving" and s.capacity == 4
    assert [s.demand(k) for k in range(4)] == [1, 1, 3, 3]
    assert s.rate_at(5) == 4.0
    nocap = S("api", 1, 5, trace=(6.0,))
    assert nocap.capacity == nocap.global_batch
    for match, bad in (("empty", dict(trace=())),
                       ("negative", dict(trace=(1.0, -2.0))),
                       ("slo_ms", dict(trace=(1.0,), slo_ms=0)),
                       ("wave_ms", dict(trace=(1.0,), wave_ms=-1)),
                       ("max_replicas", dict(trace=(1.0,), min_replicas=3,
                                             max_replicas=2)),
                       ("mp-rigid", dict(trace=(1.0,), mp_auto=True)),
                       ("virtual_workers", dict(trace=(1.0,),
                                                virtual_workers=4))):
        with pytest.raises(ValueError, match=match):
            S("api", 1, 5, **bad)


def test_serving_job_feasible_p_is_a_pure_clamp():
    job = PORT.make_cluster_job(0, PORT.ServingSpec(
        "api", 1, 5, trace=(8.0,), replica_capacity=4, global_batch=12,
        max_replicas=3))
    assert isinstance(job, PORT.ServingJob)
    assert [job.feasible_p(t) for t in (-1, 0, 1, 5, 99)] == [0, 0, 1, 3, 3]
    assert job.desired_p(0.0) == 2


# ------------------------------------------------------------ engine units
def test_engine_wave_latency_arithmetic():
    def run(pkg):
        spec = pkg.ServingSpec("api", 1, 10, trace=(8.0, 12.0, 0.0),
                               replica_capacity=4, wave_ms=20.0,
                               slo_ms=50.0)
        two = pkg.SyntheticServingEngine(spec, [0, 1])
        one = pkg.SyntheticServingEngine(spec, [0])
        return [two.step()] + [one.step() for _ in range(3)], \
            (one.throughput(), two.throughput())
    (m2, m0, m1, mz), thr = run(PORT)
    assert ([m2, m0, m1, mz], thr) == run(REF)
    assert (m2["waves"], m2["p99_ms"], m2["slo_breach"]) == (1, 20.0, False)
    assert (m0["waves"], m0["p99_ms"], m0["slo_breach"]) == (2, 40.0, False)
    assert (m1["waves"], m1["p99_ms"], m1["slo_breach"]) == (3, 60.0, True)
    assert (mz["waves"], mz["p99_ms"], mz["slo_breach"]) == (0, 0.0, False)
    assert thr == (4, 8)


def test_engine_failure_surface_partitions_whole_groups():
    spec = PORT.ServingSpec("api", 1, 10, trace=(4.0,), replica_capacity=4,
                            model_parallel=2)
    eng = PORT.SyntheticServingEngine(spec, [0, 1, 2, 3])
    assert eng.p == 2 and eng.worker_ids == ["s0", "s1"]
    with pytest.raises(LookupError):
        eng.inject_worker_failure("s9")
    eng.inject_worker_failure("s0")
    eng.step()
    assert eng.membership.dead_workers(eng.step_idx) == ["s0"]
    freed = eng.handle_failure(["s0"])
    assert freed == [0, 1] and eng.devices == [2, 3] and eng.p == 1
    assert not eng.failed_workers
    with pytest.raises(ValueError, match="no surviving replica"):
        eng.handle_failure(["s0"])
    with pytest.raises(AssertionError):
        eng.release_devices(1)


# ------------------------------------------------------- autoscale vs trace
def test_autoscale_follows_the_trace():
    trace = (4.0,) * 4 + (8.0,) * 4 + (12.0,) * 4 + (8.0,) * 4 + (4.0,) * 4
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, len(trace), trace=trace,
                              replica_capacity=4, wave_ms=20.0)],
        pkg.MaxThroughput()))
    job = ex.jobs[0]
    assert job.state is PORT.JobState.FINISHED and job.rounds_served == 20
    peaks = [m["p"] for m in job.trainer.metrics_log]
    assert max(peaks) == 3 and peaks[0] == 1 and peaks[-1] == 1
    assert _find(stats["events"], "scale_out", "api") and \
        _find(stats["events"], "scale_in", "api")
    assert stats["slo_attainment"] == 1.0 and stats["slo_breaches"] == 0
    assert stats["rounds_served"] == 20 and stats["conserved"]


def test_lull_loans_to_training_and_spike_reclaims_bounded():
    """Round by round, conservation every round: the lull loans the
    serving tier's idle slots to the trainer, and the spike reclaims every
    loaned group within one reschedule period plus the commit round,
    stop-free, the reclaim funding the serving scale-out."""
    seen = {"loan": None, "spike": None, "reclaimed": None}

    def observe(ex):
        api, t = ex.jobs[0], ex.jobs[1]
        if api.steps_done < 8:
            if t.alloc > t.requested_p:
                seen["loan"] = ex.round
        elif seen["spike"] is None:
            seen["spike"] = ex.round
        if seen["spike"] is not None and seen["reclaimed"] is None \
                and api.alloc == 3 and t.alloc <= t.requested_p:
            seen["reclaimed"] = ex.round

    def scenario(pkg):
        spec = pkg.ServingSpec("api", 1, 24, trace=(4.0,) * 8 + (12.0,) * 16,
                               replica_capacity=4, wave_ms=20.0)
        return executor(pkg, [spec, pkg.JobSpec("t", 1, 500,
                                                profile="resnet50")],
                        pkg.MaxThroughput())
    ex, _ = run_twins(scenario, by_round=True, rounds=60, observe=observe)
    api, t = ex.jobs[0], ex.jobs[1]
    assert seen["loan"] is not None
    assert seen["spike"] is not None and seen["reclaimed"] is not None
    assert seen["reclaimed"] - seen["spike"] <= 2 * ex.resched_every + 1
    sin = _find(ex.events, "scale_in", "t")
    grow = [e for e in _find(ex.events, "scale_out", "api")
            if e["to_p"] == 3]
    assert sin and grow and ex.events.index(sin[0]) < \
        ex.events.index(grow[0])
    assert not _find(ex.events, "preempt", "t")
    steps = [m["step"] for m in t.trainer.metrics_log]
    assert steps == list(range(steps[0], steps[0] + len(steps)))
    assert api.slo_breaches == 0 and api.rounds_served == 24


def test_slo_breach_events_stop_once_capacity_arrives():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, 20, trace=(4.0,) * 2 + (12.0,) * 18,
                              replica_capacity=4, wave_ms=20.0,
                              slo_ms=50.0)],
        pkg.ScriptedPolicy({0: {0: 1}, 12: {0: 3}})), rounds=40)
    job = ex.jobs[0]
    assert job.state is PORT.JobState.FINISHED
    breaches = [e for e in stats["events"] if e["op"] == "slo_breach"]
    assert breaches and all(e["p99_ms"] == 60.0 and e["slo_ms"] == 50.0
                            for e in breaches)
    grow = [e for e in _find(stats["events"], "scale_out", "api")
            if e["to_p"] == 3]
    assert grow
    assert max(stats["events"].index(e) for e in breaches) < \
        stats["events"].index(grow[0])
    assert job.slo_breaches == len(breaches)
    assert stats["slo_attainment"] == pytest.approx(
        1.0 - len(breaches) / 20, abs=1e-4)
    assert stats["slo_attainment"] < 1.0 and stats["conserved"]


def test_mixed_pool_packing_mp2_serving_next_to_training():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, 12, trace=(6.0,) * 12,
                              replica_capacity=6, model_parallel=2,
                              wave_ms=20.0),
              pkg.JobSpec("t", 2, 30, profile="resnet50")],
        pkg.MaxThroughput()), rounds=80)
    api, t = ex.jobs[0], ex.jobs[1]
    assert api.state is PORT.JobState.FINISHED and \
        t.state is PORT.JobState.FINISHED
    assert all(e["mp"] == 2 for e in stats["events"] if e["job"] == "api")
    assert all(m["p"] == 1 for m in api.trainer.metrics_log)
    assert stats["slo_attainment"] == 1.0 and stats["conserved"]


# ------------------------------------------------- stateless park + revival
def test_stateless_park_skips_checkpointer_and_resumes_trace():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, 10, trace=(4.0,) * 4 + (8.0,) * 6,
                              replica_capacity=4, wave_ms=20.0)],
        pkg.ScriptedPolicy({4: {0: 0}, 10: {0: 1}}), devices=2), rounds=40)
    job = ex.jobs[0]
    pre = _find(stats["events"], "preempt", "api")
    assert pre and pre[0].get("stateless") is True
    assert not _find(stats["events"], "checkpoint", "api") and \
        not ex.checkpointer.saved
    assert not _find(stats["events"], "recovered", "api")
    souts = _find(stats["events"], "scale_out", "api")
    assert len(souts) == 2 and not _find(stats["events"], "readmit", "api")
    assert souts[1]["round"] > pre[0]["round"]
    assert job.trainer.served_offset == 4
    assert job.trainer.metrics_log[0]["requests"] == 8.0
    assert job.state is PORT.JobState.FINISHED and job.rounds_served == 10
    assert job.steps_done == 10 and stats["conserved"]


def test_scale_to_zero_lull_loans_everything_then_spike_revives():
    def scenario(pkg):
        spec = pkg.ServingSpec("api", 1, 10,
                               trace=(4.0, 4.0, 0.0, 0.0, 0.0) + (8.0,) * 5,
                               replica_capacity=4, min_replicas=0,
                               wave_ms=20.0)
        return executor(pkg, [spec, pkg.JobSpec("t", 1, 500,
                                                profile="resnet50")],
                        pkg.MaxThroughput())
    ex, _ = run_twins(scenario, by_round=True, rounds=80)
    api = ex.jobs[0]
    assert api.state is PORT.JobState.FINISHED
    pre = _find(ex.events, "preempt", "api")
    assert pre and pre[0].get("stateless") is True
    full = [e for e in _find(ex.events, "scale_out", "t") if e["to_p"] == 4]
    assert full and full[0]["loaned"] == 3
    revive = [e for e in _find(ex.events, "scale_out", "api")
              if e["round"] > pre[0]["round"]]
    assert revive and revive[0]["to_p"] == 2
    sin = _find(ex.events, "scale_in", "t")
    assert sin and ex.events.index(sin[0]) < ex.events.index(revive[0])
    assert api.steps_done == 10 and api.rounds_served == 7
    assert api.slo_breaches == 0


# --------------------------------------------------- policy layer contracts
def _view(jobs, n_gpus, now=0.0):
    return types.SimpleNamespace(n_gpus=n_gpus, now=now,
                                 running={}, pending=list(jobs))


def test_reserve_serving_funds_demand_in_arrival_order():
    def run(pkg):
        a = pkg.make_cluster_job(0, pkg.ServingSpec(
            "a", 1, 10, trace=(12.0,), replica_capacity=4))
        b = pkg.make_cluster_job(1, pkg.ServingSpec(
            "b", 1, 10, trace=(8.0,), replica_capacity=4, arrival=1.0))
        t = pkg.make_cluster_job(2, pkg.JobSpec("t", 2, 10, arrival=0.5))
        alloc, alloc8 = {}, {}
        training, left = pkg.reserve_serving(_view([b, t, a], 4), alloc)
        _, left8 = pkg.reserve_serving(_view([a], 8), alloc8, headroom=1)
        return alloc, [j.jid for j in training], left, alloc8, left8
    got = run(PORT)
    assert got == run(REF)
    assert got == ({0: 3, 1: 1}, [2], 0, {0: 4}, 4)


def test_cross_tier_policy_makes_static_serving_aware():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, 16, trace=(4.0,) * 2 + (12.0,) * 14,
                              replica_capacity=4, wave_ms=20.0),
              pkg.JobSpec("t", 1, 30, profile="resnet50")],
        pkg.CrossTierPolicy(pkg.make_policy("static"))), rounds=80)
    assert stats["policy"] == "CrossTierPolicy"
    assert [e for e in _find(stats["events"], "scale_out", "api")
            if e["to_p"] == 3]
    api, t = ex.jobs[0], ex.jobs[1]
    assert api.state is PORT.JobState.FINISHED and \
        t.state is PORT.JobState.FINISHED
    assert max(m["p"] for m in t.trainer.metrics_log) == 1
    assert stats["slo_attainment"] == 1.0 and stats["conserved"]


def test_elastic_tiresias_shrinks_training_for_the_spike():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [pkg.ServingSpec("api", 1, 16, trace=(4.0,) * 4 + (12.0,) * 12,
                              replica_capacity=4, wave_ms=20.0,
                              slo_ms=50.0),
              pkg.JobSpec("t", 3, 400, profile="resnet50")],
        pkg.make_policy("elastic-tiresias"), devices=6), rounds=60)
    api = ex.jobs[0]
    assert api.state is PORT.JobState.FINISHED
    assert [e for e in _find(stats["events"], "scale_out", "t")
            if e["loaned"] > 0]
    grow = [e for e in _find(stats["events"], "scale_out", "api")
            if e["to_p"] == 3]
    sin = _find(stats["events"], "scale_in", "t")
    assert grow and sin and stats["events"].index(sin[0]) < \
        stats["events"].index(grow[0])
    assert not _find(stats["events"], "preempt", "t")
    assert api.slo_breaches <= 2 and stats["conserved"]


# ----------------------------------------------------------- spec grammar
KW = dict(batch=12, seq=64, n_samples=1024, d_partitions=16)


def test_parse_jobs_serving_grammar():
    text = ("api=resnet50:1:20:serve=4/8/12:cap=4:slo=90:min=1:max=3@0,"
            "t=vgg19:2:30@1")
    api, t = PORT.parse_jobs(text, **KW)
    assert [dataclasses.asdict(s) for s in (api, t)] == \
        [dataclasses.asdict(s) for s in REF.parse_jobs(text, **KW)]
    assert isinstance(api, PORT.ServingSpec) and api.tier == "serving"
    assert api.trace == (4.0, 8.0, 12.0) and api.replica_capacity == 4
    assert api.slo_ms == 90.0 and api.max_replicas == 3
    assert api.requested_p == 1 and api.total_steps == 20
    assert not isinstance(t, PORT.ServingSpec) and t.tier == "training"
    assert t.requested_p == 2 and t.arrival == 1.0


def test_parse_jobs_synthesized_trace_and_errors():
    (api,) = PORT.parse_jobs(
        "api=resnet50:1:16:serve=diurnal:period=8:base=2:peak=10:cap=4@0",
        **KW)
    assert api.trace == PORT.traffic.diurnal(16, period=8, base=2.0,
                                             peak=10.0)
    for match, text in (("serve=TRACE", "t=resnet50:1:5:slo=90@0"),
                        ("incompatible", "api=resnet50:1:5:serve=flat:vw=4@0"),
                        ("serve=TRACE", "t=resnet50:1:5:frobs=2@0")):
        with pytest.raises(ValueError, match=match):
            PORT.parse_jobs(text, **KW)


# ------------------------------------------------------- simulator serving
def test_simulator_job_trace_demand():
    kw = dict(jid=0, model="resnet50", requested_p=2, total_samples=100,
              arrival=0.0, trace=(5.0, 0.0, 11.0), trace_dt=10.0,
              replica_capacity=4.0)
    j, r = PORT.SimJob(**kw), REF.SimJob(**kw)
    times = (0.0, 10.0, 25.0, 35.0)
    assert j.tier == "serving"
    assert [j.desired_p(x) for x in times] == [2, 1, 3, 2] == \
        [r.desired_p(x) for x in times]
    train = PORT.SimJob(jid=1, model="vgg19", requested_p=3,
                        total_samples=10, arrival=0.0)
    assert train.tier == "training" and train.desired_p(0.0) == 3


# ------------------------------------------------ serving tier under chaos
def _serving_spec(pkg, steps=30, trace=None):
    return pkg.ServingSpec("api", 1, steps, profile="resnet50",
                           trace=trace or (12.0,) * steps,
                           replica_capacity=4, wave_ms=20.0)


def _assert_service_and_device_ledger(ex):
    floors = {}
    for e in ex.events:
        if e["op"] in ("worker_dead", "revoke") and e["jid"] is not None:
            floors[e["jid"]] = max(floors.get(e["jid"], 0),
                                   e.get("steps_done", 0))
    for jid, floor in floors.items():
        assert ex.jobs[jid].steps_done >= floor
    assert ex.n_gpus == ex.n_gpus_initial - ex.capacity_lost
    assert len(ex.devices) == ex.n_gpus
    _assert_ledger(ex)


def test_kill_serving_replica_scales_in_stop_free_then_respawns():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [_serving_spec(pkg)], pkg.MaxThroughput(),
        faults=pkg.FaultPlan(events=(pkg.FaultEvent(
            "kill_worker", at=4, jid=0, worker=2),))))
    api = ex.jobs[0]
    dead = _find(stats["events"], "worker_dead", "api")
    assert dead and dead[0]["workers"] == ["s2"] and \
        len(dead[0]["devices"]) == 1
    rec = _find(stats["events"], "recovered", "api")
    assert rec and rec[0]["mode"] == "stop_free"
    assert not _find(stats["events"], "preempt", "api")
    assert [e for e in _find(stats["events"], "scale_out", "api")
            if e["round"] > dead[0]["round"] and e["to_p"] == 3]
    assert api.state is PORT.JobState.FINISHED and api.rounds_served == 30
    assert stats["workers_killed"] == 1 and stats["capacity_lost"] == 1
    assert ex.n_gpus == 3 and stats["conserved"]
    _assert_service_and_device_ledger(ex)


def test_kill_sole_serving_replica_parks_stateless_and_revives():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [_serving_spec(pkg, steps=12, trace=(4.0,) * 12)],
        pkg.make_policy("static"), devices=2,
        faults=pkg.FaultPlan(events=(pkg.FaultEvent(
            "kill_worker", at=3, jid=0),))))
    api = ex.jobs[0]
    pre = _find(stats["events"], "preempt", "api")
    assert pre and pre[0].get("stateless") is True
    assert not _find(stats["events"], "checkpoint", "api") and \
        not ex.checkpointer.saved
    rec = _find(stats["events"], "recovered", "api")
    assert rec and rec[0]["mode"] == "stateless"
    assert [e for e in _find(stats["events"], "scale_out", "api")
            if e["round"] > pre[0]["round"]]
    assert api.state is PORT.JobState.FINISHED and api.rounds_served == 12
    assert ex.n_gpus == 1 and stats["capacity_lost"] == 1
    assert stats["conserved"]
    _assert_service_and_device_ledger(ex)


def test_revoke_serving_replica_group_shrinks_stop_free():
    ex, stats = run_twins(lambda pkg: executor(
        pkg, [_serving_spec(pkg)], pkg.MaxThroughput(),
        faults=pkg.FaultPlan(events=(pkg.FaultEvent(
            "revoke_devices", at=4, jid=0),))))
    api = ex.jobs[0]
    rev = _find(stats["events"], "revoke", "api")
    assert rev and len(rev[0]["devices"]) == 1
    rec = _find(stats["events"], "recovered", "api")
    assert rec and rec[0]["mode"] == "stop_free"
    assert not _find(stats["events"], "preempt", "api")
    assert api.state is PORT.JobState.FINISHED and api.rounds_served == 30
    assert stats["devices_revoked"] == 1 and ex.n_gpus == 3
    assert stats["conserved"]
    _assert_service_and_device_ledger(ex)


@pytest.mark.parametrize("seed", range(8))
def test_random_fault_schedules_keep_invariants_mixed_tiers(seed):
    """Seeded kill/revocation schedules against a serving + training pool:
    the same events in both packages, and every invariant holds."""
    def scenario(pkg):
        specs = [_serving_spec(pkg, steps=25,
                               trace=(4.0, 4.0, 8.0, 8.0, 12.0, 12.0, 8.0,
                                      8.0) * 4),
                 pkg.JobSpec("t", 2, 20, profile="resnet50")]
        return executor(pkg, specs, pkg.MaxThroughput(), devices=6,
                        faults=pkg.FaultPlan.random(
                            seed, rounds=30, n_jobs=2, kills=2, revokes=1,
                            max_devices=1))
    ex, stats = run_twins(scenario, rounds=120)
    assert stats["conserved"]
    _assert_service_and_device_ledger(ex)
    assert {r["outcome"] for r in ex.injector.log} <= \
        {"fired", "partial", "dropped"}
    api = ex.jobs[0]
    assert api.rounds_served == api.steps_done
    for job in ex.jobs.values():
        if job.state is PORT.JobState.FINISHED:
            assert job.steps_done == job.spec.total_steps
        else:
            assert job.state in (PORT.JobState.PENDING,
                                 PORT.JobState.PREEMPTED,
                                 PORT.JobState.RUNNING)
            assert job.steps_done <= job.spec.total_steps


# ----------------------------------------------------------- live (CPU)
def test_serving_spec_runs_through_make_cluster_job_and_default_factory():
    """A serving spec builds a ``ServingJob`` and, through the executor's
    default factory, a ``LiveServingEngine`` at SMOKE width whose params
    and prompts lie on its first replica's slot; a round serves a measured
    wave, and the engine follows the first replica through a failure."""
    from repro_torch.cluster.executor import default_trainer_factory
    from repro_torch.devices import slot_devices
    from repro_torch.models.params import tree_leaves
    spec = PORT.ServingSpec("api", 1, 4, trace=(8.0,), replica_capacity=4,
                            global_batch=2, prompt_len=3, gen_len=2,
                            slo_ms=60000.0)
    assert isinstance(PORT.make_cluster_job(0, spec), PORT.ServingJob)
    slots = slot_devices(2, "cpu")
    eng = default_trainer_factory(spec, slots)
    assert isinstance(eng, port_serving.LiveServingEngine)
    assert eng._cfg.name == "edl-paper-smoke" and eng.p == 2
    assert {t.device for _, t in tree_leaves(eng._params)} == \
        {eng._prompts.device} == {slots[0].device}
    assert eng._prompts.shape == (2, 3)
    m = eng.step()
    assert m["waves"] == 1 and m["p99_ms"] > 0 and not m["slo_breach"]
    eng.inject_worker_failure("s0")
    assert eng.handle_failure(["s0"], release=False) == [slots[0]]
    assert eng.devices == [slots[1]] and eng._home == slots[1].device
    assert eng.step()["waves"] == 2
    with pytest.raises(ValueError, match="single-device"):
        port_serving.LiveServingEngine(
            dataclasses.replace(spec, model_parallel=2), slots)



def test_live_serving_loans_and_reclaims_stop_free():
    """The port's driver with a ``LiveServingEngine`` tenant (measured
    ``serve_batch`` waves of SMOKE edl_paper) beside a real elastic trainer
    on four CPU slots, on the reference live test's trace: the lull loans
    slots to the trainer, the spike reclaims them, the server grows to its
    cap of 3, the trainer is never parked and its step counter runs on."""
    trace = "/".join(["4"] * 8 + ["16"] * 24 + ["4"] * 8)
    cmd = [sys.executable, "-m", "repro_torch.launch.cluster", "--json",
           "--device", "cpu", "--devices", "4", "--policy", "throughput",
           "--jobs",
           f"api=resnet50:1:40:serve={trace}:cap=4:max=3:slo=60000@0,"
           f"t=resnet50:1:100@0",
           "--max-rounds", "400"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    s = json.loads(out.stdout.strip().splitlines()[-1])
    assert s["conserved"] is True and s["policy"] == "CrossTierPolicy"
    assert s["rounds_served"] == 40 and s["slo_attainment"] == 1.0
    jobs = {j["name"]: j for j in s["jobs"]}
    assert jobs["api"]["tier"] == "serving"
    assert jobs["api"]["state"] == "finished"
    assert jobs["api"]["last_p99_ms"] > 0, "waves are measured"
    ev = s["events"]
    assert [e for e in ev if e["op"] == "scale_out" and e["job"] == "t"
            and e["loaned"] > 0]
    assert [e for e in ev if e["op"] == "scale_in" and e["job"] == "t"]
    assert [e for e in ev if e["op"] == "scale_out" and e["job"] == "api"
            and e["to_p"] == 3]
    assert not [e for e in ev if e["op"] == "preempt" and e["job"] == "t"]
    assert jobs["t"]["steps_done"] == jobs["t"]["final_step"]
