"""The port's multi-tenant cluster tier (``repro_torch.cluster``) against
the reference's ``repro.cluster``.

* Executor twins: one fake trainer (the reference suites' instant-switch
  ``ChaosFakeTrainer``), bound to each package's ``Phase`` and
  ``Membership``, drives both executors through the reference's scenarios;
  their ``events`` and ``stats()`` must be ``==``. The only fields left out
  are the wall-clock recovery latencies (``latency_s``,
  ``mean_recovery_latency_s``), which time the host.
* Slot identity: four slots on one device stay four slots through a
  revocation, the exec cache keys by slot ids, and a prefetched handle is
  found by the later grant.
* Real SMOKE tenants of the port's executor on CPU slots: a throughput-
  policy transfer, a preemption to disk and re-admission, and a ``vw=4``
  tenant whose losses are ``==`` its static run's.
* The launcher's job grammar against the reference's parser.
"""
import dataclasses
import importlib
import json
import os
import types

import pytest

torch = pytest.importorskip("torch")

import repro.chaos as ref_chaos
import repro.cluster as ref_cluster
import repro.cluster.policy as ref_policy
import repro.core.membership as ref_membership
import repro.core.scaling as ref_scaling
import repro.sched.base as ref_sched_base
import repro_torch.chaos as port_chaos
import repro_torch.cluster as port_cluster
import repro_torch.cluster.policy as port_policy
import repro_torch.core.membership as port_membership
import repro_torch.core.scaling as port_scaling
import repro_torch.sched.base as port_sched_base
from repro_torch.cluster import ClusterExecutor, JobSpec, ScriptedPolicy, \
    make_policy
from repro_torch.cluster.executor import default_trainer_factory
from repro_torch.devices import Slot, as_slots, slot_devices
from test_chaos import ChaosFakeTrainer
from test_cluster import FakeCheckpointer

# the packages export a function ``throughput`` that hides the module
ref_throughput = importlib.import_module("repro.sched.throughput")
port_throughput = importlib.import_module("repro_torch.sched.throughput")

def package(cluster, policy, chaos, scaling, membership, sched_base,
            throughput):
    return types.SimpleNamespace(
        ClusterExecutor=cluster.ClusterExecutor, JobSpec=cluster.JobSpec,
        ScriptedPolicy=policy.ScriptedPolicy, make_policy=policy.make_policy,
        plan_actions=policy.plan_actions,
        MaxThroughput=sched_base.MaxThroughput,
        MeasuredModel=throughput.MeasuredModel, FaultPlan=chaos.FaultPlan,
        FaultEvent=chaos.FaultEvent, Phase=scaling.Phase,
        Membership=membership.Membership)


REF = package(ref_cluster, ref_policy, ref_chaos, ref_scaling,
              ref_membership, ref_sched_base, ref_throughput)
PORT = package(port_cluster, port_policy, port_chaos, port_scaling,
               port_membership, port_sched_base, port_throughput)


def fake_for(pkg):
    """The reference suites' fake trainer, its controller and liveness
    view taken from ``pkg`` (each executor compares phases by identity
    with its own package's ``Phase``)."""
    class Controller:
        phase = pkg.Phase.IDLE

    class Fake(ChaosFakeTrainer):
        def __init__(self, spec, devices):
            super().__init__(spec, devices)
            self.controller = Controller()

        def _init_membership(self):
            self.membership = pkg.Membership(miss_threshold=3)
            for i, w in enumerate(self.worker_ids):
                self.membership.register(w, i, at_step=self.step_idx)
    return Fake


# Each scenario: pkg -> dict(specs, policy, devices, rounds, and optional
# resched_every, executor keywords, a hold on the checkpointer until a
# round, a straggler flag at a round). Taken from the reference's
# test_cluster.py and test_chaos.py.
def _specs(pkg, *rows):
    return [pkg.JobSpec(*args, **kw) for args, kw in rows]


SCENARIOS = {
    "throughput_loan_reclaim": lambda pkg: dict(
        specs=_specs(pkg, (("a", 3, 60), {"profile": "vgg19"}),
                     (("b", 1, 60), {"profile": "resnet50"}),
                     (("c", 2, 30), {"profile": "googlenet",
                                     "arrival": 6.0})),
        policy=pkg.MaxThroughput(), devices=4, rounds=16),
    "tiresias_compaction_readmit": lambda pkg: dict(
        specs=_specs(pkg, (("a", 2, 60), {"profile": "vgg19"}),
                     (("b", 2, 60), {"profile": "resnet50"}),
                     (("c", 2, 6), {"profile": "googlenet",
                                    "arrival": 6.0})),
        policy=pkg.make_policy("elastic-tiresias", quanta=(1.0, 50.0)),
        devices=4, rounds=40),
    "tiresias_demotion_both_ways": lambda pkg: dict(
        specs=_specs(pkg, (("a", 2, 20), {"profile": "resnet50"}),
                     (("b", 4, 12), {"profile": "vgg19", "arrival": 4.0})),
        policy=pkg.make_policy("tiresias", quanta=(0.5, 100.0)),
        devices=4, rounds=80),
    "mixed_mp_packing": lambda pkg: dict(
        specs=_specs(pkg, (("big", 2, 40), {"profile": "resnet50",
                                            "model_parallel": 2}),
                     *((("s%d" % i, 1, 40), {"profile": "googlenet"})
                       for i in range(4))),
        policy=pkg.MaxThroughput(), devices=8, rounds=30),
    "mixed_mp_loan_reclaim": lambda pkg: dict(
        specs=_specs(pkg, (("big", 1, 60), {"profile": "resnet50",
                                            "model_parallel": 2}),
                     (("s0", 1, 60), {"profile": "googlenet"})),
        policy=pkg.ScriptedPolicy({2: {0: 2, 1: 1}, 6: {0: 1, 1: 3}}),
        devices=5, rounds=10),
    "mixed_mp_preempt_in_flight": lambda pkg: dict(
        specs=_specs(pkg, (("big", 1, 30), {"profile": "resnet50",
                                            "model_parallel": 2}),
                     (("s", 1, 30), {"profile": "googlenet"})),
        policy=pkg.ScriptedPolicy({2: {0: 0, 1: 2}, 6: {0: 1, 1: 1}}),
        devices=3, rounds=40, hold_until=4),
    "mp_auto_reshape_under_pressure": lambda pkg: dict(
        specs=_specs(pkg, (("flex", 4, 200), {"profile": "vgg19",
                                              "mp_auto": True}),
                     (("goog", 2, 8), {"profile": "googlenet",
                                       "arrival": 4.0})),
        policy=pkg.make_policy("elastic-tiresias", quanta=(0.5, 50.0)),
        devices=4, rounds=60),
    "mp_auto_readmit_other_mp": lambda pkg: dict(
        specs=_specs(pkg, (("flex", 2, 30), {"profile": "vgg19",
                                             "mp_auto": True}),
                     (("b", 2, 60), {"profile": "googlenet"})),
        policy=pkg.ScriptedPolicy({2: {0: 0, 1: 4}, 6: {0: (1, 2), 1: 2}}),
        devices=4, rounds=20),
    "revocation_live_release": lambda pkg: dict(
        specs=_specs(pkg, (("a", 2, 25), {"profile": "resnet50"})),
        policy=pkg.make_policy("static"), devices=4, rounds=60,
        kw={"faults": pkg.FaultPlan(events=(pkg.FaultEvent(
            "revoke_devices", at=3, n_devices=3),))}),
    "kill_stop_free": lambda pkg: dict(
        specs=_specs(pkg, (("a", 3, 20), {"profile": "resnet50"})),
        policy=pkg.make_policy("static"), devices=3, rounds=60,
        kw={"faults": pkg.FaultPlan(events=(pkg.FaultEvent(
            "kill_worker", at=3, jid=0, worker=2),))}),
    "straggler_migration": lambda pkg: dict(
        specs=_specs(pkg, (("a", 3, 60), {"profile": "resnet50"})),
        policy=pkg.make_policy("static"), devices=3, rounds=6,
        straggler_at=3),
    "profile_sweep_measured": lambda pkg: dict(
        specs=_specs(pkg, (("a", 2, 40), {"profile": "resnet50"})),
        policy=pkg.make_policy("static"), devices=4, rounds=12,
        kw={"throughput_model": pkg.MeasuredModel(),
            "profile_sweeps": True}),
    "chaos_plan": lambda pkg: dict(
        specs=_specs(pkg, (("a", 3, 25), {"profile": "vgg19"}),
                     (("b", 2, 20), {"profile": "resnet50"})),
        policy=pkg.MaxThroughput(), devices=6, rounds=120,
        kw={"faults": pkg.FaultPlan.random(
            11, rounds=30, n_jobs=2, kills=2, revokes=1, crashes=1)}),
}
WALL_CLOCK = ("latency_s", "mean_recovery_latency_s")


def without_wall_clock(x):
    if isinstance(x, dict):
        return {k: without_wall_clock(v) for k, v in x.items()
                if k not in WALL_CLOCK}
    if isinstance(x, list):
        return [without_wall_clock(v) for v in x]
    return x


def run_scenario(pkg, name: str) -> dict:
    sc = SCENARIOS[name](pkg)
    ck = FakeCheckpointer()
    ck.hold = "hold_until" in sc
    ex = pkg.ClusterExecutor(sc["specs"], sc["policy"],
                             devices=list(range(sc["devices"])),
                             resched_every=sc.get("resched_every", 2),
                             trainer_factory=fake_for(pkg), checkpointer=ck,
                             **sc.get("kw", {}))
    pause = sc.get("hold_until") or sc.get("straggler_at")
    if pause:
        ex.run(max_rounds=pause)
        ck.hold = False
        if "straggler_at" in sc:
            ex.jobs[0].trainer._flagged_stragglers = ["w1"]
    stats = ex.run(max_rounds=sc["rounds"])
    ex.close()
    out = {"events": ex.events, "stats": stats,
           "free": list(ex.free), "pool": list(ex.devices)}
    if ex.injector is not None:
        out["injector"] = ex.injector.log
    return without_wall_clock(out)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_executor_twin_events_and_stats_equal_reference(name):
    want = run_scenario(REF, name)
    got = run_scenario(PORT, name)
    assert want["events"], name
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
    assert (got["free"], got["pool"]) == (want["free"], want["pool"])
    assert got.get("injector") == want.get("injector")


@pytest.mark.parametrize("alloc", [
    {0: 0, 1: 4}, {0: 1, 1: (1, 2)}, {0: (2, 2), 1: 0}, {0: 3, 1: 3}])
def test_plan_actions_equal_reference(alloc):
    """The diff from a target allocation to elastic actions, on the same
    live jobs (one rigid, one mp=auto)."""
    def plan(pkg):
        ex = pkg.ClusterExecutor(
            [pkg.JobSpec("a", 2, 20, profile="resnet50"),
             pkg.JobSpec("f", 2, 20, profile="vgg19", mp_auto=True)],
            pkg.make_policy("static"), devices=list(range(4)),
            trainer_factory=fake_for(pkg), checkpointer=FakeCheckpointer())
        ex.run(max_rounds=1)
        acts = pkg.plan_actions(ex.jobs, alloc, ex.n_gpus)
        ex.close()
        return [dataclasses.astuple(a) for a in acts]
    assert plan(PORT) == plan(REF)


@pytest.fixture
def build_dir():
    """The kernels' build directory, restored after the test."""
    from repro_torch.kernels import build
    old = build.BUILD_DIR
    try:
        yield build
    finally:
        build.set_build_dir(old)


def test_compile_cache_option_configures_the_build_dir(tmp_path, build_dir):
    """The counterpart of the reference's ``enable_compile_cache`` test:
    the directory is made, returned, and becomes the kernels' build
    directory, read at each call."""
    from repro_torch.cluster import enable_compile_cache
    path = enable_compile_cache(str(tmp_path / "cc"))
    assert path == str(tmp_path / "cc") and os.path.isdir(path)
    assert build_dir.BUILD_DIR == tmp_path / "cc"
    assert {build_dir.library_path(n).parent for n in build_dir.SOURCES} \
        == {tmp_path / "cc"}


def test_compile_cache_is_accepted(tmp_path, build_dir):
    """The executor's ``compile_cache=`` makes the directory the kernel
    libraries' build directory, as the reference's points XLA's cache."""
    path = tmp_path / "cc"
    ex = ClusterExecutor([JobSpec("a", 1, 2)], make_policy("static"),
                         devices=list(range(2)), compile_cache=str(path))
    ex.close()
    assert build_dir.BUILD_DIR == path and path.is_dir()
    assert build_dir.library_path("wkv6").parent == path


# --------------------------------------------------------- slot identity
SMOKE = dict(global_batch=12, seq_len=16, n_samples=96, d_partitions=8)


def smoke_trainer(devices, p, **kw):
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    return ElasticTrainer(get_config("edl-paper", smoke=True),
                          init_parallelism=p, devices=devices, seed=0,
                          time_allowance_s=0, **SMOKE, **kw)


def test_slots_have_identity_on_one_device():
    slots = slot_devices(4, "cpu")
    assert [s.id for s in slots] == [0, 1, 2, 3]
    assert len(set(slots)) == 4 and {s.device for s in slots} == \
        {torch.device("cpu")}
    assert [str(s) for s in slots] == ["cpu"] * 4
    # plain devices are wrapped in order; slots pass through
    assert as_slots(["cpu", "cpu"]) == [Slot(0, torch.device("cpu")),
                                        Slot(1, torch.device("cpu"))]
    assert as_slots(slots[2:]) == slots[2:]


def test_revoking_one_slot_of_a_shared_device_removes_that_slot_alone():
    """Four slots on ``cpu`` under one real SMOKE tenant at p = 4: a
    revoked slot is condemned by its id, leaves the cluster at the
    release's commit, and the three others stay (with equal torch devices,
    the reference's identity rule would condemn all four)."""
    pool = slot_devices(4, "cpu")
    plan = port_chaos.FaultPlan(events=(port_chaos.FaultEvent(
        "revoke_devices", at=1, jid=0, n_devices=1),))
    ex = ClusterExecutor([JobSpec("a", 4, 6, global_batch=4, seq_len=16,
                                  n_samples=64, d_partitions=8)],
                         make_policy("static"), devices=pool,
                         faults=plan, prep_yield_s=1.0)
    try:
        stats = ex.run(max_rounds=40)
    finally:
        ex.close()
    rev = [e for e in stats["events"] if e["op"] == "revoke"]
    assert rev and rev[0]["devices"] == [3]
    assert stats["capacity_lost"] == 1 and stats["n_gpus"] == 3
    assert ex.devices == pool[:3]
    assert ex.jobs[0].steps_done == 6
    assert sorted(s.id for s in ex.free) == [0, 1, 2]


def test_exec_key_by_slot_ids_and_prefetched_handle_is_found_by_grant():
    """The cache keys by slot ids in order, as the reference's keys by
    device ids; a handle built for a predicted slot set (the speculative
    prefetch) touches no trainer state and is what the later grant of
    those slots commits to, with no second build."""
    pool = slot_devices(4, "cpu")
    grant = [pool[3], pool[2]]
    with smoke_trainer(pool[:2], 2) as t:
        assert t._exec_key(2, 1) == (2, 1, (0, 1))
        assert t._exec_key(4, 1, pool[:2] + grant) == (4, 1, (0, 1, 3, 2))
        # plain devices are slots numbered in order
        assert t._exec_key(2, 1, ["cpu", "cpu"]) == (2, 1, (0, 1))
        n_cached = len(t._exec_cache)
        handle = t._build_exec(4, 1, devices=pool[:2] + grant)
        assert (t.p, len(t.devices), len(t._exec_cache)) == \
            (2, 2, n_cached + 1), "a prefetch build touches no trainer state"
        t.step()
        t.grant_devices(grant)
        rec = t.wait_for_scaling()
        assert rec.compile_cache_hit and rec.exec_cache_key == \
            (4, 1, (0, 1, 3, 2))
        assert t.exec is handle and t.devices == pool[:2] + grant


# ---------------------------------------------- real SMOKE port tenants
def run_real(specs, policy, *, n_slots=4, rounds=200, **kw):
    ex = ClusterExecutor(specs, policy, devices=slot_devices(n_slots, "cpu"),
                         prep_yield_s=2.0, **kw)
    try:
        stats = ex.run(max_rounds=rounds)
    finally:
        ex.close()
    return ex, stats


def spec(name, p, steps, **kw):
    return JobSpec(name, p, steps, **{**SMOKE, **kw})


def finite_losses(job):
    losses = [m["loss"] for m in job.trainer.metrics_log] \
        if job.trainer is not None else []
    assert all(map(lambda x: x == x and abs(x) < 1e9, losses))


def test_real_throughput_policy_transfers_slots_between_live_tenants():
    """Two SMOKE tenants under the throughput policy: a's scale-in funds
    b's scale-out (a transient loan), every step lands and conservation
    holds every round."""
    ex, stats = run_real([spec("a", 3, 14, profile="vgg19"),
                          spec("b", 1, 16, profile="resnet50")],
                         make_policy("throughput"), resched_every=2)
    ops = [(e["op"], e["job"]) for e in stats["events"]]
    assert ("scale_in", "a") in ops and ("scale_out", "b") in ops
    grow = [e for e in stats["events"] if e["op"] == "scale_out"
            and e["job"] == "b" and e["from_p"] > 0]
    assert grow and grow[0]["loaned"] >= 1
    assert stats["finished"] == 2 and stats["conserved"]
    assert [j["steps_done"] for j in stats["jobs"]] == [14, 16]


def test_real_preemption_to_disk_and_readmission(tmp_path):
    """A scripted 0-slot target checkpoint-stops a live tenant to disk;
    re-admission restores it onto another slot set and it finishes with
    its step counter continuous."""
    pol = ScriptedPolicy({2: {0: 0, 1: 3}, 6: {0: 2, 1: 1}})
    ex, stats = run_real([spec("a", 2, 6), spec("b", 2, 12)], pol,
                         resched_every=1,
                         checkpointer=port_cluster.DiskCheckpointer(
                             str(tmp_path)))
    pre = [e for e in stats["events"] if e["op"] == "preempt"]
    re_ = [e for e in stats["events"] if e["op"] == "readmit"]
    assert pre and re_ and pre[0]["job"] == re_[0]["job"] == "a"
    assert set(re_[0]["devices"]) != set(pre[0]["devices"])
    a = ex.jobs[0]
    assert a.steps_done == 6 and a.summary()["final_step"] == 6
    assert stats["finished"] == 2 and stats["conserved"]
    assert not list(tmp_path.iterdir()), "finished jobs' checkpoints dropped"


def test_real_virtual_worker_tenant_keeps_bits_across_resize_and_preempt(
        tmp_path):
    """A ``vw=4`` tenant resized by the policy and preempted to disk gives
    the losses of its static single-slot run, bit for bit."""
    steps = 8
    with smoke_trainer(slot_devices(1, "cpu"), 1, virtual_workers=4,
                       job_handle="a") as t:
        static = [t.step()["loss"] for _ in range(steps)]
    built = []

    def factory(spec, devices):
        built.append((spec.name, default_trainer_factory(spec, devices)))
        return built[-1][1]

    pol = ScriptedPolicy({2: {0: 2, 1: 1}, 4: {0: 0, 1: 1},
                          6: {0: 4, 1: 0}})
    ex, stats = run_real([spec("a", 1, steps, virtual_workers=4),
                          spec("b", 1, 10)], pol, resched_every=1,
                         trainer_factory=factory,
                         checkpointer=port_cluster.DiskCheckpointer(
                             str(tmp_path)))
    ops = [(e["op"], e["job"], e["to_p"]) for e in stats["events"]]
    assert ("scale_out", "a", 2) in ops
    assert ("preempt", "a", 0) in ops and ("readmit", "a", 4) in ops
    losses = [m["loss"] for name, t in built if name == "a"
              for m in t.metrics_log]
    assert ex.jobs[0].steps_done == steps and losses == static
    assert stats["conserved"]


# ------------------------------------------------------------- launcher
GRAMMAR = [
    "a=vgg19:3:25@0,b=resnet50:1:30@0,c=googlenet:1:15@6",
    "big=vgg19:1:12:mp=2@0,a=resnet50:1:16@0,b=googlenet:1:10@0",
    "flex=vgg19:4:20:mp=auto@0,b=googlenet:2:10@4",
    "d=resnet50:2:12:vw=4@0,e=vgg19:1:8:vw=auto@2.5",
    "r=resnet50:1:6:arch=rwkv6-1.6b@1,s=googlenet:2:9:mp=2:vw=2@3",
    # the reference's serving grammar (tests/test_serving.py)
    "api=resnet50:1:20:serve=4/8/12:cap=4:slo=90:min=1:max=3@0,"
    "t=vgg19:2:30@1",
    "api=resnet50:1:16:serve=diurnal:period=8:base=2:peak=10:cap=4@0",
]


@pytest.mark.parametrize("text", GRAMMAR)
def test_parse_jobs_equals_reference(text):
    from repro.launch.cluster import parse_jobs as ref_parse
    from repro_torch.launch.cluster import parse_jobs
    kw = dict(batch=12, seq=64, n_samples=1024, d_partitions=16)
    assert [dataclasses.asdict(s) for s in parse_jobs(text, **kw)] == \
        [dataclasses.asdict(s) for s in ref_parse(text, **kw)]


@pytest.mark.parametrize("text", ["trace=philly seed=0 jobs=6 steps=4:10",
                                  "trace=synthetic seed=2 jobs=5 mp=1:2",
                                  "trace=philly seed=1 jobs=7 mp=1:auto"])
def test_parse_workload_equals_reference(text):
    from repro.launch.cluster import parse_workload as ref_parse
    from repro_torch.launch.cluster import parse_workload
    kw = dict(devices=4, batch=12, seq=64, n_samples=1024, d_partitions=16)
    assert [dataclasses.asdict(s) for s in parse_workload(text, **kw)] == \
        [dataclasses.asdict(s) for s in ref_parse(text, **kw)]


def test_launcher_accepts_compile_cache_and_refuses_missing_card(
        tmp_path, build_dir, capsys):
    from repro_torch.launch import cluster
    path = tmp_path / "cc"
    assert cluster.main(["--device", "cpu", "--devices", "1",
                         "--compile-cache", str(path), "--jobs",
                         "a=resnet50:1:2@0", "--batch", "4", "--seq", "16",
                         "--n-samples", "16", "--d-partitions", "2",
                         "--max-rounds", "20"]) == 0
    assert build_dir.BUILD_DIR == path and path.is_dir()
    assert "device conservation: OK" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cluster.main(["--device", "cuda", "--jobs", "a=resnet50:1:2@0"])


def test_launcher_runs_smoke_tenants_on_cpu_slots(tmp_path, capsys):
    """The entry point on four CPU slots, with telemetry, a trace and the
    speculative prefetch (the executor builds predicted slot sets through
    the trainer's ``_build_exec(p, mp, devices=)``): JSON out,
    conservation, prefetches built without failure, every record valid
    under both packages' schema."""
    from repro.obs import report as ref_report
    from repro_torch.launch import cluster
    from repro_torch.obs import report
    tel, trace = tmp_path / "t.jsonl", tmp_path / "trace.json"
    rc = cluster.main(["--device", "cpu", "--devices", "4", "--json",
                       "--jobs", "a=vgg19:2:8@0,b=resnet50:1:8@0",
                       "--batch", "4", "--seq", "16", "--n-samples", "64",
                       "--d-partitions", "8", "--resched-every", "2",
                       "--prefetch-shapes", "--metrics-out", str(tel),
                       "--trace-out", str(trace)])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["conserved"] and stats["finished"] == 2
    svc = stats["compile_service"]
    assert svc["submitted"] > 0 and svc["failed"] == 0, svc
    for pkg in (report, ref_report):
        records = pkg.load(str(tel))
        assert records and pkg.validate(records) == []
    assert json.loads(trace.read_text())["traceEvents"]
