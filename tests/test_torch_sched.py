"""The port's copy of the scheduling layer (``repro_torch.sched``) against
the reference's ``repro.sched``: the same traces, curves, allocation maps
and simulated schedules, compared with ``==`` (the layer is pure Python and
numpy, so every number must agree to the last bit)."""
import dataclasses
import importlib

import pytest

from repro.cluster import policy as ref_policy
from repro.sched import base as ref_base
from repro.sched import serving as ref_serving
from repro.sched import simulator as ref_sim
from repro.sched import traffic as ref_traffic
from repro.sched import workload as ref_workload
from repro_torch.cluster import policy as port_policy
from repro_torch.sched import base as port_base
from repro_torch.sched import serving as port_serving
from repro_torch.sched import simulator as port_sim
from repro_torch.sched import traffic as port_traffic
from repro_torch.sched import workload as port_workload

# the packages export a function ``throughput`` that hides the module
ref_tp = importlib.import_module("repro.sched.throughput")
port_tp = importlib.import_module("repro_torch.sched.throughput")

REF = dict(policy=ref_policy, sim=ref_sim, workload=ref_workload,
           tp=ref_tp, serving=ref_serving)
PORT = dict(policy=port_policy, sim=port_sim, workload=port_workload,
            tp=port_tp, serving=port_serving)
POLICIES = ("tiresias", "elastic-tiresias", "throughput", "static")
TRACES = {
    "philly": lambda wl, seed: wl.philly_like(seed=seed, n_jobs=14,
                                              mp_choices=(1, 2, "auto")),
    "synthetic": lambda wl, seed: wl.synthetic_16(seed=seed, n_jobs=10),
}


def job_record(j) -> tuple:
    return (j.jid, j.model, j.requested_p, j.mp, j.mp_auto, j.alloc,
            j.start_time, j.finish_time, j.attained_gpu_s, j.remaining)


def simulate(pkg: dict, policy_name: str, trace: str, seed: int,
             mode: str) -> dict:
    """One simulator run; every allocation map the policy returns is kept
    in call order beside the per-job results."""
    jobs = TRACES[trace](pkg["workload"], seed)
    inner = pkg["policy"].make_policy(policy_name)
    maps = []

    def policy(view):
        alloc = inner(view)
        maps.append((view.now, dict(alloc)))
        return alloc

    sim = pkg["sim"].ClusterSimulator(
        8, jobs, policy, costs=pkg["sim"].ScalingCosts(mode=mode),
        quantum=60.0)
    stats = sim.run()
    return {"stats": stats, "maps": maps,
            "jobs": [job_record(j) for j in sim.jobs.values()]}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("policy_name", POLICIES)
def test_simulator_schedules_equal_reference(policy_name, trace, seed):
    """Every policy of ``make_policy`` on the same workload trace gives
    the same allocation map at every call and the same per-job results
    (start, finish, attained service, final allocation) and stats."""
    mode = "edl" if seed % 2 == 0 else "stop_resume"
    want = simulate(REF, policy_name, trace, seed, mode)
    got = simulate(PORT, policy_name, trace, seed, mode)
    assert want["stats"]["finished"] > 0
    assert got["maps"] == want["maps"]
    assert got["jobs"] == want["jobs"]
    assert got["stats"] == want["stats"]


def test_serving_tenants_schedule_equal_reference():
    """The serving tier of the simulator (trace-driven replica demand under
    ``CrossTierPolicy``) schedules the same in both packages."""
    def run(pkg):
        wl, sim = pkg["workload"], pkg["sim"]
        rates = tuple(float(r) for r in (1, 3, 6, 2, 1, 5))
        jobs = wl.synthetic_16(seed=1, n_jobs=6) + [
            sim.Job(6, "resnet50", 3, 1e5, arrival=10.0, trace=rates,
                    replica_capacity=2.0)]
        policy = pkg["serving"].CrossTierPolicy(
            pkg["policy"].make_policy("elastic-tiresias"))
        s = sim.ClusterSimulator(8, jobs, policy, quantum=45.0,
                                 t_end=3000.0)
        return s.run(), [job_record(j) for j in s.jobs.values()]
    assert run(PORT) == run(REF)


@pytest.mark.parametrize("profile", sorted(ref_tp.PROFILES))
def test_throughput_curves_equal_reference(profile):
    """The analytic curves, at every (p, mp), and a measured model fed the
    same observations."""
    ra, pa = ref_tp.AnalyticModel(), port_tp.AnalyticModel()
    for p in (1, 2, 3, 4, 8, 16):
        for mp in (1, 2, 4):
            for fn in ("throughput", "step_time", "efficiency"):
                assert getattr(pa, fn)(profile, p, mp) == \
                    getattr(ra, fn)(profile, p, mp), (fn, p, mp)
    rm, pm = ref_tp.MeasuredModel(), port_tp.MeasuredModel()

    @dataclasses.dataclass
    class View:
        model: str
        jid: int = 0
        mp: int = 1
    job = View(profile)
    for k, (p, t) in enumerate([(1, 0.3), (2, 0.2), (2, 0.22), (4, 0.15)]):
        rm.observe(job, p, t + 0.001 * k)
        pm.observe(job, p, t + 0.001 * k)
    for p in (1, 2, 3, 4, 6, 8):
        assert pm.throughput(job, p) == rm.throughput(job, p)
        assert pm.step_time(job, p) == rm.step_time(job, p)
    assert pm.curve(job) == rm.curve(job)


def test_traffic_traces_equal_reference():
    for spec, kw in (("diurnal", {"period": 12, "peak": 9.0}),
                     ("spike", {}), ("flat", {}), ("1/2/4/8/3", {})):
        assert port_traffic.parse_trace(spec, rounds=40, **kw) == \
            ref_traffic.parse_trace(spec, rounds=40, **kw)
    assert port_traffic.diurnal(30, period=10, base=2.0, peak=7.0) == \
        ref_traffic.diurnal(30, period=10, base=2.0, peak=7.0)
    assert port_traffic.spike(30, at=5, width=6, base=1.0, peak=9.0) == \
        ref_traffic.spike(30, at=5, width=6, base=1.0, peak=9.0)


@pytest.mark.parametrize("seed", range(3))
def test_workload_cluster_specs_equal_reference(seed):
    """``to_cluster_specs`` synthesizes the same live job specs."""
    def specs(wl):
        return [dataclasses.asdict(s) for s in wl.to_cluster_specs(
            wl.philly_like(seed=seed, n_jobs=8, mp_choices=(1, 2, "auto")),
            devices=4, steps=(4, 12))]
    assert specs(port_workload) == specs(ref_workload)


def test_likely_next_shapes_equal_reference():
    """The speculative-prefetch oracle names the same shapes."""
    def shapes(pkg, base):
        jobs = TRACES["philly"](pkg["workload"], 2)
        out = []
        for name in POLICIES:
            pol = pkg["policy"].make_policy(name)
            sim = pkg["sim"].ClusterSimulator(8, jobs, pol)
            sim.run()
            for j in jobs[:6]:
                j.alloc = max(1, j.requested_p // 2)
                out.append(base.likely_next_shapes(pol, sim, j, limit=3))
        return out
    assert shapes(PORT, port_base) == shapes(REF, ref_base)
