"""The port's copy of the observability layer (``repro_torch.obs``) against
the reference's ``repro.obs``: the same executor run through each
package's facade gives the same telemetry records (wall-clock fields
aside), the same span trees and metric families, each package's
``report.validate`` accepts the other's JSONL, and the ownership auditor
agrees. The fake trainer resizes through each package's REAL
``ScalingController``, so committed switches land genuine records."""
import json
import urllib.request

import pytest

import repro.core.scaling as ref_scaling
import repro.obs as ref_obs
import repro.obs.audit as ref_audit
import repro.obs.report as ref_report
import repro_torch.core.scaling as port_scaling
import repro_torch.obs as port_obs
import repro_torch.obs.audit as port_audit
import repro_torch.obs.report as port_report
from test_cluster import FakeCheckpointer
from test_obs import ObsFakeTrainer
from test_torch_cluster import PORT, REF

OBS = {id(REF): (ref_obs, ref_scaling), id(PORT): (port_obs, port_scaling)}
# the host's clock: event stamps and the ScalingRecord's measured windows
WALL_CLOCK = ("ts", "prep_s", "stop_s", "e2e_s", "stage_s", "latency_s")


def obs_fake_for(pkg):
    scaling = OBS[id(pkg)][1]

    class Fake(ObsFakeTrainer):
        def __init__(self, spec, devices):
            super().__init__(spec, devices)
            self.controller = scaling.ScalingController()
    return Fake


WORKLOADS = {
    "funding": lambda pkg: ([pkg.JobSpec("a", 3, 60, profile="vgg19"),
                             pkg.JobSpec("b", 1, 60, profile="resnet50")],
                            pkg.MaxThroughput(), 4, None),
    "reshape": lambda pkg: ([pkg.JobSpec("flex", 4, 60, profile="vgg19",
                                         mp_auto=True),
                             pkg.JobSpec("b", 2, 12, profile="googlenet",
                                         arrival=1.0)],
                            pkg.ScriptedPolicy({2: {0: (1, 2), 1: 2}}), 4,
                            None),
    "revocations": lambda pkg: ([pkg.JobSpec("a", 2, 40, profile="vgg19"),
                                 pkg.JobSpec("b", 1, 40,
                                             profile="resnet50")],
                                pkg.MaxThroughput(), 4,
                                pkg.FaultPlan.random(1, rounds=30, n_jobs=2,
                                                     kills=0, revokes=2,
                                                     max_devices=2)),
}


def run(pkg, workload: str, tmp_path=None):
    obs_mod = OBS[id(pkg)][0]
    specs, policy, n, faults = WORKLOADS[workload](pkg)
    tel = None if tmp_path is None else str(tmp_path / "t.jsonl")
    obs = obs_mod.Observability(telemetry_out=tel, metrics_every=2)
    ex = pkg.ClusterExecutor(specs, policy, devices=list(range(n)),
                             resched_every=2,
                             trainer_factory=obs_fake_for(pkg),
                             checkpointer=FakeCheckpointer(), obs=obs,
                             faults=faults)
    stats = ex.run(max_rounds=16)
    ex.close()
    obs.close()
    return ex, stats, obs, tel


def strip(x):
    if isinstance(x, dict):
        return {k: strip(v) for k, v in x.items() if k not in WALL_CLOCK}
    if isinstance(x, list):
        return [strip(v) for v in x]
    return x


def spans(obs) -> list:
    """The spans and instants in the order they were recorded."""
    return [(e["name"], e["tid"], e["cat"], strip(e["args"]))
            for e in obs.tracer.spans + obs.tracer.instants]


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_facades_give_the_same_records_spans_and_metrics(workload):
    ex_r, _, obs_r, _ = run(REF, workload)
    ex_p, _, obs_p, _ = run(PORT, workload)
    assert obs_r.records()
    assert strip(obs_p.records()) == strip(obs_r.records())
    assert spans(obs_p) == spans(obs_r)
    assert sorted(obs_p.metrics.snapshot()) == \
        sorted(obs_r.metrics.snapshot())
    kinds = {r["kind"] for r in obs_p.records()}
    assert "adjust" in kinds or workload == "revocations"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_validate_accepts_the_others_jsonl(writer, tmp_path):
    pkg = PORT if writer == "port" else REF
    _, _, obs, tel = run(pkg, "funding", tmp_path)
    for report in (port_report, ref_report):
        records = report.load(tel)
        assert sum(r.get("type") == "event" for r in records) == \
            obs.bus.emitted
        assert report.validate(records) == []
    assert port_report.render(port_report.load(tel)) == \
        ref_report.render(ref_report.load(tel))


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_ownership_audit_equals_reference(workload):
    _, stats, _, _ = run(PORT, workload)
    assert port_audit.assert_ownership(stats["events"]) == \
        ref_audit.assert_ownership(stats["events"])


def test_validate_flags_the_same_problems(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "event", "kind": "sched"}\n'
                   "not json at all\n"
                   '{"type": "mystery"}\n'
                   + json.dumps({"type": "event", "schema": 99,
                                 "kind": "nope", "name": "", "ts": "x"})
                   + "\n")
    want = ref_report.validate(ref_report.load(str(bad)))
    assert want and port_report.validate(port_report.load(str(bad))) == want


def test_prometheus_endpoint_serves_the_exposition():
    obs = port_obs.Observability(prom_port=0)
    try:
        obs.metrics.snapshot()
        url = f"http://127.0.0.1:{obs.prom_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert body == obs.metrics.exposition()
    finally:
        obs.close()
