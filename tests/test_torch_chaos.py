"""The port's copy of the fault-injection layer (``repro_torch.chaos``)
against the reference's ``repro.chaos``: seeded plans serialize to the same
JSON, each package reads the other's traces, and the injector replays the
same outcomes against the twin executors (the fake trainer of
``test_torch_cluster.py``), compared with ``==``."""
import pytest

import repro.chaos as ref_chaos
import repro_torch.chaos as port_chaos
from test_torch_cluster import PORT, REF, fake_for, without_wall_clock
from test_cluster import FakeCheckpointer

PLAN_KW = [dict(kills=1), dict(kills=2, revokes=1, crashes=1),
           dict(rounds=60, n_jobs=3, kills=1, revokes=2, delays=2,
                max_devices=2, max_workers=3)]


@pytest.mark.parametrize("kw", PLAN_KW)
@pytest.mark.parametrize("seed", range(4))
def test_random_plan_json_equals_reference(seed, kw):
    want = ref_chaos.FaultPlan.random(seed, **kw).to_json()
    assert port_chaos.FaultPlan.random(seed, **kw).to_json() == want


def test_each_package_reads_the_others_traces(tmp_path):
    plan = ref_chaos.FaultPlan.random(5, kills=2, revokes=1, delays=1,
                                      crashes=1)
    path = plan.save(str(tmp_path / "trace.json"))
    assert port_chaos.FaultPlan.load(path).to_json() == plan.to_json()
    back = port_chaos.FaultPlan.from_json(plan.to_json())
    back.save(str(tmp_path / "port.json"))
    assert ref_chaos.FaultPlan.load(str(tmp_path / "port.json")).to_json() \
        == plan.to_json()
    spec = "random:seed=3,kills=2,revokes=1,rounds=40"
    assert port_chaos.FaultPlan.parse(spec).to_json() == \
        ref_chaos.FaultPlan.parse(spec).to_json()


@pytest.mark.parametrize("bad", [dict(kind="meteor", at=1),
                                 dict(kind="kill_worker", at=-1),
                                 dict(kind="revoke_devices", at=1,
                                      n_devices=0)])
def test_event_validation_equals_reference(bad):
    with pytest.raises(ValueError) as want:
        ref_chaos.FaultEvent(**bad)
    with pytest.raises(ValueError) as got:
        port_chaos.FaultEvent(**bad)
    assert str(got.value) == str(want.value)


def replay(pkg, seed: int) -> dict:
    """One seeded kill/revocation/delay/crash plan against two fake
    tenants; the injector's log, the executor's events and stats."""
    plan = pkg.FaultPlan.random(seed, rounds=30, n_jobs=2, kills=2,
                                revokes=1, delays=1, crashes=1)
    ex = pkg.ClusterExecutor(
        [pkg.JobSpec("a", 3, 25, profile="vgg19"),
         pkg.JobSpec("b", 2, 20, profile="resnet50")],
        pkg.MaxThroughput(), devices=list(range(6)), resched_every=2,
        trainer_factory=fake_for(pkg), checkpointer=FakeCheckpointer(),
        faults=plan)
    stats = ex.run(max_rounds=120)
    ex.close()
    return without_wall_clock({"log": ex.injector.log, "events": ex.events,
                               "stats": stats})


@pytest.mark.parametrize("seed", range(6))
def test_injector_replays_the_same_sequence(seed):
    want, got = replay(REF, seed), replay(PORT, seed)
    assert want["log"]
    assert got["log"] == want["log"]
    assert got["events"] == want["events"]
    assert got["stats"] == want["stats"]
