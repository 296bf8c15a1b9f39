"""The port's failure handling on the CPU: approximate and consistent
recovery (``core/failure.py``), and the chaos twins of
``tests/test_system.py`` — a killed worker or leader is detected by missed
gradient-syncs and recovered by a stop-free scale-in, with the virtual
trajectory kept bit for bit."""
import contextlib
import io
import json

import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer, checkpoint_save
from repro_torch.core.failure import fail_worker, recover
from repro_torch.launch import train as port_train


def _trainer(**kw):
    args = dict(global_batch=6, seq_len=32, init_parallelism=3,
                n_samples=256, d_partitions=16, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(get_config("edl-paper", smoke=True), **args)


def _main(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main(["--device", "cpu", "--smoke", "--json",
                                "--seq", "32", "--n-samples", "256",
                                "--d-partitions", "16", "--devices", "4",
                                *argv]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_failure_approximate_recovery(monkeypatch):
    """Twin of the reference test: with USE_APPX_RECOVERY=1, ``fail`` at
    p = 3 recovers at once onto the 2 survivors and training goes on with
    a falling loss."""
    monkeypatch.setenv("USE_APPX_RECOVERY", "1")
    s = _main("--init-p", "3", "--batch", "6", "--steps", "40",
              "--schedule", "fail:1@10")
    ops = [e["op"] for e in s["scaling_events"]]
    assert "approx_recovery" in ops
    assert s["final_p"] == 2
    assert s["final_loss"] < s["first_loss"]


def test_consistent_recovery_from_a_periodic_checkpoint(tmp_path,
                                                        monkeypatch):
    """Without USE_APPX_RECOVERY the survivors restart from the last
    periodic checkpoint: its step, and under K = 6 its exact trajectory."""
    monkeypatch.delenv("USE_APPX_RECOVERY", raising=False)
    with _trainer(virtual_workers=6) as t:
        static = [t.step()["loss"] for _ in range(8)]
    with _trainer(virtual_workers=6) as t:
        t.run(3)
        checkpoint_save(t, str(tmp_path))
        t.run(2)
        fail_worker(t, t.worker_ids[-1])
        with pytest.raises(ValueError, match="periodic checkpoint"):
            recover(t)
        rec = recover(t, checkpoint_dir=str(tmp_path))
        assert (rec.op, rec.from_p, rec.to_p) == ("consistent_recovery", 3, 2)
        assert (t.p, t.step_idx, len(t.worker_ids)) == (2, 3, 2)
        after = [t.step()["loss"] for _ in range(5)]
    assert after == static[3:]


def test_vw_determinism_survives_worker_kill():
    """Twin of the reference chaos test: a worker of the K = 8 run at p = 4
    is killed with no recovery call; detection scales in to 2 (8 % 3 != 0
    skips p = 3), and the losses equal the static p = 2 run's."""
    static = _main("--init-p", "2", "--virtual-workers", "8", "--batch", "8",
                   "--steps", "12")
    killed = _main("--init-p", "4", "--virtual-workers", "8", "--batch", "8",
                   "--steps", "12", "--schedule", "kill:1@4")
    assert killed["final_p"] == 2
    sin = [e for e in killed["scaling_events"] if e["op"] == "scale_in"]
    assert sin and (sin[0]["from_p"], sin[0]["to_p"]) == (4, 2)
    assert len(static["losses"]) == 12 and len(killed["losses"]) >= 12
    assert killed["losses"][:12] == static["losses"]


def test_leader_death_reelects_and_training_continues():
    """Twin of the reference chaos test: killing the leader is detected,
    scales in 3 -> 2 and a survivor wins the re-election at the commit."""
    s = _main("--init-p", "3", "--virtual-workers", "6", "--batch", "6",
              "--steps", "30", "--schedule", "kill_leader:1@5")
    assert s["final_p"] == 2
    sin = [e for e in s["scaling_events"] if e["op"] == "scale_in"]
    assert sin and (sin[0]["from_p"], sin[0]["to_p"]) == (3, 2)
    assert s["leader"] != "w0", "a survivor must win the re-election"
    assert s["final_loss"] < s["first_loss"]


def test_handle_failure_moves_the_dead_slot_to_the_tail():
    """The dead worker's slot goes to the end of the pool, so the survivor
    shape is built from live slots, and a release hands it back."""
    freed = []
    with _trainer(devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"]) as t:
        t.on_devices_released = lambda tr, devs: freed.extend(devs)
        t.run(1)
        dead = t.inject_worker_failure(t.worker_ids[0])
        t.run(4)
        assert t.dead_workers() == [dead]
        rec = t.handle_failure(t.dead_workers(), block=True)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("scale_in", 3, 2, 2)
        assert dead not in t.worker_ids and not t.failed_workers
        assert [str(d) for d in freed] == ["cpu:0", "cpu:3"]
        assert [str(d) for d in t.devices] == ["cpu:1", "cpu:2"]
        assert t.leader_id == t.worker_ids[0] != dead


@pytest.mark.parametrize("mode", ["approx", "consistent"])
def test_recovery_moves_the_dead_slot_to_the_tail(mode, tmp_path,
                                                  monkeypatch):
    """Both recoveries rebuild the topology on the survivors' own slots:
    the dead leader's slot goes to the pool's tail, never into the new
    shape."""
    monkeypatch.setenv("USE_APPX_RECOVERY",
                       "1" if mode == "approx" else "0")
    with _trainer(devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"]) as t:
        t.run(2)
        checkpoint_save(t, str(tmp_path))
        dead = t.worker_ids[0]
        fail_worker(t, dead)
        rec = recover(t, checkpoint_dir=str(tmp_path))
        assert (rec.op, rec.from_p, rec.to_p, t.p) == (
            f"{mode}_recovery", 3, 2, 2)
        assert [str(d) for d in t.devices] == ["cpu:1", "cpu:2", "cpu:0",
                                               "cpu:3"]
        assert [str(d) for d in t.exec.devices] == ["cpu:1", "cpu:2"]
        assert dead not in t.worker_ids and t.leader_id == t.worker_ids[0]
        assert t.step()["p"] == 2


def test_grant_and_release_hand_slots_over():
    """A granted slot joins the pool at once and the job scales out onto
    it; a release scales in and hands the freed slot to the hook."""
    freed = []
    with _trainer(init_parallelism=1, global_batch=4,
                  devices=["cpu"]) as t:
        t.on_devices_released = lambda tr, devs: freed.extend(devs)
        t.run(1)
        with pytest.raises(ValueError, match="at least one"):
            t.grant_devices([])
        rec = t.grant_devices(["cpu"], block=True)
        assert (rec.op, rec.to_p, t.p, len(t.devices)) == ("scale_out", 2,
                                                           2, 2)
        rec = t.release_devices(1, block=True)
        assert (rec.op, rec.to_p, t.p, len(t.devices)) == ("scale_in", 1,
                                                          1, 1)
        assert [str(d) for d in freed] == ["cpu"]
