"""The port's elastic trainer on the CPU: a loss trajectory against the JAX
``ElasticTrainer`` from the same initial state and data, the elasticity
contracts of ``tests/test_system.py`` on four CPU slots, and the driver's
command line."""
import contextlib
import io
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.launch import train as port_train
from repro_torch.optim import adamw
from test_torch_model import _fan_in_scaled

ROOT = os.path.join(os.path.dirname(__file__), "..")
BATCH, SEQ, N_SAMPLES, D_PARTS = 4, 64, 64, 8
# From the JAX initial state with its stacked layer weights rescaled to std
# 1/sqrt(d_in) (a well-conditioned point; at the reference's own init the
# fp32 trajectory is chaotic, see test_torch_model.py) the port's 5 losses
# agree with the JAX trainer's to 7.1e-8 (measured). The AdamW updates move
# the losses by up to 7.1e-4 from those of the same run without updates
# (measured), and the test checks that they move by more than
# UPDATE_MARGIN x TRAJ_RTOL, so a trainer that skips its update fails.
TRAJ_RTOL = 1e-4
UPDATE_MARGIN = 5
# the JSON keys of ``repro.launch.train --json``
REFERENCE_KEYS = {"arch", "steps", "final_p", "wall_s", "final_loss",
                  "first_loss", "losses", "virtual_workers", "throughput",
                  "scaling_events", "samples_seen", "unique_sample_frac",
                  "epochs_done", "leader"}


def _trainer(**kw):
    args = dict(global_batch=BATCH, seq_len=SEQ, init_parallelism=1,
                n_samples=N_SAMPLES, d_partitions=D_PARTS, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(get_config("edl-paper", smoke=True), **args)


def _main(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main(["--device", "cpu", "--smoke", "--json",
                                *argv]) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_loss_trajectory_matches_jax_trainer():
    from repro.configs import get_config as jax_get_config
    from repro.core import ElasticTrainer as JaxElasticTrainer

    jt = JaxElasticTrainer(jax_get_config("edl-paper", smoke=True),
                           global_batch=BATCH, seq_len=SEQ,
                           init_parallelism=1, n_samples=N_SAMPLES,
                           d_partitions=D_PARTS, seed=0,
                           devices=jax.devices()[:1])
    state = jax.tree.map(np.asarray, jt.state)
    state["params"] = _fan_in_scaled(state["params"])
    jt.state = jax.tree.map(
        lambda a, old: jax.device_put(a, old.sharding), state, jt.state)
    want = np.array([jt.step()["loss"] for _ in range(5)])

    def port_losses(**kw):
        with _trainer(**kw) as pt:
            # the same samples, then the same initial state
            a, b = jt.dataset.read(0, N_SAMPLES), pt.dataset.read(0, N_SAMPLES)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            pt.state = [bridge.params_from_numpy(state, "cpu")]
            return np.array([pt.step()["loss"] for _ in range(5)])

    np.testing.assert_allclose(port_losses(), want, rtol=TRAJ_RTOL)
    frozen = port_losses(optimizer=adamw(0.0))
    assert np.max(np.abs(frozen - want) / want) > UPDATE_MARGIN * TRAJ_RTOL


def test_scale_out_then_in_commit_stop_free():
    """1 -> 2 -> 1 on one trainer: the scale-out preps a new shape, whose
    stop is shorter than its prep; the scale-in returns to the launch shape
    (a cache hit) and its stop stays as short as the reference asks."""
    with _trainer() as t:
        t.run(2)
        out = t.scale_out(1, block=True)
        assert (out.op, out.from_p, out.to_p, t.p) == ("scale_out", 1, 2, 2)
        assert not out.compile_cache_hit
        assert out.stop_time < out.prep_time, out.summary()
        t.run(2)
        rin = t.scale_in(1, block=True)
        assert (rin.op, rin.from_p, rin.to_p, t.p) == ("scale_in", 2, 1, 1)
        assert rin.compile_cache_hit and rin.stop_time < 0.5
        t.run(2)
        assert all(math.isfinite(m["loss"]) for m in t.metrics_log)
        assert len(t.worker_ids) == 1


def test_scale_in_to_a_new_shape_is_stop_free():
    with _trainer(init_parallelism=2) as t:
        t.run(2)
        rec = t.scale_in(1, block=True)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("scale_in", 2, 1, 1)
        assert not rec.compile_cache_hit
        assert rec.stop_time < rec.prep_time, rec.summary()
        t.run(2)
        assert all(math.isfinite(m["loss"]) for m in t.metrics_log)


def test_default_pool_scales_out():
    """With no ``devices`` the pool is every visible device (one slot per
    CPU core here), as the reference's is ``jax.devices()``: a job launched
    at p = 1 can grow."""
    with _trainer(devices=None) as t:
        assert len(t.devices) == os.cpu_count()
        t.run(1)
        rec = t.scale_out(1, block=True)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("scale_out", 1, 2, 2)
        t.run(1)
        assert all(math.isfinite(m["loss"]) for m in t.metrics_log)


def test_background_scale_out_keeps_training():
    """Without ``block`` the prep runs in its own thread while the current
    topology steps; the switch commits at a later mini-batch boundary."""
    with _trainer() as t:
        t.run(1)
        assert t.scale_out(1) is None
        rec = t.wait_for_scaling()
        assert rec.op == "scale_out" and t.p == 2
        assert rec.stop_time < rec.prep_time


def test_migrate_is_one_switch():
    with _trainer(init_parallelism=2) as t:
        t.run(2)
        before = list(t.worker_ids)
        rec = t.migrate(1, block=True)
        assert (rec.op, rec.from_p, rec.to_p) == ("migrate", 2, 2)
        assert len(t.controller.history) == 1
        assert t.worker_ids[0] == before[0]
        assert before[1] not in t.worker_ids and len(t.worker_ids) == 2


def test_straggler_is_removed():
    """A slowed worker is flagged after 10 consecutive steps above 1.2x the
    median and leaves through a graceful scale-in. Its simulated sync delay
    is 10 s (the trainer sleeps at most 50 ms of it a step), so no stall
    of a loaded host can hide it, as it can the training driver's 50 ms."""
    with _trainer(init_parallelism=3, global_batch=6, seq_len=16,
                  n_samples=512) as t:
        wid = t.worker_ids[-1]
        t.injected_delay[wid] = 10.0
        flagged = []
        for _ in range(12):
            assert t.step() is not None
            flagged += t._flagged_stragglers
        assert flagged == [wid]
        t.injected_delay.pop(wid)
        rec = t.scale_in(1, victims=[wid], block=True)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("scale_in", 3, 2, 2)
        assert wid not in t.worker_ids and len(t.worker_ids) == 2


def test_exactly_once_across_scaling():
    s = _main("--init-p", "1", "--batch", "4", "--devices", "4",
              "--seq", "32", "--n-samples", "32", "--d-partitions", "8",
              "--steps", "12", "--schedule", "out:1@2,in:1@6")
    assert [e["op"] for e in s["scaling_events"]] == ["scale_out",
                                                      "scale_in"]
    assert s["epochs_done"] >= 1
    assert s["epoch0_exactly_once"] is True
    assert all(math.isfinite(x) for x in s["losses"])


@pytest.mark.parametrize("argv", [["--schedule", "bogus:1@3"]])
def test_unported_options_are_refused_when_parsed(argv, capsys):
    with pytest.raises(SystemExit) as e:
        port_train.main(["--device", "cpu", "--smoke", *argv])
    assert e.value.code == 2
    assert "bogus" in capsys.readouterr().err


@pytest.mark.parametrize("argv, mp", [
    (["--arch", "rwkv6-1.6b", "--schedule", "stop_resume_mp:2@1"], 2),
    (["--arch", "rwkv6-1.6b", "--model-parallel", "2"], None),
    (["--arch", "mixtral-8x7b", "--model-parallel", "2"], None),
    (["--arch", "deepseek-v2-236b", "--model-parallel", "2"], None)])
def test_model_parallel_options_run(argv, mp):
    """The model axis for RWKV6, MoE and MLA through the entry point: a
    job at ``--model-parallel 2``, or a ``stop_resume_mp:2`` onto it, runs
    with finite losses at the (p, mp) asked."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main([
            "--device", "cpu", "--smoke", "--json", "--steps", "3",
            "--batch", "4", "--seq", "32", "--devices", "2", "--init-p",
            "1", "--n-samples", "64", "--d-partitions", "4", *argv]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert s["final_p"] == 1 and len(s["losses"]) == 3
    assert all(math.isfinite(x) for x in s["losses"])
    if mp:
        (rec,) = s["scaling_events"]
        assert (rec["op"], rec["from_mp"], rec["to_mp"]) == (
            "stop_resume", 1, mp)


@pytest.mark.parametrize("argv, op", [
    (["--init-p", "2", "--schedule", "fail:1@1"], "approx_recovery"),
    (["--init-p", "2", "--schedule", "stop_resume_in:1@1"], "stop_resume"),
    (["--init-p", "2", "--schedule", "kill_leader:1@1", "--steps", "8"],
     "scale_in"),
    (["--init-p", "1", "--virtual-workers", "4"], None)])
def test_ported_options_are_accepted(argv, op, monkeypatch):
    """The options the port used to refuse: a 3-step CPU run exits 0 and
    reports the op (``kill_leader`` runs 8 steps: detection needs more than
    ``miss_threshold`` = 3 missed syncs, then its scale-in commits)."""
    monkeypatch.setenv("USE_APPX_RECOVERY", "1")
    s = _main("--batch", "4", "--seq", "32", "--devices", "2",
              "--n-samples", "64", "--d-partitions", "8", "--steps", "3",
              *argv)
    assert s["steps"] >= 3 and all(math.isfinite(x) for x in s["losses"])
    if op is None:
        assert s["virtual_workers"] == 4 and s["unique_sample_frac"] == 1.0
    else:
        assert [e["op"] for e in s["scaling_events"]] == [op]
        assert s["final_p"] == 1


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA request is honoured")
    with pytest.raises(RuntimeError, match="CUDA"):
        _trainer(devices=None, device="cuda")


def test_cli_prints_reference_json_keys():
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--smoke", "--json", "--steps", "4", "--batch", "4",
           "--seq", "32", "--devices", "2", "--init-p", "1",
           "--n-samples", "1024", "--d-partitions", "8",
           "--schedule", "out:1@1"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    s = json.loads(out.stdout.strip().splitlines()[-1])
    assert REFERENCE_KEYS <= set(s), REFERENCE_KEYS - set(s)
    assert set(s) - REFERENCE_KEYS <= {"epoch0_exactly_once"}
    assert s["arch"] == "edl-paper-smoke" and s["steps"] >= 4
    assert s["unique_sample_frac"] == 1.0
