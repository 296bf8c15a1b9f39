"""The model axis for every mixer and FFN on the CPU: the trainer at
(1, 2) for the SMOKEs of rwkv6, mixtral (MoE), deepseek-v2 (MLA and MoE
with shared experts) and jamba (Mamba, GQA and MoE) against the JAX
trainer itself at (1, 2) on two forced host devices (its GSPMD
tensor-parallel step), and the ``==`` contract of virtual workers across a
live reshape onto the model axis and a ``stop_resume_mp`` for rwkv6 and
mixtral."""
import contextlib
import functools
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer, stop_resume_rescale
from repro_torch.launch import train as port_train
from repro_torch.optim import adamw
from test_torch_tensor_parallel import TRAJ_RTOL, UPDATE_MARGIN, \
    jax_trainer_trajectories

ARCHS = ("rwkv6-1.6b", "mixtral-8x7b", "deepseek-v2-236b", "jamba-v0.1-52b")
# the trajectories: 5 AdamW 1e-3 steps on fresh batches of 4 x 32 (the
# data of test_torch_rwkv.py's trajectory test) from the JAX init with its
# stacked layer matrices rescaled to 1/sqrt(d_in). Not one batch refitted,
# as test_torch_tensor_parallel.py's edl_paper trajectories: rwkv6 SMOKE
# memorises it (6.70 -> 1.11 in 5 steps), where AdamW's sign steps on
# near-zero gradients amplify the summation order, so that even at (1, 1)
# the port parts from the JAX trainer by 1.8e-4 (and each package's (1, 2)
# from its own (1, 1) by 4.6e-5 in JAX, 9.4e-5 in the port:
# tools/torch_tp_gap_probe.py --part refit).
BATCH, SEQ, N_SAMPLES, D_PARTS = 4, 32, 64, 8


@pytest.fixture(scope="module")
def jax_trajectories(tmp_path_factory):
    """Each arch's (rescaled initial numpy state, 5 losses) of the JAX
    trainer at (1, 2), all from one subprocess."""
    return jax_trainer_trajectories(ARCHS, 1, 2, BATCH, SEQ, N_SAMPLES,
                                    D_PARTS,
                                    str(tmp_path_factory.mktemp("jax_1x2")))


def _port_losses(arch, state, **kw):
    with ElasticTrainer(get_config(arch, smoke=True), global_batch=BATCH,
                        seq_len=SEQ, init_parallelism=1, model_parallel=2,
                        n_samples=N_SAMPLES, d_partitions=D_PARTS, seed=0,
                        devices=["cpu"] * 2, device="cpu",
                        time_allowance_s=0, **kw) as t:
        t.state = bridge.shard_state_from_numpy(
            state, t.exec.layout, t.exec.devices)
        assert isinstance(t.state, list) and len(t.state) == 2
        return np.array([t.step()["loss"] for _ in range(5)])


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectory_at_1x2_matches_the_jax_trainer_at_1x2(arch,
                                                         jax_trajectories):
    """The port's tensor-parallel trainer at (1, 2) follows the JAX trainer
    at (1, 2) from the same state and data (fp32 SMOKEs; rwkv6's WKV6 op
    runs its plain versions here, as the JAX trainer runs ``wkv6_scan``),
    and its updates move the losses by more than the tolerance."""
    assert get_config(arch, smoke=True).compute_dtype == "float32"
    state, want = jax_trajectories[arch]
    np.testing.assert_allclose(_port_losses(arch, state), want,
                               rtol=TRAJ_RTOL)
    frozen = _port_losses(arch, state, optimizer=adamw(0.0))
    assert np.max(np.abs(frozen - want) / want) > UPDATE_MARGIN * TRAJ_RTOL


# --------------------------------------------- == under virtual workers
VW_ARCHS = ("rwkv6-1.6b", "mixtral-8x7b")
VW = dict(global_batch=8, seq_len=32, n_samples=256, d_partitions=8,
          virtual_workers=8, seed=0, devices=["cpu"] * 2, device="cpu",
          time_allowance_s=0)


@functools.lru_cache(maxsize=None)
def _static_vw_losses(arch: str, n: int) -> tuple:
    with ElasticTrainer(get_config(arch, smoke=True), init_parallelism=1,
                        **VW) as t:
        return tuple(t.step()["loss"] for _ in range(n))


@pytest.mark.parametrize("arch", VW_ARCHS)
def test_virtual_losses_equal_across_a_reshape_and_stop_resume_mp(arch):
    """Under K = 8 a job at (2, 1) reshaped live to (1, 2), back to (2, 1)
    and then stop-resumed onto mp = 2 gives the static (1, 1) losses with
    ==, step for step."""
    with ElasticTrainer(get_config(arch, smoke=True), init_parallelism=2,
                        **VW) as t:
        t.run(2)
        a = t.reshape(1, 2, block=True)
        t.run(2)
        t.reshape(2, 1, block=True)
        t.run(1)
        b = stop_resume_rescale(t, 1, target_mp=2)
        t.run(2)
        assert (t.p, t.model_parallel) == (1, 2)
        losses = [m["loss"] for m in t.metrics_log]
    assert (a.op, a.from_p, a.to_p, a.from_mp, a.to_mp) == (
        "reshape", 2, 1, 1, 2)
    assert a.stop_time < a.prep_time, a.summary()
    assert (b.op, b.to_mp) == ("stop_resume", 2)
    assert losses == list(_static_vw_losses(arch, len(losses)))


@pytest.mark.parametrize("arch", VW_ARCHS)
def test_entry_point_stop_resume_mp_keeps_the_virtual_losses(arch):
    """The entry point's ``stop_resume_mp:2`` at (2, 1) resumes at (1, 2)
    on the static trajectory, loss for loss."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main([
            "--device", "cpu", "--smoke", "--json", "--arch", arch,
            "--batch", "8", "--seq", "32", "--devices", "2", "--n-samples",
            "256", "--d-partitions", "8", "--steps", "5", "--init-p", "2",
            "--virtual-workers", "8", "--schedule",
            "stop_resume_mp:2@2"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    (rec,) = s["scaling_events"]
    assert (rec["op"], rec["from_p"], rec["to_p"], rec["from_mp"],
            rec["to_mp"]) == ("stop_resume", 2, 1, 1, 2)
    assert s["losses"] == list(_static_vw_losses(arch, len(s["losses"])))


# ------------------------------------------------------- the cluster tier
@pytest.mark.parametrize("arch", VW_ARCHS)
def test_cluster_tenant_is_reshaped_onto_the_model_axis(arch):
    """An ``mp=auto`` SMOKE tenant of ``arch`` on two CPU slots, RESHAPEd
    live by the executor from (2, 1) to (1, 2) and back: it finishes its
    steps with finite losses, slots conserved every round."""
    from repro_torch.cluster import ClusterExecutor, JobSpec, ScriptedPolicy
    from repro_torch.devices import slot_devices
    spec = JobSpec("flex", 2, 10, profile="vgg19", mp_auto=True, arch=arch,
                   global_batch=4, seq_len=16, n_samples=64, d_partitions=8)
    ex = ClusterExecutor([spec], ScriptedPolicy({2: {0: (1, 2)},
                                                 6: {0: (2, 1)}}),
                         devices=slot_devices(2, "cpu"), prep_yield_s=2.0,
                         resched_every=1)
    try:
        stats = ex.run(max_rounds=80)
        losses = [m["loss"] for m in ex.jobs[0].trainer.metrics_log]
    finally:
        ex.close()
    shapes = [(e["to_p"], e["to_mp"]) for e in stats["events"]
              if e["op"] == "reshape"]
    assert shapes == [(1, 2), (2, 1)], stats["events"]
    assert stats["finished"] == 1 and stats["conserved"]
    assert ex.jobs[0].steps_done == 10
    assert losses and all(np.isfinite(losses))
