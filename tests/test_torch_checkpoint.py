"""The port's checkpoint format and stop-resume on the CPU: bit-exact round
trips (fp32, and bf16 through the reference's 2-byte ``V2`` records),
resumes across the two packages in both directions, and the stop-resume
baseline of ``tests/test_system.py``."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer, checkpoint_save, \
    resume_from_checkpoint, stop_resume_rescale
from repro_torch.models.params import tree_leaves
from test_torch_model import _fan_in_scaled

BATCH, SEQ, N_SAMPLES, D_PARTS = 4, 64, 64, 8
# a resume in the other package continues the writer's trajectory: the
# trainer-trajectory tolerance of test_torch_trainer.py, from the same
# rescaled state
TRAJ_RTOL = 1e-4


def _trainer(arch="edl-paper", cfg=None, **kw):
    args = dict(global_batch=BATCH, seq_len=SEQ, init_parallelism=1,
                n_samples=N_SAMPLES, d_partitions=D_PARTS, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(cfg or get_config(arch, smoke=True), **args)


def _jax_trainer():
    from repro.configs import get_config as jax_get_config
    from repro.core import ElasticTrainer as JaxElasticTrainer
    return JaxElasticTrainer(jax_get_config("edl-paper", smoke=True),
                             global_batch=BATCH, seq_len=SEQ,
                             init_parallelism=1, n_samples=N_SAMPLES,
                             d_partitions=D_PARTS, seed=0,
                             devices=jax.devices()[:1])


def _scaled_jax_state(jt) -> dict:
    state = jax.tree.map(np.asarray, jt.state)
    state["params"] = _fan_in_scaled(state["params"])
    return state


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same_state(a: dict, b: dict):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(_bits(x), _bits(y)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype, tmp_path):
    """Save, resume into a fresh trainer: the same state bits, and the same
    next loss (virtual workers make the next batch the same one; the
    dynamic pipeline replays an in-flight partition in another order).
    bf16 is rwkv6 SMOKE with bf16 params (fp32 moments)."""
    if dtype == "float32":
        cfg = get_config("edl-paper", smoke=True)
    else:
        cfg = dataclasses.replace(get_config("rwkv6-1.6b", smoke=True),
                                  param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    with _trainer(cfg=cfg, virtual_workers=BATCH) as t:
        t.run(2)
        checkpoint_save(t, str(tmp_path))
        with np.load(tmp_path / "state.npz") as z:
            kinds = {z[k].dtype.str for k in z.files}
        want_next = t.step()["loss"]
        saved = t.state
    if dtype == "bfloat16":
        assert "|V2" in kinds        # the reference's bf16 records
    with _trainer(cfg=cfg, virtual_workers=BATCH) as r:    # at its init
        resume_from_checkpoint(r, str(tmp_path))
        assert r.step_idx == 2
        state, _ = load_checkpoint(str(tmp_path))
        _assert_same_state(r.state, state)
        assert r.step()["loss"] == want_next
        _assert_same_state(r.state, saved)


def test_reads_a_jax_written_bf16_checkpoint_bit_exact(tmp_path):
    from repro.checkpoint import save_checkpoint as jax_save
    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    jcfg = jax_get_config("rwkv6-1.6b", smoke=True)
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jax_save(str(tmp_path), {"params": params}, step=0)
    got, meta = load_checkpoint(str(tmp_path))
    assert meta["step"] == 0
    want = dict(tree_leaves(jax.tree.map(np.asarray, params)))
    got = dict(tree_leaves(got["params"]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      w.view(np.int16), err_msg=k)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    from repro.core import checkpoint_save as jax_checkpoint_save
    jt = _jax_trainer()
    state = _scaled_jax_state(jt)
    jt.state = jax.tree.map(lambda a, old: jax.device_put(a, old.sharding),
                            state, jt.state)
    [jt.step() for _ in range(2)]
    jax_checkpoint_save(jt, str(tmp_path))
    want = [jt.step()["loss"] for _ in range(3)]
    with _trainer() as pt:
        resume_from_checkpoint(pt, str(tmp_path))
        assert (pt.step_idx, pt.samples_seen) == (2, 2 * BATCH)
        got = [pt.step()["loss"] for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    from repro.core import resume_from_checkpoint as jax_resume
    jt = _jax_trainer()
    state = _scaled_jax_state(jt)
    with _trainer() as pt:
        pt.state = bridge.state_from_numpy(state, "cpu")
        pt.run(2)
        checkpoint_save(pt, str(tmp_path))
        want = [pt.step()["loss"] for _ in range(3)]
    meta = jax_resume(jt, str(tmp_path))
    assert meta["reshard"]["bytes_moved"] >= 0 and jt.step_idx == 2
    got = [jt.step()["loss"] for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_jax_checkpoint_written_at_mp2_resumes(tmp_path):
    """A JAX writer at (dp, mp) = (1, 2) records a spec with model-axis
    shards, but its npz holds whole arrays: the port checks the spec's
    collection path by path and restores the arrays as they are. The spec
    is the reference's own device-free layout for that shape."""
    from repro.core import checkpoint_save as jax_checkpoint_save
    from repro.optim import adamw as jax_adamw
    from repro.reshape import StateSpec as JaxStateSpec
    jt = _jax_trainer()
    jt.step()
    jax_checkpoint_save(jt, str(tmp_path))
    path = os.path.join(tmp_path, "meta.json")
    with open(path) as f:
        meta = json.load(f)
    spec = JaxStateSpec.for_config(jt.cfg, jax_adamw(1e-3), 1, 2)
    assert any("model" in t.axes for t in spec.tensors)
    meta["extra"].update(mp=2, state_spec=spec.to_json())
    with open(path, "w") as f:
        json.dump(meta, f)
    with _trainer() as pt:
        resume_from_checkpoint(pt, str(tmp_path))
        state, _ = load_checkpoint(str(tmp_path))
        _assert_same_state(pt.state, state)


def test_a_foreign_collection_is_refused(tmp_path):
    with _trainer("rwkv6-1.6b") as t:
        checkpoint_save(t, str(tmp_path))
    with _trainer() as t, pytest.raises(ValueError, match="does not match"):
        resume_from_checkpoint(t, str(tmp_path))


def test_stop_resume_is_much_slower():
    """Twin of the reference test: the stop-resume baseline stops training
    for more than 10x a stop-free scale-out's stop."""
    with _trainer(init_parallelism=2) as t:
        t.run(2)
        out = t.scale_out(2, block=True)
        t.run(2)
        sr = stop_resume_rescale(t, 2)
        t.run(2)
    assert (sr.op, sr.from_p, sr.to_p, t.p) == ("stop_resume", 4, 2, 2)
    assert sr.stop_time > 10 * out.stop_time, (sr.summary(), out.summary())


def test_stop_resume_in_keeps_the_virtual_trajectory():
    """The dp half of test_checkpoint_restore_cross_shape_bitwise: under
    K = 8, a stop-resume 4 -> 2 follows the static p = 1 losses exactly."""
    kw = dict(global_batch=8, seq_len=32, n_samples=256, virtual_workers=8)
    with _trainer(**kw) as t:
        static = [t.step()["loss"] for _ in range(8)]
    with _trainer(init_parallelism=4, **kw) as t:
        t.run(4)
        rec = stop_resume_rescale(t, 2)
        t.run(4)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("stop_resume", 4, 2,
                                                        2)
        assert [m["loss"] for m in t.metrics_log] == static


def test_virtual_workers_mismatch_raises(tmp_path):
    kw = dict(global_batch=8, seq_len=32, n_samples=256)
    with _trainer(virtual_workers=8, **kw) as t:
        t.step()
        checkpoint_save(t, str(tmp_path))
    with _trainer(virtual_workers=4, **kw) as t, \
            pytest.raises(ValueError, match="virtual_workers=8"):
        resume_from_checkpoint(t, str(tmp_path))


def test_stop_resume_beyond_model_parallel_1_is_not_ported():
    """RWKV6 has no tensor-parallel form yet: its stop-resume to mp = 2 is
    refused before anything is torn down."""
    with _trainer("rwkv6-1.6b") as t, \
            pytest.raises(NotImplementedError, match="not yet ported"):
        stop_resume_rescale(t, 1, target_mp=2)
    assert t.state is not None and t.model_parallel == 1
