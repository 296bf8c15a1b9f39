"""The port's tensor parallelism on the CPU: the fixed-order collectives,
each tensor-parallel module against the port's mp = 1 module, the trainer's
trajectories at (1, 2), (2, 2) and (1, 4) against the JAX trainer, the
``==`` contract of virtual workers across ``reshape`` and
``stop_resume_mp``, the live reshape, and the group arithmetic of grants
and kills at mp = 2."""
import contextlib
import functools
import io
import json
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
from repro_torch.core import CompileService, ElasticTrainer, \
    PRIO_SPECULATIVE
from repro_torch.launch import train as port_train
from repro_torch.models import model as M
from repro_torch.models.attention import attention_forward_tp, gqa_forward
from repro_torch.models.layers import apply_embed, apply_embed_tp, \
    apply_mlp, apply_mlp_tp
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import ShardedParams, copy_to_model, model_dims, \
    reduce_from_model
from repro_torch.training.step import group_loss_and_grads, \
    loss_and_grads, port_layout, split_tree
from test_torch_model import _fan_in_scaled

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = get_config("edl-paper", smoke=True)
OPT = adamw(1e-3)
# a tensor-parallel module against the mp = 1 module on the same fp32
# inputs: the shards split the contractions over heads, d_ff or vocab, so
# their sums round in another order; each element within MODULE_RTOL of
# its value, with a floor of MODULE_RTOL x the largest entry (elements
# that cancel to near zero carry the rounding of their summands; measured:
# at most 5.6e-7 of the largest entry, forward and gradients, mp 2 and 4)
MODULE_RTOL = 1e-5
# the trainer trajectories: the tolerance and update margin of
# test_torch_trainer.py, from the same rescaled JAX state. The dataset is
# one global batch, so every step trains on the whole of it at every p
# (only the order within the batch follows p, as in the reference's
# test_checkpoint_saved_at_2x2_resumes_at_4x1_same_loss_trajectory).
# Measured: the port at (1, 2), (2, 2) and (1, 4) within 5.5e-7 of the
# JAX losses; without updates the losses differ from them by 1.2x.
BATCH, SEQ, N_SAMPLES, D_PARTS = 4, 64, 4, 2
TRAJ_RTOL = 1e-4
UPDATE_MARGIN = 5


def _close(got, want, what=""):
    want = want.detach()
    torch.testing.assert_close(
        got.detach(), want, rtol=MODULE_RTOL,
        atol=MODULE_RTOL * float(want.abs().max()), msg=what)


def _rng_tensor(rng, *shape, scale=1.0):
    return torch.from_numpy(np.asarray(rng.standard_normal(shape) * scale,
                                       dtype=np.float32))


# ------------------------------------------------------------ collectives
@pytest.mark.parametrize("mp", [2, 4])
def test_collectives_sum_in_slot_order(mp):
    """``reduce_from_model`` is the left fold of the partials and hands each
    partial the output's gradient; ``copy_to_model`` hands out ``x`` and
    folds the slots' gradients left to right: the same bits every time."""
    rng = np.random.default_rng(mp)
    parts = [_rng_tensor(rng, 5, 7, scale=10.0 ** m).requires_grad_(True)
             for m in range(mp)]
    out = reduce_from_model(parts, "cpu")
    fold = parts[0].detach()
    for p in parts[1:]:
        fold = fold + p.detach()
    assert torch.equal(out, fold)
    g = _rng_tensor(rng, 5, 7)
    grads = torch.autograd.grad(out, parts, g)
    assert all(torch.equal(gp, g) for gp in grads)

    x = _rng_tensor(rng, 5, 7).requires_grad_(True)
    copies = copy_to_model(x, ["cpu"] * mp)
    assert len(copies) == mp and all(torch.equal(c, x) for c in copies)
    gs = [_rng_tensor(rng, 5, 7, scale=10.0 ** -m) for m in range(mp)]
    (gx,) = torch.autograd.grad(copies, x, gs)
    fold = gs[0]
    for gm in gs[1:]:
        fold = fold + gm
    assert torch.equal(gx, fold)


# ---------------------------------------------------------------- modules
def _sharded(mp, params):
    """``params`` (whole, differentiable) split into ``mp`` model shards
    on the CPU, by the port's layout at (1, mp)."""
    dims = model_dims(port_layout(CFG, OPT, 1, mp))
    return ShardedParams(split_tree(params, dims, ["cpu"] * mp), dims,
                         ("cpu",) * mp)


def _module_case(module, mp):
    """(mp = 1 output, tensor-parallel output, inputs to differentiate)
    of one module on seeded inputs."""
    rng = np.random.default_rng(7)
    params = tree_map(lambda t: t.detach().requires_grad_(True),
                      M.init_params(CFG, torch.Generator().manual_seed(0),
                                    "cpu"))
    sp = _sharded(mp, params)
    x = _rng_tensor(rng, 2, SEQ, CFG.d_model).requires_grad_(True)
    cd = torch.float32
    if module == "attention":
        pos = torch.arange(SEQ).expand(2, SEQ)
        p1 = tree_map(lambda t: t[0], params["layers"]["slot0"]["mixer"])
        tp = sp["layers"].periods()[0]["slot0"]["mixer"]
        want = gqa_forward(CFG, p1, x, positions=pos)[0]
        got = attention_forward_tp(CFG, tp, x, positions=pos)
        leaves = [x] + [t for _, t in tree_leaves(
            params["layers"]["slot0"]["mixer"])]
    elif module == "mlp":
        p1 = tree_map(lambda t: t[0], params["layers"]["slot0"]["ffn"])
        tp = sp["layers"].periods()[0]["slot0"]["ffn"]
        want, got = apply_mlp(p1, x, cd), apply_mlp_tp(tp, x, cd)
        leaves = [x] + [t for _, t in tree_leaves(
            params["layers"]["slot0"]["ffn"])]
    elif module == "embedding":
        toks = torch.from_numpy(rng.integers(0, CFG.vocab, (2, SEQ)))
        want = apply_embed(params["embed"], toks, cd)
        got = apply_embed_tp(sp["embed"], toks, cd)
        leaves = [params["embed"]["table"]]
    else:   # xent
        labels = torch.from_numpy(rng.integers(0, CFG.vocab, (2, SEQ)))
        want = M.chunked_xent(CFG, params, x, labels)
        got = M.chunked_xent_tp(CFG, sp, x, labels)
        leaves = [x, params["unembed"]["w"]]
    return want, got, leaves, rng


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("module", ["attention", "mlp", "embedding",
                                    "xent"])
def test_tensor_parallel_module_matches_mp1(module, mp):
    """Forward and gradient of each tensor-parallel module against the
    port's mp = 1 module on the same inputs; the vocab-parallel embedding's
    masked shards add exact zeros, so it is the lookup's bits."""
    want, got, leaves, rng = _module_case(module, mp)
    if module == "embedding":
        assert torch.equal(got, want)
    _close(got, want, f"{module} forward")
    r = _rng_tensor(rng, *want.shape)
    g_want = torch.autograd.grad((want * r).sum(), leaves,
                                 retain_graph=True)
    g_got = torch.autograd.grad((got * r).sum(), leaves)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        _close(a, b, f"{module} gradient {i}")


def test_unsplit_leaves_run_whole_with_the_same_bits():
    """At mp = 3 the rules leave every SMOKE leaf replicated (128, 256 and
    512 are not divisible by 3): every block runs whole on the first slot
    and the loss and gradients are those of mp = 1, bit for bit."""
    dims = model_dims(port_layout(CFG, OPT, 1, 3))
    assert all(d is None for _, d in tree_leaves(dims))
    params = M.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab, (2, SEQ)))
    batch = {"tokens": toks, "labels": torch.roll(toks, 1, 1)}
    loss, _, grads = loss_and_grads(CFG, params, batch)
    loss3, _, grads3 = group_loss_and_grads(
        CFG, split_tree(params, dims, ["cpu"] * 3), dims, ["cpu"] * 3, batch)
    assert torch.equal(loss, loss3)
    for m in range(3):
        for (k, a), (_, b) in zip(tree_leaves(grads), tree_leaves(grads3[m])):
            assert torch.equal(a, b), (m, k)


# ------------------------------------------------------------ trajectories
def _trainer(**kw):
    args = dict(global_batch=BATCH, seq_len=SEQ, init_parallelism=1,
                n_samples=N_SAMPLES, d_partitions=D_PARTS, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(CFG, **args)


@functools.lru_cache(maxsize=None)
def _jax_trajectory():
    """(rescaled initial numpy state, 5 losses) of the JAX trainer at
    (1, 1): test_loss_trajectory_matches_jax_trainer's reference."""
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
    return state, np.array([jt.step()["loss"] for _ in range(5)])


def _port_losses(state, p, mp, **kw):
    with _trainer(init_parallelism=p, model_parallel=mp, **kw) as t:
        t.state = bridge.shard_state_from_numpy(
            state, t.exec.layout, t.exec.devices[:mp])
        assert isinstance(t.state, list) and len(t.state) == mp
        return np.array([t.step()["loss"] for _ in range(5)])


@pytest.mark.parametrize("p, mp", [(1, 2), (2, 2), (1, 4)])
def test_trajectory_at_model_parallel_matches_jax_trainer(p, mp):
    """The port's tensor-parallel trainer at (p, mp) follows the JAX
    trainer at (1, 1) from the same state and data, and its updates move
    the losses by more than the tolerance."""
    state, want = _jax_trajectory()
    np.testing.assert_allclose(_port_losses(state, p, mp), want,
                               rtol=TRAJ_RTOL)
    frozen = _port_losses(state, p, mp, optimizer=adamw(0.0))
    assert np.max(np.abs(frozen - want) / want) > UPDATE_MARGIN * TRAJ_RTOL


_JAX_2X2 = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_model import _fan_in_scaled
from repro.configs import get_config
from repro.core import ElasticTrainer

jt = ElasticTrainer(get_config("edl-paper", smoke=True), global_batch={b},
                    seq_len={s}, init_parallelism=2, model_parallel=2,
                    n_samples={n}, d_partitions={d}, seed=0,
                    devices=jax.devices(), use_aot=False)
state = jax.tree.map(np.asarray, jt.state)
state["params"] = _fan_in_scaled(state["params"])
jt.state = jax.tree.map(lambda a, old: jax.device_put(a, old.sharding),
                        state, jt.state)
flat = {{}}
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            flat[pre + k] = np.asarray(v)
walk(state, "")
np.savez({out!r}, **flat)
print(json.dumps([jt.step()["loss"] for _ in range(5)]))
"""


def test_trajectory_at_2x2_matches_the_jax_trainer_at_2x2(tmp_path):
    """The JAX trainer itself at (2, 2) on four forced host devices (its
    GSPMD tensor-parallel step) against the port at (2, 2), from the same
    rescaled state."""
    out = str(tmp_path / "state.npz")
    script = _JAX_2X2.format(tests=os.path.dirname(__file__), b=BATCH,
                             s=SEQ, n=N_SAMPLES, d=D_PARTS, out=out)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    want = np.array(json.loads(run.stdout.strip().splitlines()[-1]))
    from repro_torch.reshape import unflatten_tree
    with np.load(out) as z:
        state = unflatten_tree({k: z[k] for k in z.files})
    np.testing.assert_allclose(_port_losses(state, 2, 2), want,
                               rtol=TRAJ_RTOL)


# --------------------------------------------- == under virtual workers
VW = dict(global_batch=8, seq_len=32, n_samples=256, virtual_workers=8)


@functools.lru_cache(maxsize=None)
def _static_vw_losses(n: int) -> tuple:
    with _trainer(**VW) as t:
        return tuple(t.step()["loss"] for _ in range(n))


def test_virtual_losses_equal_across_live_reshapes():
    """Under K = 8 a job at (4, 1) reshaped live to (2, 2) and then to
    (1, 4) gives the static (1, 1) losses with ==, step for step; each
    switch commits stop-free and its record carries the plan's bytes."""
    with _trainer(init_parallelism=4, **VW) as t:
        t.run(2)
        a = t.reshape(2, 2, block=True)
        t.run(2)
        b = t.reshape(1, 4, block=True)
        t.run(2)
        assert (t.p, t.model_parallel, len(t.worker_ids)) == (1, 4, 1)
        losses = [m["loss"] for m in t.metrics_log]
    assert [(r.op, r.from_p, r.to_p, r.from_mp, r.to_mp) for r in (a, b)] \
        == [("reshape", 4, 2, 1, 2), ("reshape", 2, 1, 2, 4)]
    for r in (a, b):
        assert r.stop_time < r.prep_time, r.summary()
        s = r.summary()
        assert s["reshard_bytes_moved"] + s["reshard_bytes_kept"] > 0
    assert b.reshard_bytes_moved > 0 and b.reshard_bytes_kept > 0
    assert losses == list(_static_vw_losses(len(losses)))


def test_virtual_losses_equal_across_stop_resume_mp():
    """The port's twin of test_checkpoint_restore_cross_shape_bitwise: the
    entry point's ``stop_resume_mp:2`` at (4, 1) resumes at (2, 2) on the
    static trajectory, loss for loss."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main([
            "--device", "cpu", "--smoke", "--json", "--batch", "8", "--seq",
            "32", "--devices", "4", "--n-samples", "256", "--d-partitions",
            "8", "--steps", "8", "--init-p", "4", "--virtual-workers", "8",
            "--schedule", "stop_resume_mp:2@3"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    (rec,) = s["scaling_events"]
    assert (rec["op"], rec["from_p"], rec["to_p"], rec["from_mp"],
            rec["to_mp"]) == ("stop_resume", 4, 2, 1, 2)
    assert s["final_p"] == 2
    assert s["losses"] == list(_static_vw_losses(len(s["losses"])))


# ----------------------------------------------------------- live reshape
def test_live_reshape_while_training_continues():
    """Twin of the reference's live compile-service reshape: a speculative
    prep of (2, 2) runs while the job keeps stepping at (4, 1); the reshape
    then joins the cached handle, needs no prep window, and stops briefly."""
    svc = CompileService(workers=2)
    try:
        with _trainer(init_parallelism=4, global_batch=12, n_samples=1024,
                      d_partitions=16, compile_service=svc,
                      time_allowance_s=0.1) as t:
            t.run(2)
            ticket = svc.submit(t._exec_key(2, 2),
                                lambda: t._build_exec(2, 2),
                                priority=PRIO_SPECULATIVE, owner="spec")
            spec_steps = 0
            while not ticket.done():    # training continues
                t.step()
                spec_steps += 1
            assert t.reshape(2, 2) is None
            rec = t.wait_for_scaling().summary()
            t.run(2)
            loss = t.metrics_log[-1]["loss"]
    finally:
        svc.shutdown()
    assert rec["op"] == "reshape" and rec["cache_hit"] is True, rec
    assert rec["steps_during_prep"] == 0
    assert rec["prep_s"] < 0.5 and rec["stop_s"] < 0.05, rec
    assert rec["exec_cache_key"][:2] == [2, 2]
    assert spec_steps >= 1
    assert np.isfinite(loss)


def test_reshape_release_hands_the_surplus_over_named():
    """A footprint-shrinking reshape with ``release`` hands the slots
    beyond p * mp to the hook, which learns that ``reshape`` freed them."""
    seen = []
    with _trainer(init_parallelism=4,
                  devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"]) as t:
        t.on_devices_released = lambda tr, devs: seen.append(
            (tr._releasing_op, [str(d) for d in devs]))
        t.run(1)
        rec = t.reshape(1, 2, block=True, release=True)
        assert (rec.op, t.p, t.model_parallel) == ("reshape", 1, 2)
        assert [str(d) for d in t.devices] == ["cpu:0", "cpu:1"]
        assert t._releasing_op is None
        assert np.isfinite(t.step()["loss"])
    assert seen == [("reshape", ["cpu:2", "cpu:3"])]


# -------------------------------------------------------- group arithmetic
def test_grants_move_whole_groups():
    with _trainer(model_parallel=2, devices=["cpu:0", "cpu:1"]) as t:
        t.run(1)
        with pytest.raises(ValueError, match="whole slot group"):
            t.grant_devices(["cpu:2"])
        assert len(t.devices) == 2
        rec = t.grant_devices(["cpu:2", "cpu:3"], block=True)
        assert (rec.op, rec.to_p, t.p, rec.to_mp) == ("scale_out", 2, 2, 2)
        assert [str(d) for d in t.exec.devices] == ["cpu:0", "cpu:1",
                                                    "cpu:2", "cpu:3"]


def test_a_kill_at_mp2_moves_the_whole_group_to_the_tail():
    """The dead leader's two slots go to the pool's tail together; the
    survivor's group becomes the first, and the state's model shards move
    onto its slots."""
    freed = []
    with _trainer(init_parallelism=2, model_parallel=2,
                  devices=["cpu:0", "cpu:1", "cpu:2", "cpu:3"]) as t:
        t.on_devices_released = lambda tr, devs: freed.extend(devs)
        t.run(1)
        dead = t.inject_worker_failure(t.worker_ids[0])
        t.run(4)
        assert t.dead_workers() == [dead]
        rec = t.handle_failure(t.dead_workers(), block=True)
        assert (rec.op, rec.from_p, rec.to_p, t.p) == ("scale_in", 2, 1, 1)
        assert [str(d) for d in t.devices] == ["cpu:2", "cpu:3"]
        assert [str(d) for d in freed] == ["cpu:0", "cpu:1"]
        assert np.isfinite(t.step()["loss"])


def test_rwkv6_beyond_model_parallel_1_is_refused():
    rwkv = get_config("rwkv6-1.6b", smoke=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ElasticTrainer(rwkv, global_batch=4, seq_len=32, init_parallelism=1,
                       model_parallel=2, n_samples=64, devices=["cpu"] * 2,
                       device="cpu")
    with ElasticTrainer(rwkv, global_batch=4, seq_len=32, init_parallelism=2,
                        n_samples=64, devices=["cpu"] * 2, device="cpu") as t:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t.reshape(1, 2)
        assert (t.p, t.model_parallel) == (2, 1)
