"""The port's deterministic virtual-worker step on the CPU: its tree
reduction against the reference's ``_vw_tree_reduce``, one step against the
JAX virtual step from the same numpy state, and the bitwise contract of
``tests/test_system.py`` inside the port: losses ``==`` at every p and
through a resize schedule."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.reshape import gather_state
from repro_torch.training.step import make_train_step, port_layout, \
    vw_tree_reduce
from test_torch_model import _fan_in_scaled

BATCH, SEQ, K = 8, 32, 8
# the JAX virtual step against the port's, from the same state and batch:
# edl_paper SMOKE from the rescaled state, its gradients (AdamW's moments)
# element-wise with a floor of STEP_RTOL x the leaf's largest entry; rwkv6
# SMOKE at the JAX init norm-wise per leaf: the tolerances of the one-batch
# gradient tests (test_torch_model.py, test_torch_rwkv.py). The updated
# params are held norm-wise per leaf: AdamW's first step moves each by
# lr g / (|g| + eps), which where |g| is near eps turns a 1e-8 gradient
# difference into one of up to lr (measured: 1 element of 32768 in wv at
# 5.3e-5, the leaf at 3.3e-6 norm-wise; the moments at most 1.5e-6).
STEP_RTOL = 1e-4


def _norm_err(got, want) -> float:
    g, w = got.astype(np.float64), want.astype(np.float64)
    return np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)


def _trainer(arch="edl-paper", **kw):
    args = dict(global_batch=BATCH, seq_len=SEQ, init_parallelism=1,
                n_samples=256, d_partitions=8, seed=0,
                devices=["cpu"] * 4, device="cpu", time_allowance_s=0,
                virtual_workers=K)
    args.update(kw)
    return ElasticTrainer(get_config(arch, smoke=True), **args)


def _losses(t, n):
    return [t.step()["loss"] for _ in range(n)]


@pytest.mark.parametrize("n", range(1, 14))
def test_tree_reduce_pairs_as_the_reference(n):
    """The streaming carry-stack reduction gives the bits of the reference's
    level-by-level ``_vw_tree_reduce`` for every count (non-powers of two
    are where pairing orders differ)."""
    from repro.training.step import _vw_tree_reduce
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((n, 33)) *
         rng.uniform(1e-3, 1e3, (n, 1))).astype(np.float32)
    want = np.asarray(_vw_tree_reduce(jnp.asarray(x)))
    got = vw_tree_reduce(torch.from_numpy(x[i]) for i in range(n))
    np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, point):
    """(initial numpy state, batch, loss, updated state) of one JAX virtual
    step at K = 4 on a one-device mesh."""
    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_mesh
    from repro.optim import adamw as jax_adamw
    from repro.training.step import init_train_state, \
        make_train_step as jax_make_train_step
    jcfg = jax_get_config(arch, smoke=True)
    state = jax.tree.map(np.asarray, init_train_state(
        jcfg, jax_adamw(1e-3), jax.random.PRNGKey(0)))
    if point == "fan_in_scaled":
        state["params"] = _fan_in_scaled(state["params"])
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jfn = jax_make_train_step(jcfg, jax_adamw(1e-3), n_virtual=4, mesh=mesh,
                              global_batch=BATCH, seed=0)
    jstate, jm = jax.jit(jfn)(jax.tree.map(jnp.asarray, state), batch)
    return (state, batch, float(jm["loss"]),
            dict(tree_leaves(jax.tree.map(np.asarray, jstate))))


def _jax_step_and_port_step(arch, point, p):
    state, batch, jloss, want = _jax_step(arch, point)
    cfg, opt = get_config(arch, smoke=True), adamw(1e-3)
    pfn = make_train_step(cfg, opt, ["cpu"] * p, n_virtual=4,
                          global_batch=BATCH)
    layout = port_layout(cfg, opt, p, 1)
    pstate, pm = pfn(bridge.shard_state_from_numpy(state, layout,
                                                   ["cpu"] * p), batch)
    got = {k: t.numpy()
           for k, t in tree_leaves(gather_state(layout, pstate))}
    return jloss, float(pm["loss"]), want, got


@pytest.mark.parametrize("p", [1, 2])
def test_edl_virtual_step_matches_jax(p):
    """Loss; gradients (AdamW's first moment is 0.1 x the gradient after
    one step) and second moments element-wise; updated params norm-wise."""
    jloss, ploss, want, got = _jax_step_and_port_step(
        "edl-paper", "fan_in_scaled", p)
    np.testing.assert_allclose(ploss, jloss, rtol=STEP_RTOL)
    assert want.keys() == got.keys()
    for k, w in want.items():
        if k.startswith("params/"):
            assert _norm_err(got[k], w) <= STEP_RTOL, (k, _norm_err(got[k], w))
        else:
            np.testing.assert_allclose(got[k], w, rtol=STEP_RTOL,
                                       atol=STEP_RTOL * np.abs(w).max(),
                                       err_msg=k)


def test_rwkv_virtual_step_matches_jax():
    jloss, ploss, want, got = _jax_step_and_port_step("rwkv6-1.6b",
                                                      "jax_init", 2)
    np.testing.assert_allclose(ploss, jloss, rtol=STEP_RTOL)
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert _norm_err(got[k], w) <= STEP_RTOL, (k, _norm_err(got[k], w))


def test_losses_equal_across_parallelism():
    """Twin of test_grad_invariance_across_parallelism: p = 1, 2 and 4 at
    K = 8 give the same loss bits, step for step."""
    runs = {}
    for p in (1, 2, 4):
        with _trainer(init_parallelism=p) as t:
            runs[p] = _losses(t, 4)
    assert runs[1] == runs[2] == runs[4], runs
    assert len(set(runs[1])) == 4


def test_elastic_schedule_matches_static_bitwise():
    """Twin of the reference test: 1 -> 4 -> 2 follows the static p = 1
    trajectory exactly."""
    with _trainer() as t:
        static = _losses(t, 8)
    with _trainer() as t:
        t.run(2)
        out = t.scale_out(3, block=True)    # steps on until it commits
        t.run(1)
        sin = t.scale_in(2, block=True)
        t.run(8 - len(t.metrics_log))
        elastic = [m["loss"] for m in t.metrics_log]
        assert (out.to_p, sin.to_p, t.p) == (4, 2, 2)
    assert elastic == static


def test_rwkv_losses_equal_at_p1_and_p2():
    runs = {}
    for p in (1, 2):
        with _trainer("rwkv6-1.6b", init_parallelism=p, global_batch=4,
                      virtual_workers=4) as t:
            runs[p] = _losses(t, 3)
    assert runs[1] == runs[2], runs


@pytest.mark.parametrize("kw, match", [
    (dict(virtual_workers=3), "not divisible by virtual_workers=3"),
    (dict(virtual_workers=4, init_parallelism=3, global_batch=12),
     "init parallelism 3 must divide virtual_workers=4"),
    (dict(virtual_workers=-2), "must be >= 1"),
])
def test_virtual_workers_errors(kw, match):
    """The reference's messages: the batch and the launch p must fit K."""
    with pytest.raises(ValueError, match=match):
        _trainer(**kw)


def test_resize_target_must_divide_virtual_workers():
    with _trainer(init_parallelism=2, global_batch=12, virtual_workers=4,
                  devices=["cpu"] * 4) as t:
        with pytest.raises(ValueError, match="p=3 must divide"):
            t.scale_out(1)


def test_auto_is_the_largest_feasible_p():
    """``"auto"`` takes the largest p the pool can hold whose batch shard
    is whole: 4 slots and batch 8 give 4; 3 slots and batch 8 give 2."""
    with _trainer(virtual_workers="auto") as t:
        assert t.n_virtual == 4
    with _trainer(virtual_workers="auto", devices=["cpu"] * 3) as t:
        assert t.n_virtual == 2
