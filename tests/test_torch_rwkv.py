"""The port's RWKV6 slice on the CPU against the JAX package on
``rwkv6_1p6b`` SMOKE: the same parameters (the JAX init tree, carried over
by ``bridge.params_from_numpy``) and the same numpy batch go through both
``loss_fn``s; the JAX one runs the serial ``wkv6_scan``, as the JAX trainer
does for this config. Also remat, the elastic trainer and the bridge."""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.sharding import ShardedInit as JaxShardedInit
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.kernels.launches import LAUNCHES
from repro_torch.launch import train as port_train
from repro_torch.models import blocks as B
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.training.step import loss_and_grads
from test_torch_model import _fan_in_scaled

ARCH = "rwkv6-1.6b"
BATCH, SEQ = 2, 64
LOSS_RTOL = 1e-5
# Measured on three batches, against the same JAX function in float64: at
# the reference's init (stacked weights std 1/sqrt(n_periods) = 0.71) the
# JAX fp32 gradient errs by at most 1.4e-5 norm-wise per leaf, the port's
# (through the WKV6 Function's plain backward) by at most 1.7e-5. Unlike
# edl_paper's attention, RWKV6 SMOKE is well-conditioned at that init. The
# port is held there norm-wise at INIT_GRAD_NORM_RTOL against the JAX fp32
# gradient (measured at most 1.4e-5). With the stacked weights rescaled to
# std 1/sqrt(d_in) it is held element-wise at GRAD_RTOL, with a floor of
# GRAD_RTOL x the leaf's largest entry (measured at most 2.1e-5, on w0,
# whose gradient sums dlogw over the sequence).
INIT_GRAD_NORM_RTOL = 1e-4
GRAD_RTOL = 1e-4


def _setup(point: str):
    jcfg = jax_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if point == "fan_in_scaled":
        np_params = _fan_in_scaled(np_params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params))
    return dict(point=point, jcfg=jcfg, cfg=cfg, np_params=np_params,
                params=bridge.params_from_numpy(np_params, "cpu"),
                batch={k: torch.from_numpy(v).long()
                       for k, v in batch.items()},
                jloss=float(jloss), jxent=float(jparts["xent"]),
                jgrads=dict(tree_leaves(jax.tree.map(np.asarray, jgrads))))


@pytest.fixture(scope="module", params=["jax_init", "fan_in_scaled"])
def point(request):
    return _setup(request.param)


def test_same_param_tree():
    """Paths and shapes of the port's spec tree equal the reference's, at
    SMOKE and at full width, whose parameter count is the reference's."""
    for smoke in (True, False):
        jspec = dict(tree_leaves(jax.tree.map(
            lambda s: tuple(s.shape),
            JM.param_spec_tree(jax_get_config(ARCH, smoke=smoke)),
            is_leaf=lambda x: isinstance(x, JaxShardedInit))))
        spec = {k: tuple(s.shape) for k, s in
                tree_leaves(M.param_spec_tree(get_config(ARCH, smoke=smoke)))}
        assert spec == jspec
    assert sum(int(np.prod(s)) for s in spec.values()) == 1_583_941_632
    assert B.scan_plan(get_config(ARCH)) == ([("rwkv_tm", "rwkv_cm")], 24)


def test_loss_matches_jax(point):
    loss, parts = M.loss_fn(point["cfg"], point["params"], point["batch"])
    np.testing.assert_allclose(float(loss), point["jloss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["xent"]), point["jxent"],
                               rtol=LOSS_RTOL)


def test_every_gradient_leaf_matches_jax(point):
    _, _, grads = loss_and_grads(point["cfg"], point["params"],
                                 point["batch"])
    got = dict(tree_leaves(grads))
    want = point["jgrads"]
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        if point["point"] == "jax_init":
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= INIT_GRAD_NORM_RTOL, (k, rel)
        else:
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=k)


# bf16 params and compute with remat, as CONFIG has them: the port's loss
# and gradients against the JAX bf16 ones from the same bf16 parameters and
# batch. Measured over the three batches at each point: loss within 3.2e-4,
# gradients within 0.087 norm-wise per leaf, where the JAX bf16 gradients
# differ from its own fp32 ones by 0.11 to 0.24.
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_NORM_RTOL = 0.15


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("init", ["jax_init", "fan_in_scaled"])
def test_bf16_loss_and_gradients_match_jax(init, seed):
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", remat=True)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), **bf16)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **bf16)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jax_get_config(ARCH, smoke=True),
                                            jax.random.PRNGKey(0)))
    if init == "fan_in_scaled":
        np_params = _fan_in_scaled(np_params)
    np_params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), np_params)
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params))
    loss, _, grads = loss_and_grads(
        cfg, bridge.params_from_numpy(np_params, "cpu"),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=BF16_LOSS_RTOL)
    got = dict(tree_leaves(grads))
    for k, w in tree_leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                         jgrads)):
        assert got[k].dtype == torch.bfloat16, k
        g = got[k].float().numpy()
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= BF16_GRAD_NORM_RTOL, (k, rel)


def test_remat_gives_the_same_loss_and_gradients(point):
    """Per-period recomputation changes what is kept, not what is
    computed."""
    cfg = point["cfg"]
    out = [loss_and_grads(dataclasses.replace(cfg, remat=remat),
                          point["params"], point["batch"])
           for remat in (False, True)]
    assert float(out[0][0]) == float(out[1][0])
    for (k, a), (_, b) in zip(tree_leaves(out[0][2]), tree_leaves(out[1][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_remat_recompute_keeps_the_warm_up_flag(monkeypatch):
    """The forward that remat runs again in the backward sees the warm-up
    flag of the thread that ran the first forward, so its kernel launches
    are tallied as that forward's were, wherever autograd recomputes."""
    seen = []
    spec, fwd = B.MIXERS["rwkv_tm"]

    def spy(*args, **kw):
        seen.append(LAUNCHES.is_warming())
        return fwd(*args, **kw)

    monkeypatch.setitem(B.MIXERS, "rwkv_tm", (spec, spy))
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), remat=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    w = params["layers"]["slot0"]["mixer"]["wr"]["w"].requires_grad_(True)
    toks = torch.zeros((1, 8), dtype=torch.long)
    for warm in (True, False):
        seen.clear()
        with LAUNCHES.warming(warm):
            loss, _ = M.loss_fn(cfg, params, {"tokens": toks, "labels": toks})
        with LAUNCHES.warming(not warm):
            loss.backward()
        assert torch.isfinite(w.grad).all()
        # two periods, each run forward and then again in the backward
        assert seen == [warm] * 4


def test_bridge_carries_bf16_rwkv_tree():
    """The JAX init tree of RWKV6 in bf16 (as CONFIG has it) loads with the
    port's paths and shapes, bf16 where JAX has bf16, bit for bit."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(1)))
    params = bridge.params_from_numpy(np_params, "cpu")
    spec = dict(tree_leaves(M.param_spec_tree(get_config(ARCH, smoke=True))))
    leaves = dict(tree_leaves(params))
    assert leaves.keys() == spec.keys()
    for k, a in tree_leaves(np_params):
        t = leaves[k]
        assert a.dtype.name == "bfloat16" and t.dtype == torch.bfloat16, k
        assert tuple(t.shape) == spec[k].shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16), err_msg=k)
    state = bridge.state_from_numpy(
        {"params": np_params, "step": np.zeros((), np.int32)}, "cpu")
    assert state["params"]["layers"]["slot0"]["mixer"]["u"]["w"].dtype == \
        torch.bfloat16
    back = bridge.to_numpy(params)
    k = "layers/slot0/mixer/wr/w"
    np.testing.assert_array_equal(dict(tree_leaves(back))[k],
                                  dict(tree_leaves(np_params))[k]
                                  .astype(np.float32))


# the trainer: 4 samples of 32 tokens a step, 64 samples, 8 partitions
T_BATCH, T_SEQ, T_SAMPLES, T_PARTS = 4, 32, 64, 8
# From the JAX trainer's initial state with its stacked weights rescaled to
# std 1/sqrt(d_in), the port's 5 losses agree with the JAX trainer's to
# 7.5e-6 (measured); the AdamW
# updates move them by up to 4.3e-3 from an update-free run (measured),
# which the test also checks.
TRAJ_RTOL = 1e-4
UPDATE_MARGIN = 5


def _trainer(**kw):
    args = dict(global_batch=T_BATCH, seq_len=T_SEQ, init_parallelism=1,
                n_samples=T_SAMPLES, d_partitions=T_PARTS, seed=0,
                devices=["cpu"] * 2, device="cpu", time_allowance_s=0)
    args.update(kw)
    return ElasticTrainer(get_config(ARCH, smoke=True), **args)


def test_loss_trajectory_matches_jax_trainer():
    from repro.core import ElasticTrainer as JaxElasticTrainer

    jt = JaxElasticTrainer(jax_get_config(ARCH, smoke=True),
                           global_batch=T_BATCH, seq_len=T_SEQ,
                           init_parallelism=1, n_samples=T_SAMPLES,
                           d_partitions=T_PARTS, seed=0,
                           devices=jax.devices()[:1])
    state = jax.tree.map(np.asarray, jt.state)
    state["params"] = _fan_in_scaled(state["params"])
    jt.state = jax.tree.map(
        lambda a, old: jax.device_put(a, old.sharding), state, jt.state)
    want = np.array([jt.step()["loss"] for _ in range(5)])

    def port_losses(**kw):
        with _trainer(**kw) as pt:
            pt.state = bridge.state_from_numpy(state, "cpu")
            return np.array([pt.step()["loss"] for _ in range(5)])

    np.testing.assert_allclose(port_losses(), want, rtol=TRAJ_RTOL)
    from repro_torch.optim import adamw
    frozen = port_losses(optimizer=adamw(0.0))
    assert np.max(np.abs(frozen - want) / want) > UPDATE_MARGIN * TRAJ_RTOL


def test_entry_point_scale_out_keeps_data_exactly_once():
    """``--arch rwkv6-1.6b --smoke`` through ``launch/train.py``, with a
    scale-out 1 -> 2 that commits stop-free; every sample drawn is
    distinct."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert port_train.main([
            "--device", "cpu", "--smoke", "--json", "--arch", ARCH,
            "--steps", "5", "--batch", "4", "--seq", "32", "--devices", "2",
            "--init-p", "1", "--n-samples", "256", "--d-partitions", "8",
            "--schedule", "out:1@1"]) == 0
    s = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert s["arch"] == "rwkv6-smoke" and s["final_p"] == 2
    [ev] = s["scaling_events"]
    assert ev["op"] == "scale_out" and ev["stop_s"] < ev["prep_s"]
    assert s["unique_sample_frac"] == 1.0
    assert all(np.isfinite(s["losses"]))
