"""The port's model, optimizer and bridge against the JAX package on
``edl_paper`` SMOKE, on the CPU: the same parameters (the JAX init tree,
carried over by ``bridge.params_from_numpy``) and the same numpy batch go
through both."""
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
from repro.optim import adamw as jax_adamw
from repro.sharding import ShardedInit as JaxShardedInit
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim import adamw

B, L = 2, 64
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# At the reference's own init the stacked layer weights have std
# 1/sqrt(n_periods) = 0.71 at d_model 128, so attention saturates and the
# fp32 gradient is ill-conditioned: the JAX gradient in fp32 differs from
# the same function in float64 by 0.9e-4 to 4.1e-4 norm-wise per leaf (three
# batches). There the port is held norm-wise at 1e-3 (measured at most
# 2.5e-4 on the same three batches). With the stacked weights rescaled to
# std 1/sqrt(d_in) both agree to 1.6e-6 of each leaf's largest entry, and
# the port is held element-wise at GRAD_RTOL.
INIT_GRAD_NORM_RTOL = 1e-3


def _fan_in_scaled(np_params):
    """The JAX init tree with every stacked layer weight ``[n_periods,
    d_in, d_out]`` (and stacked expert weight ``[n_periods, E, d_in,
    d_out]``) rescaled from std 1/sqrt(n_periods) to 1/sqrt(d_in): a
    well-conditioned point."""
    def one(k, a):
        if k.startswith("layers/") and a.ndim >= 3:
            return (a * np.sqrt(a.shape[0] / a.shape[-2])).astype(a.dtype)
        return a
    return tree_unflatten((k, one(k, a)) for k, a in tree_leaves(np_params))


def _setup(point: str):
    jcfg = jax_get_config("edl-paper", smoke=True)
    cfg = get_config("edl-paper", smoke=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    if point == "fan_in_scaled":
        np_params = _fan_in_scaled(np_params)
        jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, L + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, batch), has_aux=True))(jparams)
    params = bridge.params_from_numpy(np_params, "cpu")
    return dict(point=point, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params, batch=batch, jloss=float(jloss),
                jxent=float(jparts["xent"]), jgrads=jgrads)


@pytest.fixture(scope="module")
def setup():
    return _setup("jax_init")


@pytest.fixture(scope="module", params=["jax_init", "fan_in_scaled"])
def point(request):
    return _setup(request.param)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jleaves(tree):
    return dict(tree_leaves(jax.tree.map(np.asarray, tree)))


def test_same_param_tree(setup):
    spec = {k: tuple(s.shape)
            for k, s in tree_leaves(M.param_spec_tree(setup["cfg"]))}
    jspec = dict(tree_leaves(jax.tree.map(
        lambda s: tuple(s.shape), JM.param_spec_tree(setup["jcfg"]),
        is_leaf=lambda x: isinstance(x, JaxShardedInit))))
    assert spec == jspec
    assert "layers/slot0/mixer/wq/w" in spec


def test_loss_matches_jax(point):
    loss, parts = M.loss_fn(point["cfg"], point["params"],
                            _torch_batch(point["batch"]))
    np.testing.assert_allclose(float(loss), point["jloss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["xent"]), point["jxent"],
                               rtol=LOSS_RTOL)
    assert float(parts["aux"]) == 0.0


def test_every_gradient_leaf_matches_jax(point):
    from repro_torch.training.step import loss_and_grads
    _, _, grads = loss_and_grads(point["cfg"], point["params"],
                                 _torch_batch(point["batch"]))
    want = _jleaves(point["jgrads"])
    got = dict(tree_leaves(grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        if point["point"] == "jax_init":
            rel = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert rel <= INIT_GRAD_NORM_RTOL, (k, rel)
        else:
            # rtol on each element, with a floor of rtol x the leaf's
            # largest entry for elements that are near zero
            np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(w).max(),
                                       err_msg=k)


def test_adamw_updates_match_jax(setup):
    """Two AdamW updates from the same params and gradients (the JAX
    gradients): params, count, mu and nu agree, bias correction included."""
    jopt, opt = jax_adamw(1e-3), adamw(1e-3)
    jp, jstate = setup["jparams"], jopt.init(setup["jparams"])
    p = setup["params"]
    state = opt.init(p)
    g_np = jax.tree.map(np.asarray, setup["jgrads"])
    for scale in (1.0, -0.5):
        jg = jax.tree.map(lambda g: g * scale, setup["jgrads"])
        g = bridge.params_from_numpy(jax.tree.map(lambda a: a * scale, g_np),
                                     "cpu")
        jp, jstate = jopt.update(jg, jstate, jp)
        p, state = opt.update(g, state, p)
        assert int(state["count"]) == int(jstate["count"])
        assert state["count"].dtype == torch.int32
        for mine, ref in ((p, jp), (state["mu"], jstate["mu"]),
                          (state["nu"], jstate["nu"])):
            want = _jleaves(ref)
            for k, t in tree_leaves(mine):
                np.testing.assert_allclose(t.numpy(), want[k], rtol=1e-6,
                                           atol=1e-7, err_msg=k)


def test_bridge_round_trips_exactly():
    rng = np.random.default_rng(3)
    tree = {"params": {"a": {"w": rng.standard_normal((3, 4),
                                                      dtype=np.float32)},
                       "b": np.asarray(jnp.asarray(
                           rng.standard_normal(5), jnp.bfloat16))},
            "opt": {"count": np.int32(7)},
            "step": np.zeros((), np.int32)}
    state = bridge.params_from_numpy(tree, "cpu")
    assert state["params"]["b"].dtype == torch.bfloat16
    assert state["opt"]["count"].dtype == torch.int32
    assert state["opt"]["count"].shape == ()
    back = bridge.to_numpy(state)
    for k, a in tree_leaves(tree):
        got = dict(tree_leaves(back))[k]
        np.testing.assert_array_equal(got, np.asarray(a, got.dtype),
                                      err_msg=k)
        assert got.shape == np.shape(a)


def test_init_follows_reference_std_rule(setup):
    """The port's own init draws each leaf with the reference's rule,
    ``std = scale / sqrt(shape[0])`` on the stacked leaf (so stacked layer
    weights get 1/sqrt(n_periods)): per-leaf mean and std agree with the
    JAX init tree, not the bits."""
    params = M.init_params(setup["cfg"], torch.Generator().manual_seed(0),
                           "cpu")
    want = _jleaves(setup["jparams"])
    for k, t in tree_leaves(params):
        a, w = t.numpy(), want[k]
        assert a.shape == w.shape and a.dtype == w.dtype, k
        if w.std() == 0:
            np.testing.assert_array_equal(a, w, err_msg=k)
            continue
        n = a.size
        np.testing.assert_allclose(a.std(), w.std(),
                                   rtol=6 / np.sqrt(2 * n), err_msg=k)
        assert abs(a.mean()) < 5 * w.std() / np.sqrt(n), k
    wq = params["layers"]["slot0"]["mixer"]["wq"]["w"]
    n_periods = wq.shape[0]
    np.testing.assert_allclose(float(wq.std()), n_periods ** -0.5,
                               rtol=0.02)
