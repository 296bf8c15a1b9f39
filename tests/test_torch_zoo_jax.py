"""Each new zoo SMOKE config in the port against the JAX package on the
CPU, from the JAX init tree (carried over by ``bridge.params_from_numpy``)
as ``tests/test_torch_model.py`` holds edl_paper: the same parameter tree,
the loss, every gradient leaf, one AdamW update; and the bridge on a MoE
tree (rank-3 and rank-4 leaves), on a tree with no ``embed`` leaf and on
the MLA and Mamba trees."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.models import model as JM
from repro.optim import adamw as jax_adamw
from repro.sharding import ShardedInit as JaxShardedInit
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.optim import adamw
from repro_torch.training.step import loss_and_grads
from test_torch_model import _fan_in_scaled
from test_torch_zoo import NEW, _jleaves, _np_batch, _torch_batch

# the JAX package against the port, in fp32 from the same params and inputs:
# the loss within LOSS_RTOL at the JAX init and at the rescaled point; each
# gradient leaf at the rescaled point within GRAD_RTOL of each element, with
# a floor of GRAD_RTOL x the leaf's largest entry (at the reference's init,
# std 1/sqrt(n_periods), the fp32 gradients are ill-conditioned: ROADMAP C)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
# one AdamW update from the same params and gradients
UPDATE_RTOL, UPDATE_ATOL = 1e-6, 1e-7


@functools.lru_cache(maxsize=None)
def _parity(arch: str, point: str):
    """The JAX init tree of ``arch`` SMOKE (rescaled at "fan_in"), a numpy
    batch, and JAX's loss, xent and aux on it, with its gradients at
    "fan_in"."""
    jcfg = jbase.get_config(arch, smoke=True)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if point == "fan_in":
        np_params = _fan_in_scaled(np_params)
    batch = _np_batch(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    out = dict(np_params=np_params, batch=batch)
    if point == "fan_in":
        (jloss, parts), jgrads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, batch), has_aux=True))(jparams)
        out["grads"] = _jleaves(jgrads)
    else:
        jloss, parts = jax.jit(lambda p: JM.loss_fn(jcfg, p, batch))(jparams)
    return dict(out, loss=float(jloss), xent=float(parts["xent"]),
                aux=float(parts["aux"]))


@pytest.mark.parametrize("arch", NEW)
def test_same_param_tree(arch):
    cfg = base.get_config(arch, smoke=True)
    spec = {k: (tuple(s.shape), tuple(s.axes))
            for k, s in tree_leaves(M.param_spec_tree(cfg))}
    jspec = dict(tree_leaves(jax.tree.map(
        lambda s: (tuple(s.shape), tuple(s.axes)),
        JM.param_spec_tree(jbase.get_config(arch, smoke=True)),
        is_leaf=lambda x: isinstance(x, JaxShardedInit))))
    assert spec == jspec
    assert ("embed/table" in spec) == (cfg.frontend == "tokens")


@pytest.mark.parametrize("point", ["init", "fan_in"])
@pytest.mark.parametrize("arch", NEW)
def test_loss_matches_jax(arch, point):
    want = _parity(arch, point)
    cfg = base.get_config(arch, smoke=True)
    loss, parts = M.loss_fn(cfg, bridge.params_from_numpy(
        want["np_params"], "cpu"), _torch_batch(want["batch"]))
    np.testing.assert_allclose(float(loss), want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["xent"]), want["xent"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), want["aux"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", NEW)
def test_every_gradient_leaf_matches_jax(arch):
    want = _parity(arch, "fan_in")
    cfg = base.get_config(arch, smoke=True)
    _, _, grads = loss_and_grads(cfg, bridge.params_from_numpy(
        want["np_params"], "cpu"), _torch_batch(want["batch"]))
    got = dict(tree_leaves(grads))
    assert got.keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("arch", NEW)
def test_adamw_update_matches_jax(arch):
    """One AdamW update from the same params and the JAX gradients:
    params, count, mu and nu."""
    want = _parity(arch, "fan_in")
    jopt, opt = jax_adamw(1e-3), adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, want["np_params"])
    jg = jax.tree.map(jnp.asarray, tree_unflatten(want["grads"].items()))
    jp, jstate = jax.jit(lambda g, p: jopt.update(g, jopt.init(p), p))(jg,
                                                                      jp)
    p = bridge.params_from_numpy(want["np_params"], "cpu")
    p, state = opt.update(bridge.params_from_numpy(
        tree_unflatten(want["grads"].items()), "cpu"), opt.init(p), p)
    assert int(state["count"]) == int(jstate["count"]) == 1
    for mine, ref in ((p, jp), (state["mu"], jstate["mu"]),
                      (state["nu"], jstate["nu"])):
        ref = _jleaves(ref)
        for k, t in tree_leaves(mine):
            np.testing.assert_allclose(t.numpy(), ref[k], rtol=UPDATE_RTOL,
                                       atol=UPDATE_ATOL, err_msg=k)


@pytest.mark.parametrize("arch, dtype", [
    ("mixtral_8x7b", "float32"), ("mixtral_8x7b", "bfloat16"),
    ("llava_next_mistral_7b", "float32"), ("musicgen_medium", "bfloat16"),
    ("deepseek_v2_236b", "bfloat16"), ("jamba_v01_52b", "float32")])
def test_bridge_carries_zoo_trees(arch, dtype):
    """The JAX init tree into the port and back, bit for bit: MoE's rank-3
    router and rank-4 expert leaves; an ``embeds`` tree, which has no
    ``embed`` leaf; MLA's rank-4 ``w_uk``/``w_uv`` and Mamba's ``conv_w``,
    ``A_log``, ``D_skip`` and ``dt_proj`` bias in their stacked layouts."""
    jcfg = dataclasses.replace(jbase.get_config(arch, smoke=True),
                               param_dtype=dtype)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(5)))
    params = bridge.params_from_numpy(tree, "cpu")
    ranks = {t.dim() for _, t in tree_leaves(params)}
    assert (4 in ranks) == (jcfg.moe is not None)
    assert ("embed" in params) == (jcfg.frontend == "tokens")
    assert all(t.dtype == getattr(torch, dtype)
               for _, t in tree_leaves(params))
    back = dict(tree_leaves(bridge.to_numpy(params)))
    for k, a in tree_leaves(tree):
        np.testing.assert_array_equal(back[k], a.astype(np.float32),
                                      err_msg=k)
