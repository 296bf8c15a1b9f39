"""The port's ``models/moe.py`` against the reference's ``moe_forward`` on
the CPU: the same numpy parameters and inputs go through both, on mixtral
SMOKE's MoE (4 experts, top 2). Out and aux loss in fp32 within
``RTOL``; gradients of every input; a skewed router whose capacity drops
claims, with the same claims kept in both packages; a decode-shaped call
of B tokens, where nothing drops; and the reference's failure where B·L is
above a group and not a multiple of it."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.sharding import ShardedInit as JaxShardedInit
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.params import tree_leaves, tree_map, \
    tree_unflatten

ARCH = "mixtral_8x7b"
# fp32 on both sides; the expert products sum in another order: each
# element within RTOL of its value, with a floor of RTOL x the largest
# entry for elements near zero
RTOL = 1e-5
GRAD_RTOL = 1e-4
# bf16: both cast dispatch, combine and the expert weights to bf16 and
# round every product there, in another order
BF16_RTOL = 2e-2


def _cfgs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_get_config(ARCH, smoke=True), **kw),
            dataclasses.replace(get_config(ARCH, smoke=True), **kw))


def _np_params(cfg, seed=0, skew=None):
    """Seeded numpy leaves with the reference's shapes, each with std
    1/sqrt(d_in); ``skew`` (a unit vector [D]) points the router's expert
    0 along it, so that inputs along it crowd expert 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in tree_leaves(moe.moe_specs(cfg)):
        d_in = s.shape[-2]
        out[path] = (rng.standard_normal(s.shape) / np.sqrt(d_in)).astype(
            np.float32)
    if skew is not None:
        out["router/w"][:, 0] += 4.0 * skew
    return out


def _tree(flat):
    return tree_unflatten(flat.items())


def _x(cfg, B, L, seed=1, skew=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    if skew is not None:
        x += 2.0 * skew
    return x


def _run(B, L, dtype="float32", skew_on=False):
    jcfg, cfg = _cfgs(dtype)
    skew = None
    if skew_on:
        skew = np.random.default_rng(5).standard_normal(cfg.d_model)
        skew = (skew / np.linalg.norm(skew)).astype(np.float32)
    flat = _np_params(cfg, skew=skew)
    x = _x(cfg, B, L, skew=skew)
    jdt = jnp.dtype(dtype)
    jout, jaux = jmoe.moe_forward(jcfg, jax.tree.map(
        lambda a: jnp.asarray(a, jdt), _tree(flat)), jnp.asarray(x, jdt))
    tdt = getattr(torch, dtype)
    p = tree_map(lambda a: torch.from_numpy(a).to(tdt), _tree(flat))
    out, aux = moe.moe_forward(cfg, p, torch.from_numpy(x).to(tdt))
    return (cfg, p, torch.from_numpy(x).to(tdt),
            np.asarray(jout, np.float32), float(jaux),
            out.float().numpy(), float(aux))


def _kept_claims(cfg, p, x):
    """(claims kept, claims made) of the port's routing of ``x``."""
    r = moe.route(cfg, p, x)
    return int((r["pos"] < r["C"]).sum()), r["pos"].numel()


def _jax_kept_claims(cfg, flat, x):
    """The reference's kept claims, counted with its own routing steps
    (``moe.py``: softmax, ``lax.top_k``, the (k, s) cumsum, capacity)."""
    m = cfg.moe
    B, L, D = x.shape
    S = min(jmoe.GROUP_SIZE, B * L)
    xf = jnp.asarray(x).reshape(-1, S, D)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", xf,
                                      jnp.asarray(flat["router/w"])), -1)
    _, idx = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(idx, m.n_experts, dtype=jnp.int32)
    G = xf.shape[0]
    oh_ks = jnp.swapaxes(onehot, 1, 2).reshape(G, m.top_k * S, m.n_experts)
    pos = jnp.swapaxes((jnp.cumsum(oh_ks, 1) - oh_ks).reshape(
        G, m.top_k, S, m.n_experts), 1, 2)
    C = jmoe._capacity(S, m.n_experts, m.top_k, m.capacity_factor)
    return int(((pos * onehot).sum(-1) < C).sum())


def test_moe_specs_equal_jax():
    jcfg, cfg = _cfgs()
    want = dict(tree_leaves(jax.tree.map(
        lambda s: (tuple(s.shape), tuple(s.axes)), jmoe.moe_specs(jcfg),
        is_leaf=lambda s: isinstance(s, JaxShardedInit))))
    got = {k: (tuple(s.shape), tuple(s.axes))
           for k, s in tree_leaves(moe.moe_specs(cfg))}
    assert got == want
    assert got["wi_gate/w"][0] == (cfg.moe.n_experts, cfg.d_model,
                                   cfg.moe.d_ff_expert)


@pytest.mark.parametrize("B, L", [(2, 64), (2, 512)],
                         ids=["one_group", "two_groups"])
def test_moe_forward_matches_jax(B, L):
    _, _, _, jout, jaux, out, aux = _run(B, L)
    np.testing.assert_allclose(out, jout, rtol=RTOL,
                               atol=RTOL * np.abs(jout).max())
    np.testing.assert_allclose(aux, jaux, rtol=RTOL)


def test_moe_forward_matches_jax_in_bf16():
    _, _, _, jout, jaux, out, aux = _run(2, 64, "bfloat16")
    np.testing.assert_allclose(out, jout, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(jout).max())
    np.testing.assert_allclose(aux, jaux, rtol=RTOL)


def test_moe_gradients_match_jax():
    """The gradients of sum(out * r) + aux: the input, the router (through
    the gate values and the aux loss) and every expert leaf."""
    jcfg, cfg = _cfgs()
    flat = _np_params(cfg)
    x = _x(cfg, 2, 64)
    r = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_forward(jcfg, p, xx)
        return jnp.sum(out * r) + aux
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, _tree(flat)), jnp.asarray(x))
    want = {**dict(tree_leaves(jax.tree.map(np.asarray, jg_p))),
            "x": np.asarray(jg_x)}
    p = tree_map(lambda a: torch.from_numpy(a).requires_grad_(True),
                 _tree(flat))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_forward(cfg, p, xt)
    ((out * torch.from_numpy(r)).sum() + aux).backward()
    got = {**{k: t.grad.numpy() for k, t in tree_leaves(p)},
           "x": xt.grad.numpy()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=k)


def test_capacity_drops_the_same_claims():
    """A router skewed to expert 0 overfills it: claims drop, and both
    packages keep the same ones (the same count, the same outputs)."""
    B, L = 2, 64
    cfg, p, x, jout, jaux, out, aux = _run(B, L, skew_on=True)
    kept, made = _kept_claims(cfg, p, x)
    flat = dict(tree_leaves(tree_map(lambda t: t.numpy(), p)))
    assert kept < made, "the skewed router must overfill an expert"
    assert kept == _jax_kept_claims(cfg, flat, x.numpy())
    np.testing.assert_allclose(out, jout, rtol=RTOL,
                               atol=RTOL * np.abs(jout).max())
    np.testing.assert_allclose(aux, jaux, rtol=RTOL)


def test_decode_shaped_call_drops_nothing():
    """One token of each of B sequences: a group of B tokens, capacity
    max(4, ...) >= B, so every claim is kept."""
    cfg, p, x, jout, jaux, out, aux = _run(4, 1)
    kept, made = _kept_claims(cfg, p, x)
    assert kept == made == 4 * cfg.moe.top_k
    np.testing.assert_allclose(out, jout, rtol=RTOL,
                               atol=RTOL * np.abs(jout).max())
    np.testing.assert_allclose(aux, jaux, rtol=RTOL)


def test_tokens_that_do_not_fill_whole_groups_raise():
    """600 tokens: above one group of 512 and not a multiple of it; the
    reference's reshape fails there, and so does the port."""
    jcfg, cfg = _cfgs()
    flat = _np_params(cfg)
    x = _x(cfg, 3, 200)
    with pytest.raises(TypeError):
        jmoe.moe_forward(jcfg, jax.tree.map(jnp.asarray, _tree(flat)),
                         jnp.asarray(x))
    p = tree_map(torch.from_numpy, _tree(flat))
    with pytest.raises(ValueError, match="groups of 512"):
        moe.moe_forward(cfg, p, torch.from_numpy(x))
