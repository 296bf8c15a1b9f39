"""The port's MLA, Mamba, chunked attention and grouped remat against the
JAX package on the CPU, from the same numpy parameters and inputs:

- ``chunked_attention`` with k and v of different widths over several kv
  chunks, forward and ``jax.vjp``;
- ``mla_forward`` in train mode (deepseek SMOKE, several kv chunks) with
  its gradients, and token by token against a cache;
- ``mamba_forward`` (jamba SMOKE) at a chunk below L, in train mode with
  its gradients and with a cache carried in, and the doubling scan
  against the reference's ``_assoc_scan``;
- MoE with a shared expert (deepseek SMOKE's ``n_shared``);
- grouped remat (``remat_group`` 2) against ``remat_group`` 1, the twin of
  ``tests/test_models.py::test_grouped_remat_equivalence``."""
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
from repro.models import attention as jattn
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import attention, moe, ssm
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.step import loss_and_grads

# fp32 on both sides, the sums in other orders: each element within RTOL
# of its value, with a floor of RTOL x the largest entry
RTOL = 1e-5
GRAD_RTOL = 1e-4
# grouped remat against remat_group 1, both in the port: the forward within
# REMAT_TOL, and every gradient leaf within REMAT_TOL of each element (with
# the floor above); torch recomputes the same ops in the same order
REMAT_TOL = 1e-5


def _close(got, want, rtol=RTOL, msg=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def _np_params(specs, seed=0) -> dict:
    """Seeded numpy leaves of a spec tree: matrices with std 1/sqrt(d_in);
    norm scales and ``D_skip`` near 1, ``A_log`` near log(1..N) and biases
    near 0, each moved off its init so that every leaf shows."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in tree_leaves(specs):
        noise = rng.standard_normal(s.shape)
        if s.init == "ones":
            a = 1.0 + 0.1 * noise
        elif s.init == "alog":
            a = np.log(np.arange(1, s.shape[-1] + 1)) + 0.1 * noise
        elif s.init == "zeros":
            a = 0.1 * noise
        else:
            d_in = s.shape[-2] if len(s.shape) > 1 else 1
            a = s.scale * noise / np.sqrt(d_in)
        out[path] = a.astype(np.float32)
    return tree_unflatten(out.items())


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree, grad=False):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(
        grad), tree)


def _grads_match(jgrads: dict, params: dict):
    want = dict(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    got = {k: t.grad for k, t in tree_leaves(params)}
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, GRAD_RTOL, k)


# -------------------------------------------------------- chunked attention
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chunked_attention_matches_jax(causal):
    """q [2,1,4,48,40] against k 40 and v 24 wide in kv chunks of 16, an
    explicit scale: the output and the gradients of q, k and v."""
    q, k, v = (_x(s, seed) for s, seed in (((2, 1, 4, 48, 40), 1),
                                           ((2, 1, 48, 40), 2),
                                           ((2, 1, 48, 24), 3)))
    r = _x((2, 1, 4, 48, 24), 4)
    kw = dict(causal=causal, chunk=16, scale=0.3)
    jout, vjp = jax.vjp(lambda *a: jattn.chunked_attention(*a, **kw),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(r))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention.chunked_attention(*ts, **kw)
    assert out.shape == (2, 1, 4, 48, 24)
    _close(out, jout)
    (out * torch.from_numpy(r)).sum().backward()
    for t, jg, name in zip(ts, jgrads, "qkv"):
        _close(t.grad, jg, GRAD_RTOL, name)


# ---------------------------------------------------------------------- MLA
def _mla_cfgs(**replace):
    return (dataclasses.replace(jax_get_config("deepseek-v2-236b", smoke=True),
                                **replace),
            dataclasses.replace(get_config("deepseek-v2-236b", smoke=True),
                                **replace))


def test_mla_specs_equal_jax():
    jcfg, cfg = _mla_cfgs()
    want = {k: (tuple(s.shape), tuple(s.axes)) for k, s in tree_leaves(
        jax.tree.map(lambda s: s, jattn.mla_specs(jcfg),
                     is_leaf=lambda s: hasattr(s, "axes")))}
    got = {k: (tuple(s.shape), tuple(s.axes))
           for k, s in tree_leaves(attention.mla_specs(cfg))}
    assert got == want
    assert got["w_uk/w"][0] == (cfg.n_heads, cfg.mla.kv_lora,
                                cfg.mla.qk_nope_dim)


def test_mla_forward_matches_jax():
    """Train mode over three kv chunks (attn_chunk 16, L 48): the output
    and the gradients of x and of every leaf."""
    jcfg, cfg = _mla_cfgs(attn_chunk=16)
    flat = _np_params(attention.mla_specs(cfg))
    B, L = 2, 48
    x, r = _x((B, L, cfg.d_model)), _x((B, L, cfg.d_model), 2)
    pos = np.broadcast_to(np.arange(L), (B, L))

    def jf(p, xx):
        return jattn.mla_forward(jcfg, p, xx, positions=jnp.asarray(pos))[0]
    jout, vjp = jax.vjp(jf, _jax(flat), jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(r))
    p = _torch(flat, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, cache = attention.mla_forward(cfg, p, xt,
                                       positions=torch.from_numpy(pos.copy()))
    assert cache is None
    _close(out, jout)
    (out * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, jg_x, GRAD_RTOL, "x")
    _grads_match(jg_p, p)


def test_mla_decode_matches_jax():
    """Token by token from an empty compressed cache: each step's output,
    and ``ckv`` and ``krope`` after the last step, written in place."""
    jcfg, cfg = _mla_cfgs()
    flat = _np_params(attention.mla_specs(cfg), seed=3)
    B, T = 2, 6
    xs = _x((B, T, cfg.d_model), 4)
    jcache = {k: jnp.zeros(s.shape, jnp.float32)
              for k, s in jattn.mla_cache_spec(jcfg, B, T).items()}
    cache = {k: torch.zeros(s.shape)
             for k, s in attention.mla_cache_spec(cfg, B, T).items()}
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    p = _torch(flat)
    for t in range(T):
        pos = np.full((B, 1), t, np.int32)
        jout, jcache = jattn.mla_forward(jcfg, _jax(flat),
                                         jnp.asarray(xs[:, t:t + 1]),
                                         positions=jnp.asarray(pos),
                                         cache=jcache)
        with torch.inference_mode():
            out, cache = attention.mla_forward(
                cfg, p, torch.from_numpy(xs[:, t:t + 1].copy()),
                positions=torch.from_numpy(pos), cache=cache)
        _close(out, jout, msg=f"step {t}")
    assert {k: t.data_ptr() for k, t in cache.items()} == ptrs
    for k in ("ckv", "krope"):
        _close(cache[k], jcache[k], msg=k)


# -------------------------------------------------------------------- Mamba
def _mamba_cfgs(**replace):
    return (dataclasses.replace(jax_get_config("jamba-v0.1-52b", smoke=True),
                                **replace),
            dataclasses.replace(get_config("jamba-v0.1-52b", smoke=True),
                                **replace))


@pytest.mark.parametrize("T", [1, 13, 64])
def test_doubling_scan_matches_assoc_scan(T):
    """h_t = a_t h_{t-1} + b_t: the port's doubling scan against the
    reference's ``jax.lax.associative_scan`` over the same combine."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.5, 1.0, (2, T, 6, 4)).astype(np.float32)
    b = rng.standard_normal((2, T, 6, 4)).astype(np.float32)
    P, Q = ssm._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    jP, jQ = jssm._assoc_scan(jnp.asarray(a), jnp.asarray(b))
    _close(P, jP)
    _close(Q, jQ)


def test_mamba_specs_equal_jax():
    jcfg, cfg = _mamba_cfgs()
    want = {k: (tuple(s.shape), tuple(s.axes), s.init) for k, s in
            tree_leaves(jax.tree.map(lambda s: s, jssm.mamba_specs(jcfg),
                                     is_leaf=lambda s: hasattr(s, "axes")))}
    got = {k: (tuple(s.shape), tuple(s.axes), s.init)
           for k, s in tree_leaves(ssm.mamba_specs(cfg))}
    assert got == want
    # dt_rank defaults to ceil(d_model / 16)
    assert got["dt_proj/w"][0][0] == -(-cfg.d_model // 16)


def test_mamba_forward_matches_jax():
    """Train mode at mamba_chunk 8 over L 32 (four chunks): the output and
    the gradients of x and of every leaf."""
    jcfg, cfg = _mamba_cfgs(mamba_chunk=8)
    flat = _np_params(ssm.mamba_specs(cfg))
    B, L = 2, 32
    x, r = _x((B, L, cfg.d_model)), _x((B, L, cfg.d_model), 2)
    jout, vjp = jax.vjp(lambda p, xx: jssm.mamba_forward(jcfg, p, xx)[0],
                        _jax(flat), jnp.asarray(x))
    jg_p, jg_x = vjp(jnp.asarray(r))
    p = _torch(flat, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, cache = ssm.mamba_forward(cfg, p, xt)
    assert cache is None
    _close(out, jout)
    (out * torch.from_numpy(r)).sum().backward()
    _close(xt.grad, jg_x, GRAD_RTOL, "x")
    _grads_match(jg_p, p)


@pytest.mark.parametrize("L", [1, 24], ids=["decode", "chunks"])
def test_mamba_with_a_cache_matches_jax(L):
    """A cache carried in (seeded ``conv`` and ``ssm`` states): one decode
    token, and 24 tokens at mamba_chunk 8; the output, and both states
    written back in place."""
    jcfg, cfg = _mamba_cfgs(mamba_chunk=8)
    flat = _np_params(ssm.mamba_specs(cfg), seed=5)
    B = 2
    x = _x((B, L, cfg.d_model), 6)
    state = {k: _x(s.shape, 7 + i) for i, (k, s) in enumerate(
        ssm.mamba_cache_spec(cfg, B, 1).items())}
    jout, jcache = jssm.mamba_forward(jcfg, _jax(flat), jnp.asarray(x),
                                      cache=_jax(state))
    cache = _torch(state)
    ptrs = {k: t.data_ptr() for k, t in cache.items()}
    with torch.inference_mode():
        out, got = ssm.mamba_forward(cfg, _torch(flat), torch.from_numpy(x),
                                     cache=cache)
    assert got is cache
    assert {k: t.data_ptr() for k, t in cache.items()} == ptrs
    _close(out, jout)
    for k in ("conv", "ssm"):
        _close(cache[k], jcache[k], msg=k)


# ---------------------------------------------------------------------- MoE
def test_shared_expert_moe_matches_jax():
    """deepseek SMOKE's MoE: 4 routed experts, top 2, and one shared
    expert (``n_shared`` 1, an MLP of d_ff_expert): out and aux loss."""
    jcfg = jax_get_config("deepseek-v2-236b", smoke=True)
    cfg = get_config("deepseek-v2-236b", smoke=True)
    assert cfg.moe.n_shared == 1
    specs = moe.moe_specs(cfg)
    assert tuple(specs["shared"]["wi_gate"].shape) == (
        cfg.d_model, cfg.moe.n_shared * cfg.moe.d_ff_expert)
    flat = _np_params(specs, seed=8)
    x = _x((2, 32, cfg.d_model), 9)
    jout, jaux = jmoe.moe_forward(jcfg, _jax(flat), jnp.asarray(x))
    out, aux = moe.moe_forward(cfg, _torch(flat), torch.from_numpy(x))
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


# ------------------------------------------------------------ grouped remat
@pytest.mark.parametrize("arch, n_layers", [("phi3-mini-3.8b", 4),
                                            ("jamba-v0.1-52b", 8)])
def test_grouped_remat_equivalence(arch, n_layers, monkeypatch):
    """``remat_group`` 2 against 1 at 4 periods (phi3 SMOKE at 4 layers;
    jamba SMOKE at 8, whose period is (mamba, mlp), (attn, moe), so the aux
    loss is averaged over the groups as the reference averages it): the
    loss, xent and aux within REMAT_TOL, every gradient leaf within
    REMAT_TOL; the grouped forward nests the 4 period checkpoints in 2
    group ones; and its loss holds the JAX package's grouped loss."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              n_layers=n_layers, remat=True)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                               n_layers=n_layers, remat=True, remat_group=2)
    np_params = jax.tree.map(np.asarray,
                             JM.init_params(jcfg, jax.random.PRNGKey(6)))
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    calls = []
    inner = M.remat
    monkeypatch.setattr(M, "remat",
                        lambda *a: calls.append(1) or inner(*a))
    runs = {}
    for g in (1, 2):
        params = bridge.params_from_numpy(np_params, "cpu")
        calls.clear()
        loss, parts, grads = loss_and_grads(
            dataclasses.replace(cfg, remat_group=g), params,
            {k: torch.from_numpy(v).long() for k, v in batch.items()})
        runs[g] = (loss, parts, dict(tree_leaves(grads)), len(calls))
    (l1, p1, g1, n1), (l2, p2, g2, n2) = runs[1], runs[2]
    # ungrouped: the 4 periods' checkpoints; grouped: 2 groups around the 4
    # periods', and the 4 periods' again as the backward recomputes a group
    assert (n1, n2) == (4, 2 + 4 + 4)
    for a, b in ((l2, l1), (p2["xent"], p1["xent"]), (p2["aux"], p1["aux"])):
        np.testing.assert_allclose(float(a), float(b), rtol=REMAT_TOL)
    assert g2.keys() == g1.keys()
    for k in g1:
        _close(g2[k], g1[k], REMAT_TOL, k)
    jloss, _ = jax.jit(lambda p: JM.loss_fn(jcfg, p, batch))(_jax(np_params))
    np.testing.assert_allclose(float(l2), float(jloss), rtol=1e-4)
