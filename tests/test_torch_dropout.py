"""Input dropout on the CPU, with the reference's threefry bits: the port's
virtual-worker step at dropout 0.5 against the JAX virtual step over three
steps from the same state and batches (edl_paper SMOKE, K = 2, B 4 x L 32),
at p = 1 and p = 2; the trainer's ``==`` contract across p with dropout
on; the ``embeds`` frontend dropped by the reference's mask; and dropout 0
(or no key) leaving the bits of a forward without dropout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro_torch import bridge, prng
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.training.step import init_train_state, loss_and_grads, \
    make_train_step, port_layout
from test_torch_model import _fan_in_scaled

BATCH, SEQ, K, STEPS = 4, 32, 2, 3
DROPOUT = 0.5
# the losses of test_torch_virtual.py's one-step comparison, over three
# steps here (AdamW's updates keep the two packages within it, as the
# trainer tests' TRAJ_RTOL)
RTOL = 1e-4


def _cfg(dropout=DROPOUT):
    return dataclasses.replace(get_config("edl-paper", smoke=True),
                               dropout=dropout)


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


@pytest.fixture(scope="module")
def jax_run():
    """The JAX virtual step at K = 2 on a one-device mesh: the rescaled
    initial state, and the losses of three steps at dropout 0.5 and 0."""
    from repro.configs import get_config as jax_get_config
    from repro.launch.mesh import make_mesh
    from repro.optim import adamw as jax_adamw
    from repro.training.step import init_train_state as jax_init, \
        make_train_step as jax_make_train_step
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    base = jax_get_config("edl-paper", smoke=True)
    state0 = jax.tree.map(np.asarray, jax_init(base, jax_adamw(1e-3),
                                               jax.random.PRNGKey(0)))
    state0["params"] = _fan_in_scaled(state0["params"])
    losses = {}
    for rate in (DROPOUT, 0.0):
        jcfg = dataclasses.replace(base, dropout=rate)
        fn = jax.jit(jax_make_train_step(jcfg, jax_adamw(1e-3), n_virtual=K,
                                         mesh=mesh, global_batch=BATCH,
                                         seed=0))
        state = jax.tree.map(jnp.asarray, state0)
        losses[rate] = []
        for b in _batches(jcfg.vocab):
            state, m = fn(state, b)
            losses[rate].append(float(m["loss"]))
    return state0, losses


def _port_losses(state0, rate, p, seed=0):
    cfg, opt = _cfg(rate), adamw(1e-3)
    fn = make_train_step(cfg, opt, ["cpu"] * p, n_virtual=K,
                         global_batch=BATCH, seed=seed)
    state = bridge.shard_state_from_numpy(state0, port_layout(cfg, opt, p, 1),
                                          ["cpu"] * p)
    out = []
    for b in _batches(cfg.vocab):
        state, m = fn(state, b)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("p", [1, 2])
def test_virtual_step_with_dropout_matches_jax(p, jax_run):
    state0, want = jax_run
    got = _port_losses(state0, DROPOUT, p)
    np.testing.assert_allclose(got, want[DROPOUT], rtol=RTOL)
    # dropout moves the losses well past the tolerance, in both packages
    assert all(abs(a - b) > 10 * RTOL * abs(b)
               for a, b in zip(want[DROPOUT], want[0.0]))
    np.testing.assert_allclose(_port_losses(state0, 0.0, p), want[0.0],
                               rtol=RTOL)


def test_losses_equal_across_parallelism_with_dropout():
    """The ``==`` contract of the virtual-worker trainer with dropout on:
    p = 1 and p = 2 give the same loss bits, step for step."""
    runs = {}
    for p in (1, 2):
        with ElasticTrainer(_cfg(), global_batch=BATCH, seq_len=SEQ,
                            init_parallelism=p, n_samples=64,
                            d_partitions=8, seed=0, devices=["cpu"] * 2,
                            device="cpu", time_allowance_s=0,
                            virtual_workers=K) as t:
            runs[p] = [t.step()["loss"] for _ in range(STEPS)]
    assert runs[1] == runs[2], runs
    assert len(set(runs[1])) == STEPS


def test_embeds_frontend_takes_the_references_mask():
    """The ``embeds`` frontend is dropped as the tokens' one is: where
    ``jax.random.bernoulli``'s mask holds, x / keep, else 0."""
    cfg = dataclasses.replace(get_config("musicgen-medium", smoke=True),
                              dropout=0.25, compute_dtype="float32")
    x = np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    key = prng.fold_in(prng.fold_in(prng.key(3), 1), 2)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = M.embed_tp(cfg, M.sharded(params), {"embeds": torch.from_numpy(
        x)}, key).numpy()
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 1),
                              2)
    mask = np.asarray(jax.random.bernoulli(jkey, 0.75, x.shape))
    want = np.where(mask, x / np.float32(0.75), np.float32(0.0))
    np.testing.assert_array_equal(got, want)
    assert 0.6 < mask.mean() < 0.9


@pytest.mark.parametrize("seed", [0, 7])
def test_dropout_zero_leaves_the_bits(seed):
    """At dropout 0 a key changes nothing: the loss and gradients of
    ``loss_and_grads`` with a key are those without, bit for bit, and the
    virtual step's loss does not depend on its seed."""
    cfg = _cfg(0.0)
    state = init_train_state(cfg, adamw(1e-3),
                             torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v).long() for k, v in _batches(cfg.vocab)[0]
         .items()}
    key = prng.fold_in(prng.key(seed), 1)
    l0, _, g0 = loss_and_grads(cfg, state["params"], b)
    l1, _, g1 = loss_and_grads(cfg, state["params"], b, rng=key)
    assert torch.equal(l0, l1)
    for (k, a), (_, c) in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, c), k
    state0 = bridge.to_numpy(state)
    assert _port_losses(state0, 0.0, 1, seed=seed) == _port_losses(
        state0, 0.0, 1, seed=0)
