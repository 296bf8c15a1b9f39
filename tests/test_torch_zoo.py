"""The model zoo in the port on the CPU: the config registry against the
reference's (``get_config``, ``all_configs``, ``input_specs`` and the
decode cache's specs and axes), the twin of ``tests/test_models.py`` over
every ported architecture, the window against both of the reference's
paths, and mixtral SMOKE's virtual-worker losses ``==`` across p. Each new
SMOKE config against the JAX package: ``tests/test_torch_zoo_jax.py``;
MLA, Mamba and grouped remat: ``tests/test_torch_mla_mamba.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS
from repro.configs import base as jbase
from repro.models import cache as jcache
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core import ElasticTrainer
from repro_torch.models import cache
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw

PORTED = list(ARCH_IDS)
NEW = [a for a in PORTED if a != "rwkv6_1p6b"]
MOE = [a for a in PORTED if base.get_config(a).moe]
B, L = 2, 64
# decode logits against the teacher-forced forward: the reference's
# tolerance for its dense configs (tests/test_models.py), and for its MoE
# configs, whose train-mode groups route (and drop claims) otherwise than
# the decode's groups of B tokens; with capacity_factor E / K no claim
# drops, and MoE is held at TF_TOL too
TF_TOL = 1e-4
MOE_TF_TOL = 5e-2


def _np_batch(cfg, length=L, seed=0):
    """Labels, and tokens or (for an ``embeds`` frontend) embeddings of
    std 0.02, drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab, (B, length)).astype(
        np.int32)}
    if cfg.frontend == "embeds":
        batch["embeds"] = (rng.standard_normal((B, length, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, length)).astype(
            np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _jleaves(tree):
    return dict(tree_leaves(jax.tree.map(np.asarray, tree)))


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("arch", PORTED + ["edl_paper"])
@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_get_config_is_the_reference_field_for_field(arch, smoke):
    got = base.get_config(arch, smoke=smoke)
    want = jbase.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_every_reference_arch_is_ported():
    """``all_configs`` gives every one of the reference's ``ARCH_IDS``,
    CONFIG and SMOKE, field for field; an unknown name is refused."""
    for smoke in (False, True):
        got = base.all_configs(smoke)
        want = jbase.all_configs(smoke)
        assert list(got) == list(want) == ARCH_IDS
        assert {a: dataclasses.asdict(c) for a, c in got.items()} == \
            {a: dataclasses.asdict(c) for a, c in want.items()}
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get_config("bogus-7b")
    assert base.ARCH_IDS == ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in base.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}


def _spec_leaves(tree, is_jax: bool) -> dict:
    if is_jax:
        tree = jax.tree.map(lambda s: (tuple(s.shape), jnp.dtype(s.dtype).name),
                            tree)
    else:
        tree = jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).replace("torch.", "")),
                            tree, is_leaf=lambda t: isinstance(t, torch.Tensor))
    return dict(tree_leaves(tree))


@pytest.mark.parametrize("shape", list(jbase.INPUT_SHAPES))
@pytest.mark.parametrize("arch", PORTED)
def test_input_specs_match_the_reference(arch, shape):
    """Meta tensors against ShapeDtypeStructs: every input and, for the
    decode shapes, every cache leaf, with its shape and dtype."""
    got = base.input_specs(base.get_config(arch), shape)
    want = jbase.input_specs(jbase.get_config(arch), shape)
    assert all(t.device.type == "meta" for _, t in tree_leaves(got))
    assert _spec_leaves(got, False) == _spec_leaves(want, True)


@pytest.mark.parametrize("arch", PORTED)
def test_cache_logical_axes_match_the_reference(arch):
    got = cache.cache_logical_axes(base.get_config(arch), 4, 8192)
    want = jcache.cache_logical_axes(jbase.get_config(arch), 4, 8192)
    flat_want = dict(tree_leaves(jax.tree.map(
        tuple, want, is_leaf=lambda x: isinstance(x, tuple))))
    assert dict(tree_leaves(got)) == flat_want


# ------------------------------------------ the twin of tests/test_models.py
@pytest.mark.parametrize("arch", PORTED)
def test_smoke_forward_loss(arch):
    cfg = base.get_config(arch, smoke=True)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.n_experts <= 4
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, parts = M.loss_fn(cfg, params, _torch_batch(_np_batch(cfg)))
    assert loss.shape == ()
    assert np.isfinite(float(loss))
    # a random model should sit near ln(vocab)
    assert abs(float(parts["xent"]) - np.log(cfg.vocab)) < 2.0
    assert (float(parts["aux"]) > 0) == bool(cfg.moe)


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_train_step(arch):
    """Three AdamW steps on one batch through the trainer (its context
    prep warms the step, embeddings and all): the loss falls."""
    cfg = base.get_config(arch, smoke=True)
    with ElasticTrainer(cfg, global_batch=B, seq_len=L, init_parallelism=1,
                        optimizer=adamw(1e-3), n_samples=8, d_partitions=2,
                        seed=1, devices=["cpu"], device="cpu") as t:
        batch = t.dataset.read(0, B)
        batch.pop("sample_ids")
        losses = []
        for _ in range(3):
            t.state, m = t.exec.step_fn(t.state, batch)
            losses.append(float(m["loss"]))
        assert int(t.state[0]["step"]) == 3
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]           # memorizing one batch


@pytest.mark.parametrize("arch", PORTED)
def test_smoke_decode_shapes(arch):
    cfg = base.get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    c = cache.init_cache(cfg, B, 32, pos=3, device="cpu")
    tok = ({"embeds": torch.randn((B, 1, cfg.d_model),
                                  generator=torch.Generator().manual_seed(2))}
           if cfg.frontend == "embeds"
           else {"tokens": torch.ones((B, 1), dtype=torch.int32)})
    ids, c = M.serve_step(cfg, params, tok, c)
    assert ids.shape == (B,)
    assert int(c["pos"]) == 4
    assert not any(bool(t.isnan().any()) for _, t in tree_leaves(c)
                   if t.is_floating_point())


def _decode_and_teacher_forced(cfg, seed: int = 3):
    """Step-by-step decode logits over 12 seeded tokens and the train-mode
    forward's over the same tokens, as numpy."""
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, 12)))
    with torch.no_grad():
        hidden, _ = M.forward(cfg, params, {"tokens": toks})
        ref = hidden @ params["unembed"]["w"]
        c = cache.init_cache(cfg, B, 12, device="cpu")
        outs = []
        for t in range(12):
            lg, c = M.forward(cfg, params, {"tokens": toks[:, t:t + 1]},
                              mode="decode", cache=c)
            outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy(), ref.numpy()


@pytest.mark.parametrize("arch", ["phi3_mini_3p8b", "starcoder2_15b",
                                  "mistral_nemo_12b"])
def test_decode_matches_teacher_forcing(arch):
    """Step-by-step decode logits == the train-mode forward's, at the
    reference's tolerance (starcoder2's window of 64 is past 12 tokens)."""
    dec, ref = _decode_and_teacher_forced(base.get_config(arch, smoke=True))
    np.testing.assert_allclose(dec, ref, atol=TF_TOL, rtol=TF_TOL)


@pytest.mark.parametrize("arch, no_drops", [
    *((a, False) for a in ("deepseek_v2_236b", "jamba_v01_52b")),
    *((a, True) for a in MOE)])
def test_moe_decode_matches_teacher_forcing(arch, no_drops):
    """deepseek and jamba SMOKE at their own capacity within MOE_TF_TOL,
    the reference's tolerance for them; every MoE config with
    capacity_factor E / K, where a group's capacity covers all its tokens
    and no claim drops in either pass, within TF_TOL."""
    cfg = base.get_config(arch, smoke=True)
    if no_drops:
        m = cfg.moe
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.n_experts / m.top_k))
    dec, ref = _decode_and_teacher_forced(cfg)
    tol = TF_TOL if no_drops else MOE_TF_TOL
    np.testing.assert_allclose(dec, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("swa_pruned", [True, False],
                         ids=["window_pruned", "masked"])
def test_window_loss_matches_both_jax_paths(swa_pruned):
    """starcoder2 SMOKE at L 128 past its window of 64: the port's flash op
    (its plain version on the CPU) against the reference's window-pruned
    path and its masked full computation, from the same params."""
    jcfg = dataclasses.replace(jbase.get_config("starcoder2_15b", smoke=True),
                               swa_pruned=swa_pruned)
    cfg = base.get_config("starcoder2_15b", smoke=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(4))
    batch = _np_batch(cfg, length=128, seed=4)
    jloss, _ = jax.jit(lambda p: JM.loss_fn(jcfg, p, batch))(jparams)
    loss, _ = M.loss_fn(cfg, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu"), _torch_batch(batch))
    assert abs(float(loss) - float(jloss)) < 1e-5


def test_mixtral_virtual_losses_equal_across_parallelism():
    """The virtual-worker contract on MoE: K = 4 shards of the batch, each
    routed in its own group, give the same loss bits at p = 1, 2 and 4."""
    runs = {}
    for p in (1, 2, 4):
        with ElasticTrainer(base.get_config("mixtral_8x7b", smoke=True),
                            global_batch=8, seq_len=32, init_parallelism=p,
                            n_samples=64, d_partitions=4, seed=0,
                            devices=["cpu"] * 4, device="cpu",
                            time_allowance_s=0, virtual_workers=4) as t:
            runs[p] = [t.step()["loss"] for _ in range(3)]
    assert runs[1] == runs[2] == runs[4], runs
    assert len(set(runs[1])) == 3
