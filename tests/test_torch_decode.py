"""The port's serving path (decode caches, ``prefill``, ``serve_step`` and
``serve_batch``) against the JAX package, on the CPU at SMOKE width.

The JAX ``init_params`` tree is carried across by ``bridge.params_from_numpy``
and the same numpy token ids go through both packages. Tolerances:

* fp32 logits within ``RTOL`` of each entry plus ``RTOL`` of the largest
  entry (the reference's teacher-forcing test holds decode at 1e-4);
* rwkv6 in bf16 (the full CONFIG's dtype, whose ``wkv`` state is rounded
  to bf16 between tokens in both packages) within ``BF16_TOL`` of the
  largest logit: eight bf16 roundings' worth (2^-8 each), where the two
  packages' bf16 matrix products round in different orders (measured
  1.6e-2 over 12 tokens).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.serving import serve_batch as jax_serve_batch
from repro.models import model as JM
from repro.models.cache import cache_bytes as jax_cache_bytes
from repro.models.cache import init_cache as jax_init_cache
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import make_decode_fn, serve_batch
from repro_torch.models import model as M
from repro_torch.models.cache import cache_bytes, init_cache
from repro_torch.models.params import tree_leaves
from repro_torch.parallel import ShardedParams

ARCHS = ["edl-paper", "rwkv6-1.6b", "deepseek-v2-236b", "jamba-v0.1-52b"]
B, T = 2, 12
RTOL = 1e-4
BF16_TOL = 8 * 2.0 ** -8
# serve_batch ids are compared up to the first greedy decision whose top-two
# JAX logits lie closer than this: there, a difference far inside the
# tolerance may pick the other token, and every later id follows it
MARGIN = 1e-3


def _configs(arch, **replace):
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    return jcfg, cfg


def _no_drops(arch) -> dict:
    """A MoE config's ``moe`` at capacity_factor E / K, so that no claim
    drops; nothing for the others."""
    m = get_config(arch, smoke=True).moe
    if m is None:
        return {}
    return {"moe": dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k)}


def _params(jcfg):
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _jax_decode(jcfg):
    return jax.jit(lambda p, b, c: JM.forward(jcfg, p, b, mode="decode",
                                              cache=c))


def _port_decode(cfg, params, tokens, cache):
    with torch.inference_mode():
        return M.forward(cfg, params, {"tokens": torch.from_numpy(tokens)},
                         mode="decode", cache=cache)


# ------------------------------------------------------------ cache trees
@pytest.mark.parametrize("arch,replace", [
    ("edl-paper", {}), ("rwkv6-1.6b", {}), ("deepseek-v2-236b", {}),
    ("jamba-v0.1-52b", {}),
    ("edl-paper", {"window": 8}),
    ("rwkv6-1.6b", {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"})])
def test_cache_tree_equals_jax(arch, replace):
    """Paths, shapes and dtypes of ``init_cache`` (the window's ring
    included), ``pos`` a 0-d int32, and ``cache_bytes``."""
    jcfg, cfg = _configs(arch, **replace)
    want = tree_leaves(jax.tree.map(np.asarray,
                                    jax_init_cache(jcfg, B, 20, pos=3)))
    got = tree_leaves(bridge.to_numpy(init_cache(cfg, B, 20, pos=3,
                                                 device="cpu")))
    dtype = np.float32      # to_numpy gives bfloat16 leaves as float32
    assert [(p, a.shape) for p, a in got] == [(p, a.shape) for p, a in want]
    for (path, a), (_, b) in zip(got, want):
        if path == "pos":
            assert a.dtype == b.dtype == np.int32 and a == b == 3
        else:
            assert a.dtype == dtype and not a.any() and not b.any()
    port = init_cache(cfg, B, 20, device="cpu")
    assert {t.dtype for p, t in tree_leaves(port) if p != "pos"} == \
        {getattr(torch, cfg.param_dtype)}
    assert cache_bytes(cfg, B, 20) == jax_cache_bytes(jcfg, B, 20)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_logits_and_cache_equal_jax(arch):
    """Token by token from the same params: logits at every step and the
    final cache leaves within RTOL, and ``pos`` equal."""
    jcfg, cfg = _configs(arch)
    jparams, params = _params(jcfg)
    toks = _tokens(cfg, (B, T))
    step = _jax_decode(jcfg)
    jc, c = jax_init_cache(jcfg, B, T), init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        jl, jc = step(jparams, {"tokens": toks[:, t:t + 1]}, jc)
        lg, c = _port_decode(cfg, params, toks[:, t:t + 1], c)
        assert lg.shape == (B, 1, cfg.vocab) and lg.dtype == torch.float32
        _assert_close(lg, jl)
    want = tree_leaves(jax.tree.map(np.asarray, jc))
    got = tree_leaves(bridge.to_numpy(c))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if path == "pos":
            assert a == b == T
        else:
            _assert_close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Inside the port, as the reference's test_decode_matches_teacher_forcing:
    step-by-step decode logits equal the train-mode forward's over the same
    tokens within 1e-4."""
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, T), seed=3))
    with torch.inference_mode():
        hidden, _ = M.forward(cfg, params, {"tokens": toks})
        ref = hidden.float() @ params["unembed"]["w"].float()
        cache = init_cache(cfg, B, T, device="cpu")
        outs = []
        for t in range(T):
            lg, cache = M.forward(cfg, params, {"tokens": toks[:, t:t + 1]},
                                  mode="decode", cache=cache)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               atol=1e-4, rtol=1e-4)
    assert int(cache["pos"]) == T


def test_windowed_gqa_decode_equals_jax():
    """A sliding window of 8 over 14 tokens: the ring of 8 slots wraps and
    the port's logits and ring follow JAX's."""
    jcfg, cfg = _configs("edl-paper", window=8)
    jparams, params = _params(jcfg)
    n = 14
    toks = _tokens(cfg, (B, n), seed=4)
    step = _jax_decode(jcfg)
    jc, c = jax_init_cache(jcfg, B, n), init_cache(cfg, B, n, device="cpu")
    assert c["layers"]["slot0"]["k"].shape[3] == 8
    for t in range(n):
        jl, jc = step(jparams, {"tokens": toks[:, t:t + 1]}, jc)
        lg, c = _port_decode(cfg, params, toks[:, t:t + 1], c)
        _assert_close(lg, jl)
    for (_, a), (_, b) in zip(tree_leaves(bridge.to_numpy(c)),
                              tree_leaves(jax.tree.map(np.asarray, jc))):
        _assert_close(a, b)


def test_rwkv6_bf16_cache_rounding_matches_jax():
    """rwkv6 SMOKE in bf16, the full config's dtype: the ``wkv`` state goes
    through the WKV6 op in fp32 and back to bf16 between tokens in both
    packages; logits and the bf16 states within BF16_TOL of their largest
    entries."""
    bf16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}
    jcfg, cfg = _configs("rwkv6-1.6b", **bf16)
    jparams, params = _params(jcfg)
    toks = _tokens(cfg, (B, T), seed=5)
    step = _jax_decode(jcfg)
    jc, c = jax_init_cache(jcfg, B, T), init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        jl, jc = step(jparams, {"tokens": toks[:, t:t + 1]}, jc)
        lg, c = _port_decode(cfg, params, toks[:, t:t + 1], c)
        _assert_close(lg, jl, rtol=BF16_TOL)
    wkv = c["layers"]["slot0"]["wkv"]
    assert wkv.dtype == torch.bfloat16
    _assert_close(wkv.float().numpy(),
                  np.asarray(jc["layers"]["slot0"]["wkv"], np.float32),
                  rtol=BF16_TOL)


def test_jax_cache_continues_in_the_port():
    """``cache_from_numpy`` carries a JAX cache across mid-sequence: the
    port decodes on from it as JAX does, and ``to_numpy`` gives its bits
    back."""
    jcfg, cfg = _configs("edl-paper")
    jparams, params = _params(jcfg)
    toks = _tokens(cfg, (B, T), seed=6)
    step = _jax_decode(jcfg)
    jc = jax_init_cache(jcfg, B, T)
    for t in range(T // 2):
        _, jc = step(jparams, {"tokens": toks[:, t:t + 1]}, jc)
    np_cache = jax.tree.map(np.asarray, jc)
    c = bridge.cache_from_numpy(np_cache, "cpu")
    assert c["pos"].dtype == torch.int32 and c["pos"].dim() == 0
    for (pa, a), (pb, b) in zip(tree_leaves(bridge.to_numpy(c)),
                                tree_leaves(np_cache)):
        assert pa == pb and np.array_equal(a, b)
    for t in range(T // 2, T):
        jl, jc = step(jparams, {"tokens": toks[:, t:t + 1]}, jc)
        lg, c = _port_decode(cfg, params, toks[:, t:t + 1], c)
        _assert_close(lg, jl)


# ----------------------------------------------------------------- prefill
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "interpret"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_jax(arch, use_pallas):
    """The last prompt position's logits against JAX's ``prefill``, its
    Pallas kernels off and in interpret mode; and against the port's own
    decode after the last prompt token. MoE runs at capacity_factor E / K,
    where the prompt's group drops no claim, as the decode's groups of B
    tokens drop none."""
    jcfg, cfg = _configs(arch, **_no_drops(arch))
    jparams, params = _params(jcfg)
    toks = _tokens(cfg, (B, 16), seed=7)
    want = JM.prefill(jcfg, jparams, {"tokens": toks},
                      use_pallas=use_pallas)
    with torch.inference_mode():
        got = M.prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, cfg.vocab) and got.dtype == torch.float32
    _assert_close(got, want)
    c = init_cache(cfg, B, 16, device="cpu")
    for t in range(16):
        lg, c = _port_decode(cfg, params, toks[:, t:t + 1], c)
    _assert_close(lg[:, 0], got)


# ------------------------------------------------------------ serve_batch
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_ids_equal_jax(arch):
    """A wave of 8 prompt and 8 generated tokens: the port's greedy ids
    equal JAX's ``serve_batch`` up to the first decision whose top-two JAX
    logits are closer than MARGIN (every decision here, as the assert on
    ``cut`` shows), and the returned cache has seen every token."""
    jcfg, cfg = _configs(arch)
    jparams, params = _params(jcfg)
    prompt_len, gen_len = 8, 8
    prompts = _tokens(cfg, (B, prompt_len), seed=8)
    want, _ = jax_serve_batch(jcfg, jparams, jnp.asarray(prompts), gen_len)
    want = np.asarray(want)
    # JAX's decisions: the last prompt step's argmax (the first generated
    # step's input), then each generated id
    step = _jax_decode(jcfg)
    jc = jax_init_cache(jcfg, B, prompt_len + gen_len)
    margins, tok = [], None
    for t in range(prompt_len + gen_len):
        inp = prompts[:, t:t + 1] if t < prompt_len else tok
        jl, jc = step(jparams, {"tokens": inp}, jc)
        top2 = np.sort(np.asarray(jl[:, -1]), axis=-1)[:, -2:]
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        if t >= prompt_len - 1:
            margins.append(float((top2[:, 1] - top2[:, 0]).min()))
    # generated[i] rests on decisions 0..i+1
    cut = next((i for i in range(gen_len)
                if min(margins[:i + 2]) < MARGIN), gen_len)
    decode = make_decode_fn(cfg)
    got, cache = serve_batch(cfg, params, torch.from_numpy(prompts),
                             gen_len, decode=decode)
    assert got.shape == (B, gen_len) and got.dtype == torch.int32
    assert int(cache["pos"]) == prompt_len + gen_len
    assert cut == gen_len, f"a near-tie at decision {cut}: {margins}"
    np.testing.assert_array_equal(got.numpy()[:, :cut], want[:, :cut])
    # a second wave from the same prompts gives the same ids
    again, _ = serve_batch(cfg, params, torch.from_numpy(prompts), gen_len,
                           decode=decode)
    assert torch.equal(again, got)


def test_serve_batch_checks_its_lengths_and_frontend():
    cfg = get_config("edl-paper", smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="prompt_len >= 1"):
        serve_batch(cfg, params, torch.zeros((2, 0), dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="gen_len >= 1"):
        serve_batch(cfg, params, torch.zeros((2, 3), dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="tokens frontend"):
        make_decode_fn(dataclasses.replace(cfg, frontend="embeds"))


# -------------------------------------------------------------- mp > 1
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_serving_modes_at_mp_above_1_raise(mode):
    """Prefill and decode run over the model axis: the same ``forward_tp``
    call at mp = 2 (its cache split over the two slots) equals mp = 1's
    within MODULE_RTOL; ``forward`` still refuses a decode without a cache
    and an unknown mode."""
    from repro_torch.models.cache import init_cache_shards
    from repro_torch.optim import adamw
    from repro_torch.parallel import model_dims
    from repro_torch.training.step import port_layout, split_tree
    module_rtol = 1e-5
    cfg = get_config("edl-paper", smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dims = model_dims(port_layout(cfg, adamw(1e-3), 1, 2))
    sp = ShardedParams(split_tree(params, dims, ["cpu"] * 2), dims,
                       ("cpu", "cpu"))
    toks = torch.from_numpy(_tokens(cfg, (B, 3), seed=7))
    if mode == "decode":
        c1 = init_cache(cfg, B, 4, device="cpu")
        c2 = init_cache_shards(cfg, B, 4, ("cpu", "cpu"))
    with torch.inference_mode():
        for t in range(3 if mode == "decode" else 1):
            batch = {"tokens": toks[:, t:t + 1] if mode == "decode" else toks}
            want, _ = M.forward_tp(cfg, ShardedParams.one(params), batch,
                                   mode=mode,
                                   cache=c1 if mode == "decode" else None)
            got, _ = M.forward_tp(cfg, sp, batch, mode=mode,
                                  cache=c2 if mode == "decode" else None)
            _assert_close(got, want, rtol=module_rtol)
    if mode == "decode":
        assert int(c2.trees[0]["pos"]) == int(c1["pos"]) == 3
    with pytest.raises(ValueError, match="decode takes a cache"):
        M.forward(cfg, params, {"tokens": toks[:, :1]}, mode="decode")
    with pytest.raises(ValueError, match="mode must be one of"):
        M.forward(cfg, params, {"tokens": toks[:, :1]}, mode="generate")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_writes_the_cache_in_place(arch):
    """A decode step writes its token into the stacked leaves it was given
    and advances ``pos`` in place: the same tensors come back, k and v
    change at slot ``pos`` alone, and no leaf is copied whole."""
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, (B, 3), seed=9))
    cache = init_cache(cfg, B, 8, device="cpu")
    ptrs = {p: t.data_ptr() for p, t in tree_leaves(cache)}
    with torch.inference_mode():
        for t in range(3):
            before = {p: t.clone() for p, t in tree_leaves(cache)}
            _, out = M.forward(cfg, params, {"tokens": toks[:, t:t + 1]},
                               mode="decode", cache=cache)
            assert out is cache
            assert {p: t.data_ptr() for p, t in tree_leaves(out)} == ptrs
            assert int(out["pos"]) == t + 1
            for path, leaf in tree_leaves(out["layers"]):
                if path.endswith(("/k", "/v", "/ckv", "/krope")):
                    changed = (leaf != before[f"layers/{path}"]).flatten(
                        0, 2).any(-1).any(0).nonzero().flatten().tolist()
                    assert changed == [t], path
