"""Serving over the model axis on the CPU: ``prefill``, ``serve_step`` and
``serve_batch`` at (1, 2) for the SMOKEs of edl_paper, rwkv6, mixtral,
deepseek-v2 and jamba against the JAX package's GSPMD prefill and decode
at (1, 2) on two forced host devices (one subprocess), the port's (1, 2)
and (1, 4) against its own (1, 1) module by module and model-wide, and the
cache's layout over the model axis against the reference's
``cache_sharding``.

Tolerances: ``test_torch_decode.py``'s ``RTOL`` (1e-4 of each entry plus
1e-4 of the largest) against JAX; ``MODULE_RTOL`` (1e-5, the tensor-parallel
modules' tolerance of ``test_torch_tensor_parallel.py``) within the port,
where (1, mp) sums the same fp32 terms as (1, 1) in another order.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.training.step import cache_sharding as jax_cache_sharding
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import make_decode_fn, serve_batch
from repro_torch.core.serving import trainer_params
from repro_torch.models import attention, model as M, ssm
from repro_torch.models.cache import cache_dims, init_cache, \
    init_cache_shards
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import ShardedParams, model_dims
from repro_torch.training.step import port_layout, split_tree
from test_torch_decode import _assert_close, _no_drops
from test_torch_model import _fan_in_scaled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("edl-paper", "rwkv6-1.6b", "mixtral-8x7b", "deepseek-v2-236b",
         "jamba-v0.1-52b")
B, T, S = 2, 6, 16          # batch, tokens (prompt, then decode), cache slots
MODULE_RTOL = 1e-5

_JAX_SERVE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses, json
import jax, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.cache import init_cache
from repro.training.step import cache_sharding, params_sharding
B, T, S = {b}, {t}, {s}
mesh = make_mesh(1, 2)
for arch in {archs}:
    cfg = get_config(arch, smoke=True)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    p_sh = params_sharding(cfg, mesh)
    c_sh = cache_sharding(cfg, mesh, B, S)
    params = jax.device_put(M.init_params(cfg, jax.random.PRNGKey(0)), p_sh)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T)).astype(
        np.int32)
    with mesh:
        pre = jax.jit(lambda p, b: M.prefill(cfg, p, b),
                      in_shardings=(p_sh, None))(params, {{"tokens": toks}})
        step = jax.jit(lambda p, b, c: M.forward(cfg, p, b, mode="decode",
                                                 cache=c),
                       in_shardings=(p_sh, None, c_sh))
        cache = jax.device_put(init_cache(cfg, B, S), c_sh)
        logits = []
        for t in range(T):
            lg, cache = step(params, {{"tokens": toks[:, t:t + 1]}}, cache)
            logits.append(np.asarray(lg))
    flat = {{}}
    for name, tree in (("params", params), ("cache", cache)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            flat[name + "/" + key] = np.asarray(leaf)
    np.savez(os.path.join({out!r}, arch + ".npz"), tokens=toks,
             prefill=np.asarray(pre), logits=np.stack(logits), **flat)
print("done")
"""


def _unflatten(z, prefix: str) -> dict:
    from repro_torch.reshape import unflatten_tree
    return unflatten_tree({k[len(prefix):]: z[k] for k in z.files
                           if k.startswith(prefix)})


@pytest.fixture(scope="module")
def jax_serving(tmp_path_factory):
    """Each arch's JAX params, tokens, prefill logits, decode logits and
    final cache at (1, 2), from one subprocess."""
    out = str(tmp_path_factory.mktemp("jax_serve_1x2"))
    script = _JAX_SERVE.format(b=B, t=T, s=S, archs=ARCHS, out=out)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = {}
    for arch in ARCHS:
        with np.load(os.path.join(out, arch + ".npz")) as z:
            got[arch] = {"params": _unflatten(z, "params/"),
                         "cache": _unflatten(z, "cache/"),
                         **{k: z[k] for k in ("tokens", "prefill", "logits")}}
    return got


def _cfg(arch, **replace):
    return dataclasses.replace(get_config(arch, smoke=True),
                               **{**_no_drops(arch), **replace})


def _params(cfg) -> dict:
    """The port's init from seed 0 with its stacked matrices rescaled to
    1/sqrt(d_in), the well-conditioned point of the port's tensor-parallel
    twins (at the reference's init jamba's Mamba states reach 5e7, and
    sums in another order part by more than MODULE_RTOL)."""
    return bridge.params_from_numpy(_fan_in_scaled(bridge.to_numpy(
        M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))),
        "cpu")


def _sharded(cfg, params: dict, mp: int) -> ShardedParams:
    """``params`` split over mp CPU slots by the port's layout."""
    dims = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
    return ShardedParams(split_tree(params, dims, ["cpu"] * mp), dims,
                         ("cpu",) * mp)


# ------------------------------------------------ against JAX at (1, 2)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_at_1x2_match_jax_gspmd(arch, jax_serving):
    """From the same params, ``prefill`` and T steps of decode at (1, 2)
    follow the JAX package's GSPMD prefill and decode at (1, 2): the
    prefill logits, each step's logits, each final cache leaf joined along
    its dim, and ``pos``. rwkv6's WKV6 op runs its plain versions here, as
    the JAX step runs ``wkv6_scan``."""
    cfg = _cfg(arch)
    assert cfg.compute_dtype == "float32"
    want = jax_serving[arch]
    sp = _sharded(cfg, bridge.params_from_numpy(want["params"], "cpu"), 2)
    toks = torch.from_numpy(want["tokens"])
    cache = init_cache_shards(cfg, B, S, ("cpu", "cpu"))
    with torch.inference_mode():
        _assert_close(M.prefill(cfg, sp, {"tokens": toks}), want["prefill"])
        for t in range(T):
            logits, cache = M.forward(cfg, sp, {"tokens": toks[:, t:t + 1]},
                                      mode="decode", cache=cache)
            assert logits.shape == (B, 1, cfg.vocab)
            _assert_close(logits, want["logits"][t])
    got = dict(tree_leaves(bridge.to_numpy(cache.whole())))
    jc = tree_leaves(want["cache"])
    assert sorted(got) == [p for p, _ in jc]
    for path, b in jc:
        if path == "pos":
            assert got[path] == b == T
        else:
            _assert_close(got[path], b)


# ------------------------------------------------------- the cache layout
@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["edl_paper"])
def test_cache_dims_follow_the_reference_cache_sharding(arch, mp):
    """``cache_dims`` is the ``model`` entry of the reference's
    ``cache_sharding`` PartitionSpecs, leaf for leaf (full CONFIGs, the
    cache of 2 x 64 slots), at (1, mp)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    specs = jax.tree.map(lambda s: s.spec, jax_cache_sharding(
        jcfg, AbstractMesh((1, mp), ("data", "model")), 2, 64))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            next((i for i, a in enumerate(spec) if a == "model"), None)
            for path, spec in flat}
    assert dict(tree_leaves(cache_dims(cfg, 2, 64, mp))) == want


@pytest.mark.parametrize("arch,mp,whole", [
    ("edl-paper", 4, {}),                   # 4 kv heads: split at 4
    ("edl-paper", 4, {"n_kv_heads": 2}),    # GQA with Hkv % mp != 0
    ("rwkv6-1.6b", 4, {"d_model": 192}),    # H 3: RWKV6 with H % mp != 0
    ("jamba-v0.1-52b", 3, {}),              # di 512, Hkv 2: Mamba and GQA
])
def test_a_form_running_whole_gets_whole_cache_leaves(arch, mp, whole):
    """The rule that splits a cache leaf is the one that makes each
    tensor-parallel form run whole: where the heads (or Mamba's channels)
    do not divide by mp, the leaf stays whole, and decode at (1, mp) still
    equals (1, 1)'s."""
    cfg = _cfg(arch, param_dtype="float32", compute_dtype="float32",
               **whole)
    dims = dict(tree_leaves(cache_dims(cfg, B, S, mp)))
    heads = {"k": cfg.n_kv_heads, "v": cfg.n_kv_heads,
             "wkv": cfg.d_model // cfg.ssm.rwkv_head_dim if cfg.ssm else 0,
             "conv": cfg.ssm.expand * cfg.d_model if cfg.ssm else 0,
             "ssm": cfg.ssm.expand * cfg.d_model if cfg.ssm else 0}
    for path, d in dims.items():
        leaf = path.rsplit("/", 1)[-1]
        if leaf in heads:
            assert (d is not None) == (heads[leaf] % mp == 0), (path, d)
    assert any(d is None for p, d in dims.items() if p != "pos") == (
        arch != "edl-paper" or bool(whole))
    _decode_twins(cfg, mp)


def _decode_twins(cfg, mp: int):
    params = _params(cfg)
    sp = _sharded(cfg, params, mp)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, T)))
    c1 = init_cache(cfg, B, S, device="cpu")
    cm = init_cache_shards(cfg, B, S, ["cpu"] * mp)
    with torch.inference_mode():
        for t in range(T):
            a, _ = M.forward(cfg, params, {"tokens": toks[:, t:t + 1]},
                             mode="decode", cache=c1)
            b, _ = M.forward(cfg, sp, {"tokens": toks[:, t:t + 1]},
                             mode="decode", cache=cm)
            _assert_close(b, a, rtol=MODULE_RTOL)
    got = dict(tree_leaves(cm.whole()))
    for path, a in tree_leaves(c1):
        _assert_close(got[path], a, rtol=MODULE_RTOL)


# --------------------------------------------- the port's (1, mp) twins
MIXER_CASES = [("edl-paper", "attn"), ("mixtral-8x7b", "attn"),
               ("deepseek-v2-236b", "attn"), ("jamba-v0.1-52b", "mamba"),
               ("rwkv6-1.6b", "rwkv_tm"), ("rwkv6-1.6b", "rwkv_cm")]


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("arch,module", MIXER_CASES)
def test_module_decode_at_mp_equals_mp_1(arch, module, mp):
    """Each mixer's (and RWKV6's channel-mix's) decode branch over the
    model axis against its plain form at mp = 1, token by token from the
    same block params and x: the output and every cache leaf joined, within
    MODULE_RTOL."""
    from repro_torch.models.blocks import scan_plan
    cfg = _cfg(arch, param_dtype="float32", compute_dtype="float32")
    params = _params(cfg)
    slots, _ = scan_plan(cfg)
    j = next(i for i, (mx, ffn) in enumerate(slots)
             if module in (mx, ffn))
    part = "ffn" if module == "rwkv_cm" else "mixer"
    block = tree_map(lambda a: a[0], params["layers"][f"slot{j}"][part])
    dims_all = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
    dims = tree_map(lambda d: None if d is None else d - 1,
                    dims_all["layers"][f"slot{j}"][part])
    sp = ShardedParams(split_tree(block, dims, ["cpu"] * mp), dims,
                       ("cpu",) * mp)
    one = tree_map(lambda a: a[0], init_cache(cfg, B, S, device="cpu")[
        "layers"][f"slot{j}"])
    cs = init_cache_shards(cfg, B, S, ["cpu"] * mp)
    shards = cs["layers"].periods()[0][f"slot{j}"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))
    plain = {"attn": attention.attention_forward,
             "mamba": ssm.mamba_forward, "rwkv_tm": ssm.rwkv_tm_forward,
             "rwkv_cm": ssm.rwkv_cm_forward}[module]
    tp = {"attn": attention.attention_forward_tp,
          "mamba": ssm.mamba_forward_tp, "rwkv_tm": ssm.rwkv_tm_forward_tp,
          "rwkv_cm": ssm.rwkv_cm_forward_tp}[module]
    with torch.inference_mode():
        for t in range(T):
            pos = torch.full((B, 1), t)
            kw = {} if module == "rwkv_cm" else {"positions": pos}
            a = plain(cfg, block, x[:, t:t + 1], cache=one, **kw)[0]
            b = tp(cfg, sp, x[:, t:t + 1], cache=shards, **kw)
            _assert_close(b, a, rtol=MODULE_RTOL)
    got = dict(tree_leaves(shards.whole()))
    for path, a in tree_leaves(one):
        _assert_close(got[path], a, rtol=MODULE_RTOL)


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_at_mp_equal_mp_1(arch, mp):
    """Model-wide: ``prefill`` and decode at (1, mp) against (1, 1) from
    the same params, within MODULE_RTOL."""
    cfg = _cfg(arch)
    params = _params(cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, T)))
    with torch.inference_mode():
        _assert_close(M.prefill(cfg, _sharded(cfg, params, mp),
                                {"tokens": toks}),
                      M.prefill(cfg, params, {"tokens": toks}),
                      rtol=MODULE_RTOL)
    _decode_twins(cfg, mp)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_batch_at_1x2_gives_the_ids_of_1x1(arch):
    """``serve_batch`` from a ``ShardedParams`` at (1, 2) gives (1, 1)'s
    greedy ids, and a second wave the same ids; its cache is split over
    the two slots and ends at ``prompt + gen``."""
    cfg = _cfg(arch)
    params = _params(cfg)
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, 5)).astype(np.int32))
    decode = make_decode_fn(cfg)
    want, _ = serve_batch(cfg, params, prompts, 6, decode=decode)
    sp = _sharded(cfg, params, 2)
    got, cache = serve_batch(cfg, sp, prompts, 6, decode=decode)
    assert isinstance(cache, ShardedParams) and cache.mp == 2
    assert int(cache.trees[0]["pos"]) == 11
    assert torch.equal(got, want)
    again, _ = serve_batch(cfg, sp, prompts, 6, decode=decode)
    assert torch.equal(again, got)


def test_trainer_params_serve_what_the_trainer_trained():
    """A tenant trained at (1, 2) serves from its own state through
    ``trainer_params``: the shards are the trainer's tensors, and the ids
    equal those of the joined params at (1, 1)."""
    from repro_torch.core import ElasticTrainer
    cfg = get_config("edl-paper", smoke=True)
    with ElasticTrainer(cfg, global_batch=4, seq_len=16, init_parallelism=1,
                        model_parallel=2, n_samples=16, d_partitions=2,
                        seed=0, devices=["cpu"] * 2, device="cpu",
                        time_allowance_s=0) as t:
        t.step()
        sp = trainer_params(t)
        assert sp.mp == 2 and all(
            a is b for (_, a), (_, b) in zip(
                tree_leaves(sp.trees[1]), tree_leaves(t.state[1]["params"])))
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab, (2, 4)).astype(np.int32))
        got, _ = serve_batch(cfg, sp, prompts, 5)
        want, _ = serve_batch(cfg, sp.whole(), prompts, 5)
    assert torch.equal(got, want)
