"""The dry-run on ``meta`` tensors (``repro_torch.launch.dryrun``) on the
CPU: the parameter counts and the per-slot argument bytes against the
reference's (``repro.configs`` and ``repro.launch.dryrun._lower(...)
.compile().memory_analysis()`` on forced host devices, in a subprocess),
the counted flops against ``FlopCounterMode`` on real CPU tensors, each
kernel's ``meta`` branch held to the CUDA path's checks, the CLI, and one
full-width, full-depth config's step."""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro_torch.configs import ARCH_IDS, InputShape, get_config, \
    input_specs
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.launches import COSTS, KernelRefusal
from repro_torch.kernels.rwkv import ops as rwkv_ops
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M
from repro_torch.models.cache import cache_dims, cache_spec_tree, \
    init_cache_shards
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import ShardedParams, model_dims
from repro_torch.training.step import init_train_state, join_shards, \
    make_train_step, port_layout, split_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_ARCHS = ("edl-paper", "rwkv6-1.6b", "jamba-v0.1-52b")
MODES = ("train", "prefill", "decode")
SMALL = {m: InputShape(f"{m}_small", 64, 4, m) for m in MODES}

_JAX_ARGS = r"""
import json
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.dryrun import _lower
from repro.launch.mesh import make_mesh
out = {{}}
for arch in {archs}:
    cfg = get_config(arch, smoke=True)
    for mode in {modes}:
        for mp in (1, 2):
            shape = InputShape(mode + "_small", 64, 4, mode)
            mem = _lower(cfg, shape, make_mesh(1, mp)).compile()\
                .memory_analysis()
            out[arch + "/" + mode + "/" + str(mp)] = \
                mem.argument_size_in_bytes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_arg_bytes():
    """``argument_size_in_bytes`` a device of the reference's lowered step
    for each SMOKE arch, mode and (1, mp), from one subprocess."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _JAX_ARGS.format(archs=SMOKE_ARCHS,
                                                modes=MODES)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


# ------------------------------------------------------ parameter counts
@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["edl_paper"])
def test_param_counts_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


# ------------------------------------------------------ phase A: the bytes
@pytest.mark.parametrize("mp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_first_slot_arg_bytes_equal_the_reference(arch, mode, mp,
                                                  jax_arg_bytes):
    """The first slot's ``arg_bytes`` equal the reference's
    ``argument_size_in_bytes`` a device at (1, mp); the other slots hold
    the replicated cache leaves (and ``pos``) fewer, and the batch, which
    the port keeps on the first slot."""
    cfg = get_config(arch, smoke=True)
    r = D.dryrun(cfg, SMALL[mode], (1, mp), cost=False)
    assert r["status"] == "OK" and r["group_batch"] == 4
    assert r["arg_bytes"] == jax_arg_bytes[f"{arch}/{mode}/{mp}"]
    specs = input_specs(cfg, SMALL[mode])
    cache = specs.pop("cache", None)
    fewer = sum(t.nbytes for t in specs.values())
    if cache is not None:
        dims = dict(tree_leaves(cache_dims(cfg, 4, 64, mp)))
        fewer += sum(t.nbytes for p, t in tree_leaves(cache)
                     if dims[p] is None)
    assert r["arg_bytes_by_slot"][1:] == [r["arg_bytes"] - fewer] * (mp - 1)
    assert r["per_device_bytes"] >= r["arg_bytes"] > 0 and r["fits"]


# ------------------------------------------------------ phase B: the flops
def _unmetered(fn):
    def run(*args, **kw):
        with _disable_current_modes():
            return fn(*args, **kw)
    return run


def _cpu_step(cfg, shape: InputShape, mp: int):
    """The dry-run's step on real CPU tensors at (1, mp)."""
    opt = adamw(1e-4)
    gen = torch.Generator().manual_seed(0)
    B, L = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab, (B, L), generator=gen,
                           dtype=torch.int32)
    devices = ["cpu"] * mp
    layout = port_layout(cfg, opt, 1, mp)
    if shape.mode == "train":
        state = init_train_state(cfg, opt, gen, "cpu")
        state = join_shards(split_tree(state, model_dims(layout, prefix=""),
                                       devices))
        step = make_train_step(cfg, opt, devices, mp=mp)
        return lambda: step(state, {"tokens": tokens, "labels": tokens})
    dims = model_dims(layout)
    sp = ShardedParams(split_tree(M.init_params(cfg, gen, "cpu"), dims,
                                  devices), dims, tuple(devices))
    if shape.mode == "prefill":
        return lambda: M.prefill(cfg, sp, {"tokens": tokens})
    cache = init_cache_shards(cfg, B, L, devices)
    return lambda: M.serve_step(cfg, sp, {"tokens": tokens[:, :1]}, cache)


@pytest.mark.parametrize("mp", [1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ("edl-paper", "rwkv6-1.6b"))
def test_counted_flops_equal_the_step_on_real_tensors(arch, mode, mp,
                                                      monkeypatch):
    """The flops the dry-run counts on ``meta`` equal ``FlopCounterMode``'s
    count of the same step on real CPU tensors plus the kernels' formula
    counts (``COSTS``): the plain versions the CPU runs in the kernels'
    place are not counted, as on the card no aten op runs there."""
    cfg = get_config(arch, smoke=True)
    for mod, name in ((attn_ops, "flash_attn_fwd_plain"),
                      (attn_ops, "flash_attn_bwd_plain"),
                      (rwkv_ops, "wkv6_fwd_plain"),
                      (rwkv_ops, "wkv6_bwd_plain")):
        monkeypatch.setattr(mod, name, _unmetered(getattr(mod, name)))
    run = _cpu_step(cfg, SMALL[mode], mp)
    COSTS.reset()
    with FlopCounterMode(display=False) as fc, torch.inference_mode(
            mode != "train"):
        run()
    kernels = COSTS.snapshot()["flops"]
    r = D.dryrun(cfg, SMALL[mode], (1, mp))
    assert sum(r["flops_by_slot"]) == fc.get_total_flops() + sum(
        kernels.values())
    assert r["kernel_flops"] == {k: n for k, n in kernels.items() if n}
    assert r["dominant"] in ("compute", "memory", "collective")
    if mp > 1:
        assert r["collective_bytes_per_slot"] > 0


# ------------------------------------------ the kernels' meta branches
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["head_dim_80", "elements_2_31",
                                  "wkv6_bf16"])
def test_meta_branches_raise_the_cuda_paths_errors(case):
    """On ``meta`` each wrapper applies the CUDA path's checks and raises
    its error (a ``KernelRefusal``) with the kernel's message, where the
    CPU would run the plain version."""
    if case == "head_dim_80":
        q = _meta(1, 2, 8, 80)
        with pytest.raises(KernelRefusal, match="head_dim in"):
            attn_ops.flash_attention_bhld(q, q, q)
        cpu = torch.zeros(1, 2, 8, 80)
        assert attn_ops.flash_attention_bhld(cpu, cpu, cpu).shape == (
            1, 2, 8, 80)
    elif case == "elements_2_31":
        q = _meta(32, 32, 32768, 64)              # 2^31 elements
        with pytest.raises(KernelRefusal, match="int offsets"):
            attn_ops.flash_attention_bhld(q, q, q)
        ok = _meta(16, 32, 32768, 64)             # 2^30: runs
        assert attn_ops.flash_attention_bhld(ok, ok, ok).is_meta
    else:
        r = _meta(1, 4, 2, 64, dtype=torch.bfloat16)
        with pytest.raises(KernelRefusal, match="take float32"):
            rwkv_ops.wkv6(r, r, r, r, _meta(2, 64, dtype=torch.bfloat16),
                          _meta(1, 2, 64, 64, dtype=torch.bfloat16))


def test_meta_branches_give_the_kernels_output_shapes_forward_and_back():
    """Forward and backward on ``meta``: empty tensors of each CUDA
    kernel's output shapes and dtypes, the kernels' work in ``COSTS``."""
    COSTS.reset()
    q = _meta(2, 4, 64, 64).requires_grad_()
    k = _meta(2, 2, 64, 64).requires_grad_()
    v = _meta(2, 2, 64, 64).requires_grad_()
    o = attn_ops.flash_attention_bhld(q, k, v)
    o.sum().backward()
    assert o.is_meta and o.shape == q.shape and k.grad.shape == k.shape
    r = _meta(2, 3, 4, 64).requires_grad_()
    u, s0 = _meta(4, 64).requires_grad_(), _meta(2, 4, 64, 64)
    y, sT = rwkv_ops.wkv6(r, r, r, r, u, s0)
    (y.sum() + sT.sum()).backward()
    assert y.shape == r.shape and sT.shape == s0.shape
    assert r.grad.shape == r.shape and u.grad.shape == u.shape
    flops = COSTS.snapshot()["flops"]
    pairs = 2 * 4 * attn_ops.visible_pairs(64, 64, True, 0, 64)
    assert (flops["flash_attn_fwd"], flops["flash_attn_bwd_dq"],
            flops["flash_attn_bwd_dkdv"]) == (4 * 64 * pairs,
                                              6 * 64 * pairs,
                                              8 * 64 * pairs)
    assert flops["wkv6_fwd"] == 5 * 2 * 3 * 4 * 64 * 64


def test_a_kernel_limit_ends_the_record_as_its_refusal():
    """starcoder2's prefill_32k with the whole batch of 32 on one group
    (mp 8 does not split its 4 KV heads, so GQA runs whole): the flash
    kernels refuse 6.4e9 elements, and the record says so with their
    message, where a plain version would have run."""
    r = D.dryrun_one("starcoder2-15b", "prefill_32k", mesh_override=(1, 8),
                     verbose=False, cost=False)
    assert r["status"] == "REFUSED"
    assert r["refused_by"] == "attention/ops.py"
    assert "int offsets" in r["error"] and "2**31" in r["error"]


# ------------------------------------------------------------------ the CLI
def test_cli_writes_resumes_and_refuses(tmp_path):
    out = str(tmp_path / "f.jsonl")
    args = ["--arch", "edl-paper", "--shape", "train_4k", "--out", out]
    with contextlib.redirect_stdout(io.StringIO()):
        assert D.main(args) == 0
    (rec,) = [json.loads(line) for line in open(out)]
    for key in ("arch", "shape", "status", "mesh", "cards", "mode",
                "group_batch", "arg_bytes", "temp_bytes", "output_bytes",
                "per_device_bytes", "fits", "flops_per_slot",
                "bytes_per_slot", "collective_bytes_per_slot",
                "collective_breakdown", "t_compute_s", "t_memory_s",
                "t_collective_s", "dominant", "params", "active_params",
                "model_flops", "useful_flops_ratio"):
        assert key in rec, key
    assert (rec["status"], rec["mesh"], rec["cards"], rec["group_batch"]) \
        == ("OK", "32x8", 256, 8)
    assert rec["params"] == get_config("edl-paper").param_count()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert D.main(args + ["--resume"]) == 0
    assert "1 done, 0 remaining" in buf.getvalue()
    assert len(open(out).readlines()) == 1
    with pytest.raises(SystemExit) as e, \
            contextlib.redirect_stderr(io.StringIO()):
        D.main(["--arch", "edl-paper", "--shape", "train_4k",
                "--multi-pod"])
    assert e.value.code == 2
    skip = D.dryrun_one("edl-paper", "long_500k", verbose=False)
    assert skip["status"] == "SKIP" and "sub-quadratic" in skip["reason"]


def test_full_width_full_depth_config_runs_phase_a():
    """phi3-mini-3.8b at its published widths and all 32 layers,
    ``decode_32k`` over the production layout (32, 8): a group of 4
    sequences against a 32768-slot cache split by kv heads."""
    cfg = get_config("phi3-mini-3.8b")
    r = D.dryrun_one("phi3-mini-3.8b", "decode_32k", cost=False,
                     verbose=False)
    assert r["status"] == "OK" and r["mesh"] == "32x8"
    assert r["group_batch"] == 4
    cache = sum(int(np.prod(s.shape)) for _, s in tree_leaves(
        cache_spec_tree(cfg, 4, 32768))) * 2            # bf16
    params = cfg.param_count() * 2
    # every phi3 leaf but the norms splits 8 ways (vocab 32064 too)
    assert params / 8 < r["arg_bytes"] - cache / 8 < params / 8 * 1.01
    assert r["fits"] and r["per_device_bytes"] < 8e9
