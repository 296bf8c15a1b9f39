#!/usr/bin/env python3
"""How far rwkv6 over the model axis parts from mp = 1, and whether the
reference parts the same way.

``--part refit`` (the CPU; imports the JAX package): rwkv6 SMOKE in fp32,
one global batch of 4 x 64 tokens refitted by 5 AdamW 1e-3 steps (the
data of ``test_torch_tensor_parallel.py``'s trajectories) from the JAX
init with its stacked layer matrices rescaled to 1/sqrt(d_in). The JAX
trainer runs at (1, 1) and at (1, 2) on two forced host devices from the
same state, in one subprocess; then the port's trainer at (1, 1) and
(1, 2) from that state. Prints the four trajectories and the largest
relative gap of each pair. Then one step's gradients at that state on a
batch of 4 x 64 tokens from numpy seed 0, in each package at (1, 1) and
at (1, 2) (the JAX one jitted with the trainer's parameter shardings on a
(1, 2) mesh): each package's worst leaf at (1, 2) against its (1, 1),
norm-wise, and the same for ``w0``.

``--part serve`` (the CPU; imports the JAX package): serving, where the
refit's sums differ: rwkv6 SMOKE in fp32 at the reference's init, the
prefill of 2 x 6 tokens from numpy seed 0 and 6 decode steps of them into
a 16-slot cache (``test_torch_serve_tp.py``'s inputs), in the JAX package
jitted at (1, 1) and at (1, 2) (params and cache by the trainer's
shardings, on two forced host devices, one subprocess) and in the port at
(1, 1) and (1, 2) from the same params. Prints each pair's largest gap
over the largest logit (prefill and every decode step) and over the
largest entry of the final ``wkv`` state.

``--part clamp`` (the card; ``--device cpu --smoke`` at SMOKE width): one
forward of rwkv6-1.6b in fp32 at 4 layers on one batch of 8 x 1024
tokens (phase 8 (e)'s step of ``chip_smoke.py``: params from seed 0
drawn on the device, tokens from numpy seed 0) at
(1, 1) and at (1, 2). It captures each time-mix's decay pre-activation
raw = w0 + lora(xw), which the model clamps to [-8, 4] before its exp,
and prints per layer: the largest |raw(1, 2) - raw(1, 1)|, the entries of
raw(1, 1) within that distance of a bound, and the entries whose clamp
differs between the two.

One JSON line per part. Run from the repo root:

    python3 tools/torch_tp_gap_probe.py --part refit
    python3 tools/torch_tp_gap_probe.py --part serve
    python3 tools/torch_tp_gap_probe.py --part clamp [--device cpu --smoke]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "rwkv6-1.6b"
REFIT = dict(global_batch=4, seq_len=64, n_samples=4, d_partitions=2, seed=0)
STEPS = 5
GRAD_BATCH = (4, 65)
CLAMP = (-8.0, 4.0)
CLAMP_LAYERS, CLAMP_BATCH = 4, (8, 1025)

_JAX_REFIT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import numpy as np
from repro.configs import get_config
from repro.core import ElasticTrainer
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.training.step import params_sharding


def rescaled(tree, pre=""):
    out = {{}}
    for k, v in tree.items():
        path = pre + k
        if isinstance(v, dict):
            out[k] = rescaled(v, path + "/")
        elif path.startswith("layers/") and v.ndim >= 3:
            out[k] = (v * np.sqrt(v.shape[0] / v.shape[-2])).astype(v.dtype)
        else:
            out[k] = v
    return out


def flat(tree, pre="", out=None):
    out = {{}} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(v, pre + k + "/", out)
        else:
            out[pre + k] = np.asarray(v)
    return out


state, losses = None, {{}}
for mp in (1, 2):
    jt = ElasticTrainer(get_config({arch!r}, smoke=True), init_parallelism=1,
                        model_parallel=mp, devices=jax.devices()[:mp],
                        use_aot=False, **{refit!r})
    if state is None:
        state = jax.tree.map(np.asarray, jt.state)
        state["params"] = rescaled(state["params"])
        np.savez({out!r}, **flat(state))
    jt.state = jax.tree.map(lambda a, old: jax.device_put(a, old.sharding),
                            state, jt.state)
    losses[mp] = [float(jt.step()["loss"]) for _ in range({steps})]
cfg = get_config({arch!r}, smoke=True)
toks = np.random.default_rng(0).integers(0, cfg.vocab, {grad_batch!r})
batch = {{"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
grads = {{}}
for mp in (1, 2):
    psh = params_sharding(cfg, make_mesh(1, mp, devices=np.array(
        jax.devices()[:mp])))
    g = jax.jit(jax.grad(lambda p: JM.loss_fn(cfg, p, batch)[0]),
                in_shardings=(psh,), out_shardings=psh)(
        jax.tree.map(jax.device_put, state["params"], psh))
    grads.update({{f"mp{{mp}}/" + k: v for k, v in flat(g).items()}})
np.savez({grads_out!r}, **grads)
print(json.dumps(losses))
"""


_JAX_SERVE = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
import numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import model as JM
from repro.models.cache import init_cache
from repro.training.step import cache_sharding, params_sharding

B, T, S = {batch}, {steps}, {slots}
cfg = get_config({arch!r}, smoke=True)
params = JM.init_params(cfg, jax.random.PRNGKey(0))
toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, T)).astype(
    np.int32)
out = {{"tokens": toks}}
out.update({{"params/" + "/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}})
for mp in (1, 2):
    mesh = make_mesh(1, mp, devices=np.array(jax.devices()[:mp]))
    p_sh, c_sh = params_sharding(cfg, mesh), cache_sharding(cfg, mesh, B, S)
    ps = jax.device_put(params, p_sh)
    with mesh:
        pre = jax.jit(lambda p, b: JM.prefill(cfg, p, b),
                      in_shardings=(p_sh, None))(ps, {{"tokens": toks}})
        step = jax.jit(lambda p, b, c: JM.forward(cfg, p, b, mode="decode",
                                                  cache=c),
                       in_shardings=(p_sh, None, c_sh))
        cache = jax.device_put(init_cache(cfg, B, S), c_sh)
        logits = []
        for t in range(T):
            lg, cache = step(ps, {{"tokens": toks[:, t:t + 1]}}, cache)
            logits.append(np.asarray(lg[:, 0]))
    out[f"mp{{mp}}/prefill"] = np.asarray(pre)
    out[f"mp{{mp}}/decode"] = np.stack(logits, 1)
    out[f"mp{{mp}}/wkv"] = np.asarray(cache["layers"]["slot0"]["wkv"])
np.savez({out!r}, **out)
print("done")
"""
SERVE = dict(batch=2, steps=6, slots=16)


def max_rel_gap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def grad_gaps(mp1: dict, mp2: dict) -> dict:
    """The worst leaf's and ``w0``'s norm-wise gap of the flat gradients
    ``mp2`` against ``mp1`` (numpy arrays by path)."""
    errs = {k: float(np.linalg.norm(mp2[k] - g) / np.linalg.norm(g))
            for k, g in mp1.items()}
    worst = max(errs, key=errs.get)
    return {"worst_leaf": worst, "worst_leaf_gap": errs[worst],
            "w0_gap": max(e for k, e in errs.items()
                          if k.endswith("/w0/w"))}


def port_grads(state: dict, mp: int) -> dict:
    import torch
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import ShardedParams, model_dims
    from repro_torch.training.step import group_loss_and_grads, \
        port_layout, shard_batch, split_tree
    cfg = get_config(ARCH, smoke=True)
    params = bridge.params_from_numpy(state["params"], "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, GRAD_BATCH)
    batch = shard_batch({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 1,
                        ["cpu"])[0]
    dims = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
    devs = ["cpu"] * mp
    _, _, grads = group_loss_and_grads(cfg, split_tree(params, dims, devs),
                                       dims, devs, batch)
    whole = ShardedParams(grads, dims, tuple(devs)).whole()
    with torch.no_grad():
        return {k: g.numpy() for k, g in tree_leaves(whole)}


def refit() -> dict:
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.reshape import unflatten_tree
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "state.npz")
        grads_npz = os.path.join(tmp, "grads.npz")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        run = subprocess.run(
            [sys.executable, "-c", _JAX_REFIT.format(
                arch=ARCH, refit=REFIT, out=npz, steps=STEPS,
                grad_batch=GRAD_BATCH, grads_out=grads_npz)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
        if run.returncode:
            raise RuntimeError(run.stderr[-3000:])
        jax_losses = json.loads(run.stdout.strip().splitlines()[-1])
        with np.load(npz) as z:
            state = unflatten_tree({k: z[k] for k in z.files})
        with np.load(grads_npz) as z:
            jax_grads = {mp: {k[len(f"mp{mp}/"):]: z[k] for k in z.files
                              if k.startswith(f"mp{mp}/")} for mp in (1, 2)}
    port = {}
    for mp in (1, 2):
        with ElasticTrainer(get_config(ARCH, smoke=True), init_parallelism=1,
                            model_parallel=mp, devices=["cpu"] * mp,
                            device="cpu", time_allowance_s=0, **REFIT) as t:
            t.state = bridge.shard_state_from_numpy(
                state, t.exec.layout, t.exec.devices)
            port[str(mp)] = [float(t.step()["loss"]) for _ in range(STEPS)]
    return {"part": "refit", "arch": ARCH, **REFIT, "steps": STEPS,
            "jax": jax_losses, "port": port,
            "jax_1x2_vs_jax_1x1": max_rel_gap(jax_losses["2"],
                                              jax_losses["1"]),
            "port_1x2_vs_port_1x1": max_rel_gap(port["2"], port["1"]),
            "port_1x1_vs_jax_1x1": max_rel_gap(port["1"], jax_losses["1"]),
            "port_1x2_vs_jax_1x2": max_rel_gap(port["2"], jax_losses["2"]),
            "grads_jax_1x2_vs_1x1": grad_gaps(jax_grads[1], jax_grads[2]),
            "grads_port_1x2_vs_1x1": grad_gaps(port_grads(state, 1),
                                               port_grads(state, 2))}


def logit_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def port_served(params: dict, tokens, mp: int) -> dict:
    """The port's prefill logits, decode logits [B, T, V] and final ``wkv``
    state at (1, mp) from ``params``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.cache import init_cache_shards
    from repro_torch.optim import adamw
    from repro_torch.parallel import ShardedParams, model_dims
    from repro_torch.training.step import port_layout, split_tree
    cfg = get_config(ARCH, smoke=True)
    dims = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
    devs = ("cpu",) * mp
    sp = ShardedParams(split_tree(params, dims, devs), dims, devs)
    toks = torch.from_numpy(tokens)
    cache = init_cache_shards(cfg, toks.shape[0], SERVE["slots"], devs)
    with torch.inference_mode():
        pre = M.prefill(cfg, sp, {"tokens": toks})
        logits = [M.forward(cfg, sp, {"tokens": toks[:, t:t + 1]},
                            mode="decode", cache=cache)[0][:, 0]
                  for t in range(toks.shape[1])]
        wkv = cache.whole()["layers"]["slot0"]["wkv"]
    return {"prefill": pre.numpy(), "decode": torch.stack(logits, 1).numpy(),
            "wkv": wkv.numpy()}


def serve() -> dict:
    from repro_torch import bridge
    from repro_torch.reshape import unflatten_tree
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "serve.npz")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "JAX_PLATFORMS": "cpu"}
        env.pop("XLA_FLAGS", None)
        run = subprocess.run(
            [sys.executable, "-c", _JAX_SERVE.format(arch=ARCH, out=npz,
                                                     **SERVE)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
        if run.returncode:
            raise RuntimeError(run.stderr[-3000:])
        with np.load(npz) as z:
            got = {k: z[k] for k in z.files}
    params = bridge.params_from_numpy(unflatten_tree(
        {k[len("params/"):]: v for k, v in got.items()
         if k.startswith("params/")}), "cpu")
    jax_ = {mp: {k: got[f"mp{mp}/{k}"] for k in ("prefill", "decode", "wkv")}
            for mp in (1, 2)}
    port = {mp: port_served(params, got["tokens"], mp) for mp in (1, 2)}

    def gaps(a: dict, b: dict) -> dict:
        return {k: logit_gap(a[k], b[k]) for k in ("prefill", "decode",
                                                    "wkv")}
    return {"part": "serve", "arch": ARCH, **SERVE, "point": "init",
            "jax_1x2_vs_jax_1x1": gaps(jax_[2], jax_[1]),
            "port_1x2_vs_port_1x1": gaps(port[2], port[1]),
            "port_1x1_vs_jax_1x1": gaps(port[1], jax_[1]),
            "port_1x2_vs_jax_1x2": gaps(port[2], jax_[2])}


def clamp(args) -> dict:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.layers import dt
    from repro_torch.optim import adamw
    from repro_torch.parallel import ShardedParams, model_dims
    from repro_torch.training.step import port_layout, shard_batch, \
        split_tree
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card (pass --device cpu --smoke)")
    cfg = dataclasses.replace(get_config(ARCH, smoke=args.smoke),
                              param_dtype="float32", compute_dtype="float32",
                              n_layers=CLAMP_LAYERS)
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, CLAMP_BATCH)
    batch = shard_batch({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 1,
                        [dev])[0]
    heads, raws = ssm._rwkv_tm_heads, []

    def captured(cfg, p, ln_scale, xr, xk, xv, xg, lora_h, state):
        lora = lora_h @ p["w_lora_b"]["w"].to(dt(cfg, "compute"))
        raws.append(p["w0"]["w"].float() + lora.float())
        return heads(cfg, p, ln_scale, xr, xk, xv, xg, lora_h, state)

    runs = {}
    ssm._rwkv_tm_heads = captured
    try:
        with torch.no_grad():
            for mp in (1, 2):
                dims = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
                devs = [dev] * mp
                raws.clear()
                M.loss_fn_tp(cfg, ShardedParams(split_tree(params, dims, devs),
                                                dims, tuple(devs)), batch)
                runs[mp] = [torch.cat(raws[i:i + mp], dim=-1)
                            for i in range(0, len(raws), mp)]
    finally:
        ssm._rwkv_tm_heads = heads
    lo, hi = CLAMP
    layers = []
    for a, b in zip(runs[1], runs[2]):
        gap = float((a - b).abs().max())
        near = ((a - lo).abs() <= gap) | ((a - hi).abs() <= gap)
        flips = ((a < lo) != (b < lo)) | ((a > hi) != (b > hi))
        layers.append({"max_abs_gap": gap, "min": float(a.min()),
                       "max": float(a.max()),
                       "clamped": int(((a < lo) | (a > hi)).sum()),
                       "within_gap_of_a_bound": int(near.sum()),
                       "clamp_flips": int(flips.sum()),
                       "entries": a.numel()})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip() if dev.type == "cuda" \
        else None
    return {"part": "clamp", "arch": ARCH, "smoke": args.smoke,
            "layers": CLAMP_LAYERS, "d_model": cfg.d_model,
            "tokens": CLAMP_BATCH, "device": str(dev),
            "per_layer": layers, "card": card}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("refit", "serve", "clamp"),
                    required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    parts = {"refit": refit, "serve": serve, "clamp": lambda: clamp(args)}
    print(json.dumps(parts[args.part]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
