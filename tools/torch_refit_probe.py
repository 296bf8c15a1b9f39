#!/usr/bin/env python3
"""Whether a zoo config at a cut depth learns one batch, and from where.

Cuts ``--arch`` to ``--layers`` layers and, with ``--d-model``, to another
width (heads, KV heads and ``d_ff`` in proportion, head width kept), draws
its params from seed 0 and one batch of ``--batch`` x ``--seq`` uniform
noise tokens from seed 1 (labels the next token), and takes ``--steps``
AdamW steps on that batch at each learning rate of ``--lrs`` and each
point of ``--points``: "init" (the reference's init, whose stacked layer
matrices have std 1/sqrt(n_periods)) and "fan_in" (those rescaled to
1/sqrt(d_in), ``torch_serve_probe.fan_in_scaled``). It also prints the rms
of the embedding and of the first block's mixer output at each point.
``--jax`` (CPU only) adds the JAX package's losses from the same "init"
params at each lr. One JSON line per run. Run from the repo root:

    python3 tools/torch_refit_probe.py --device cpu --arch jamba-v0.1-52b \\
        --layers 1 --seq 128 --dtype float32 --lrs 1e-3 --points init --jax
    python3 tools/torch_refit_probe.py --device cpu --arch jamba-v0.1-52b \\
        --layers 1 --seq 256 --lrs 1e-4,3e-5 --points fan_in
"""
import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))


def cut_config(get_config, arch, layers, d_model, dtype):
    cfg = get_config(arch)
    d = d_model or cfg.d_model
    kv = max(1, cfg.n_kv_heads * d // cfg.d_model)
    return dataclasses.replace(
        cfg, n_layers=layers, d_model=d, d_ff=cfg.d_ff * d // cfg.d_model,
        n_kv_heads=kv, n_heads=kv * (cfg.n_heads // cfg.n_kv_heads),
        head_dim=cfg.resolved_head_dim, param_dtype=dtype or cfg.param_dtype,
        compute_dtype=dtype or cfg.compute_dtype)


def mixer_rms(torch, cfg, params, tokens) -> dict:
    """The rms of the embedding and of the first block's mixer output."""
    from repro_torch.models import blocks
    from repro_torch.models.layers import apply_embed, apply_rmsnorm, dt
    from repro_torch.models.params import tree_map
    cd = dt(cfg, "compute")
    with torch.no_grad():
        x = apply_embed(params["embed"], tokens, cd)
        p0 = tree_map(lambda t: t[0], params["layers"]["slot0"])
        mixer = blocks.scan_plan(cfg)[0][0][0]
        h = apply_rmsnorm(p0["norm1"], x, cfg.norm_eps)
        pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
        out, _ = blocks.MIXERS[mixer][1](cfg, p0["mixer"], h, positions=pos)

    def rms(t):
        return float(t.double().pow(2).mean().sqrt())
    return {"embed_rms": rms(x), "mixer_rms": rms(out)}


def port_losses(torch, cfg, params, batch, lr, steps):
    from repro_torch.optim import adamw
    from repro_torch.training.step import loss_and_grads
    opt = adamw(lr)
    state, out = opt.init(params), []
    for _ in range(steps):
        loss, _, grads = loss_and_grads(cfg, params, batch)
        params, state = opt.update(grads, state, params)
        out.append(float(loss))
    return out


def jax_losses(arch, args, np_params, np_batch, lr):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro.optim import adamw as jax_adamw
    jcfg = cut_config(jax_get_config, arch, args.layers, args.d_model,
                      args.dtype)
    opt = jax_adamw(lr)

    @jax.jit
    def step(p, s):
        (loss, _), g = jax.value_and_grad(
            lambda q: JM.loss_fn(jcfg, q, np_batch), has_aux=True)(p)
        p, s = opt.update(g, s, p)
        return p, s, loss
    p = jax.tree.map(jnp.asarray, np_params)
    s, out = opt.init(p), []
    for _ in range(args.steps):
        p, s, loss = step(p, s)
        out.append(float(loss))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lrs", default="1e-3")
    ap.add_argument("--points", default="init,fan_in")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()

    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    if args.jax and args.device != "cpu":
        print("--jax runs on the CPU", file=sys.stderr)
        return 1
    import torch_serve_probe as probe
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = cut_config(get_config, args.arch, args.layers, args.d_model,
                     args.dtype)
    toks = torch.randint(0, cfg.vocab, (args.batch, args.seq + 1),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].to(args.device),
             "labels": toks[:, 1:].to(args.device)}
    card = "cpu" if args.device == "cpu" else torch.cuda.get_device_name(0)
    base = M.init_params(cfg, torch.Generator().manual_seed(0), args.device)
    for point in args.points.split(","):
        params = base if point == "init" else probe.fan_in_scaled(base)
        rec = {"arch": cfg.name, "d_model": cfg.d_model,
               "layers": cfg.n_layers, "dtype": cfg.param_dtype,
               "batch": args.batch, "seq": args.seq, "point": point,
               **mixer_rms(torch, cfg, params, batch["tokens"])}
        for lr in (float(x) for x in args.lrs.split(",")):
            rec["lr"] = lr
            rec["losses"] = port_losses(torch, cfg, params, batch, lr,
                                        args.steps)
            if args.jax and point == "init":
                rec["jax_losses"] = jax_losses(
                    args.arch, args, bridge.to_numpy(params),
                    {k: v.numpy().astype("int32") for k, v in batch.items()},
                    lr)
            print(json.dumps({"refit": rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
