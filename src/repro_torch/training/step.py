"""Train state and the default data-parallel train step.

TrainState = {"params": tree, "opt": {"count", "mu"[, "nu"]}, "step": i32},
the reference's tree. The state lives on slot 0's device. A step splits the
global batch into p equal shards, one per slot; each shard runs forward and
backward on its slot's device against that slot's replica of the params;
the gradients are summed in fixed slot order on slot 0's device and divided
by p, and one optimizer update follows. Because the global batch is
constant, the step computes the same math at every p, up to fp32 summation
order.

The reference's deterministic virtual-worker step is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import Optimizer


def init_train_state(cfg, optimizer: Optimizer, generator: torch.Generator,
                     device) -> dict:
    params = M.init_params(cfg, generator, device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=torch.device(device))}


def shard_batch(batch: dict, p: int, devices) -> list[dict]:
    """p equal shards of a host (numpy) batch, each on its slot's device.
    Integer arrays become int64 (embedding and gather indices)."""
    n = len(next(iter(batch.values())))
    if n % p:
        raise ValueError(f"global batch {n} not divisible by p={p}")
    per = n // p
    out = []
    for s in range(p):
        shard = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v[s * per:(s + 1) * per]))
            if not t.is_floating_point():
                t = t.long()
            shard[k] = t.to(devices[s])
        out.append(shard)
    return out


def loss_and_grads(cfg, params: dict, batch: dict):
    """(loss, parts, grads) of ``loss_fn`` at ``params``."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_(True) for _, p in leaves]
    tree = tree_unflatten((k, t) for (k, _), t in zip(leaves, live))
    loss, parts = M.loss_fn(cfg, tree, batch)
    grads = torch.autograd.grad(loss, live)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_unflatten((k, g) for (k, _), g in zip(leaves, grads)))


def make_train_step(cfg, optimizer: Optimizer, devices) -> Callable:
    """The default step over ``len(devices)`` slots; ``devices[s]`` is slot
    s's device and ``devices[0]`` holds the state."""
    devices = [torch.device(d) for d in devices]
    p, home = len(devices), devices[0]

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        outs = []
        for s, shard in enumerate(shard_batch(batch, p, devices)):
            replica = (params if devices[s] == home else
                       tree_map(lambda t, d=devices[s]: t.to(d), params))
            outs.append(loss_and_grads(cfg, replica, shard))
        loss = sum(o[0].to(home) for o in outs) / p
        xent = sum(o[1]["xent"].to(home) for o in outs) / p
        aux = sum(o[1]["aux"].to(home) for o in outs) / p
        sums = dict(tree_leaves(outs[0][2]))
        for o in outs[1:]:
            for k, g in tree_leaves(o[2]):
                sums[k] = sums[k] + g.to(home)
        grads = tree_unflatten((k, g / p) for k, g in sums.items())
        new_params, new_opt = optimizer.update(grads, state["opt"], params)
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for _, g in tree_leaves(grads)))
        metrics = {"loss": loss, "xent": xent, "aux": aux, "grad_norm": gnorm}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step
