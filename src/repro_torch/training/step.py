"""Train state and the two train steps.

TrainState = {"params": tree, "opt": {"count", "mu"[, "nu"]}, "step": i32},
the reference's tree. The state lives on slot 0's device.

  * ``make_train_step(cfg, opt, devices)`` — the default step: the global
    batch splits into p equal shards, one per slot; each shard runs forward
    and backward on its slot's device against that slot's replica of the
    params; the gradients are summed in fixed slot order on slot 0's device
    and divided by p, and one optimizer update follows. Because the global
    batch is constant, the step computes the same math at every p, up to
    fp32 summation order (the shard shape follows p).
  * ``make_train_step(cfg, opt, devices, n_virtual=K, global_batch=...,
    seed=...)`` — the DETERMINISTIC virtual-worker step: the global batch
    splits into K fixed slices; slot s of p runs virtual workers
    ``[s K/p, (s+1) K/p)`` one after another, each at the same
    ``(global_batch / K, seq)`` shape at every p, and the K losses and
    gradient trees are summed on slot 0's device in a fixed balanced binary
    tree over the virtual axis (``vw_tree_reduce``, the reference's
    ``_vw_tree_reduce`` pairing) — a function of K alone. So every p gives
    bitwise-identical updates. Per-virtual-worker RNG only feeds dropout,
    which the port's configs refuse, so the step threads no RNG.
"""
from __future__ import annotations

import operator
from typing import Callable, Iterable

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


def state_shapes(cfg, optimizer: Optimizer) -> dict:
    """The train state's tree of ``(shape, dtype)`` leaves, allocating
    nothing (the counterpart of the reference's ``state_shape_structs``)."""
    dtype = M.dt(cfg, "param")
    params = tree_map(lambda s: (tuple(s.shape), dtype),
                      M.param_spec_tree(cfg))
    moments = tree_map(lambda sd: (sd[0], torch.float32), params)
    opt = {"count": ((), torch.int32), "mu": moments}
    if optimizer.slots >= 2:
        opt["nu"] = moments
    return {"params": params, "opt": opt, "step": ((), torch.int32)}


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


def vw_tree_reduce(items: Iterable, add: Callable = operator.add):
    """Sum ``items`` in the reference's fixed balanced binary tree: fold
    adjacent pairs level by level, carrying an odd tail up a level, so the
    pairing is a function of the count alone.

    Streams: a carry stack merges each complete aligned block of 2^l items
    as it closes, so at most log2(n) + 1 partial sums are held at once, not
    n. The blocks left on the stack at the end are the tree's partial right
    spine, and folding them right to left (``left + acc``) is the pairing
    the level-by-level form gives them."""
    stack: list[tuple[int, object]] = []        # (level, partial sum)
    for x in items:
        level = 0
        while stack and stack[-1][0] == level:
            x = add(stack.pop()[1], x)
            level += 1
        stack.append((level, x))
    if not stack:
        raise ValueError("vw_tree_reduce of no items")
    acc = stack.pop()[1]
    while stack:
        acc = add(stack.pop()[1], acc)
    return acc


def _apply_update(optimizer: Optimizer, state: dict, grads: dict, loss,
                  xent, aux) -> tuple[dict, dict]:
    """One optimizer update from the reduced gradients, and the step's
    metrics. grad_norm is diagnostic only: outside the virtual step's
    bitwise contract, as in the reference."""
    new_params, new_opt = optimizer.update(grads, state["opt"],
                                           state["params"])
    gnorm = torch.sqrt(sum(g.float().square().sum()
                           for _, g in tree_leaves(grads)))
    metrics = {"loss": loss, "xent": xent, "aux": aux, "grad_norm": gnorm}
    return ({"params": new_params, "opt": new_opt,
             "step": state["step"] + 1}, metrics)


def _add_flat(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def make_train_step(cfg, optimizer: Optimizer, devices, *,
                    n_virtual: int = 0, global_batch: int = 0,
                    seed: int = 0) -> Callable:
    """The step over ``len(devices)`` slots; ``devices[s]`` is slot s's
    device and ``devices[0]`` holds the state. With ``n_virtual > 0``
    (requires ``global_batch``) the deterministic virtual-worker step is
    built instead of the default step — see the module docstring.
    ``seed`` keys the reference's per-virtual-worker RNG, which only dropout
    reads; the port's configs refuse dropout, so no step reads it yet."""
    devices = [torch.device(d) for d in devices]
    if n_virtual:
        if not global_batch:
            raise ValueError("the virtual-worker step needs global_batch")
        return _make_virtual_train_step(cfg, optimizer, devices, n_virtual,
                                        global_batch)
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
        return _apply_update(optimizer, state, grads, loss, xent, aux)

    return train_step


def _make_virtual_train_step(cfg, optimizer: Optimizer, devices,
                             n_virtual: int, global_batch: int) -> Callable:
    p, home = len(devices), devices[0]
    if n_virtual % p:
        raise ValueError(f"n_virtual={n_virtual} not divisible by data "
                         f"parallelism {p}")
    if global_batch % n_virtual:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"n_virtual={n_virtual}")
    local = n_virtual // p           # virtual workers per slot

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        # one shard per virtual worker, in virtual order; slot s hosts the
        # contiguous block [s * local, (s + 1) * local)
        shards = shard_batch(batch, n_virtual,
                             [devices[vw // local] for vw in range(n_virtual)])
        replicas = {home: params}

        def per_vw():
            # one virtual worker at a time: its loss, parts and gradients,
            # flattened and moved to slot 0's device
            for vw, shard in enumerate(shards):
                dev = devices[vw // local]
                if dev not in replicas:
                    replicas[dev] = tree_map(lambda t: t.to(dev), params)
                loss, parts, grads = loss_and_grads(cfg, replicas[dev], shard)
                flat = {k: g.to(home) for k, g in tree_leaves(grads)}
                flat.update({"/loss": loss.to(home),
                             "/xent": parts["xent"].to(home),
                             "/aux": parts["aux"].to(home)})
                yield flat

        total = vw_tree_reduce(per_vw(), _add_flat)
        loss, xent, aux = (total.pop(k) / n_virtual
                           for k in ("/loss", "/xent", "/aux"))
        grads = tree_unflatten((k, g / n_virtual) for k, g in total.items())
        return _apply_update(optimizer, state, grads, loss, xent, aux)

    return train_step
