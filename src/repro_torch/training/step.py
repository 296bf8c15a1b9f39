"""Train state and the two train steps.

TrainState = {"params": tree, "opt": {"count", "mu"[, "nu"]}, "step": i32},
the reference's tree. At model-parallel degree mp > 1 the state is a list
of mp such trees, one per model shard, laid out by the port's
``StateSpec`` (``port_layout``: the reference's rules with the data axis
replicated): shard m holds its box of every tensor (the whole of a
replicated one) and lives on slot m's device. At mp = 1 it is the one tree,
on slot 0's device. ``model_shards`` and ``join_shards`` convert.

Slot ``d * mp + m`` of the step's devices holds data shard d and model
shard m; slots ``d * mp .. d * mp + mp - 1`` are data group d.

  * ``make_train_step(cfg, opt, devices, mp=M)`` — the default step: the
    global batch splits into p = len(devices) / mp equal shards, one per
    data group; each group runs forward and backward on its slots' devices
    against its replica of the params — tensor-parallel over its mp slots
    (``models.model.loss_fn_tp``); the gradients are summed in
    fixed group order onto each model shard's device and divided by p, and
    the optimizer update runs shard by shard. Because the global batch is
    constant, the step computes the same math at every (p, mp), up to fp32
    summation order (the shard shapes follow p and mp).
  * ``make_train_step(cfg, opt, devices, mp=M, n_virtual=K,
    global_batch=...)`` — the DETERMINISTIC virtual-worker step: the
    global batch splits into K fixed slices; data group d runs virtual
    workers ``[d K/p, (d+1) K/p)`` one after another on its first slot,
    against the whole params assembled there once (never tensor-parallel:
    its reductions would follow mp), each at the same
    ``(global_batch / K, seq)`` shape at every (p, mp); the K losses and
    gradient trees are summed on slot 0's device in a fixed balanced binary
    tree over the virtual axis (``vw_tree_reduce``, the reference's
    ``_vw_tree_reduce`` pairing) — a function of K alone — and the summed
    gradients are sliced into model shards for the elementwise update. So
    every (p, mp) gives bitwise-identical updates. Per-virtual-worker RNG
    only feeds dropout, which the port's configs refuse, so the step
    threads no RNG.
"""
from __future__ import annotations

import operator
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import Optimizer
from repro_torch.parallel import ShardedParams, model_dims, send
from repro_torch.reshape.spec import StateSpec


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
    """p equal shards of a batch of host (numpy) arrays or tensors (the
    dry-run's ``meta`` ones), each on its slot's device. Integer arrays
    become int64 (embedding and gather indices)."""
    n = len(next(iter(batch.values())))
    if n % p:
        raise ValueError(f"global batch {n} not divisible by p={p}")
    per = n // p
    out = []
    for s in range(p):
        shard = {}
        for k, v in batch.items():
            t = v[s * per:(s + 1) * per]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.ascontiguousarray(t))
            if not t.is_floating_point():
                t = t.long()
            shard[k] = t.to(devices[s])
        out.append(shard)
    return out


def loss_and_grads(cfg, params: dict, batch: dict):
    """(loss, parts, grads) of ``loss_fn`` at ``params``: the one shard of
    mp = 1."""
    sp = ShardedParams.one(params)
    loss, parts, (grads,) = group_loss_and_grads(cfg, sp.trees, sp.dims,
                                                 sp.devices, batch)
    return loss, parts, grads


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


def port_layout(cfg, optimizer: Optimizer, p: int, mp: int) -> StateSpec:
    """The port's layout of the train state at ``(p, mp)``: the
    reference's rules with the data axis replicated."""
    return StateSpec.for_config(cfg, optimizer, p, mp).data_replicated()


def model_shards(state) -> list[dict]:
    """The model shards of a train state: a one-tree state at mp = 1."""
    return state if isinstance(state, list) else [state]


def join_shards(shards: list[dict]):
    """The train state from its model shards (the tree itself at mp = 1)."""
    return shards[0] if len(shards) == 1 else list(shards)


def split_tree(tree: dict, dims: dict, devices) -> list[dict]:
    """A whole tree as one tree per model shard, shard m on
    ``devices[m]``: a leaf split over the model axis (``dims``) gives its
    m-th equal part along its dim, a replicated one its whole."""
    mp = len(devices)
    d = dict(tree_leaves(dims))
    out = []
    for m, dev in enumerate(devices):
        leaves = []
        for k, g in tree_leaves(tree):
            if d[k] is not None:
                size = g.shape[d[k]] // mp
                g = g.narrow(d[k], m * size, size).contiguous()
            leaves.append((k, g.to(dev)))
        out.append(tree_unflatten(leaves))
    return out


def group_loss_and_grads(cfg, trees: list[dict], dims: dict, devices,
                         batch: dict):
    """(loss, parts, grads per model shard) of one data group, its batch on
    ``devices[0]``. A replicated leaf is read from shard 0 and every shard
    gets its gradient, on its device."""
    d = dict(tree_leaves(dims))
    live = [[(k, p.detach().requires_grad_(m == 0 or d[k] is not None))
             for k, p in tree_leaves(t)] for m, t in enumerate(trees)]
    sp = ShardedParams([tree_unflatten(leaves) for leaves in live], dims,
                       tuple(devices))
    loss, parts = M.loss_fn_tp(cfg, sp, batch)
    wanted = [t for leaves in live for _, t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads: list[dict] = []
    for m, (dev, leaves) in enumerate(zip(devices, live)):
        g = {}
        for k, t in leaves:
            if t.requires_grad:
                gk = next(got)
                g[k] = torch.zeros_like(t) if gk is None else gk
            else:
                g[k] = send(grads[0][k], dev, 0, m, "replicated_grads")
        grads.append(g)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            [tree_unflatten(g.items()) for g in grads])


def _apply_update(optimizer: Optimizer, shards: list[dict],
                  grads: list[dict], dims: dict, loss, xent, aux):
    """The optimizer update of each model shard from its reduced
    gradients, and the step's metrics. grad_norm is diagnostic only:
    outside the virtual step's bitwise contract, as in the reference."""
    new = []
    for state, g in zip(shards, grads):
        new_params, new_opt = optimizer.update(g, state["opt"],
                                               state["params"])
        new.append({"params": new_params, "opt": new_opt,
                    "step": state["step"] + 1})
    d = dict(tree_leaves(dims))
    home = loss.device
    flat = [dict(tree_leaves(g)) for g in grads]
    gnorm = torch.sqrt(sum(
        g.float().square().sum() if d[k] is None else
        sum(f[k].float().square().sum().to(home) for f in flat)
        for k, g in flat[0].items()))
    metrics = {"loss": loss, "xent": xent, "aux": aux, "grad_norm": gnorm}
    return join_shards(new), metrics


def _add_flat(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def make_train_step(cfg, optimizer: Optimizer, devices, *, mp: int = 1,
                    n_virtual: int = 0, global_batch: int = 0,
                    seed: int = 0) -> Callable:
    """The step over ``len(devices)`` slots, ``mp`` to a data group;
    ``devices[m]`` holds model shard m of the state. With ``n_virtual > 0``
    (requires ``global_batch``) the deterministic virtual-worker step is
    built instead of the default step — see the module docstring.
    ``seed`` keys the reference's per-virtual-worker RNG, which only dropout
    reads; the port's configs refuse dropout, so no step reads it yet."""
    devices = [torch.device(d) for d in devices]
    if len(devices) % mp:
        raise ValueError(f"{len(devices)} slots do not form groups of "
                         f"mp={mp}")
    p = len(devices) // mp
    groups = [devices[d * mp:(d + 1) * mp] for d in range(p)]
    homes = groups[0]
    dims = model_dims(port_layout(cfg, optimizer, p, mp))
    if n_virtual:
        if not global_batch:
            raise ValueError("the virtual-worker step needs global_batch")
        return _make_virtual_train_step(cfg, optimizer, groups, dims,
                                        n_virtual, global_batch)

    def train_step(state, batch: dict):
        shards = model_shards(state)
        params = [s["params"] for s in shards]
        outs = []
        for group, shard in zip(groups, shard_batch(
                batch, p, [g[0] for g in groups])):
            replicas = [prm if dev == home else
                        tree_map(lambda t, dev=dev: t.to(dev), prm)
                        for prm, dev, home in zip(params, group, homes)]
            outs.append(group_loss_and_grads(cfg, replicas, dims, group,
                                             shard))
        loss = sum(o[0].to(homes[0]) for o in outs) / p
        xent = sum(o[1]["xent"].to(homes[0]) for o in outs) / p
        aux = sum(o[1]["aux"].to(homes[0]) for o in outs) / p
        grads = []
        for m, home in enumerate(homes):
            sums = dict(tree_leaves(outs[0][2][m]))
            for o in outs[1:]:
                for k, g in tree_leaves(o[2][m]):
                    sums[k] = sums[k] + g.to(home)
            grads.append(tree_unflatten((k, g / p) for k, g in sums.items()))
        return _apply_update(optimizer, shards, grads, dims, loss, xent, aux)

    return train_step


def _make_virtual_train_step(cfg, optimizer: Optimizer, groups, dims,
                             n_virtual: int, global_batch: int) -> Callable:
    p, homes = len(groups), groups[0]
    home = homes[0]
    if n_virtual % p:
        raise ValueError(f"n_virtual={n_virtual} not divisible by data "
                         f"parallelism {p}")
    if global_batch % n_virtual:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"n_virtual={n_virtual}")
    local = n_virtual // p           # virtual workers per data group
    leads = [g[0] for g in groups]

    def train_step(state, batch: dict):
        shards = model_shards(state)
        # the whole params, assembled once on slot 0 (the tree itself at
        # mp = 1) and copied once to each other group's first slot
        whole = {home: ShardedParams([s["params"] for s in shards], dims,
                                     tuple(homes)).whole()}
        # one shard per virtual worker, in virtual order; data group d
        # hosts the contiguous block [d * local, (d + 1) * local)
        vw_devs = [leads[vw // local] for vw in range(n_virtual)]
        batches = shard_batch(batch, n_virtual, vw_devs)

        def per_vw():
            # one virtual worker at a time: its loss, parts and gradients,
            # flattened and moved to slot 0's device
            for dev, vb in zip(vw_devs, batches):
                if dev not in whole:
                    whole[dev] = tree_map(lambda t: t.to(dev), whole[home])
                loss, parts, grads = loss_and_grads(cfg, whole[dev], vb)
                flat = {k: g.to(home) for k, g in tree_leaves(grads)}
                flat.update({"/loss": loss.to(home),
                             "/xent": parts["xent"].to(home),
                             "/aux": parts["aux"].to(home)})
                yield flat

        total = vw_tree_reduce(per_vw(), _add_flat)
        loss, xent, aux = (total.pop(k) / n_virtual
                           for k in ("/loss", "/xent", "/aux"))
        grads = tree_unflatten((k, g / n_virtual) for k, g in total.items())
        return _apply_update(optimizer, shards,
                             split_tree(grads, dims, homes), dims, loss,
                             xent, aux)

    return train_step
