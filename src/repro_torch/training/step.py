"""Train state and the two train steps.

TrainState = {"params": tree, "opt": {"count", "mu"[, "nu"]}, "step": i32},
the reference's tree. A trainer's state is a list of p * mp such trees,
one per slot, laid out by ``port_layout``: the reference's ``StateSpec``,
data axis included. Slot ``d * mp + m`` holds its box of every tensor, in
``reshape.shard_state``'s order, on the step's ``devices[d * mp + m]``: a
weight and both its AdamW moments split 1/p over the data axis (FSDP,
ZeRO-3 style) and 1/mp over the model axis where the rules say so, and a
leaf the rules replicate (the scalars among them) whole on every slot.
``reshape.gather_state`` gives the whole tree.

Slot ``d * mp + m`` of the step's devices holds data shard d and model
shard m; slots ``d * mp .. d * mp + mp - 1`` are data group d.

  * ``make_train_step(cfg, opt, devices, mp=M)`` — the default step: the
    global batch splits into p = len(devices) / mp equal shards, one per
    data group; group d gathers its model shards' params whole over the
    data axis (``gather_group``: boxes (0, m) .. (p - 1, m) in that order
    onto slot (d, m)), runs forward and backward on its slots' devices,
    tensor-parallel over its mp slots (``models.model.loss_fn_tp``), and
    lets the gathered params go; box (d, m) of each gradient is then the
    sum over the groups, in group order, of their d-th slices, on slot (d,
    m), divided by p (``scatter_group``; a leaf that every data slot holds
    whole is summed in the same order on each, so the copies stay the same
    bits), and the optimizer update runs slot by slot on its boxes.
    Because the global batch is constant, the step computes the same math
    at every (p, mp), up to fp32 summation order (the shard shapes follow
    p and mp). For an MoE config at p > 1 that holds because a routing
    pre-pass (``models/model.py: route_globally``, a forward of the groups
    in lockstep without autograd) first gives each group its share of
    every MoE layer's routing over the global batch, as the reference's one
    program routes it: the queue positions and the aux loss's choice-0
    fractions of all tokens. At the step's end a flag, read once, checks
    that each gradded pass routed the claims the pre-pass planned.
  * ``make_train_step(cfg, opt, devices, mp=M, n_virtual=K,
    global_batch=...)`` — the DETERMINISTIC virtual-worker step: the
    global batch splits into K fixed slices; data group d runs virtual
    workers ``[d K/p, (d+1) K/p)`` one after another on its first slot,
    against the whole params assembled on slot 0 once from every slot's
    boxes (never tensor-parallel: its reductions would follow mp), each at
    the same ``(global_batch / K, seq)`` shape at every (p, mp); the K
    losses and gradient trees are summed on slot 0's device in a fixed
    balanced binary tree over the virtual axis (``vw_tree_reduce``, the
    reference's ``_vw_tree_reduce`` pairing) — a function of K alone — and
    the summed gradients are split into the p * mp slots' boxes for the
    elementwise update. So every (p, mp) gives bitwise-identical updates.
    Virtual worker vw's dropout is keyed ``fold_in(fold_in(key(seed), vw),
    step)`` with the reference's threefry bits (``prng``), the state's
    step before the update, so its masks follow the worker and not the
    slot that hosts it. MoE routes each worker's batch apart, as the
    reference does.
"""
from __future__ import annotations

import operator
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import Optimizer
from repro_torch.parallel import ShardedParams, all_gather_data, \
    data_dims, model_dims, reduce_scatter_data, send
from repro_torch.reshape.apply import place_state
from repro_torch.reshape.spec import StateSpec, TensorLayout


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


def loss_and_grads(cfg, params: dict, batch: dict, rng=None):
    """(loss, parts, grads) of ``loss_fn`` at ``params``: the one shard of
    mp = 1; ``rng`` keys dropout."""
    sp = ShardedParams.one(params)
    loss, parts, (grads,) = group_loss_and_grads(cfg, sp.trees, sp.dims,
                                                 sp.devices, batch, rng=rng)
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
    """The layout of the train state at ``(p, mp)``: the reference's
    ``StateSpec.for_config``, data axis included."""
    return StateSpec.for_config(cfg, optimizer, p, mp)


def params_layout(layout: StateSpec) -> StateSpec:
    """The params' part of a train state's layout, the paths under
    ``params/`` (a gradient tree's layout)."""
    return StateSpec(layout.dp, layout.mp, tuple(
        TensorLayout(t.path[len("params/"):], t.shape, t.axes)
        for t in layout.tensors if t.path.startswith("params/")))


def gather_group(layout: StateSpec, params: list[dict], d: int, group
                 ) -> list[dict]:
    """Data group ``d``'s model shards of the params whole over the data
    axis: ``params`` holds one tree per slot of ``layout``, and model
    shard m, on ``group[m]``, joins the boxes of slots (0, m) .. (p - 1, m)
    (``all_gather_data``); a leaf without a data split is slot (d, m)'s
    own. A copy where p > 1."""
    mp = layout.mp
    dims = dict(tree_leaves(data_dims(layout)))
    out = []
    for m, dev in enumerate(group):
        own = params[d * mp + m]
        if layout.dp == 1:
            out.append(own)
            continue
        boxes = [dict(tree_leaves(params[g * mp + m]))
                 for g in range(layout.dp)]
        out.append(tree_unflatten(
            (k, t if dims[k] is None else all_gather_data(
                [b[k] for b in boxes], d, dims[k], dev, m))
            for k, t in tree_leaves(own)))
    return out


def scatter_group(layout: StateSpec, grads: list[list[dict]], d: int,
                  group) -> list[dict]:
    """Data group ``d``'s boxes of the gradients summed over the data
    axis, not yet divided by p: ``grads[g][m]`` is data group g's gradient
    tree of model shard m, and box (d, m), on ``group[m]``, sums the d-th
    slices of ``grads[0][m]`` .. ``grads[p - 1][m]`` in that order
    (``reduce_scatter_data``)."""
    dims = dict(tree_leaves(data_dims(layout)))
    out = []
    for m, dev in enumerate(group):
        parts = [dict(tree_leaves(g[m])) for g in grads]
        out.append(tree_unflatten(
            (k, reduce_scatter_data([x[k] for x in parts], d, dims[k], dev,
                                    m))
            for k in parts[0]))
    return out


def whole_params(layout: StateSpec, params: list[dict], device) -> dict:
    """The whole params on ``device``, assembled from every slot's boxes
    (``params``: one tree per slot of ``layout``)."""
    mp = layout.mp
    shards = gather_group(layout, params, 0, [device] * mp)
    return ShardedParams(shards, model_dims(layout),
                         (torch.device(device),) * mp).whole()


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
                         batch: dict, *, rng=None, routing=None):
    """(loss, parts, grads per model shard) of one data group, its batch on
    ``devices[0]``. A replicated leaf is read from shard 0 and every shard
    gets its gradient, on its device. ``rng`` keys dropout; ``routing`` is
    the group's plan from ``route_globally``."""
    d = dict(tree_leaves(dims))
    live = [[(k, p.detach().requires_grad_(m == 0 or d[k] is not None))
             for k, p in tree_leaves(t)] for m, t in enumerate(trees)]
    sp = ShardedParams([tree_unflatten(leaves) for leaves in live], dims,
                       tuple(devices))
    loss, parts = M.loss_fn_tp(cfg, sp, batch, rng=rng, routing=routing)
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


def apply_update(optimizer: Optimizer, state: list[dict],
                 grads: list[dict], layout: StateSpec, loss, xent, aux,
                 slots=None):
    """The optimizer update of each slot of ``state`` from its boxes of
    the reduced gradients, and the step's metrics. ``slots`` are the
    slots' indices in ``layout`` (every slot by default). grad_norm counts
    each element once, a box that several slots hold from the first; it
    is diagnostic only, outside the virtual step's bitwise contract, as in
    the reference."""
    new = []
    for s, g in zip(state, grads):
        new_params, new_opt = optimizer.update(g, s["opt"], s["params"])
        new.append({"params": new_params, "opt": new_opt,
                    "step": s["step"] + 1})
    home = loss.device
    tensors = {t.path: t for t in params_layout(layout).tensors}
    seen, total = set(), torch.zeros((), device=home)
    for i, g in zip(slots if slots is not None else range(len(grads)),
                    grads):
        for k, t in tree_leaves(g):
            box = (k, tensors[k].box(layout.dp, layout.mp, i))
            if box not in seen:
                seen.add(box)
                total = total + t.float().square().sum().to(home)
    metrics = {"loss": loss, "xent": xent, "aux": aux,
               "grad_norm": torch.sqrt(total)}
    return new, metrics


def _add_flat(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def make_train_step(cfg, optimizer: Optimizer, devices, *, mp: int = 1,
                    n_virtual: int = 0, global_batch: int = 0,
                    seed: int = 0) -> Callable:
    """The step over ``len(devices)`` slots, ``mp`` to a data group;
    ``devices[i]`` holds slot i's tree of the state. With ``n_virtual > 0``
    (requires ``global_batch``) the deterministic virtual-worker step is
    built instead of the default step — see the module docstring.
    ``seed`` keys the virtual workers' dropout, as in the reference; the
    default step drops nothing, as the reference's does not."""
    devices = [torch.device(d) for d in devices]
    if len(devices) % mp:
        raise ValueError(f"{len(devices)} slots do not form groups of "
                         f"mp={mp}")
    p = len(devices) // mp
    groups = [devices[d * mp:(d + 1) * mp] for d in range(p)]
    layout = port_layout(cfg, optimizer, p, mp)
    dims = model_dims(layout)
    if n_virtual:
        if not global_batch:
            raise ValueError("the virtual-worker step needs global_batch")
        return _make_virtual_train_step(cfg, optimizer, groups, layout,
                                        n_virtual, global_batch, seed)
    home = devices[0]

    def train_step(state, batch: dict):
        params = [s["params"] for s in state]
        shards = shard_batch(batch, p, [g[0] for g in groups])
        plans = routing_prepass(cfg, layout, params, groups, shards)
        outs = []
        for d, (group, shard) in enumerate(zip(groups, shards)):
            # the gathered params go when the group's backward is done
            outs.append(group_loss_and_grads(
                cfg, gather_group(layout, params, d, group), dims, group,
                shard, routing=plans[d]))
        loss = sum(o[0].to(home) for o in outs) / p
        xent = sum(o[1]["xent"].to(home) for o in outs) / p
        aux = sum(o[1]["aux"].to(home) for o in outs) / p
        grads = [o[2] for o in outs]
        boxes = [tree_map(lambda g: g / p, box)
                 for d, group in enumerate(groups)
                 for box in scatter_group(layout, grads, d, group)]
        del outs, grads
        check_routing(plans)
        return apply_update(optimizer, state, boxes, layout, loss, xent,
                            aux)

    return train_step


def routing_prepass(cfg, layout: StateSpec, params: list[dict], groups,
                    shards: list[dict]) -> list[dict]:
    """Each data group's plan of its MoE layers' routing over the global
    batch (``models/model.py: route_globally``), for an MoE config at
    p > 1; empty plans otherwise, where a group's own routing is the
    reference's. The groups' params are gathered as the step gathers them,
    once for groups on the same devices (all of them on one card), and go
    when the plans are made."""
    p = len(groups)
    if not cfg.moe or p == 1:
        return [{}] * p
    dims = model_dims(layout)
    gathered: dict = {}
    sps = []
    for d, group in enumerate(groups):
        on = tuple(group)
        if on not in gathered:
            gathered[on] = ShardedParams(gather_group(layout, params, d,
                                                      group), dims, on)
        sps.append(gathered[on])
    return M.route_globally(cfg, sps, shards, p)


def check_routing(plans: list[dict]):
    """Raise where an MoE layer routed other claims than its plan, in the
    pre-pass or a gradded pass since (the shares' device flags, read in
    one host sync a step; none where there is no plan)."""
    flags = [f for plan in plans for sh in plan.values()
             for f in sh.mismatches]
    if flags and bool(torch.stack([f.to(flags[0].device)
                                   for f in flags]).any()):
        raise RuntimeError("an MoE layer's gradded pass routed other claims "
                           "than the routing pre-pass planned for it")


def _make_virtual_train_step(cfg, optimizer: Optimizer, groups,
                             layout: StateSpec, n_virtual: int,
                             global_batch: int, seed: int) -> Callable:
    p = len(groups)
    home = groups[0][0]
    devices = [dev for g in groups for dev in g]
    if n_virtual % p:
        raise ValueError(f"n_virtual={n_virtual} not divisible by data "
                         f"parallelism {p}")
    if global_batch % n_virtual:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"n_virtual={n_virtual}")
    local = n_virtual // p           # virtual workers per data group
    leads = [g[0] for g in groups]
    grads_layout = params_layout(layout)

    def train_step(state, batch: dict):
        # the whole params, assembled once on slot 0 from every slot's
        # boxes and copied once to each other group's first slot
        whole = {home: whole_params(layout, [s["params"] for s in state],
                                    home)}
        # one shard per virtual worker, in virtual order; data group d
        # hosts the contiguous block [d * local, (d + 1) * local)
        vw_devs = [leads[vw // local] for vw in range(n_virtual)]
        batches = shard_batch(batch, n_virtual, vw_devs)
        # the reference's per-(virtual worker, step) keys, from the state's
        # step before the update, on the device (no host sync)
        root = prng.key(seed, home) if cfg.dropout > 0.0 else None

        def per_vw():
            # one virtual worker at a time: its loss, parts and gradients,
            # flattened and moved to slot 0's device
            for vw, (dev, vb) in enumerate(zip(vw_devs, batches)):
                if dev not in whole:
                    whole[dev] = tree_map(lambda t: t.to(dev), whole[home])
                rng = None if root is None else prng.fold_in(
                    prng.fold_in(root, vw), state[0]["step"].to(home))
                loss, parts, grads = loss_and_grads(cfg, whole[dev], vb, rng)
                flat = {k: g.to(home) for k, g in tree_leaves(grads)}
                flat.update({"/loss": loss.to(home),
                             "/xent": parts["xent"].to(home),
                             "/aux": parts["aux"].to(home)})
                yield flat

        total = vw_tree_reduce(per_vw(), _add_flat)
        whole.clear()
        loss, xent, aux = (total.pop(k) / n_virtual
                           for k in ("/loss", "/xent", "/aux"))
        grads = tree_unflatten((k, g / n_virtual) for k, g in total.items())
        del total
        return apply_update(optimizer, state,
                            place_state(grads_layout, grads, devices),
                            layout, loss, xent, aux)

    return train_step
