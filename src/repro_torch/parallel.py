"""Tensor parallelism over the model axis, in one process.

The reference runs its model axis under GSPMD, which inserts the
collectives; this module is the port's counterpart of them. A data group
is ``mp`` slots, one per model shard; ``devices[m]`` is model shard m's
device, and ``devices[0]`` (the group's first slot) carries the residual
stream. There is no NCCL here: on one card every slot is the same device
and a "collective" is a sum taken in a fixed order; across cards it is
``.to(device)`` copies.

  * ``copy_to_model(x, devices)`` — the identity forward onto every model
    slot's device; its backward sums the slots' gradients in slot order.
  * ``reduce_from_model(partials, device)`` — the partial results of the
    model slots summed in slot order onto ``device``; its backward hands
    each partial the gradient of the sum (the identity).

Both take and give gradients in one autograd node, so a tensor used on
several devices never has its gradients accumulated in arrival order
(autograd runs one worker thread per device, and arrival order can differ
from run to run): the sums are the same bits on every rerun.

``ShardedParams`` is what a tensor-parallel forward reads: the parameter
tree of each model shard with the dim each leaf is split along over the
model axis (``None``: replicated, read from shard 0), from the layout.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        return tuple(x.view_as(x) if torch.device(d) == x.device
                     else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[0].to(ctx.device)
        for g in grads[1:]:
            acc = acc + g.to(ctx.device)
        return (acc,) + (None,) * len(grads)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *partials):
        ctx.devices = [p.device for p in partials]
        acc = partials[0].to(device)
        for p in partials[1:]:
            acc = acc + p.to(device)
        return acc

    @staticmethod
    def backward(ctx, g):
        return (None,) + tuple(g.to(d) for d in ctx.devices)


def copy_to_model(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` on each of ``devices``; gradients summed in device order."""
    return list(_CopyToModel.apply(x, *devices))


def reduce_from_model(partials, device) -> torch.Tensor:
    """``partials[0] + partials[1] + ...`` in that order, on ``device``."""
    return _ReduceFromModel.apply(torch.device(device), *partials)


def model_dims(layout, prefix: str = "params/") -> dict:
    """The tree of the dim each leaf under ``prefix`` is split along over
    the model axis in ``layout`` (a ``StateSpec``), ``None`` where it is
    replicated — or where the split is one way (mp = 1)."""
    return tree_unflatten(
        (t.path[len(prefix):],
         next((i for i, a in enumerate(t.axes) if a == "model"), None)
         if layout.mp > 1 else None)
        for t in layout.tensors if t.path.startswith(prefix))


@dataclasses.dataclass
class ShardedParams:
    """The model shards' parameter trees of one data group: ``trees[m]``
    on ``devices[m]``, and ``dims``, the same tree of the dim each leaf is
    split along over the model axis (``None``: replicated; read from
    ``trees[0]``, the copy on the group's first slot)."""
    trees: list[dict]
    dims: dict
    devices: tuple

    @classmethod
    def one(cls, tree: dict) -> "ShardedParams":
        """``tree`` as the one model shard of mp = 1: every leaf whole."""
        return cls([tree], tree_map(lambda _: None, tree),
                   (tree_leaves(tree)[0][1].device,))

    @property
    def mp(self) -> int:
        return len(self.trees)

    def __getitem__(self, key: str) -> "ShardedParams":
        return ShardedParams([t[key] for t in self.trees], self.dims[key],
                             self.devices)

    def periods(self) -> list["ShardedParams"]:
        """One ``ShardedParams`` per period of a subtree of stacked
        ``[n_periods, ...]`` leaves (one unbind per leaf, as the model's
        forward takes them)."""
        unbound = [tree_map(lambda a: a.unbind(0), t) for t in self.trees]
        dims = tree_map(lambda d: None if d is None else d - 1, self.dims)
        n = len(tree_leaves(unbound[0])[0][1])
        return [ShardedParams([tree_map(lambda u, i=i: u[i], t)
                               for t in unbound], dims, self.devices)
                for i in range(n)]

    def split(self) -> bool:
        """Whether every leaf of this subtree is split over the model axis
        (the subtree can run tensor-parallel)."""
        return all(d is not None for _, d in tree_leaves(self.dims))

    def whole(self) -> dict:
        """The subtree's whole tensors on the group's first slot: split
        leaves concatenated in shard order along their dim, replicated
        leaves from shard 0. Differentiable: each shard gets its part's
        gradient."""
        lead = self.devices[0]
        leaves = []
        for (path, d), *parts in zip(tree_leaves(self.dims),
                                     *(tree_leaves(t) for t in self.trees)):
            if d is None:
                leaves.append((path, parts[0][1]))
            else:
                leaves.append((path, torch.cat([t.to(lead) for _, t in parts],
                                               dim=d)))
        return tree_unflatten(leaves)


def require_model_parallel(cfg, mp: int):
    """Raise ``NotImplementedError`` for a model-parallel degree the port
    cannot run ``cfg`` at: the RWKV6 mixers have no tensor-parallel form
    yet (WKV6 at H/mp heads, ``ssm_inner`` column shards)."""
    if mp > 1 and cfg.family == "ssm":
        raise NotImplementedError(
            f"model_parallel={mp} for {cfg.name} (the RWKV6 mixers) is not "
            f"yet ported")
