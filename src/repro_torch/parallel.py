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
  * ``regroup_columns(parts, n_groups, devices)`` — the all-to-all that
    turns a column split of grouped columns into a split of each group.
  * ``gather_from_model(parts, device)`` — the shards' column blocks
    concatenated in shard order onto ``device`` (the vocab-parallel
    logits of prefill and decode).

The first two take and give gradients in one autograd node, so a tensor
used on several devices never has its gradients accumulated in arrival
order (autograd runs one worker thread per device, and arrival order can
differ from run to run): the sums are the same bits on every rerun.

``COLLECTIVES`` counts the bytes each of these sends, and those that
``ShardedParams.whole`` gathers, forward and backward, by the index of the
slot in its group that sends them (``devices[m]`` is slot m; the tensor a
``copy_to_model`` copies out and the sums ``reduce_from_model`` and
``gather_from_model`` form lie on slot 0). The index, not the device,
names the sender: on one card the copies are views and nothing moves, and
the counter counts what would cross between cards, with one card a slot.
The dry-run reads it (``launch/dryrun.py``); ``kernels/launches.py:
LAUNCHES`` is its model. On ``meta`` tensors, where every slot is the one
device ``meta``, a collective under ``placing(fn)`` hands each slot a
copy of its own (free on ``meta``) and calls ``fn(copy, slot)``, so the
dry-run can tell the slots' tensors apart.

``ShardedParams`` is what a tensor-parallel forward reads: the parameter
tree of each model shard with the dim each leaf is split along over the
model axis (``None``: replicated, read from shard 0), from the layout. A
decode cache split over the model axis is one too (``models/cache.py:
init_cache_shards``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten


class ByteCounter:
    """Bytes sent by each slot of a group (its index), by collective;
    thread-safe, as autograd may run a backward on a thread of its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: dict[tuple[str, int], int] = {}

    def add(self, kind: str, slot: int, nbytes: int):
        with self._lock:
            self._n[kind, slot] = self._n.get((kind, slot), 0) + int(nbytes)

    def reset(self):
        with self._lock:
            self._n = {}

    def snapshot(self) -> dict[tuple[str, int], int]:
        """``{(collective, slot index): bytes}`` since the last reset."""
        with self._lock:
            return dict(self._n)


COLLECTIVES = ByteCounter()


_PLACE: list = []          # the innermost ``placing`` hook


@contextlib.contextmanager
def placing(fn):
    """Within, each collective's copy of a ``meta`` tensor for slot m is a
    tensor of its own, and ``fn(copy, m)`` is called on it."""
    _PLACE.append(fn)
    try:
        yield
    finally:
        _PLACE.pop()


def _move(x: torch.Tensor, device, slot: int) -> torch.Tensor:
    """``x`` on ``device``, slot ``slot``'s: a view where it lies there."""
    if x.is_meta and _PLACE:
        y = x.clone()
        _PLACE[-1](y, slot)
        return y
    return x.view_as(x) if torch.device(device) == x.device else x.to(device)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        for _ in devices[1:]:
            COLLECTIVES.add("copy_to_model", 0, x.nbytes)
        return tuple(_move(x, d, m) for m, d in enumerate(devices))

    @staticmethod
    def backward(ctx, *grads):
        acc = _move(grads[0], ctx.device, 0)
        for m, g in enumerate(grads[1:], 1):
            COLLECTIVES.add("copy_to_model", m, g.nbytes)
            acc = acc + _move(g, ctx.device, 0)
        return (acc,) + (None,) * len(grads)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, device, *partials):
        ctx.devices = [p.device for p in partials]
        acc = _move(partials[0], device, 0)
        for m, p in enumerate(partials[1:], 1):
            COLLECTIVES.add("reduce_from_model", m, p.nbytes)
            acc = acc + _move(p, device, 0)
        return acc

    @staticmethod
    def backward(ctx, g):
        for _ in ctx.devices[1:]:
            COLLECTIVES.add("reduce_from_model", 0, g.nbytes)
        return (None,) + tuple(_move(g, d, m)
                               for m, d in enumerate(ctx.devices))


class _Send(torch.autograd.Function):
    """``x`` from slot ``src`` to slot ``dst`` (on ``device``), counted
    both ways."""

    @staticmethod
    def forward(ctx, x, device, src: int, dst: int, kind: str):
        ctx.device, ctx.src, ctx.dst, ctx.kind = x.device, src, dst, kind
        COLLECTIVES.add(kind, src, x.nbytes)
        return _move(x, device, dst)

    @staticmethod
    def backward(ctx, g):
        COLLECTIVES.add(ctx.kind, ctx.dst, g.nbytes)
        return _move(g, ctx.device, ctx.src), None, None, None, None


def send(x: torch.Tensor, device, src: int, dst: int, kind: str
         ) -> torch.Tensor:
    """``x`` on ``device``, counted in ``COLLECTIVES`` as ``kind`` sent by
    slot ``src`` (and its gradient by ``dst``) unless the two are one."""
    if src == dst:
        return _move(x, device, dst)
    return _Send.apply(x, device, src, dst, kind)


def copy_to_model(x: torch.Tensor, devices) -> list[torch.Tensor]:
    """``x`` on each of ``devices``; gradients summed in device order."""
    return list(_CopyToModel.apply(x, *devices))


def reduce_from_model(partials, device) -> torch.Tensor:
    """``partials[0] + partials[1] + ...`` in that order, on ``device``."""
    return _ReduceFromModel.apply(torch.device(device), *partials)


def regroup_columns(parts, n_groups: int, devices) -> list[torch.Tensor]:
    """The all-to-all of a column-split product whose columns are
    ``n_groups`` equal groups (Mamba's ``in_proj``: x, then z). ``parts[s]``
    holds the contiguous columns ``[s W/mp, (s + 1) W/mp)`` of the whole
    (width W); shard m gets, on ``devices[m]``, the m-th of mp equal
    blocks of each group, concatenated group by group. Each block goes
    whole to one shard, so every gradient is a single term."""
    mp = len(parts)
    c = parts[0].shape[-1] // n_groups
    out = []
    for m, dev in enumerate(devices):
        blocks = []
        for j in range(n_groups):
            b = j * mp + m
            s = b // n_groups
            blocks.append(send(parts[s][..., (b % n_groups) * c:
                                        (b % n_groups + 1) * c], dev, s, m,
                               "regroup_columns"))
        out.append(torch.cat(blocks, dim=-1))
    return out


def gather_from_model(parts, device, dim: int = -1) -> torch.Tensor:
    """``parts`` (shard m's block on slot m) concatenated in shard order
    along ``dim`` on ``device``, slot 0's."""
    return torch.cat([send(p, device, m, 0, "gather_from_model")
                      for m, p in enumerate(parts)], dim=dim)


def whole_cache(cache: "ShardedParams | None"):
    """The one tree of a cache that a form running whole reads and writes
    in place: its first slot's, which must hold every leaf whole."""
    if cache is None:
        return None
    split = [path for path, d in tree_leaves(cache.dims) if d is not None]
    if split:
        raise ValueError(f"a form running whole got split cache leaves "
                         f"{split}")
    return cache.trees[0]


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

    def split(self, but=()) -> bool:
        """Whether every leaf of this subtree is split over the model axis
        (the subtree can run tensor-parallel), but those under the keys
        ``but``, which the rules replicate by design."""
        return all(d is not None for path, d in tree_leaves(self.dims)
                   if path.split("/")[0] not in but)

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
                leaves.append((path, torch.cat(
                    [send(t, lead, m, 0, "whole")
                     for m, (_, t) in enumerate(parts)], dim=d)))
        return tree_unflatten(leaves)
