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

The data axis's two, over the p slots that hold one model shard's boxes
(slot ``(d, m)`` for d = 0 .. p - 1), are plain copies and sums outside
autograd (the step calls them on detached parameters and on gradients):

  * ``all_gather_data(boxes, d, dim, device, slot)`` — a leaf's p data
    boxes concatenated in data order onto data group d's slot;
  * ``reduce_scatter_data(parts, d, dim, device, slot)`` — box d of the
    sum over the data groups, in group order, of their gradients.

The first two take and give gradients in one autograd node, so a tensor
used on several devices never has its gradients accumulated in arrival
order (autograd runs one worker thread per device, and arrival order can
differ from run to run): the sums are the same bits on every rerun.

``COLLECTIVES`` counts the bytes each of these sends, and those that
``ShardedParams.whole`` gathers, forward and backward, by the index of the
slot in its group that sends them (the data axis's two under
``all_gather_data`` and ``reduce_scatter_data``: slot (g, m) sends as
index m) (``devices[m]`` is slot m; the tensor a
``copy_to_model`` copies out and the sums ``reduce_from_model`` and
``gather_from_model`` form lie on slot 0). The index, not the device,
names the sender: on one card the copies are views and nothing moves, and
the counter counts what would cross between cards, with one card a slot.
The dry-run reads it (``launch/dryrun.py``); ``kernels/launches.py:
LAUNCHES`` is its model. On ``meta`` tensors, where every slot is the one
device ``meta``, a collective under ``placing(fn)`` hands each slot a
copy of its own (free on ``meta``) and calls ``fn(copy, slot)``, so the
dry-run can tell the slots' tensors apart.

The default train step holds its params as the reference's scan does,
one period of layers gathered at a time (``FsdpGroup``, ``GradBoxes``):

  * ``gather_box(boxes, d, dim, device, slot, row)`` — row ``row`` of a
    stacked ``[n_periods, ...]`` leaf's boxes (the whole boxes where it is
    None) joined by ``all_gather_data``;
  * ``FsdpGroup`` — data group d's view of every slot's boxes: the leaves
    outside ``layers`` gathered once (``params()``), period i's layer
    leaves gathered when the period's forward reads them
    (``params()["layers"].periods()[i]``), each through an autograd node
    whose backward hands the period's gradient to a ``GradBoxes`` and lets
    it go; ``saving()`` keeps a gathered layer leaf that the forward saves
    for the backward as its name, and gathers it again there;
  * ``GradBoxes`` — each slot's boxes of the gradients, summed over the
    groups in group order as the backwards hand them in, the slices for
    other slots counted as ``reduce_scatter_data``'s.

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
import weakref

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

LAYERS = "layers/"          # the stacked ``[n_periods, ...]`` leaves' prefix


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


def all_gather_data(boxes, d: int, dim: int, device, slot: int
                    ) -> torch.Tensor:
    """One leaf of model shard ``slot`` whole over the data axis, on
    ``device``, data group ``d``'s slot: ``boxes[g]``, slot (g, slot)'s
    box, concatenated in g order along ``dim``. The boxes of the other
    groups are counted as sent."""
    parts = []
    for g, box in enumerate(boxes):
        if g != d:
            COLLECTIVES.add("all_gather_data", slot, box.nbytes)
        if g != d or box.device != torch.device(device):
            box = _move(box, device, slot)
        parts.append(box)
    return torch.cat(parts, dim=dim)


def reduce_scatter_data(parts, d: int, dim: int | None, device, slot: int
                        ) -> torch.Tensor:
    """Box ``d`` of a leaf's gradient summed over the data axis, on
    ``device``: ``parts[g]`` is data group g's gradient of model shard
    ``slot``'s leaf, and each gives its d-th of p equal slices along
    ``dim`` (its whole where ``dim`` is None), summed in g order. The
    slices of the other groups are counted as sent."""
    p = len(parts)
    acc = None
    for g, x in enumerate(parts):
        if dim is not None:
            size = x.shape[dim] // p
            x = x.narrow(dim, d * size, size)
        if g != d:
            COLLECTIVES.add("reduce_scatter_data", slot, x.nbytes)
        if g != d or x.device != torch.device(device):
            x = _move(x, device, slot)
        acc = x if acc is None else acc + x
    return acc


def gather_box(boxes, d: int, dim: int | None, device, slot: int,
               row: int | None = None) -> torch.Tensor:
    """Row ``row`` of a stacked leaf's data boxes (``boxes[g]``, slot (g,
    slot)'s; the whole boxes where ``row`` is None) whole over the data
    axis on ``device``, data group ``d``'s slot: ``all_gather_data`` along
    ``dim``, the boxes' data dim. A leaf with no data split (``dim`` None)
    is group d's own box, a view."""
    if row is not None:
        boxes = [b[row] for b in boxes]
        dim = None if dim is None else dim - 1
    if dim is None:
        return boxes[d].view_as(boxes[d])
    return all_gather_data(boxes, d, dim, device, slot)


class GradBoxes:
    """Each slot's boxes of one step's gradients summed over the data
    axis, filled as the data groups' backwards hand them in: slot (e, m)'s
    box of a leaf, or row i of it, is the left fold in group order of
    the groups' e-th slices along the leaf's data dim (their wholes where
    it has none) — group 0's assigned, each later group's added, so the
    bits are ``reduce_scatter_data``'s (a sum begun at zero would turn
    -0.0 into 0.0). The groups run in order 0 .. p - 1. ``like`` holds
    every slot's params tree (the boxes' shapes, dtypes and devices). Kept
    are the slots in ``keep`` (all by default); the slices for the others
    are counted as sent and dropped (the dry-run walks group 0 alone)."""

    def __init__(self, layout, like: list[dict], keep=None):
        self.p, self.mp = layout.dp, layout.mp
        self.dims = dict(tree_leaves(data_dims(layout)))
        keep = range(len(like)) if keep is None else keep
        self.like = {s: dict(tree_leaves(like[s])) for s in keep}
        self.acc: dict[int, dict] = {s: {} for s in keep}

    def add(self, d: int, m: int, path: str, row: int | None,
            g: torch.Tensor):
        """Data group ``d``'s gradient ``g`` of model shard ``m``'s leaf
        ``path`` (of its row ``row``), whole over the data axis on slot
        (d, m), into every slot (e, m)'s box."""
        dim = self.dims[path]
        if dim is not None and row is not None:
            dim -= 1
        for e in range(self.p):
            x = g
            if dim is not None:
                size = g.shape[dim] // self.p
                x = g.narrow(dim, e * size, size)
            if e != d:
                COLLECTIVES.add("reduce_scatter_data", m, x.nbytes)
            s = e * self.mp + m
            box = self.acc.get(s)
            if box is None:
                continue
            if path not in box:
                box[path] = torch.empty_like(self.like[s][path])
            dst = box[path] if row is None else box[path][row]
            if e != d or x.device != dst.device:
                x = _move(x, dst.device, m)
            if d == 0:
                dst.copy_(x)
            else:
                dst.add_(x)

    def boxes(self) -> list[dict]:
        """The kept slots' gradient trees, in slot order, each box divided
        by p in place."""
        return [tree_unflatten((k, t.div_(self.p))
                               for k, t in sorted(self.acc[s].items()))
                for s in sorted(self.acc)]


class _Gathered(torch.autograd.Function):
    """A leaf of an ``FsdpGroup`` gathered in the forward; the backward
    hands its gradient to the group's ``GradBoxes``. It holds no tensor:
    ``anchor`` only links it to the graph."""

    @staticmethod
    def forward(ctx, anchor, src: "FsdpGroup", key: tuple):
        ctx.src, ctx.key = src, key
        return src.gather(*key)

    @staticmethod
    def backward(ctx, g):
        ctx.src.scatter(ctx.key, g)
        return None, None, None


class FsdpGroup:
    """Data group ``d``'s params as the default step reads them, the
    reference's scan over periods under FSDP: ``params`` holds one tree per
    slot of ``layout``, model shard m of the group lies on ``group[m]``,
    and a leaf of model shard m is gathered from slots (0, m) .. (p - 1,
    m) (``gather_box``; a leaf with no data split is slot (d, m)'s own).
    ``params()`` gathers the leaves outside ``layers`` once, and its
    ``["layers"].periods()[i]`` (this group's item i) period i's layer
    leaves when it is read, so only the period that runs is held. With
    ``grads`` (a ``GradBoxes``)
    and autograd recording, each leaf that takes a gradient — every leaf
    of shard 0 and the model-split ones of the others, as
    ``training/step.py: group_loss_and_grads`` takes them — is gathered
    through a node whose backward hands the gradient to ``grads`` and lets
    it go; a replicated leaf's gradient is sent from shard 0 to the
    others' boxes (``replicated_grads``). ``finish()`` hands in zeros for
    the leaves the backward did not reach, as the whole form's
    ``torch.zeros_like``."""

    def __init__(self, layout, params: list[dict], d: int, group,
                 grads: GradBoxes | None = None):
        self.p, self.mp, self.d = layout.dp, layout.mp, d
        self.devices = tuple(group)
        self.ddims = dict(tree_leaves(data_dims(layout)))
        self.mdims = model_dims(layout)
        self._split = dict(tree_leaves(self.mdims))
        flat = [dict(tree_leaves(t)) for t in params]
        self.boxes = [{k: [flat[g * self.mp + m][k] for g in range(self.p)]
                       for k in flat[d * self.mp + m]}
                      for m in range(self.mp)]
        self.n_periods = next(b[0].shape[0] for k, b in self.boxes[0].items()
                              if k.startswith(LAYERS))
        self.grads = grads
        self.anchor = None if grads is None else torch.zeros(
            (), device=self.devices[0], requires_grad=True)
        self._done: set = set()
        self._made: dict = {}       # storage: (weakref, key) of a gathered row

    def gather(self, m: int, path: str, row: int | None) -> torch.Tensor:
        """Model shard ``m``'s leaf ``path`` (its row ``row``) whole over
        the data axis, outside autograd."""
        t = gather_box(self.boxes[m][path], self.d, self.ddims[path],
                       self.devices[m], m, row)
        if row is not None and self.ddims[path] is not None:
            key = t.untyped_storage()._cdata

            def drop(ref, key=key):
                if self._made.get(key, (None,))[0] is ref:
                    del self._made[key]
            self._made[key] = (weakref.ref(t, drop), (m, path, row))
        return t

    def _takes_grad(self, m: int, path: str) -> bool:
        return m == 0 or self._split[path] is not None

    def leaf(self, m: int, path: str, row: int | None) -> torch.Tensor:
        if (self.grads is None or not torch.is_grad_enabled()
                or not self._takes_grad(m, path)):
            return self.gather(m, path, row)
        return _Gathered.apply(self.anchor, self, (m, path, row))

    def scatter(self, key: tuple, g: torch.Tensor):
        """The gradient ``g`` of the leaf ``key`` into ``grads``."""
        m, path, row = key
        self._done.add(key)
        self.grads.add(self.d, m, path, row, g)
        if m == 0 and self._split[path] is None:
            for m2 in range(1, self.mp):
                self.grads.add(self.d, m2, path, row, send(
                    g, self.devices[m2], 0, m2, "replicated_grads"))

    def finish(self):
        """Zeros into ``grads`` for each leaf that takes a gradient and got
        none in the backward."""
        for m, leaves in enumerate(self.boxes):
            for path, boxes in leaves.items():
                if not self._takes_grad(m, path):
                    continue
                rows = range(self.n_periods) if path.startswith(LAYERS) \
                    else (None,)
                for row in rows:
                    if (m, path, row) in self._done:
                        continue
                    box = boxes[self.d] if row is None else boxes[self.d][row]
                    shape = list(box.shape)
                    dim = self.ddims[path]
                    if dim is not None:
                        shape[dim - (row is not None)] *= self.p
                    self.scatter((m, path, row), torch.zeros(
                        shape, dtype=box.dtype, device=self.devices[m]))

    def __len__(self) -> int:
        return self.n_periods

    def __getitem__(self, i: int) -> "ShardedParams":
        """Period ``i``'s layer params, gathered now."""
        trees = [tree_unflatten((k[len(LAYERS):], self.leaf(m, k, i))
                                for k in leaves if k.startswith(LAYERS))
                 for m, leaves in enumerate(self.boxes)]
        dims = tree_map(lambda d: None if d is None else d - 1,
                        self.mdims["layers"])
        return ShardedParams(trees, dims, self.devices)

    def periods(self) -> "FsdpGroup":
        """The layers' periods: item i gathers period i when read."""
        return self

    def params(self) -> "FsdpParams":
        """The group's params: the leaves outside ``layers`` gathered now,
        ``layers`` by period on use."""
        trees = [tree_unflatten((k, self.leaf(m, k, None))
                                for k in leaves if not k.startswith(LAYERS))
                 for m, leaves in enumerate(self.boxes)]
        return FsdpParams(trees, self.mdims, self.devices, layers=self)

    @contextlib.contextmanager
    def saving(self):
        """Within, a gathered layer row (or a view of it) that autograd
        saves for the backward is kept as its key and gathered again when
        the backward reads it, so no period's gathered weights are held
        from the forward to the backward (under remat the checkpoint's own
        hooks take its place: the recomputation gathers again)."""
        again: dict = {}

        def pack(t):
            entry = self._made.get(t.untyped_storage()._cdata)
            base = None if entry is None else entry[0]()
            if base is None or base.dtype != t.dtype:
                return t
            return entry[1], tuple(t.shape), t.stride(), t.storage_offset()

        def unpack(x):
            if isinstance(x, torch.Tensor):
                return x
            key, shape, stride, offset = x
            ref = again.get(key)
            base = None if ref is None else ref()
            if base is None:
                base = self.gather(*key)
                again[key] = weakref.ref(base)
            return base.as_strided(shape, stride, offset)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            yield


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


def axis_dims(layout, axis: str, prefix: str = "params/") -> dict:
    """The tree of the dim each leaf under ``prefix`` is split along over
    ``axis`` (``"model"`` or ``"data"``) in ``layout`` (a ``StateSpec``),
    ``None`` where it is replicated — or where the split is one way."""
    ways = layout.mp if axis == "model" else layout.dp
    return tree_unflatten(
        (t.path[len(prefix):],
         next((i for i, a in enumerate(t.axes) if a == axis), None)
         if ways > 1 else None)
        for t in layout.tensors if t.path.startswith(prefix))


def model_dims(layout, prefix: str = "params/") -> dict:
    """``axis_dims`` over the model axis."""
    return axis_dims(layout, "model", prefix)


def data_dims(layout, prefix: str = "params/") -> dict:
    """``axis_dims`` over the data axis."""
    return axis_dims(layout, "data", prefix)


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


@dataclasses.dataclass
class FsdpParams(ShardedParams):
    """``ShardedParams`` of the leaves outside ``layers``, whose
    ``["layers"]`` is the ``FsdpGroup`` that gathers a period on use."""
    layers: FsdpGroup | None = None

    def __getitem__(self, key: str):
        if key == "layers":
            return self.layers
        return super().__getitem__(key)
