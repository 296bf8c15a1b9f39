"""Decode-state (KV / SSM) cache: spec construction, init and size, in the
stacked layout of the layer periods, and the dry-run's meta-device specs
and logical axes.

Counterpart of the reference's ``models/cache.py``, with its tree:

  {"layers": {"slot<j>": {<leaf>: [n_periods, ...]}},
   "pos": int32 0-d tensor}   # next write position (== tokens seen so far)

Every leaf takes ``cfg.param_dtype``, as in the reference: under a bf16
config the RWKV6 ``wkv`` state is rounded to bf16 between tokens. ``pos``
lies on the cache's device, so a decode step reads it without a host sync.

Over the model axis (``init_cache_shards``) the cache is a
``parallel.ShardedParams`` of mp trees: a leaf that ``cache_dims`` splits
(GQA's ``k``/``v`` on ``kv_heads``, RWKV6's ``wkv`` on ``heads``, Mamba's
``conv``/``ssm`` on ``ssm_inner``) gives shard m its m-th part on slot m;
a replicated one (RWKV6's token shifts, MLA's ``ckv``/``krope``, a leaf
whose dim mp does not divide) and ``pos`` are held once, on the first
slot, and every shard's tree names that one tensor. The rule is
``sharding.spec_for`` on the logical axes, the rule that splits the
parameters, so a tensor-parallel form that runs whole (its heads not
divisible by mp) always finds its cache leaves whole.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.blocks import block_cache_spec, scan_plan
from repro_torch.models.layers import dt
from repro_torch.models.params import ShardedInit, tree_leaves, tree_map, \
    tree_unflatten
from repro_torch.parallel import ShardedParams
from repro_torch.sharding import spec_for


def _stack(spec: ShardedInit, n: int) -> ShardedInit:
    return ShardedInit((n,) + spec.shape, ("layers",) + spec.axes, spec.init)


def cache_spec_tree(cfg, batch: int, max_seq: int) -> dict:
    slots, n_periods = scan_plan(cfg)
    return {"layers": {
        f"slot{j}": tree_map(lambda s: _stack(s, n_periods),
                             block_cache_spec(cfg, mixer, batch, max_seq))
        for j, (mixer, _) in enumerate(slots)}}


def cache_specs(cfg, batch: int, max_seq: int) -> dict:
    """Meta-device stand-ins of the cache's leaves (no allocation)."""
    dtype = dt(cfg, "param")
    tree = tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"),
                    cache_spec_tree(cfg, batch, max_seq))
    tree["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return tree


def cache_logical_axes(cfg, batch: int, max_seq: int) -> dict:
    tree = tree_map(lambda s: s.axes, cache_spec_tree(cfg, batch, max_seq))
    tree["pos"] = ()
    return tree


def init_cache(cfg, batch: int, max_seq: int, pos: int = 0, *,
               device) -> dict:
    """A zero cache for ``batch`` sequences of up to ``max_seq`` tokens on
    ``device``, its next write position ``pos``."""
    dtype, device = dt(cfg, "param"), torch.device(device)
    tree = tree_map(lambda s: torch.zeros(s.shape, dtype=dtype,
                                          device=device),
                    cache_spec_tree(cfg, batch, max_seq))
    tree["pos"] = torch.tensor(pos, dtype=torch.int32, device=device)
    return tree


def cache_bytes(cfg, batch: int, max_seq: int) -> int:
    itemsize = torch.empty((), dtype=dt(cfg, "param")).element_size()
    return sum(math.prod(s.shape) * itemsize
               for _, s in tree_leaves(cache_spec_tree(cfg, batch, max_seq)))


def cache_dims(cfg, batch: int, max_seq: int, mp: int) -> dict:
    """The cache's tree of the dim each leaf splits along over the model
    axis of ``mp`` slots, ``None`` where it is replicated (every leaf at
    mp = 1; ``pos`` always): ``spec_for`` on its logical axes at
    ``{"data": 1, "model": mp}``, as ``parallel.model_dims`` reads the
    parameters' layout."""
    mesh = {"data": 1, "model": mp}

    def dim(s: ShardedInit):
        if mp == 1:
            return None
        spec = spec_for(s.axes, s.shape, mesh)
        return next((i for i, a in enumerate(spec) if a == "model"), None)
    tree = tree_map(dim, cache_spec_tree(cfg, batch, max_seq))
    tree["pos"] = None
    return tree


def init_cache_shards(cfg, batch: int, max_seq: int, devices,
                      pos: int = 0) -> ShardedParams:
    """A zero cache split over the model axis of ``devices`` (slot m's
    device ``devices[m]``): each split leaf's m-th part on slot m, each
    replicated leaf and ``pos`` once, on the first slot (see the module
    docstring). Each shard is allocated where it lives."""
    devices = tuple(torch.device(d) for d in devices)
    mp = len(devices)
    dims = cache_dims(cfg, batch, max_seq, mp)
    specs = dict(tree_leaves(cache_spec_tree(cfg, batch, max_seq)))
    dtype = dt(cfg, "param")
    first: dict = {}
    trees = []
    for m, dev in enumerate(devices):
        leaves = []
        for path, d in tree_leaves(dims):
            if d is None and m:
                leaves.append((path, first[path]))
                continue
            if path == "pos":
                t = torch.tensor(pos, dtype=torch.int32, device=dev)
            else:
                shape = list(specs[path].shape)
                if d is not None:
                    shape[d] //= mp
                t = torch.zeros(shape, dtype=dtype, device=dev)
            leaves.append((path, t))
        if not m:
            first = dict(leaves)
        trees.append(tree_unflatten(leaves))
    return ShardedParams(trees, dims, devices)
