"""Decode-state (KV / SSM) cache: spec construction, init and size, in the
stacked layout of the layer periods, and the dry-run's meta-device specs
and logical axes.

Counterpart of the reference's ``models/cache.py``, with its tree:

  {"layers": {"slot<j>": {<leaf>: [n_periods, ...]}},
   "pos": int32 0-d tensor}   # next write position (== tokens seen so far)

Every leaf takes ``cfg.param_dtype``, as in the reference: under a bf16
config the RWKV6 ``wkv`` state is rounded to bf16 between tokens. ``pos``
lies on the cache's device, so a decode step reads it without a host sync.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.blocks import block_cache_spec, scan_plan
from repro_torch.models.layers import dt
from repro_torch.models.params import ShardedInit, tree_leaves, tree_map


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
