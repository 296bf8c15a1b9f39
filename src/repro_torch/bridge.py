"""Move parameter and train-state trees between numpy and the port.

The JAX package's ``init_params`` and train-state trees, converted leaf by
leaf with ``np.asarray``, load into the port with the same paths, shapes and
dtypes; ``to_numpy`` goes back. A bfloat16 leaf (the 2-byte extension
dtype JAX hands numpy) is reinterpreted bit for bit; it goes back as
float32, since numpy itself has no bfloat16. ``shard_state_from_numpy``
lands a numpy train state on a trainer's model shards at any (dp, mp).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map
from repro_torch.reshape import shard_state, unflatten_tree
from repro_torch.training.step import join_shards


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)      # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, device) -> dict:
    """A numpy parameter tree as the port's tensor tree on ``device``."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def state_from_numpy(tree: dict, device) -> dict:
    """A numpy train-state tree (``params``, ``opt``, ``step``) as the port's
    tensor tree on ``device``; scalars stay 0-d tensors of their dtype."""
    return params_from_numpy(tree, device)


def shard_state_from_numpy(tree: dict, spec, devices):
    """A numpy train-state tree as the port's train state laid out by
    ``spec`` (a trainer's ``exec.layout``): the boxes of the first
    ``len(devices)`` slots (``reshape.shard_state``), slot m's on
    ``devices[m]`` — the one tree at mp = 1, the list of model shards
    above."""
    return join_shards([
        unflatten_tree({k: _leaf_from_numpy(a, dev)
                        for k, a in shards.items()})
        for shards, dev in zip(shard_state(spec, tree), devices)])


def to_numpy(tree: dict) -> dict:
    """The port's tensor tree as numpy, bfloat16 leaves as float32."""
    def one(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)
