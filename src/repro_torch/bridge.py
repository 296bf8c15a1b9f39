"""Move parameter, train-state and decode-cache trees between numpy and the
port.

The JAX package's ``init_params``, train-state and ``init_cache`` trees,
converted leaf by leaf with ``np.asarray``, load into the port with the
same paths, shapes and dtypes; ``to_numpy`` goes back. A bfloat16 leaf (the 2-byte extension
dtype JAX hands numpy) is reinterpreted bit for bit; it goes back as
float32, since numpy itself has no bfloat16. ``shard_state_from_numpy``
lands a numpy train state on a trainer's slots at any (dp, mp).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map
from repro_torch.reshape import shard_state, unflatten_tree


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)      # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, device) -> dict:
    """A numpy tree as the port's tensor tree on ``device``: parameters, or
    a whole train state (``params``, ``opt``, ``step``), whose scalars stay
    0-d tensors of their dtype."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


def cache_from_numpy(tree: dict, device) -> dict:
    """A numpy decode cache (``layers`` and ``pos``) as the port's on
    ``device``; ``pos`` stays a 0-d int32 tensor."""
    return params_from_numpy(tree, device)


def shard_state_from_numpy(tree: dict, spec, devices) -> list[dict]:
    """A numpy train-state tree as the port's train state laid out by
    ``spec`` (a trainer's ``exec.layout``): one tree per slot, slot i's
    boxes (``reshape.shard_state``) on ``devices[i]``."""
    if len(devices) != spec.n_devices:
        raise ValueError(f"{len(devices)} devices for the "
                         f"{spec.n_devices} slots of ({spec.dp}, {spec.mp})")
    return [unflatten_tree({k: _leaf_from_numpy(a, dev)
                            for k, a in shards.items()})
            for shards, dev in zip(shard_state(spec, tree), devices)]


def to_numpy(tree: dict) -> dict:
    """The port's tensor tree (params, train state or decode cache) as
    numpy, bfloat16 leaves as float32."""
    def one(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)
