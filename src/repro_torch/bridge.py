"""Move parameter and train-state trees between numpy and the port.

The JAX package's ``init_params`` and train-state trees, converted leaf by
leaf with ``np.asarray``, load into the port with the same paths, shapes and
dtypes; ``to_numpy`` goes back. A bfloat16 leaf (the 2-byte extension
dtype JAX hands numpy) is reinterpreted bit for bit; it goes back as
float32, since numpy itself has no bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import tree_map


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


def to_numpy(tree: dict) -> dict:
    """The port's tensor tree as numpy, bfloat16 leaves as float32."""
    def one(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)
