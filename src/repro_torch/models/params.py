"""Parameter specs and their initializer, plus the chunk-fitting helper.

Counterpart of ``ShardedInit`` and ``fit_chunk`` in the reference's
``sharding.py``. The logical axes ride along so a later tensor-parallel
slice can map them to devices; this slice places every leaf whole on one
device, so the reference's ``constrain`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ShardedInit:
    """A parameter's shape, logical axes and initializer, kept together so the
    same metadata drives init and shape accounting."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | alog
    scale: float = 1.0

    def materialize(self, generator: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        """Draw the leaf on the CPU from ``generator`` (so a seed gives the
        same values on every device) and move it to ``device``.

        The std rule is the reference's as written: ``fan_in = shape[0]``.
        On a stacked ``[n_periods, d_in, d_out]`` layer leaf that is
        n_periods, not d_in."""
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "alog":     # mamba A_log: log(1..N) along last dim
            a = torch.log(torch.arange(1, self.shape[-1] + 1,
                                       dtype=torch.float32))
            return a.expand(self.shape).to(dtype=dtype, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[-1], 1)
        std = self.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32)
        return (x * std).to(dtype=dtype, device=device)


def fit_chunk(total: int, desired: int) -> int:
    """Largest chunk <= desired that divides total (chunked loops need an
    exact tiling; non-divisible requests degrade instead of failing)."""
    c = max(1, min(desired, total))
    while total % c:
        c -= 1
    return c


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` pairs in sorted-key order — the order
    ``jax.tree.flatten`` gives a nested dict — with ``/``-joined paths."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_leaves(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_unflatten(pairs) -> dict:
    """Inverse of :func:`tree_leaves`."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
