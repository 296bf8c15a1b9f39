"""Logical-axis sharding rules, device-free: a copy of the reference's
``DEFAULT_RULES``, ``mesh_axis_size`` and ``spec_for``.

Every parameter dim carries a *logical* axis name (``ShardedInit.axes``);
the rules map logical names to mesh axes. The reference applies them to a
JAX mesh. The port has no mesh object: a mesh here is its axis sizes,
``{"data": dp, "model": mp}``, and a spec is a plain tuple with one entry
per dim (a mesh axis name, a tuple of them, or ``None``), trailing
``None``s dropped as ``PartitionSpec`` drops them.

A dim whose size is not divisible by the product of its mapped mesh axes is
left unsharded (replicated), as in the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

# Logical axis -> tuple of mesh axes (tried in order; dropped if not
# divisible). ``embed`` and ``fsdp2`` shard weights over the data axis
# (FSDP), in the reference and the port alike; ``heads``, ``kv_heads``,
# ``mlp`` and ``vocab`` go on the model axis.
DEFAULT_RULES: dict[str | None, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    "seq_shard": ("data",),
    "embed_act": (),
    # weights
    "vocab": ("model",),
    "embed": ("pod", "data"),   # FSDP dim
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "qk_dim": (),
    "experts": ("model",),
    "expert_mlp": ("model",),
    "layers": (),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv": (),
    "lora": (),
    "fsdp2": ("pod", "data"),
    None: (),
}


def mesh_axis_size(mesh: Mapping[str, int], axes: Sequence[str]) -> int:
    """The product of the sizes of ``axes`` that ``mesh`` has."""
    n = 1
    for a in axes:
        if a in mesh:
            n *= mesh[a]
    return n


def spec_for(logical_axes: Sequence[str | None], shape: Sequence[int],
             mesh: Mapping[str, int],
             rules: Mapping[str | None, tuple[str, ...]] | None = None
             ) -> tuple[Any, ...]:
    """The spec of one array from its logical axis names, on a mesh given
    by its axis sizes."""
    rules = dict(DEFAULT_RULES) if rules is None else {**DEFAULT_RULES,
                                                       **rules}
    used: set[str] = set()
    entries: list[Any] = []
    for name, dim in zip(logical_axes, shape):
        mapped = tuple(a for a in rules.get(name, ())
                       if a in mesh and a not in used)
        if mapped and dim % mesh_axis_size(mesh, mapped) == 0:
            entries.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)
