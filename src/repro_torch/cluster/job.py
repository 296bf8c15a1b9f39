"""The one piece of the reference's cluster-level job module that the
trainer needs: the feasibility clamp. The cluster executor, its jobs and
policies are not ported yet."""
from __future__ import annotations


def feasible_parallelism(global_batch: int, target: int,
                         n_virtual: int = 0) -> int:
    """Largest parallelism <= target the live trainer can actually run at
    (the global batch must divide evenly across the data-parallel
    replicas — ``target`` is in GROUPS, not devices); 0 when target < 1.
    Deterministic tenants additionally require p to divide their fixed
    virtual-worker count ``n_virtual`` (contiguous equal blocks at every
    shape)."""
    if target < 1:
        return 0
    p = target
    while global_batch % p or (n_virtual and n_virtual % p):
        p -= 1
    return p
