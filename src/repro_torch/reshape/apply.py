"""Plan executors (the reference's ``reshape/apply.py``).

Two of them, sharing the StateSpec box arithmetic:

  * ``shard_state`` / ``apply_plan_host`` / ``assemble_state`` — the
    reference's pure numpy executor over explicit per-slot shard dicts,
    copied as it is. It is the oracle the property tests round-trip and
    needs no device.

  * ``apply_plan(plan, shards, devices)`` — the LIVE path on torch tensors:
    every ``ElasticTrainer`` switch that changes the layout or the slots
    (a resize, a migration, a reshape, a recovery) commits by moving the
    per-slot shards of the train state onto the destination slots' devices,
    tensor by tensor. Each destination box is taken from the source shards
    in the cheapest way the boxes allow: a ``keep`` move hands over the
    same tensor (no copy on the same device), a ``slice`` copies the box
    out of the one source shard that contains it (a tensor of its own, so
    the source's storage can go), and ``allgather`` and ``reshard`` fill
    the box from the source boxes that overlap it, in box order — which is
    the box of the global assembly, without assembling it.
    ``copied_bytes`` counts what a move really copied. ``place_state``
    and ``gather_state`` are the same executor from and to whole tensors
    (a restore from a checkpoint, a checkpoint save).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.reshape.plan import ReshardPlan, plan_reshard
from repro_torch.reshape.spec import StateSpec, TensorLayout, \
    flatten_tree, unflatten_tree


def shard_state(spec: StateSpec, state: dict) -> list[dict]:
    """Split a global (host) state tree into per-mesh-slot shard dicts:
    ``out[i][path]`` is the box the device at linear index i holds."""
    flat = flatten_tree(state)
    out: list[dict] = []
    for i in range(spec.n_devices):
        shards = {}
        for t in spec.tensors:
            box = t.box(spec.dp, spec.mp, i)
            shards[t.path] = np.asarray(flat[t.path])[
                tuple(slice(lo, hi) for lo, hi in box)]
        out.append(shards)
    return out


def assemble_state(spec: StateSpec, shards: list[dict]) -> dict:
    """Reconstruct the global state tree from per-slot shards (the inverse
    of ``shard_state``; replicated boxes overwrite with equal values)."""
    flat = {}
    for t in spec.tensors:
        ref = shards[0][t.path]
        full = np.empty(t.shape, dtype=ref.dtype)
        for i in range(spec.n_devices):
            box = t.box(spec.dp, spec.mp, i)
            full[tuple(slice(lo, hi) for lo, hi in box)] = shards[i][t.path]
        flat[t.path] = full
    return unflatten_tree(flat)


def apply_plan_host(plan: ReshardPlan, shards: list[dict]) -> list[dict]:
    """Reference executor: move per-slot shards from ``plan.src`` layout to
    ``plan.dst`` layout with numpy slicing/concat only."""
    if len(shards) != plan.src.n_devices:
        raise ValueError(f"got {len(shards)} shard dicts for a "
                         f"{plan.src.n_devices}-slot source mesh")
    global_flat = flatten_tree(assemble_state(plan.src, shards))
    out: list[dict] = []
    for i in range(plan.dst.n_devices):
        dst = {}
        for t in plan.dst.tensors:
            box = t.box(plan.dst.dp, plan.dst.mp, i)
            dst[t.path] = global_flat[t.path][
                tuple(slice(lo, hi) for lo, hi in box)].copy()
        out.append(dst)
    return out


def _box_slices(box, within) -> tuple[slice, ...]:
    """``box`` as slices of a tensor that holds the box ``within``."""
    return tuple(slice(lo - wlo, hi - wlo)
                 for (lo, hi), (wlo, _) in zip(box, within))


def _intersect(a, b):
    out = tuple((max(alo, blo), min(ahi, bhi))
                for (alo, ahi), (blo, bhi) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _volume(box) -> int:
    n = 1
    for lo, hi in box:
        n *= hi - lo
    return n


def _take(layout: TensorLayout, spec: StateSpec, shards: list[dict], box,
          slot: int, device: torch.device) -> torch.Tensor:
    """The ``box`` of one tensor on ``device``, from the per-slot shards of
    ``spec``. Of the slots holding the same source box, the one already on
    ``device`` is read first, then slot ``slot`` itself."""
    holders: dict = {}
    for j in sorted(range(len(shards)), key=lambda j: (
            shards[j][layout.path].device != device, j != slot, j)):
        holders.setdefault(layout.box(spec.dp, spec.mp, j),
                           shards[j][layout.path])
    if box in holders:                                      # keep
        return holders[box].to(device)
    ref = next(iter(holders.values()))
    out = torch.empty([hi - lo for lo, hi in box], dtype=ref.dtype,
                      device=device)
    for held, t in holders.items():
        if _intersect(held, box) == box:                    # slice
            out.copy_(t[_box_slices(box, held)])
            return out
    filled = 0
    for held, t in holders.items():                # allgather, reshard
        part = _intersect(held, box)
        if part is not None:
            out[_box_slices(part, box)] = t[_box_slices(part, held)]
            filled += _volume(part)
    if filled != _volume(box):
        raise ValueError(f"the source shards do not cover {layout.path} "
                         f"box {box}")
    return out


def apply_plan(plan: ReshardPlan, shards: list[dict], devices
               ) -> list[dict]:
    """Live executor: move per-slot shard dicts (``{path: tensor}``, one per
    slot of ``plan.src``) to the layout of ``plan.dst``. ``devices`` are the
    devices of the destination slots to fill, the first ``len(devices)`` of
    ``plan.dst``'s (a trainer fills all of them). The plan has validated
    the collection; its moves carry the byte accounting the scaling record
    reports."""
    if len(shards) != plan.src.n_devices:
        raise ValueError(f"got {len(shards)} shard dicts for a "
                         f"{plan.src.n_devices}-slot source mesh")
    if len(devices) > plan.dst.n_devices:
        raise ValueError(f"{len(devices)} devices for a "
                         f"{plan.dst.n_devices}-slot destination mesh")
    src = {t.path: t for t in plan.src.tensors}
    out: list[dict] = [{} for _ in devices]
    for t in plan.dst.tensors:
        for i, dev in enumerate(devices):
            out[i][t.path] = _take(src[t.path], plan.src, shards,
                                   t.box(plan.dst.dp, plan.dst.mp, i), i,
                                   torch.device(dev))
    return out


def _whole(spec: StateSpec) -> StateSpec:
    """The collection of ``spec`` as whole tensors on one slot."""
    return StateSpec(1, 1, tuple(TensorLayout(t.path, t.shape,
                                              (None,) * len(t.shape))
                                 for t in spec.tensors))


def place_state(spec: StateSpec, state: dict, devices) -> list[dict]:
    """A whole state tree of tensors as the shard trees of the first
    ``len(devices)`` slots of ``spec`` (a trainer's: all of them), each on
    its device."""
    plan = plan_reshard(_whole(spec), spec)
    return [unflatten_tree(s) for s in
            apply_plan(plan, [flatten_tree(state)], devices)]


def gather_state(spec: StateSpec, shards: list[dict],
                 device="cpu") -> dict:
    """The whole state tree on ``device`` from the shard trees of every
    slot of ``spec``, each box read from a slot that holds it."""
    plan = plan_reshard(spec, _whole(spec))
    return unflatten_tree(apply_plan(
        plan, [flatten_tree(s) for s in shards], [device])[0])


def copied_bytes(src: list[dict], dst: list[dict]) -> int:
    """The bytes of the tensors of the shard trees ``dst`` that lie on no
    storage of ``src``'s: what a move from ``src`` to ``dst`` copied."""
    def leaves(shards):
        return [t for s in shards for t in flatten_tree(s).values()]
    held = {t.untyped_storage().data_ptr() for t in leaves(src)}
    return sum(t.nbytes for t in leaves(dst)
               if t.untyped_storage().data_ptr() not in held)
