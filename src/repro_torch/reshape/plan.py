"""plan_reshard(src, dst) — the minimal move set between two layouts (a
copy of the reference's planner).

For every tensor of the collection the planner compares the shard grid at
the source and destination configs and emits one ``TensorMove``:

  keep       — identical grid (e.g. replicated scalars, or a dim sharded
               over ``model`` when mp did not change): zero bytes move.
  slice      — the destination grid strictly refines the source (every dst
               shard is a sub-box of one src shard): pure local slicing.
  allgather  — the source grid strictly refines the destination (every dst
               shard is a concat of whole src shards).
  reshard    — anything else (mixed refine/coarsen across dims): general
               slice + concat.

``bytes_moved`` is the non-local traffic: for each destination mesh slot
the bytes of its shard NOT already present in the shard the same linear
slot holds at the source (slots beyond the source mesh hold nothing).
When the two configs use different device counts every byte a new slot
needs counts as moved. ``bytes_kept`` is the complementary local overlap —
the planner's "minimality" is exactly this: data a slot already holds is
never re-fetched.
"""
from __future__ import annotations

import dataclasses

from repro_torch.reshape.spec import StateSpec, TensorLayout


def _overlap(a: tuple[tuple[int, int], ...],
             b: tuple[tuple[int, int], ...]) -> int:
    """Element count of the intersection of two boxes (0 if disjoint)."""
    n = 1
    for (alo, ahi), (blo, bhi) in zip(a, b):
        lo, hi = max(alo, blo), min(ahi, bhi)
        if hi <= lo:
            return 0
        n *= hi - lo
    return n


@dataclasses.dataclass(frozen=True)
class TensorMove:
    path: str
    kind: str               # keep | slice | allgather | reshard
    bytes_moved: int        # non-local traffic (see module docstring)
    bytes_kept: int         # bytes already resident at their dst slot


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    src: StateSpec
    dst: StateSpec
    moves: tuple[TensorMove, ...]

    @property
    def bytes_moved(self) -> int:
        return sum(m.bytes_moved for m in self.moves)

    @property
    def bytes_kept(self) -> int:
        return sum(m.bytes_kept for m in self.moves)

    def move(self, path: str) -> TensorMove:
        for m in self.moves:
            if m.path == path:
                return m
        raise KeyError(path)

    def summary(self) -> dict:
        kinds: dict[str, int] = {}
        for m in self.moves:
            kinds[m.kind] = kinds.get(m.kind, 0) + 1
        return {"from": [self.src.dp, self.src.mp],
                "to": [self.dst.dp, self.dst.mp],
                "tensors": len(self.moves), "kinds": kinds,
                "bytes_moved": self.bytes_moved,
                "bytes_kept": self.bytes_kept}


def _classify(src: TensorLayout, dst: TensorLayout,
              sf: tuple[int, ...], df: tuple[int, ...]) -> str:
    if sf == df:
        return "keep"
    refines = coarsens = False
    for s, d in zip(sf, df):
        if s == d:
            continue
        # grids nest only when one factor divides the other; non-nesting
        # factors (3 -> 2) slice AND concat, which is a general reshard
        if d % s == 0:
            refines = True      # dst splits finer along this dim
        elif s % d == 0:
            coarsens = True
        else:
            return "reshard"
    if refines and coarsens:
        return "reshard"
    return "slice" if refines else "allgather"


def plan_reshard(src: StateSpec, dst: StateSpec, *,
                 itemsize: int = 4) -> ReshardPlan:
    """Plan the move from ``src`` to ``dst``. Both specs must describe the
    same tensor collection (same paths, same global shapes) — a checkpoint
    written by a different model config fails loudly here rather than
    restoring garbage. ``itemsize`` prices the byte accounting (train
    state is fp32 throughout this repo)."""
    src_paths = {t.path: t for t in src.tensors}
    moves = []
    for d_t in dst.tensors:
        s_t = src_paths.pop(d_t.path, None)
        if s_t is None:
            raise ValueError(f"reshard plan: {d_t.path!r} missing from "
                             f"source spec")
        if s_t.shape != d_t.shape:
            raise ValueError(
                f"reshard plan: {d_t.path!r} global shape changed "
                f"{s_t.shape} -> {d_t.shape}; resharding moves data, it "
                f"cannot resize tensors")
        sf = s_t.factors(src.dp, src.mp)
        df = d_t.factors(dst.dp, dst.mp)
        kind = _classify(s_t, d_t, sf, df)
        kept = 0
        if kind == "keep" and src.n_devices == dst.n_devices:
            shard = d_t.n_elements
            for f in df:
                shard //= f
            kept = shard * dst.n_devices * itemsize
            moved = 0
        else:
            moved = 0
            for i in range(dst.n_devices):
                d_box = d_t.box(dst.dp, dst.mp, i)
                local = (_overlap(d_box, s_t.box(src.dp, src.mp, i))
                         if i < src.n_devices else 0)
                need = 1
                for lo, hi in d_box:
                    need *= hi - lo
                moved += (need - local) * itemsize
                kept += local * itemsize
        moves.append(TensorMove(d_t.path, kind, moved, kept))
    if src_paths:
        raise ValueError(f"reshard plan: destination spec lacks "
                         f"{sorted(src_paths)}")
    return ReshardPlan(src, dst, tuple(moves))
