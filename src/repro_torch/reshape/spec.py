"""StateSpec — a device-independent description of how a train state is
laid out over a ``(data, model)`` mesh (Tenplex's parallelizable tensor
collection, specialized to 2-D meshes), copied from the reference.

A ``TensorLayout`` records, per tensor, its GLOBAL shape and which mesh
axis (``"data"``, ``"model"`` or ``None``) each dimension is partitioned
over at a given ``(dp, mp)``. The physical device list is deliberately
absent, so the same spec can be serialized into a checkpoint and compared
against a topology built in another process — or another framework: a
checkpoint written by the JAX package carries its spec in the same JSON.
Devices are addressed by their *linear mesh index* ``d * mp + m``.

The port holds the whole state on slot 0's device, so its own specs have
every axis ``None`` (``for_trainer``).
"""
from __future__ import annotations

import dataclasses


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Flatten a nested dict tree to {"a/b/c": leaf} (sorted keys — the
    same path scheme the checkpoint format uses, so specs, checkpoints and
    live state trees all address tensors identically)."""
    flat: dict = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        node = tree[k]
        if isinstance(node, dict):
            flat.update(flatten_tree(node, path))
        else:
            flat[path] = node
    return flat


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


@dataclasses.dataclass(frozen=True)
class TensorLayout:
    """One tensor of the collection: global shape + per-dim mesh axis."""
    path: str
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]    # "data" | "model" | None per dim

    def factors(self, dp: int, mp: int) -> tuple[int, ...]:
        """How many ways each dim is split at (dp, mp)."""
        return tuple(dp if a == "data" else mp if a == "model" else 1
                     for a in self.axes)

    def box(self, dp: int, mp: int, index: int
            ) -> tuple[tuple[int, int], ...]:
        """Half-open [lo, hi) interval per dim of the shard held by the
        device at linear mesh index ``index`` (replicated dims span the
        whole dim)."""
        d, m = divmod(index, mp)
        out = []
        for dim, axis, n in zip(self.shape, self.axes,
                                self.factors(dp, mp)):
            coord = d if axis == "data" else m if axis == "model" else 0
            size = dim // n
            out.append((coord * size, (coord + 1) * size))
        return tuple(out)

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """The whole collection at one parallelization config.

    ``virtual`` is the optional deterministic-elasticity payload: the
    virtual-worker count, sampling seed, and the pipeline's cursor/epoch
    state (``VirtualWorkerPipeline.state_dict``). Like the tensor layouts
    it is device-free, so carrying it through a checkpoint preserves the
    exact training trajectory onto ANY target shape. ``None`` for jobs
    running the dynamic (non-deterministic) pipeline."""
    dp: int
    mp: int
    tensors: tuple[TensorLayout, ...]
    virtual: dict | None = None

    @property
    def n_devices(self) -> int:
        return self.dp * self.mp

    def layout(self, path: str) -> TensorLayout:
        for t in self.tensors:
            if t.path == path:
                return t
        raise KeyError(path)

    @classmethod
    def for_trainer(cls, trainer) -> "StateSpec":
        """The live trainer's collection: the whole state on slot 0's
        device, every axis ``None`` (+ the virtual-worker payload when the
        trainer runs deterministic elasticity)."""
        tensors = tuple(TensorLayout(path, tuple(t.shape), (None,) * t.dim())
                        for path, t in flatten_tree(trainer.state).items())
        virtual = None
        if trainer.n_virtual:
            virtual = {"n_virtual": trainer.n_virtual, "seed": trainer.seed,
                       "pipeline": trainer.pipeline.state_dict()}
        return cls(trainer.p, trainer.model_parallel, tensors, virtual)

    # -------------------------------------------------------- serialization
    def to_json(self) -> dict:
        out = {"dp": self.dp, "mp": self.mp,
               "tensors": [[t.path, list(t.shape), list(t.axes)]
                           for t in self.tensors]}
        if self.virtual is not None:
            out["virtual"] = self.virtual
        return out

    @classmethod
    def from_json(cls, obj: dict) -> "StateSpec":
        return cls(int(obj["dp"]), int(obj["mp"]), tuple(
            TensorLayout(p, tuple(s), tuple(a))
            for p, s, a in obj["tensors"]),
            virtual=obj.get("virtual"))
