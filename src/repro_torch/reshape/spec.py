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

``for_config`` is the reference's layout rule exactly, so plans made from
configs match the JAX package's, and it is the port's trainer's layout
(``for_trainer``), data axis included: every weight and both AdamW
moments are split over the data axis where the rules say so (FSDP).
"""
from __future__ import annotations

import dataclasses

from repro_torch.sharding import spec_for


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


def _canonical_axis(entry) -> str | None:
    """Normalize one spec entry to "data" | "model" | None. Composite
    entries like ``("pod", "data")`` collapse onto the elastic data axis
    (the pod axis is a second data-parallel tier)."""
    if entry is None:
        return None
    names = entry if isinstance(entry, (tuple, list)) else (entry,)
    if any(n in ("data", "pod") for n in names):
        return "data"
    if "model" in names:
        return "model"
    return None


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
    it is device-free, so carrying it through a reshape or a checkpoint preserves the
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

    # -------------------------------------------------------- constructors
    @classmethod
    def from_shardings(cls, dp: int, mp: int, shardings, state
                       ) -> "StateSpec":
        """Read a layout off matching dict trees: ``shardings`` holds one
        spec per tensor (a raw tuple, or anything with a ``.spec``) and
        ``state`` the tensors, or their shapes (only the shape is read)."""
        flat_sh = flatten_tree(shardings)
        flat_st = flatten_tree(state)
        tensors = []
        for path, sh in flat_sh.items():
            shape = tuple(getattr(flat_st[path], "shape", flat_st[path]))
            spec = getattr(sh, "spec", sh)
            entries = tuple(spec) + (None,) * (len(shape) - len(spec))
            axes = []
            for dim, entry in zip(shape, entries):
                axis = _canonical_axis(entry)
                n = dp if axis == "data" else mp if axis == "model" else 1
                # spec_for never emits a non-divisible mapping, but specs
                # read from foreign checkpoints are validated here
                axes.append(axis if n <= 1 or dim % n == 0 else None)
            tensors.append(TensorLayout(path, shape, tuple(axes)))
        return cls(dp, mp, tuple(tensors))

    @classmethod
    def for_config(cls, cfg, optimizer, dp: int, mp: int) -> "StateSpec":
        """Device-free construction: the layout the reference's trainer at
        ``(dp, mp)`` uses, from the same logical-axis rules (``spec_for``)
        on the port's parameter specs and train-state shapes."""
        from repro_torch.models.model import param_spec_tree
        from repro_torch.models.params import tree_map
        from repro_torch.training.step import state_shapes
        mesh = {"data": dp, "model": mp}
        params = tree_map(lambda s: spec_for(s.axes, s.shape, mesh),
                          param_spec_tree(cfg))
        specs = {"params": params, "step": (),
                 "opt": {"count": (), "mu": params}}
        if optimizer.slots >= 2:
            specs["opt"]["nu"] = params
        shapes = tree_map(lambda sd: sd[0], state_shapes(cfg, optimizer))
        return cls.from_shardings(dp, mp, specs, shapes)

    @classmethod
    def for_trainer(cls, trainer) -> "StateSpec":
        """The live trainer's collection: its handle's layout at ``(p, mp)``
        (+ the virtual-worker payload when the trainer runs deterministic
        elasticity)."""
        spec = trainer.exec.layout
        if trainer.n_virtual:
            spec = dataclasses.replace(
                spec, virtual={"n_virtual": trainer.n_virtual,
                               "seed": trainer.seed,
                               "pipeline": trainer.pipeline.state_dict()})
        return spec

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
