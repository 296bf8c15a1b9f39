"""The dry-run: does a configuration's step fit a card, and which roofline
term bounds it — on torch ``meta`` tensors, which allocate nothing.

Counterpart of the reference's ``launch/dryrun.py``. For one (architecture
x input shape x layout ``(p, mp)``):

  A. One data group's state on ``meta``: ``training/step.py:
     state_shapes`` laid out by ``port_layout`` at (p, mp), each of the
     group's mp slots holding its boxes (FSDP over the data axis, split
     over the model axis), or, to serve, the params split over the model
     axis alone (whole over the data axis, as ``core/serving.py:
     trainer_params`` gathers them); and the group's batch,
     ``global_batch / p`` (at least 1). Then the full config's real step
     runs, at full width and depth: for train, the group's share of the
     default step (``group_train_step``: the all-gather of its params over
     the data axis, forward and backward, the reduce-scatter of its
     gradients and its slots' update), ``prefill`` for prefill,
     ``serve_step`` against a cache split by ``cache_dims``
     (``init_cache_shards``) for decode. So every tensor-parallel shape
     of the step has to cohere, and every kernel's wrapper applies the
     CUDA path's checks (``kernels/*/ops.py``): a limit it hits ends the
     record as ``REFUSED`` with the kernel's own message, never as a run
     of its plain version.
  B. Costs of the same run: ``torch.utils.flop_counter.FlopCounterMode``
     over the aten ops, plus each kernel's formula counts
     (``kernels/launches.py: COSTS``), which no aten op stands for; the
     bytes of every aten op's operands and results (views and empty
     allocations aside: an unfused upper bound, each op reading and
     writing memory as if nothing were fused or cached), plus the
     kernels'; the bytes the collectives send (``parallel.COLLECTIVES``),
     the data axis's (``all_gather_data``, ``reduce_scatter_data``) apart
     from the model axis's.
     Eager mode runs every layer, so the counts need no depth
     extrapolation (the reference's XLA counts a loop body once).

Slot accounting. ``meta`` tensors carry no device index, so the slots of
a group cannot be told apart while the step runs: ``arg_bytes`` (slot 0)
and ``arg_bytes_by_slot`` are exact, from the shards each slot holds; the
step's flops, bytes and peak are the group's, and a slot is given 1/mp of
each (``temp_bytes``, ``flops_per_slot``, ``bytes_per_slot``), though the
first slot carries the residual stream, the norms, the embedding lookup
and the loss. The first slot holds every replicated leaf, as each JAX
device does; the others hold the replicated cache leaves (and ``pos``)
fewer, and the batch fewer (the port keeps the batch on the first slot
and copies the tokens out inside the step). The batch is counted as the
caller hands it in: int32 ids, as the reference's ``input_specs``, and
fp32 embeddings, as the port's data pipeline gives them (the reference's
specs say bf16). ``collective_bytes_per_slot``
is the most any slot sends, ``data_collective_bytes_per_slot`` the most
it sends over the data axis. The model axis's bytes are priced at
``mesh.NVLINK_BW``; the data axis's at ``mesh.data_link_bw(p, mp)``
(``data_link``): NVLink while the layout fits one node, else one
InfiniBand port a card.

Record keys. Those of the reference where the meaning is the same
(``arch``, ``shape``, ``status``, ``mesh``, ``mode``, ``arg_bytes``,
``temp_bytes``, ``output_bytes``, ``per_device_bytes``, ``t_compute_s``,
``t_memory_s``, ``t_collective_s``, ``dominant``, ``params``,
``active_params``, ``model_flops``, ``useful_flops_ratio``,
``collective_breakdown``). Renamed, their meaning differing: ``chips`` ->
``cards``; ``lower_s`` and ``compile_s`` -> ``step_s`` (the meta step's
wall time); ``hlo_flops_per_device`` -> ``flops_per_slot``;
``hlo_bytes_per_device`` -> ``bytes_per_slot``;
``collective_bytes_per_device`` -> ``collective_bytes_per_slot``;
``collective_ops_full`` has none. ``temp_bytes`` is the peak of the bytes
the step holds beyond its arguments, its outputs included as they are
made (XLA's excludes them), so ``per_device_bytes`` = ``arg_bytes`` +
``temp_bytes`` is the slot's peak; ``fits`` compares it with
``mesh.HBM_BYTES``. New: ``group_batch``, ``group_temp_bytes``,
``kernel_flops`` and ``kernel_bytes`` by kernel,
``data_collective_bytes_per_slot`` and ``data_link``.

The times are the port's arithmetic on the datasheet constants of
``launch/mesh.py`` (an ``H100 SXM5 80GB``), not measurements. The
reference's ``--save-hlo`` has no counterpart (there is no HLO), nor
``--no-swa-pruned`` (the port's windowed attention is the flash kernel's
window mask); ``--multi-pod`` is refused: the port has no multi-host pool
(ROADMAP A9).

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
      --shape train_4k [--mesh 1,8] [--out results.jsonl] [--resume]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-cost]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, \
    get_config, input_specs
from repro_torch.kernels.launches import COSTS, KernelRefusal
from repro_torch.launch import mesh as H
from repro_torch.models import model as M
from repro_torch.models.cache import init_cache_shards
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import COLLECTIVES, ShardedParams, model_dims, \
    placing
from repro_torch.reshape import place_state
from repro_torch.training.step import apply_update, gather_group, \
    group_loss_and_grads, port_layout, scatter_group, shard_batch, \
    split_tree, state_shapes

META = torch.device("meta")
# the data axis's collectives (``parallel.py``)
DATA_AXIS = ("all_gather_data", "reduce_scatter_data")
# allocations that write nothing: no bytes moved
_EMPTY = {"empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided"}


class StepMeter(TorchDispatchMode):
    """Per slot of a group: the live bytes of the storages made while it
    is on and their peak, and (with ``count``) the flops
    (``FlopCounterMode``'s formulas) and the operand and result bytes of
    every aten op but views and empty allocations.

    A storage is live while a tensor that an op gave back on it is (a
    view's too). It belongs to a slot: the argument tensors ``hold`` names
    theirs, a collective's copy is ``place``d on the slot it is for
    (``parallel.placing``), and an op's outputs go to the highest slot
    among its inputs' (slot m's work reads slot-0 tensors copied out to
    it, never another shard's) — slot 0 where it has none."""

    def __init__(self, n_slots: int, count: bool = True):
        super().__init__()
        self.count = count
        self.live = [0] * n_slots
        self.peak = [0] * n_slots
        self.flops = [0] * n_slots
        self.bytes = [0] * n_slots
        self._slot: dict[int, int] = {}          # storage: slot
        self._held: dict[int, list[int]] = {}    # storage: [bytes, holders]
        self._registry = FlopCounterMode(display=False).flop_registry

    def hold(self, tensors, slot: int):
        """The step's arguments on ``slot``: not counted as live."""
        for t in tensors:
            self._slot[t.untyped_storage()._cdata] = slot

    def slot_of(self, t: torch.Tensor) -> int:
        return self._slot.get(t.untyped_storage()._cdata, 0)

    def place(self, t: torch.Tensor, slot: int):
        key = t.untyped_storage()._cdata
        old = self._slot.get(key, 0)
        self._slot[key] = slot
        if key in self._held:
            n = self._held[key][0]
            self.live[old] -= n
            self.live[slot] += n
            self.peak[slot] = max(self.peak[slot], self.live[slot])

    def _release(self, key: int):
        entry = self._held[key]
        entry[1] -= 1
        if not entry[1]:
            del self._held[key]
            self.live[self._slot.pop(key, 0)] -= entry[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self._registry and func is not torch.ops.prim.device\
                .default:
            # a composite op (aten.matmul under inference_mode): its parts,
            # as FlopCounterMode counts them
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = [t for t in pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        aliased = {t.untyped_storage()._cdata for t in ins}
        slot = max((self.slot_of(t) for t in ins), default=0)
        made = False                # an output on a storage of its own
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._held:
                if key in aliased:
                    continue            # a view of a tensor made before
                self._held[key] = [st.nbytes(), 0]
                self._slot[key] = slot
                self.live[slot] += st.nbytes()
                made = True
            self._held[key][1] += 1
            weakref.finalize(t, self._release, key)
        self.peak[slot] = max(self.peak[slot], self.live[slot])
        if self.count:
            packet = func.overloadpacket
            if packet in self._registry:
                self.flops[slot] += self._registry[packet](
                    *args, **kwargs, out_val=out)
            if (made or not outs or func._schema.is_mutable) \
                    and packet.__name__ not in _EMPTY:
                self.bytes[slot] += sum(t.nbytes for t in ins + outs)
        return out


def _nbytes(tensors) -> int:
    return sum(t.nbytes for t in tensors)


def _meta_tree(shapes: dict) -> dict:
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device=META),
                    shapes)


def _split(tree: dict, dims: dict, mp: int) -> list[dict]:
    """``split_tree`` onto mp ``meta`` slots, each shard a tree of tensors
    of its own (a replicated leaf too, as each card holds its copy)."""
    return [tree_map(torch.clone, shard)
            for shard in split_tree(tree, dims, [META] * mp)]


def group_train_step(cfg, optimizer, layout, slots: list[dict],
                     batch: dict):
    """Data group 0's share of the default train step
    (``training/step.py: make_train_step``) at ``layout``'s (p, mp) on
    ``meta``: ``slots`` are its mp slots' trees, and the gather, forward
    and backward, reduce-scatter and update run as the step runs them for
    one group. The boxes and the gradients of the other p - 1 groups,
    which the two collectives read, are stand-ins of the same shapes: the
    group's own, copied onto its slots as the real ones are. An MoE config
    at p > 1 first walks the group's routing pre-pass
    (``M.route_globally``), the other groups' claims stand-ins too."""
    p, mp = layout.dp, layout.mp
    devices = [META] * mp
    (shard,) = shard_batch(batch, 1, devices[:1])
    params = [s["params"] for s in slots] * p
    dims = model_dims(layout)
    plan = None
    if cfg.moe and p > 1:
        (plan,) = M.route_globally(cfg, [ShardedParams(
            gather_group(layout, params, 0, devices), dims,
            tuple(devices))], [shard], p)
    loss, parts, grads = group_loss_and_grads(
        cfg, gather_group(layout, params, 0, devices), dims, devices, shard,
        routing=plan)
    boxes = [tree_map(lambda g: g / p, box)
             for box in scatter_group(layout, [grads] * p, 0, devices)]
    return apply_update(optimizer, slots, boxes, layout, loss,
                        parts["xent"], parts["aux"], slots=range(mp))


def _prepare(cfg, shape: InputShape, p: int, mp: int):
    """The group's step on ``meta`` as a thunk, what each slot holds
    before it ({slot: [tensors]}) and the group's batch."""
    optimizer = adamw(1e-4)
    layout = port_layout(cfg, optimizer, p, mp)
    devices = [META] * mp
    group_batch = max(1, shape.global_batch // p)
    specs = input_specs(cfg, dataclasses.replace(shape,
                                                 global_batch=group_batch))
    specs.pop("cache", None)               # the split cache is built below
    if "embeds" in specs:
        # the port's data pipeline hands embeddings in fp32
        # (data/synthetic.py), which the model casts to the compute dtype;
        # the reference's input_specs say bf16
        specs["embeds"] = specs["embeds"].float()
    held = {m: [] for m in range(mp)}
    held[0] += list(specs.values())
    if shape.mode == "train":
        # group 0's slots' boxes, each a tensor of its own (a replicated
        # leaf too, as each card holds its copy)
        slots = [tree_map(torch.clone, s) for s in place_state(
            layout, _meta_tree(state_shapes(cfg, optimizer)), devices)]
        for m, tree in enumerate(slots):
            held[m] += [t for _, t in tree_leaves(tree)]
        return (lambda: group_train_step(cfg, optimizer, layout, slots,
                                         specs)), held, group_batch
    dims = model_dims(layout)
    sp = ShardedParams(_split(_meta_tree(state_shapes(cfg, optimizer)[
        "params"]), dims, mp), dims, tuple(devices))
    for m, tree in enumerate(sp.trees):
        held[m] += [t for _, t in tree_leaves(tree)]
    if shape.mode == "prefill":
        def run():
            with torch.inference_mode():
                return M.prefill(cfg, sp, specs)
        return run, held, group_batch
    cache = init_cache_shards(cfg, group_batch, shape.seq_len, devices)
    cdims = dict(tree_leaves(cache.dims))
    for m, tree in enumerate(cache.trees):
        held[m] += [t for path, t in tree_leaves(tree)
                    if m == 0 or cdims[path] is not None]

    def run():
        with torch.inference_mode():
            return M.serve_step(cfg, sp, specs, cache)
    return run, held, group_batch


def _output_bytes(out) -> int:
    """Bytes of what the step returns on the first slot: the new state's
    first shard and the metrics, the logits, or the ids and the cache's
    first shard (written in place, as the reference's step returns it)."""
    if isinstance(out, tuple) and isinstance(out[1], ShardedParams):
        ids, cache = out
        return ids.nbytes + _nbytes(t for _, t in tree_leaves(cache.trees[0]))
    if isinstance(out, tuple):
        state, metrics = out
        return _nbytes(t for _, t in tree_leaves(state[0])) + _nbytes(
            metrics.values())
    return out.nbytes


def dryrun(cfg, shape: InputShape, layout: tuple[int, int], *,
           cost: bool = True) -> dict:
    """Phases A and B of ``cfg`` at ``shape`` over ``layout`` ``(p, mp)``;
    the record's keys are the module docstring's. A kernel's refusal gives
    status ``REFUSED`` and its message."""
    p, mp = layout
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": f"{p}x{mp}",
           "cards": p * mp, "mode": shape.mode, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch}
    run, held, group_batch = _prepare(cfg, shape, p, mp)
    rec["group_batch"] = group_batch
    args = [_nbytes(held[m]) for m in range(mp)]
    meter = StepMeter(mp, count=cost)
    for m, tensors in held.items():
        meter.hold(tensors, m)
    flops = FlopCounterMode(display=False)
    COSTS.reset()
    COLLECTIVES.reset()
    t0 = time.monotonic()
    try:
        with flops if cost else contextlib.nullcontext(), meter, \
                placing(meter.place), COSTS.locating(meter.slot_of):
            out = run()
    except KernelRefusal as e:
        return {**rec, "status": "REFUSED", "refused_by": _kernel_of(e),
                "error": f"{type(e).__name__}: {e}"}
    rec["step_s"] = time.monotonic() - t0
    peak = [a + t for a, t in zip(args, meter.peak)]
    rec.update({
        "status": "OK", "arg_bytes": args[0], "arg_bytes_by_slot": args,
        "temp_bytes": meter.peak[0], "temp_bytes_by_slot": meter.peak,
        "output_bytes": _output_bytes(out),
        "per_device_bytes": max(peak), "fits": max(peak) <= H.HBM_BYTES})
    del out
    if not cost:
        return rec
    kernels = COSTS.snapshot()
    sent, data_sent = [0] * mp, [0] * mp
    breakdown: dict[str, int] = {}
    for (kind, slot), n in COLLECTIVES.snapshot().items():
        sent[slot] += n
        if kind in DATA_AXIS:
            data_sent[slot] += n
        breakdown[kind] = breakdown.get(kind, 0) + n
    f_slot, b_slot = list(meter.flops), list(meter.bytes)
    for slot, (f, b) in kernels["by_slot"].items():
        f_slot[slot] += f
        b_slot[slot] += b
    group_flops = flops.get_total_flops() + sum(kernels["flops"].values())
    if group_flops != sum(f_slot):
        raise RuntimeError(f"the slots' flops {sum(f_slot)} are not the "
                           f"step's {group_flops}")
    data_bw = H.data_link_bw(p, mp)
    t = {"compute": max(f_slot) / H.PEAK_FLOPS[cfg.compute_dtype],
         "memory": max(b_slot) / H.HBM_BW,
         "collective": max((n - dn) / H.NVLINK_BW + dn / data_bw
                           for n, dn in zip(sent, data_sent))}
    active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.mode != "decode"
                                   else 1)
    model_flops = (6 if shape.mode == "train" else 2) * active * tokens
    rec.update({
        "flops_per_slot": max(f_slot), "flops_by_slot": f_slot,
        "bytes_per_slot": max(b_slot), "bytes_by_slot": b_slot,
        "collective_bytes_per_slot": max(sent),
        "collective_bytes_by_slot": sent,
        "data_collective_bytes_per_slot": max(data_sent),
        "data_link": "nvlink" if data_bw == H.NVLINK_BW else "infiniband",
        "collective_breakdown": breakdown,
        "kernel_flops": {k: n for k, n in kernels["flops"].items() if n},
        "kernel_bytes": {k: n for k, n in kernels["bytes"].items() if n},
        "t_compute_s": t["compute"], "t_memory_s": t["memory"],
        "t_collective_s": t["collective"], "dominant": max(t, key=t.get),
        "params": cfg.param_count(), "active_params": active,
        "model_flops": model_flops,
        "useful_flops_ratio": model_flops / max(group_flops * p, 1.0)})
    return rec


def _kernel_of(e: KernelRefusal) -> str:
    """The ops module whose check refused: the innermost frame's."""
    tb = e.__traceback__
    while tb.tb_next is not None:
        tb = tb.tb_next
    path = tb.tb_frame.f_code.co_filename
    return os.path.basename(os.path.dirname(path)) + "/" + \
        os.path.basename(path)


def dryrun_one(arch: str, shape_name: str, *, cost: bool = True,
               verbose: bool = True,
               mesh_override: tuple[int, int] | None = None) -> dict:
    """``dryrun`` of the full CONFIG of ``arch`` at ``INPUT_SHAPES
    [shape_name]`` over ``mesh_override`` or ``production_layout()``;
    ``long_500k`` is skipped for a config that is not sub-quadratic, as in
    the reference."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    layout = mesh_override or H.production_layout()
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return {"arch": arch, "shape": shape_name, "status": "SKIP",
                "mesh": f"{layout[0]}x{layout[1]}",
                "reason": "pure full-attention arch; long-context decode "
                          "requires sub-quadratic attention"}
    rec = dict(dryrun(cfg, shape, layout, cost=cost), arch=arch)
    if verbose:
        print(json.dumps(rec, indent=1))
    return rec


def parse_mesh(text: str) -> tuple[int, int]:
    p, mp = (int(x) for x in text.split(","))
    if p < 1 or mp < 1:
        raise argparse.ArgumentTypeError(f"bad layout {text!r}")
    return p, mp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the dry-run on meta tensors (see the module docstring)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="phase A only (the step on meta, its bytes)")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="the layout P,M (default "
                         f"{','.join(map(str, H.production_layout()))})")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--resume", action="store_true",
                    help="skip pairs already recorded in --out")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the port has no multi-host pool (A9)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod is refused: the port has no multi-host pool "
                 "yet (ROADMAP A9)")
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    layout = args.mesh or H.production_layout()
    mesh = f"{layout[0]}x{layout[1]}"
    if args.resume and args.out and os.path.exists(args.out):
        done = set()
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("OK", "SKIP", "REFUSED") \
                        and r.get("mesh") == mesh:
                    done.add((r["arch"], r["shape"]))
        pairs = [p_ for p_ in pairs if p_ not in done]
        print(f"resume: {len(done)} done, {len(pairs)} remaining", flush=True)

    failures = 0
    for arch, shape in pairs:
        t0 = time.monotonic()
        try:
            r = dryrun_one(arch, shape, cost=not args.no_cost,
                           verbose=not args.out, mesh_override=layout)
        except Exception as e:  # a step that does not cohere: a port bug
            r = {"arch": arch, "shape": shape, "status": "FAIL",
                 "mesh": mesh, "error": f"{type(e).__name__}: {e}"}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
            print(f"{arch} x {shape} [{r['mesh']}]: {r['status']} "
                  f"({time.monotonic() - t0:.0f}s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
