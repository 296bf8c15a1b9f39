"""The port's reshape package on the CPU: ``StateSpec.for_config`` and the
planner against the JAX package's for every ``(dp, mp)`` pair of a
4-slot budget (edl_paper and rwkv6 SMOKE), the twins of the fast
properties of ``tests/test_reshape.py`` on the port's own train state, the
live executor ``apply_plan`` on torch tensors against the numpy one, and
the checkpoint saved at (2, 2) resuming at (4, 1)."""
import functools
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer, checkpoint_save, \
    resume_from_checkpoint
from repro_torch.optim import adamw
from repro_torch.reshape import StateSpec, apply_plan, apply_plan_host, \
    assemble_state, flatten_tree, gather_state, place_state, plan_reshard, \
    shard_state, unflatten_tree
from repro_torch.reshape.spec import TensorLayout
from repro_torch.training.step import init_train_state, port_layout

# every (dp, mp) shape that fits a 4-slot budget, incl. non-power-of-2
SHAPES = [(dp, mp) for dp, mp in itertools.product((1, 2, 3, 4), repeat=2)
          if dp * mp <= 4]
ARCHS = ("edl-paper", "rwkv6-1.6b")
OPT = adamw(1e-3)


@functools.lru_cache(maxsize=None)
def _state(arch):
    """The port's own train state (SMOKE params + AdamW moments +
    counters) as numpy, and its layouts by the reference's rule."""
    cfg = get_config(arch, smoke=True)
    state = init_train_state(cfg, OPT, torch.Generator().manual_seed(0),
                             "cpu")
    specs = {shape: StateSpec.for_config(cfg, OPT, *shape)
             for shape in SHAPES}
    return bridge.to_numpy(state), specs


@functools.lru_cache(maxsize=None)
def _jax_specs(arch):
    from repro.configs import get_config as jax_get_config
    from repro.optim import adamw as jax_adamw
    from repro.reshape import StateSpec as JaxStateSpec
    cfg = jax_get_config(arch, smoke=True)
    return {shape: JaxStateSpec.for_config(cfg, jax_adamw(1e-3), *shape)
            for shape in SHAPES}


# ------------------------------------------------------ parity with JAX
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_for_config_matches_the_reference(arch, shape):
    _, specs = _state(arch)
    assert specs[shape].to_json() == _jax_specs(arch)[shape].to_json()


@pytest.mark.parametrize("src", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_and_host_moves_match_the_reference(arch, src):
    """From ``src`` to every other shape: the same plan summary as the
    reference's planner, and the same shards out of ``apply_plan_host``."""
    from repro.reshape import apply_plan_host as jax_apply_plan_host
    from repro.reshape import plan_reshard as jax_plan_reshard
    from repro.reshape import shard_state as jax_shard_state
    state, specs = _state(arch)
    jspecs = _jax_specs(arch)
    shards = shard_state(specs[src], state)
    jshards = jax_shard_state(jspecs[src], state)
    for dst in SHAPES:
        if dst == src:
            continue
        plan = plan_reshard(specs[src], specs[dst])
        jplan = jax_plan_reshard(jspecs[src], jspecs[dst])
        assert plan.summary() == jplan.summary(), (src, dst)
        got = apply_plan_host(plan, shards)
        want = jax_apply_plan_host(jplan, jshards)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------- twins of tests/test_reshape.py
def test_state_spec_layouts_follow_the_sharding_rules():
    state, specs = _state("edl-paper")
    spec = specs[(2, 2)]
    flat = flatten_tree(state)
    assert {t.path for t in spec.tensors} == set(flat)
    assert all(t.shape == flat[t.path].shape for t in spec.tensors)
    # replicated scalars stay replicated; some tensor uses each mesh axis
    assert spec.layout("step").axes == ()
    axes_used = {a for t in spec.tensors for a in t.axes if a}
    assert axes_used == {"data", "model"}
    # moments shard exactly like their parameters
    for t in spec.tensors:
        if t.path.startswith("params/"):
            mu = spec.layout("opt/mu/" + t.path[len("params/"):])
            assert mu.axes == t.axes
    # the port's trainer keeps the data axis replicated, model entries equal
    port = spec.data_replicated()
    assert port == port_layout(get_config("edl-paper", smoke=True), OPT, 2,
                               2)
    for a, b in zip(spec.tensors, port.tensors):
        assert b.axes == tuple(None if x == "data" else x for x in a.axes)


def test_state_spec_json_round_trip():
    _, specs = _state("edl-paper")
    for spec in specs.values():
        for s in (spec, spec.data_replicated()):
            assert StateSpec.from_json(json.loads(
                json.dumps(s.to_json()))) == s


def test_shard_boxes_tile_the_tensor():
    t = TensorLayout("w", (8, 6), ("data", "model"))
    boxes = [t.box(2, 2, i) for i in range(4)]
    assert boxes[0] == ((0, 4), (0, 3)) and boxes[3] == ((4, 8), (3, 6))
    # non-divisible dims are left whole by construction (spec_for rule)
    t3 = TensorLayout("w", (8, 5), ("data", None))
    assert t3.box(2, 1, 1) == ((4, 8), (0, 5))


def test_identity_plan_moves_nothing():
    _, specs = _state("edl-paper")
    for spec in specs.values():
        plan = plan_reshard(spec, spec)
        assert plan.bytes_moved == 0
        assert all(m.kind == "keep" for m in plan.moves)


def test_plan_classifies_pure_data_axis_moves():
    _, specs = _state("edl-paper")
    # dp 4 -> 2 with mp fixed: every data-sharded tensor coarsens
    plan = plan_reshard(specs[(4, 1)], specs[(2, 1)])
    kinds = {m.kind for m in plan.moves}
    assert kinds <= {"keep", "allgather"}
    assert any(m.kind == "allgather" for m in plan.moves)
    # and the reverse refines
    back = plan_reshard(specs[(2, 1)], specs[(4, 1)])
    assert any(m.kind == "slice" for m in back.moves)
    # trading data for model parallelism mixes both: a general reshard
    swap = plan_reshard(specs[(4, 1)], specs[(2, 2)])
    assert any(m.kind == "reshard" for m in swap.moves)
    assert swap.bytes_moved > 0 and swap.bytes_kept > 0


def test_plan_rejects_mismatched_collections():
    _, specs = _state("edl-paper")
    src = specs[(2, 1)]
    missing = StateSpec(2, 1, src.tensors[:-1])
    with pytest.raises(ValueError, match="lacks"):
        plan_reshard(src, missing)
    with pytest.raises(ValueError, match="missing from"):
        plan_reshard(missing, src)
    t0 = next(t for t in src.tensors if t.shape)     # first non-scalar
    resized = StateSpec(2, 1, tuple(
        TensorLayout(t.path, tuple(d + 1 for d in t.shape), t.axes)
        if t.path == t0.path else t for t in src.tensors))
    with pytest.raises(ValueError, match="shape changed"):
        plan_reshard(src, resized)


@pytest.mark.parametrize("layouts", ["reference", "port"])
def test_reshard_round_trip_is_identity_for_every_shape_pair(layouts):
    """apply(plan(a, b)) then apply(plan(b, a)) gives every source shard
    back bit for bit, and the intermediate assembles to the original —
    through the numpy executor on the reference's layouts and the live
    torch executor on both the reference's and the port's own."""
    state, specs = _state("edl-paper")
    if layouts == "port":
        specs = {k: s.data_replicated() for k, s in specs.items()}
    flat = flatten_tree(state)
    tflat = {k: torch.from_numpy(v) for k, v in flat.items()}
    for sa, sb in itertools.permutations(SHAPES, 2):
        a, b = specs[sa], specs[sb]
        if layouts == "reference":
            shards_a = shard_state(a, state)
            shards_b = apply_plan_host(plan_reshard(a, b), shards_a)
            asm = flatten_tree(assemble_state(b, shards_b))
            for path in flat:
                assert np.array_equal(flat[path], asm[path]), (sa, sb, path)
            back = apply_plan_host(plan_reshard(b, a), shards_b)
            for orig, rt in zip(shards_a, back):
                for path in orig:
                    assert np.array_equal(orig[path], rt[path])
        t_a = apply_plan(plan_reshard(_whole(a), a), [tflat],
                         ["cpu"] * a.n_devices)
        t_b = apply_plan(plan_reshard(a, b), t_a, ["cpu"] * b.n_devices)
        asm = flatten_tree(gather_state(b, [unflatten_tree(s) for s in t_b]))
        for path in flat:
            assert torch.equal(asm[path], tflat[path]), (sa, sb, path)
        t_back = apply_plan(plan_reshard(b, a), t_b, ["cpu"] * a.n_devices)
        for i, (orig, rt) in enumerate(zip(t_a, t_back)):
            for path in orig:
                assert torch.equal(orig[path], rt[path]), \
                    f"{sa}->{sb}->{sa} slot {i} corrupted {path}"


def test_moved_bytes_accounting_is_consistent():
    """bytes_moved + bytes_kept covers exactly the destination shards, and
    a same-device-count transpose keeps something local."""
    _, specs = _state("edl-paper")
    for sa, sb in [((4, 1), (2, 2)), ((2, 2), (4, 1)), ((2, 1), (1, 2))]:
        plan = plan_reshard(specs[sa], specs[sb])
        total = 0
        for t in specs[sb].tensors:
            per_slot = t.n_elements
            for f in t.factors(*sb):
                per_slot //= f
            total += per_slot * specs[sb].n_devices * 4
        assert plan.bytes_moved + plan.bytes_kept == total, (sa, sb)
        assert plan.bytes_kept > 0, (sa, sb)


# ------------------------------------------------------- live executor
def _whole(spec):
    return StateSpec(1, 1, tuple(TensorLayout(t.path, t.shape,
                                              (None,) * len(t.shape))
                                 for t in spec.tensors))


@pytest.mark.parametrize("src", SHAPES)
def test_live_apply_plan_matches_the_host_executor(src):
    """``apply_plan`` on torch shards gives ``apply_plan_host``'s shards for
    every destination shape; a ``keep`` move hands over the source tensor
    itself, and a destination slot that holds its box already copies
    nothing from another slot."""
    state, specs = _state("edl-paper")
    a = specs[src]
    host_a = shard_state(a, state)
    live_a = [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
              for s in host_a]
    for dst in SHAPES:
        b = specs[dst]
        plan = plan_reshard(a, b)
        want = apply_plan_host(plan, host_a)
        got = apply_plan(plan, live_a, ["cpu"] * b.n_devices)
        for i, (g, w) in enumerate(zip(got, want)):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k])
                if plan.move(k).kind == "keep" and i < a.n_devices and \
                        a.layout(k).box(a.dp, a.mp, i) == \
                        b.layout(k).box(b.dp, b.mp, i):
                    assert g[k] is live_a[i][k], (src, dst, k)


def test_apply_plan_fills_a_leading_subset_of_slots():
    state, specs = _state("edl-paper")
    a, b = specs[(1, 4)], specs[(2, 2)]
    shards = [{k: torch.from_numpy(np.asarray(v)) for k, v in s.items()}
              for s in shard_state(a, state)]
    got = apply_plan(plan_reshard(a, b), shards, ["cpu"] * 2)
    want = apply_plan_host(plan_reshard(a, b), shard_state(a, state))[:2]
    assert len(got) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    with pytest.raises(ValueError, match="destination"):
        apply_plan(plan_reshard(a, b), shards, ["cpu"] * 5)
    with pytest.raises(ValueError, match="source"):
        apply_plan(plan_reshard(a, b), shards[:3], ["cpu"])


def test_bridge_lands_a_numpy_state_on_the_model_shards():
    """``bridge.shard_state_from_numpy`` puts a numpy state on the slots of
    any (dp, mp), as ``place_state`` puts the same tensors."""
    state, _ = _state("edl-paper")
    cfg = get_config("edl-paper", smoke=True)
    tstate = unflatten_tree({k: torch.from_numpy(v)
                             for k, v in flatten_tree(state).items()})
    for shape in SHAPES:
        spec = port_layout(cfg, OPT, *shape)
        got = bridge.shard_state_from_numpy(state, spec, ["cpu"] * shape[1])
        want = place_state(spec, tstate, ["cpu"] * shape[1])
        shards = got if isinstance(got, list) else [got]
        assert len(shards) == shape[1]
        for g, w in zip(shards, want):
            fg, fw = flatten_tree(g), flatten_tree(w)
            assert all(torch.equal(fg[k], fw[k]) for k in fw)


# ------------------------------------- checkpoint-based reparallelization
def test_checkpoint_saved_at_2x2_resumes_at_4x1_same_loss_trajectory(
        tmp_path):
    """Twin of the reference's test: a checkpoint written at (2, 2)
    restores onto (4, 1) — the planner plans the restore from the saved
    layout — and the resumed losses follow the uninterrupted (2, 2) run's.
    The dataset is one global batch, so the batch content is the same at
    every shape."""
    cfg = get_config("edl-paper", smoke=True)

    def make(p, mp):
        return ElasticTrainer(cfg, global_batch=12, seq_len=32,
                              init_parallelism=p, model_parallel=mp,
                              optimizer=adamw(1e-3), n_samples=12,
                              d_partitions=4, seed=0, devices=["cpu"] * 4,
                              device="cpu", use_aot=False)

    with make(2, 2) as t1:
        for _ in range(3):
            t1.step()
        checkpoint_save(t1, str(tmp_path))
        ref = [t1.step()["loss"] for _ in range(3)]
    with make(4, 1) as t2:
        meta = resume_from_checkpoint(t2, str(tmp_path))
        assert t2.step_idx == 3
        got = [t2.step()["loss"] for _ in range(3)]
    assert meta["extra"]["p"] == 2 and meta["extra"]["mp"] == 2
    assert meta["reshard"]["from"] == [2, 2]
    assert meta["reshard"]["to"] == [4, 1]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
