"""The train state laid out FSDP-style over (p, mp) on the CPU: each slot
of the live trainer holds exactly its boxes of the reference's layout, the
trainer at (2, 1) and (2, 2) against the JAX trainer itself at those
layouts (losses, and every device's shard of params and both AdamW moments
against the port's slot of the same mesh index), the default step against
a hand-built gather, group-ordered sum and AdamW on the same boxes, and the
switches' records: a reshape's bytes are the reference planner's, a
scale-out copies bytes behind the step and stays stop-free."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.reshape import flatten_tree, plan_reshard, shard_state, \
    unflatten_tree
from repro_torch.training.step import init_train_state, loss_and_grads, \
    make_train_step, port_layout, shard_batch

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("edl-paper", "rwkv6-1.6b", "mixtral-8x7b", "deepseek-v2-236b",
         "jamba-v0.1-52b")
# every (p, mp) of a 4-slot budget
LAYOUTS = [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (1, 4)]
OPT = adamw(1e-3)
# the trajectories against the JAX trainer: 3 AdamW 1e-3 steps on fresh
# batches of 4 x 32 (test_torch_tp_zoo.py's data) from the JAX init with
# its stacked layer matrices rescaled to 1/sqrt(d_in). Losses within
# TRAJ_RTOL (test_torch_trainer.py's). Each leaf's shard against the
# port's box, norm-wise: of params, the update (the shard less its initial
# value); of the moments, the moment; its error over its norm within
# the arch's UPDATE_MARGIN. AdamW's first steps move every element by
# about lr whatever its gradient's size, so a gradient near 0 whose sign
# the other summation order flips moves its element by 2 lr: elementwise
# limits cannot hold, norm-wise ones can. Measured (both SMOKEs fp32):
# edl_paper at most 7.1e-4 (params), 2.4e-5 (moments); rwkv6, whose
# gradients are ill-conditioned from this init (test_torch_tp_zoo.py), at
# most 2.3e-2 (params) and 8.5e-3 (moments) at (2, 2), and already 6.3e-3
# and 1.4e-3 at (1, 1); losses within 2.8e-6. A step that skips the
# division by p moves no loss past TRAJ_RTOL, but its moments err by 1.0
# (mu) and 3.0 (nu).
BATCH, SEQ, N_SAMPLES, D_PARTS, STEPS = 4, 32, 64, 8, 3
TRAJ_RTOL = 1e-4
UPDATE_MARGIN = {"edl-paper": 5e-3, "rwkv6-1.6b": 5e-2}
JAX_ARCHS = ("edl-paper", "rwkv6-1.6b")
JAX_LAYOUTS = ((2, 1), (2, 2))

_JAX_FSDP = r"""
import json, os, sys
import jax
import numpy as np
sys.path.insert(0, {tests!r})
from test_torch_model import _fan_in_scaled
from repro.configs import get_config
from repro.core import ElasticTrainer


def flat(tree, pre=""):
    out = {{}}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


out = {{}}
for arch in {archs!r}:
    for p, mp in {layouts!r}:
        jt = ElasticTrainer(get_config(arch, smoke=True), global_batch={b},
                            seq_len={s}, init_parallelism=p,
                            model_parallel=mp, n_samples={n},
                            d_partitions={d}, seed=0,
                            devices=jax.devices()[:p * mp], use_aot=False)
        state = jax.tree.map(np.asarray, jt.state)
        state["params"] = _fan_in_scaled(state["params"])
        jt.state = jax.tree.map(
            lambda a, old: jax.device_put(a, old.sharding), state,
            jt.state)
        name = f"{{arch}}_{{p}}x{{mp}}"
        np.savez(os.path.join({out!r}, name + "_init.npz"),
                 **{{k: np.asarray(v) for k, v in flat(state).items()}})
        losses = [jt.step()["loss"] for _ in range({steps})]
        order = list(jt.exec.mesh.devices.reshape(-1))
        shards = {{}}
        for k, a in flat(jt.state).items():
            for sh in a.addressable_shards:
                shards[f"{{k}}@{{order.index(sh.device)}}"] = \
                    np.asarray(sh.data)
        np.savez(os.path.join({out!r}, name + "_shards.npz"), **shards)
        out[name] = losses
print(json.dumps(out))
"""


def _trainer(cfg, p, mp, **kw):
    return ElasticTrainer(cfg, global_batch=BATCH, seq_len=SEQ,
                          init_parallelism=p, model_parallel=mp,
                          optimizer=OPT, n_samples=N_SAMPLES,
                          d_partitions=D_PARTS, seed=0,
                          devices=["cpu"] * 4, device="cpu", **kw)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


# ------------------------------------------------- each slot its boxes
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_slots_hold_their_boxes_of_the_references_layout(arch, layout):
    """``port_layout`` is the reference's ``StateSpec.for_config``, data
    axis included; the live trainer's slot trees are
    ``shard_state(layout, whole)`` of its initial state in shape and bits,
    no tensor on a storage larger than itself (no slot keeps a view of a
    larger tensor), and after a step they are still the boxes of one whole
    state (the copies of a replicated leaf stayed the same bits)."""
    from repro.configs import get_config as jax_get_config
    from repro.optim import adamw as jax_adamw
    from repro.reshape import StateSpec as JaxStateSpec
    p, mp = layout
    cfg = get_config(arch, smoke=True)
    spec = port_layout(cfg, OPT, p, mp)
    assert spec.to_json() == JaxStateSpec.for_config(
        jax_get_config(arch, smoke=True), jax_adamw(1e-3), p,
        mp).to_json()
    whole = bridge.to_numpy(init_train_state(
        cfg, OPT, torch.Generator().manual_seed(0), "cpu"))
    with _trainer(cfg, p, mp, use_aot=False) as t:
        assert t.exec.layout == spec and len(t.state) == p * mp
        for _ in range(2):
            want = shard_state(spec, whole)
            for i, (slot, box) in enumerate(zip(t.state, want)):
                got = flatten_tree(slot)
                assert got.keys() == box.keys()
                for k, w in box.items():
                    g = got[k]
                    assert tuple(g.shape) == w.shape, (i, k)
                    assert g.untyped_storage().nbytes() <= g.nbytes, (i, k)
                    np.testing.assert_array_equal(_numpy(g), w,
                                                  err_msg=f"{i} {k}")
            t.step()
            whole = bridge.to_numpy(t.whole_state())


# ----------------------------------------- against the JAX trainer
@pytest.fixture(scope="module")
def jax_fsdp(tmp_path_factory):
    """The JAX trainer at (2, 1) and (2, 2) on four forced host devices,
    for each of ``JAX_ARCHS``: its rescaled initial state, its losses and
    every device's shard after ``STEPS`` steps, from one subprocess."""
    out = str(tmp_path_factory.mktemp("jax_fsdp"))
    script = _JAX_FSDP.format(
        tests=os.path.dirname(__file__), archs=JAX_ARCHS,
        layouts=JAX_LAYOUTS, b=BATCH, s=SEQ, n=N_SAMPLES, d=D_PARTS,
        steps=STEPS, out=out)
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    run = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    losses = json.loads(run.stdout.strip().splitlines()[-1])
    runs = {}
    for name, ls in losses.items():
        with np.load(os.path.join(out, name + "_init.npz")) as z:
            init = {k: z[k] for k in z.files}
        with np.load(os.path.join(out, name + "_shards.npz")) as z:
            shards = {k: z[k] for k in z.files}
        runs[name] = (init, np.array(ls), shards)
    return runs


def _norm_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("layout", JAX_LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_fsdp_trainer_matches_the_jax_trainer(arch, layout, jax_fsdp):
    """The port at (2, mp) from the JAX trainer's state and data: losses
    within TRAJ_RTOL, and the box of every leaf of params, mu and nu on
    slot i within UPDATE_MARGIN of the JAX trainer's shard on the device
    of mesh index i (params by their update)."""
    p, mp = layout
    init, want, jshards = jax_fsdp[f"{arch}_{p}x{mp}"]
    cfg = get_config(arch, smoke=True)
    tol = UPDATE_MARGIN[arch]
    with _trainer(cfg, p, mp, use_aot=False) as t:
        state = unflatten_tree(init)
        t.state = bridge.shard_state_from_numpy(state, t.exec.layout,
                                                t.exec.devices)
        start = shard_state(t.exec.layout, state)
        got = np.array([t.step()["loss"] for _ in range(STEPS)])
        slots = [flatten_tree(s) for s in t.state]
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    assert len(jshards) == p * mp * len(slots[0])
    for i, slot in enumerate(slots):
        for k, g in slot.items():
            w = jshards[f"{k}@{i}"].astype(np.float32)
            g = _numpy(g)
            assert g.shape == w.shape, (i, k)
            if not g.shape:
                assert g == w, (i, k)
                continue
            if k.startswith("params/"):
                s0 = start[i][k].astype(np.float32)
                g, w = g - s0, w - s0
            assert _norm_err(g, w) <= tol, (i, k, _norm_err(g, w))


# ------------------------------------------------- the step's arithmetic
def test_default_step_is_gather_group_sum_and_adamw_bit_for_bit():
    """The default step at (2, 1) on edl_paper SMOKE equals, bit for bit,
    the step built by hand on the same boxes: the whole params from the two
    data boxes, each group's gradients on its half of the batch, summed in
    group order and divided by 2, sliced into the boxes and handed to
    AdamW slot by slot."""
    cfg = get_config("edl-paper", smoke=True)
    layout = port_layout(cfg, OPT, 2, 1)
    whole = init_train_state(cfg, OPT, torch.Generator().manual_seed(0),
                             "cpu")
    slots = bridge.shard_state_from_numpy(bridge.to_numpy(whole), layout,
                                          ["cpu"] * 2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (BATCH, SEQ), dtype=np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    new, metrics = make_train_step(cfg, OPT, ["cpu"] * 2)(slots, batch)

    grads = [loss_and_grads(cfg, whole["params"], shard)[2]
             for shard in shard_batch(batch, 2, ["cpu"] * 2)]
    summed = {k: (g + dict(tree_leaves(grads[1]))[k]) / 2
              for k, g in tree_leaves(grads[0])}
    for i, slot in enumerate(slots):
        boxes = {}
        for k, g in summed.items():
            box = layout.layout("params/" + k).box(2, 1, i)
            boxes[k] = g[tuple(slice(lo, hi) for lo, hi in box)]
        params, opt = OPT.update(unflatten_tree(boxes), slot["opt"],
                                 slot["params"])
        want = flatten_tree({"params": params, "opt": opt})
        got = flatten_tree(new[i])
        for k, w in want.items():
            assert torch.equal(got[k], w), (i, k)
    assert torch.isfinite(metrics["grad_norm"])


# ------------------------------------------------------- the switches
def test_reshape_records_the_reference_planners_bytes():
    """A live reshape (4, 1) -> (2, 2) records the reference planner's
    ``bytes_moved`` and ``bytes_kept`` for the same layouts, commits
    stop-free, and leaves each slot its boxes."""
    from repro.configs import get_config as jax_get_config
    from repro.optim import adamw as jax_adamw
    from repro.reshape import StateSpec as JaxStateSpec
    from repro.reshape import plan_reshard as jax_plan_reshard
    cfg = get_config("edl-paper", smoke=True)
    jcfg = jax_get_config("edl-paper", smoke=True)
    jplan = jax_plan_reshard(JaxStateSpec.for_config(jcfg, jax_adamw(1e-3),
                                                     4, 1),
                             JaxStateSpec.for_config(jcfg, jax_adamw(1e-3),
                                                     2, 2))
    with _trainer(cfg, 4, 1) as t:
        t.run(1)
        rec = t.reshape(2, 2, block=True)
        whole = bridge.to_numpy(t.whole_state())
        for slot, box in zip(t.state, shard_state(t.exec.layout, whole)):
            got = flatten_tree(slot)
            assert all(tuple(got[k].shape) == b.shape
                       for k, b in box.items())
    assert (rec.op, rec.to_p, rec.to_mp) == ("reshape", 2, 2)
    assert (rec.reshard_bytes_moved, rec.reshard_bytes_kept) == (
        jplan.bytes_moved, jplan.bytes_kept)
    assert rec.reshard_bytes_moved > 0 and rec.stop_time < rec.prep_time


def test_scale_out_copies_the_state_behind_the_step_stop_free():
    """A scale-out 1 -> 2 splits every FSDP leaf in two: the staged move
    copies the bytes of the split leaves' boxes (a replicated leaf is
    handed over as it is), the stop is shorter than the prep, and the
    plan's bytes moved are the half of the split leaves that leaves slot 0
    and slot 1's copy of the replicated ones (on the one CPU device that
    copy is the same tensor)."""
    cfg = get_config("edl-paper", smoke=True)
    with _trainer(cfg, 1, 1) as t:
        t.run(1)
        rec = t.scale_out(1, block=True)
        layout = t.exec.layout
        split = {x.path for x in layout.tensors if "data" in x.axes}
        boxes = sum(v.nbytes for s in t.state
                    for k, v in flatten_tree(s).items() if k in split)
        copies = sum(v.nbytes for k, v in flatten_tree(t.state[1]).items()
                     if k not in split)
    plan = plan_reshard(port_layout(cfg, OPT, 1, 1), layout)
    assert (rec.op, rec.to_p) == ("scale_out", 2)
    assert rec.t_stage_end > 0.0, "the state move was not staged"
    assert rec.bytes_moved_overlapped == boxes > 0
    assert plan.bytes_moved == boxes // 2 + copies
    assert rec.stop_time < rec.prep_time, rec.summary()
