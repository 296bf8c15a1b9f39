"""The default step's params held as the reference's scan holds them, on
the CPU: one period of layers gathered over the data axis at a time,
gathered again in the backward, and each period's gradients
reduce-scattered as the backward leaves it (``parallel.FsdpGroup``,
``parallel.GradBoxes``, ``training/step.py: fsdp_group_step``).

  * the step equals its whole-gather plain version
    (``make_whole_gather_step``) bit for bit, two steps from one seeded
    state, at (2, 1), (2, 2) and (4, 1): edl_paper (no remat), rwkv6 with
    remat, jamba and mixtral (MoE, the routing pre-pass at p > 1) and
    edl_paper at 4 layers in grouped remat (``remat_group`` 2);
  * a census of the gathered tensors (weak references to
    ``all_gather_data``'s outputs): at no gather is a gathered layer row of
    another period alive than the one gathered, nor more leaves outside
    ``layers`` than one group's; after a group's backward none of its
    gathered gradients is;
  * the dry-run's peak of a SMOKE at (4, 1), four times as deep, falls
    below the whole-gather form's by at least the layer params it no
    longer holds gathered, its reduce-scatter bytes the same and its
    gather bytes those of the backward's gathering again on top.

The step against the JAX trainer itself: ``test_torch_fsdp.py`` and
``test_torch_fsdp_moe.py``, which run this step."""
import dataclasses
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import bridge, parallel
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun as D
from repro_torch.models.blocks import scan_plan
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.reshape import flatten_tree
from repro_torch.training import step as S

OPT = adamw(1e-3)
BATCH, SEQ, STEPS = 8, 32, 2
LAYOUTS = [(2, 1), (2, 2), (4, 1)]
# name: (arch, changes to its SMOKE)
CASES = {
    "edl_paper": ("edl-paper", {}),
    "rwkv6_remat": ("rwkv6-1.6b", {"remat": True}),
    "jamba": ("jamba-v0.1-52b", {}),
    "mixtral": ("mixtral-8x7b", {}),
    "edl_paper_grouped_remat": ("edl-paper", {"n_layers": 4, "remat": True,
                                              "remat_group": 2}),
}


def _cfg(case: str):
    arch, changes = CASES[case]
    return dataclasses.replace(get_config(arch, smoke=True), **changes)


def _batch(cfg, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _slots(cfg, p: int, mp: int) -> list[dict]:
    whole = S.init_train_state(cfg, OPT, torch.Generator().manual_seed(0),
                               "cpu")
    return bridge.shard_state_from_numpy(
        bridge.to_numpy(whole), S.port_layout(cfg, OPT, p, mp),
        ["cpu"] * (p * mp))


def _steps(make, cfg, p: int, mp: int) -> list:
    step = make(cfg, OPT, ["cpu"] * (p * mp), mp=mp)
    state, out = _slots(cfg, p, mp), []
    for _ in range(STEPS):
        state, metrics = step(state, _batch(cfg))
        out.append((metrics, [flatten_tree(s) for s in state]))
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_period_step_is_the_whole_gather_step_bit_for_bit(case, layout):
    cfg = _cfg(case)
    got = _steps(S.make_train_step, cfg, *layout)
    want = _steps(S.make_whole_gather_step, cfg, *layout)
    for n, ((gm, gs), (wm, ws)) in enumerate(zip(got, want)):
        assert set(gm) == set(wm)
        for k in wm:
            assert torch.equal(gm[k], wm[k]), (n, k, gm[k], wm[k])
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert g.keys() == w.keys()
            for k in w:
                assert torch.equal(g[k], w[k]), (n, i, k)


# ---------------------------------------------------------------- census
class Census:
    """Weak references to every tensor ``all_gather_data`` gives, each
    tagged with the row ``gather_box`` asked for (None outside ``layers``),
    and to every gradient ``GradBoxes.add`` takes."""

    def __init__(self, monkeypatch, n_outer: int):
        self.gathered: list[tuple[int | None, weakref.ref]] = []
        self.grads: list[weakref.ref] = []
        self.n_outer = n_outer
        self.row = None
        self.rows: set = set()          # every row gathered
        self.checks = 0
        gather_box, all_gather = parallel.gather_box, parallel.all_gather_data
        add = parallel.GradBoxes.add
        group_step = S.fsdp_group_step

        def tagged_gather_box(boxes, d, dim, device, slot, row=None):
            self.row = row
            self.check(row)
            return gather_box(boxes, d, dim, device, slot, row)

        def recorded_all_gather(*args):
            out = all_gather(*args)
            self.gathered.append((self.row, weakref.ref(out)))
            self.rows.add(self.row)
            return out

        def recorded_add(boxes, d, m, path, row, g):
            self.grads.append(weakref.ref(g))
            return add(boxes, d, m, path, row, g)

        def checked_group_step(*args, **kw):
            out = group_step(*args, **kw)
            gc.collect()
            alive = [r for r in self.grads if r() is not None]
            assert not alive, f"{len(alive)} gradients outlive the backward"
            assert not self.alive(), "gathered leaves outlive the group"
            self.grads.clear()
            return out

        monkeypatch.setattr(parallel, "gather_box", tagged_gather_box)
        monkeypatch.setattr(parallel, "all_gather_data", recorded_all_gather)
        monkeypatch.setattr(parallel.GradBoxes, "add", recorded_add)
        monkeypatch.setattr(S, "fsdp_group_step", checked_group_step)

    def alive(self) -> list:
        self.gathered = [(row, r) for row, r in self.gathered
                         if r() is not None]
        return self.gathered

    def check(self, row):
        """At a gather of ``row``: no layer row of another period alive,
        and at most one group's leaves outside ``layers``."""
        self.checks += 1

        def wrong():
            rows = {r for r, _ in self.alive() if r is not None}
            outer = sum(r is None for r, _ in self.alive())
            return rows - {row}, outer
        if wrong()[0] or wrong()[1] > self.n_outer:
            gc.collect()        # cycles aside, refcounts free at once
        stale, outer = wrong()
        assert not stale, f"rows {stale} alive at a gather of row {row}"
        assert outer <= self.n_outer, f"{outer} outer leaves alive"


@pytest.mark.parametrize("layout", [(2, 1), (2, 2)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("case", ["edl_paper", "rwkv6_remat", "mixtral",
                                  "edl_paper_grouped_remat"])
def test_census_holds_one_period_and_no_gradient_past_its_backward(
        case, layout, monkeypatch):
    cfg = dataclasses.replace(_cfg(case),
                              n_layers=max(4, _cfg(case).n_layers))
    p, mp = layout
    n_outer = mp * sum(not k.startswith(parallel.LAYERS) for k, _ in
                       tree_leaves(S.state_shapes(cfg, OPT)["params"]))
    census = Census(monkeypatch, n_outer)
    step = S.make_train_step(cfg, OPT, ["cpu"] * (p * mp), mp=mp)
    state, metrics = step(_slots(cfg, p, mp), _batch(cfg))
    assert torch.isfinite(metrics["loss"])
    assert census.rows == {None, *range(scan_plan(cfg)[1])}, census.rows
    assert census.checks > 0


# -------------------------------------------------------------- dry-run
def whole_group_train_step(cfg, optimizer, layout, slots, batch):
    """The dry-run's group step in the whole-gather form: the group's
    params gathered whole, its whole gradients reduce-scattered at its
    end (the other groups' stand-ins its own)."""
    p, mp = layout.dp, layout.mp
    devices = [D.META] * mp
    (shard,) = S.shard_batch(batch, 1, devices[:1])
    params = [s["params"] for s in slots] * p
    dims = parallel.model_dims(layout)
    plan = None
    if cfg.moe and p > 1:
        (plan,) = S.M.route_globally(cfg, [parallel.ShardedParams(
            S.gather_group(layout, params, 0, devices), dims,
            tuple(devices))], [shard], p)
    loss, parts, grads = S.group_loss_and_grads(
        cfg, S.gather_group(layout, params, 0, devices), dims, devices,
        shard, routing=plan)
    boxes = [tree_map(lambda g: g / p, box)
             for box in S.scatter_group(layout, [grads] * p, 0, devices)]
    return S.apply_update(optimizer, slots, boxes, layout, loss,
                          parts["xent"], parts["aux"], slots=range(mp))


@pytest.mark.parametrize("case", ["edl_paper", "rwkv6_remat"])
def test_dryrun_peak_falls_by_the_layer_params_no_longer_gathered(
        case, monkeypatch):
    base = _cfg(case)
    cfg = dataclasses.replace(base, n_layers=4 * base.n_layers)
    shape = InputShape("train_small", 64, 8, "train")
    per = D.dryrun(cfg, shape, (4, 1))
    monkeypatch.setattr(D, "group_train_step", whole_group_train_step)
    whole = D.dryrun(cfg, shape, (4, 1))
    # the layer leaves split over the data axis: the whole form holds each
    # gathered (the others are a slot's own box, read in place)
    layout = S.port_layout(cfg, OPT, 4, 1)
    split = dict(tree_leaves(parallel.data_dims(layout)))
    esz = torch.empty((), dtype=S.M.dt(cfg, "param")).element_size()
    layers = sum(int(np.prod(sd[0])) for k, sd in tree_leaves(
        S.state_shapes(cfg, OPT)["params"])
        if k.startswith(parallel.LAYERS) and split[k] is not None) * esz
    n_periods = scan_plan(cfg)[1]
    assert n_periods >= 4 and layers > 0
    assert per["arg_bytes"] == whole["arg_bytes"]
    assert per["temp_bytes"] <= whole["temp_bytes"] - (
        layers - layers // n_periods), (per["temp_bytes"],
                                        whole["temp_bytes"], layers)
    pb, wb = per["collective_breakdown"], whole["collective_breakdown"]
    assert pb["reduce_scatter_data"] == wb["reduce_scatter_data"]
    # the backward gathers every row once more, the other 3 groups' boxes:
    # under remat in the recomputation, without it where a saved one is
    # read (every split leaf is a matmul's saved operand)
    assert pb["all_gather_data"] == wb["all_gather_data"] + layers * 3 // 4
