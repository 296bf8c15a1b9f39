"""The comparison that decides a run's ``correct``.

The program's checked steps are the window's own call (``step()``) on
the benchmark's weights and rows; the reference (``reference/model.py``)
follows the same first steps from the same weights and rows. Compared:

* ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``,
  the first step's, which no update has touched: steady from seed to
  seed where the later steps follow a gradient whose rounding swings;
* ``grad_gap``: of the first step's gradient norm, worst leaf: the gap
  between the program's norm (its first moment after one step, over
  1 - b1) and the reference's, over the larger of the reference's norm of
  that leaf and the median leaf's;
* ``change_gap``: of the norm of each leaf's change after those steps,
  worst leaf, measured alike. Leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone and are left
  out;
* ``data_repeats``: sample ids read more than once (exact: 0);
* ``stops_outside_step``: switch stops not inside the ``step()`` call
  that committed them (exact: 0; cells that switch).

A run computes only the numbers its cell's limits name; ``probe.py``
reads them all.
"""
from __future__ import annotations

import statistics

TINY_GRAD = 1e-3        # a leaf's gradient under this x the median leaf's


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |prog - ref| over max(ref, median ref), over the leaves
    in ``keep`` (all by default)."""
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    out = {}
    for k in keys:
        den = max(ref[k], med)
        out[k] = abs(prog[k] - ref[k]) / den if den > 0 else (
            0.0 if prog[k] == ref[k] else float("inf"))
    return out


def worst(gaps: dict) -> tuple[float, str]:
    at = max(gaps, key=gaps.get)
    return gaps[at], at


def compare(prog: dict, ref: dict, names=None) -> dict:
    """The compared numbers among ``names`` (all of them by default; names
    this module does not compute are skipped) and where their worst leaf
    lies, from the program's and the reference's ``loss`` (a list),
    ``grad_norm`` and ``change_norm`` (path -> norm)."""
    odd = set(prog["grad_norm"]) ^ set(ref["grad_norm"])
    if odd:
        raise ValueError(f"the program's and the reference's trees differ: "
                         f"{sorted(odd)}")
    g = ref["grad_norm"]
    med = statistics.median(g.values())
    moved = {k for k, v in g.items() if v >= TINY_GRAD * med}

    def loss_gap():
        return max(abs(a - b) / abs(b)
                   for a, b in zip(prog["loss"], ref["loss"])), None

    def loss1_gap():
        return abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0]), \
            None

    def grad_gap():
        return worst(leaf_gaps(prog["grad_norm"], g))

    def change_gap():
        return worst(leaf_gaps(prog["change_norm"], ref["change_norm"],
                               moved))
    numbers = {"loss_gap": loss_gap, "loss1_gap": loss1_gap,
               "grad_gap": grad_gap, "change_gap": change_gap}
    out = {"values": {}, "worst_leaf": {}, "left_out": sorted(set(g) - moved)}
    for name, fn in numbers.items():
        if names is None or name in names:
            out["values"][name], at = fn()
            if at is not None:
                out["worst_leaf"][name] = at
    return out
