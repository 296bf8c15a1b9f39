"""What the metric files share: each file under ``metrics/`` is one
metric's reader, ``read(run) -> float | None``, found by the metric's name.

``run`` is the record a run leaves (``run.py``): ``model`` and ``traffic``
(the cell's files), ``chips``, ``setup_s``, ``window`` (its ``seconds``,
its ``steps``, each ``{"t0", "t1", "p", "tokens", "values"}``, ``values``
being every number the program's ``step()`` returned, and their
``tokens``), ``switches`` (the scaling records of the switches committed
in the window: ``op``, ``prep_s``, ``stop_s``, ``bytes_moved_overlapped``,
``staged``), and in a traced run ``trace`` (``trace.summarize`` of the
traced stretch, the program's spans with it), ``trace_steps`` (the steps
inside it) and ``untraced_steps`` (the window's others). A reader that
finds nothing to read returns None, and the run leaves the metric out.

A reader of a span the program opens is three lines::

    from edlbench.readers import span_ms

    def read(run):
        return span_ms(run, "edl.<name>", within=True)

and one of a number ``step()`` returns reads ``step_values(run, key)``.
"""
from __future__ import annotations

from edlbench import counts


def traced(run: dict):
    """(trace summary, steps in it), or None where the run was not traced
    or its stretch holds no step or no device work."""
    tr = run.get("trace")
    steps = run.get("trace_steps") or []
    if not tr or not steps or not tr["busy_s"]:
        return None
    return tr, steps


def per_step_ms(run: dict, seconds_of) -> float | None:
    """ms a traced step of what ``seconds_of(trace)`` sums (device time
    summed over the cards); None where it gives None or nothing."""
    t = traced(run)
    if t is None:
        return None
    tr, steps = t
    s = seconds_of(tr)
    return None if s is None or s <= 0 else 1e3 * s / len(steps)


def span_ms(run: dict, name: str, within: bool = False) -> float | None:
    """Device ms a traced step under the program's span ``name``: the
    work launched while it was the innermost of the step's phases
    (``trace.PHASES``), or with ``within`` all the work launched while it
    was open (for a span the program opens inside a phase)."""
    key = "span_within_s" if within else "span_device_s"
    return per_step_ms(run, lambda tr: tr[key].get(name))


def step_values(run: dict, key: str) -> list | None:
    """The number ``key`` that ``step()`` returned at each of the window's
    steps, traced and untraced, in order; None where no step returned
    it."""
    w = run.get("window") or {}
    out = [s["values"][key] for s in w.get("steps") or []
           if key in s.get("values", {})]
    return out or None


def kernel_seconds(tr: dict, marks) -> float:
    """Device seconds of the kernels whose names hold any of ``marks``."""
    return sum(v for n, v in tr["name_s"].items()
               if any(m in n for m in marks))


def roofline(run: dict, marks, bound_of) -> float | None:
    """The least time of the traced steps' work (``bound_of(model,
    traffic, p)`` a step) over the device time of the kernels that did it,
    in %."""
    t = traced(run)
    if t is None:
        return None
    tr, steps = t
    spent = kernel_seconds(tr, marks)
    if spent <= 0:
        return None
    least = sum(bound_of(run["model"], run["traffic"], s["p"])
                for s in steps)
    return 100.0 * least / spent


def step_mfu(run: dict) -> float | None:
    """The model flops of the window's steps outside the traced stretch,
    which the profiler did not slow, over their host seconds x chips x
    the bf16 dense peak, in %."""
    steps = run.get("untraced_steps") or []
    if traced(run) is None or not steps:
        return None
    L = run["traffic"]["seq_len"]
    flops = sum(counts.step_model_flops(run["model"], s["tokens"] // L, L)
                for s in steps)
    seconds = sum(s["t1"] - s["t0"] for s in steps)
    return 100.0 * flops / (seconds * run["chips"] * counts.PEAK_BF16_FLOPS)


def idle_share(run: dict) -> float | None:
    """One minus each card's busy share of the traced window, averaged
    over the cell's cards, in %."""
    t = traced(run)
    if t is None:
        return None
    tr, _ = t
    busy = sum(tr["busy_s"].values()) / run["chips"]
    return 100.0 * (1.0 - busy / tr["window_s"])


def tokens_per_s(run: dict) -> float | None:
    w = run.get("window")
    if not w or not w["steps"] or w["seconds"] <= 0:
        return None
    return w["tokens"] / w["seconds"]
