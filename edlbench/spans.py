#!/usr/bin/env python3
"""The traced stretch by the program's own ``edl.*`` spans.

    python3 edlbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with the same output, and
prints one more line: the step's device time split into its phases, the
host's time a step, and the idle gaps named by the span the program had
open, read from the same ``torch.profiler`` trace.

The port opens the spans inside ``ElasticTrainer.step`` while a profiler
records (``repro_torch.obs.trace.span``): ``edl.step`` around the step,
``edl.data`` around the batch's assembly and its copies to the cards,
``edl.forward`` and ``edl.backward`` around each data group's forward and
backward, ``edl.recompute`` around remat's recomputation (on autograd's
thread), ``edl.update`` around the optimizer update and the gradient norm,
``edl.sync`` around the host's read of the step's metrics.

``summarize`` adds to ``trace.summarize``'s keys, over the same window:

- ``span_device_s``: device seconds of kernels and copies by the innermost
  ``edl.*`` span open at their launch. A device event is matched to its
  ``cuda_runtime`` / ``cuda_driver`` launch by ``args.correlation``; the
  launch counts under the innermost span open on its own thread, or, where
  that thread has none open (autograd's device thread in the backward),
  under the innermost one open on any thread at that time. Device work
  launched under no span, or with no launch found, is ``"unattributed"``.
- ``span_group_s`` and ``span_kernels``: the same device seconds by
  ``trace.group_of``'s kernel group (copies and memsets as ``"copy"``),
  and the kernels launched, by span.
- ``span_host_s``: the host seconds of each ``edl.*`` name.
- ``idle_by_span``: each device's idle gaps of ``trace.SHORT_GAP_US`` or
  more, by the innermost ``edl.*`` span open at the gap's middle on any
  thread, ``"outside"`` where none is.
- ``launch_host_s``: the host seconds inside CUDA runtime and driver calls
  (launches, copies, syncs); a launch that waits for room in the card's
  queue shows here.
- ``host_own_s``: the host's own seconds in the steps: each ``edl.step``'s
  host time less the union of its ``edl.sync`` and of every CUDA runtime
  and driver call made during it on any thread, so that no wait for the
  card counts (the launch queue's, a stream sync's, the metrics' read).
  What is left is Python, dispatch and the profiler's own recording of
  each op, on the thread that drives the card at the time (the main
  thread, or autograd's in the backward while the main thread waits).
"""
from __future__ import annotations

import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from edlbench import trace  # noqa: E402
from edlbench.readers import traced  # noqa: E402

PREFIX = "edl."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside"
PHASES = ("edl.forward", "edl.backward", "edl.recompute", "edl.update")


class _Open:
    """Spans as (start, end, name), answering which one is innermost at a
    time: the latest-starting span that still runs then."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            a, b, name = self.spans[i]
            if b >= t:
                return name
        return None


def _window(events) -> tuple[float, float]:
    wins = [e for e in events if e.get("name") == trace.WINDOW and "dur" in e]
    if not wins:
        raise ValueError(f"the trace holds no {trace.WINDOW!r} span")
    return (min(e["ts"] for e in wins),
            max(e["ts"] + e["dur"] for e in wins))


def summarize(events: list) -> dict:
    """The keys above, of the events inside the window (times in s)."""
    w0, w1 = _window(events)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e["name"].startswith(PREFIX)]
    anywhere = _Open(s[:3] for s in spans)
    by_tid: dict = {}
    for a, b, name, tid in spans:
        by_tid.setdefault(tid, []).append((a, b, name))
    on_thread = {tid: _Open(sp) for tid, sp in by_tid.items()}
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launches[corr] = (e.get("tid"), e["ts"])

    group_us: dict[str, dict[str, float]] = {}
    kernels: dict[str, int] = {}
    by_dev: dict = {}
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        by_dev.setdefault(trace._device_of(e), []).append((a, b))
        name = None
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            tid, ts = launch
            own = on_thread.get(tid)
            name = (own.at(ts) if own is not None else None) \
                or anywhere.at(ts)
        name = name or UNATTRIBUTED
        g = trace.group_of(e["name"]) if e["cat"] == "kernel" else "copy"
        groups = group_us.setdefault(name, {})
        groups[g] = groups.get(g, 0.0) + (b - a)
        kernels[name] = kernels.get(name, 0) + (e["cat"] == "kernel")

    host_us: dict[str, float] = {}
    for a, b, name, _ in spans:
        d = min(b, w1) - max(a, w0)
        if d > 0:
            host_us[name] = host_us.get(name, 0.0) + d

    idle_us: dict[str, float] = {}
    for a, b in _gaps(by_dev, w0, w1):
        if b - a < trace.SHORT_GAP_US:
            continue
        name = anywhere.at((a + b) / 2) or OUTSIDE
        idle_us[name] = idle_us.get(name, 0.0) + (b - a)

    def seconds(d):
        return {k: v / 1e6 for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])}
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") in LAUNCH_CATS and "dur" in e]
    launch_us = sum(b - a for a, b in _clipped(calls, w0, w1))
    waits = calls + [(a, b) for a, b, name, _ in spans if name == "edl.sync"]
    own_us = 0.0
    for a, b, name, _ in spans:
        a, b = max(a, w0), min(b, w1)
        if name == "edl.step" and b > a:
            own_us += (b - a) - trace._union(_clipped(waits, a, b))
    return {"span_device_s": seconds({k: sum(v.values())
                                      for k, v in group_us.items()}),
            "span_group_s": {k: seconds(v) for k, v in group_us.items()},
            "span_kernels": kernels,
            "span_host_s": seconds(host_us),
            "idle_by_span": seconds(idle_us),
            "launch_host_s": launch_us / 1e6,
            "host_own_s": own_us / 1e6}


def _clipped(spans, a: float, b: float) -> list:
    return [(max(x, a), min(y, b)) for x, y in spans if min(y, b) > max(x, a)]


def _gaps(by_dev: dict, w0: float, w1: float) -> list:
    """Each device's idle intervals in the window."""
    gaps = []
    for spans in by_dev.values():
        prev = w0
        for a, b in sorted(spans):
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 > prev:
            gaps.append((prev, w1))
    return gaps


def load(path: str) -> dict:
    """``trace.load``'s summary with ``summarize``'s keys added."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {**trace.summarize(events), **summarize(events)}


# ------------------------------------------------------------- readers
# each ``read(run) -> float | None`` as the files of ``metrics/`` are,
# given per traced step; None where the trace holds no ``edl.*`` span

def _per_step_ms(run: dict, seconds_of) -> float | None:
    t = traced(run)
    if t is None or "span_host_s" not in t[0]:
        return None
    tr, steps = t
    s = seconds_of(tr)
    return None if s is None else 1e3 * s / len(steps)


def _device(name: str):
    def read(run):
        return _per_step_ms(run, lambda tr: tr["span_device_s"].get(name))
    read.__doc__ = f"Device ms a traced step under ``{name}``."
    return read


forward_ms = _device("edl.forward")
backward_ms = _device("edl.backward")       # remat's recompute is apart
recompute_ms = _device("edl.recompute")
update_ms = _device("edl.update")


def data_wait_ms(run: dict) -> float | None:
    """Host ms a traced step in ``edl.data``."""
    return _per_step_ms(run, lambda tr: tr["span_host_s"].get("edl.data"))


def host_ms(run: dict) -> float | None:
    """The host's own ms a traced step (``host_own_s``): ``edl.step`` less
    ``edl.sync`` and every CUDA call's wait. Under the profiler, so it
    holds the profiler's cost of each op too."""
    def seconds(tr):
        return (tr.get("host_own_s") if "edl.step" in tr["span_host_s"]
                else None)
    return _per_step_ms(run, seconds)


READERS = {"forward_ms": forward_ms, "backward_ms": backward_ms,
           "recompute_ms": recompute_ms, "update_ms": update_ms,
           "data_wait_ms": data_wait_ms, "host_ms": host_ms}


def coverage(tr: dict) -> dict:
    """How far the spans cover the traced stretch, in %: the four phases'
    device time over the devices' busy time, the device time under no
    span over all device time, the idle time of gaps of 10 µs or more
    inside a span over all of it."""
    dev, idle = tr["span_device_s"], tr["idle_by_span"]
    busy = sum(tr["busy_s"].values())
    every, gaps = sum(dev.values()), sum(idle.values())
    return {"phases_of_busy": (100.0 * sum(dev.get(p, 0.0) for p in PHASES)
                               / busy if busy else None),
            "unattributed_share": (100.0 * dev.get(UNATTRIBUTED, 0.0)
                                   / every if every else None),
            "idle_in_spans_share": (100.0 * (gaps - idle.get(OUTSIDE, 0.0))
                                    / gaps if gaps else None)}


def main(argv=None) -> int:
    """``run.py``'s run with ``--trace 1``, its trace read by ``load``
    too; prints run.py's two lines, then the readers' values, the span
    summary and ``coverage``."""
    import argparse
    from edlbench import run as run_mod
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    kept = {}
    real_run_cell = run_mod.run_cell

    def run_cell(*a, **kw):
        kept["out"] = out = real_run_cell(*a, **kw)
        return out
    trace_load, trace.load = trace.load, load
    run_mod.run_cell = run_cell
    try:
        rc = run_mod.main(["--workload", args.workload, "--seed",
                           str(args.seed), "--seconds", str(args.seconds),
                           "--trace", "1"])
    finally:
        trace.load, run_mod.run_cell = trace_load, real_run_cell
    if rc or "out" not in kept:
        return rc or 1
    run = kept["out"]["run"]
    tr = run["trace"] or {}
    print(json.dumps({
        "spans": {k: r(run) for k, r in READERS.items()},
        "step_s": run_mod.step_seconds(run),
        "idle_by_span": tr.get("idle_by_span"),
        "span_device_s": tr.get("span_device_s"),
        "span_group_s": tr.get("span_group_s"),
        "span_kernels": tr.get("span_kernels"),
        "span_host_s": tr.get("span_host_s"),
        "busy_s": tr.get("busy_s"),
        "launch_host_s": tr.get("launch_host_s"),
        "host_own_s": tr.get("host_own_s"),
        "traced_steps": len(run["trace_steps"] or []),
        "coverage": coverage(tr) if "span_device_s" in tr else None}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
