"""Read a ``torch.profiler`` chrome trace of a run's traced stretch.

The grouping of kernel names is a copy of ``tools/torch_step_profile.py``'s
(``GROUPS``, ``MATMUL_MARKS``, ``group_of``). Two things differ from its
``kernel_breakdown``: busy time is the union of a device's own intervals,
one device at a time (a union over all devices lets one card's work hide
another's idle time), and device copies and memsets count as busy, so a
state move or a gather between cards is work, not idle time.

Only device events inside the harness's ``edlbench.window`` annotation are
read, clipped to it; its length is the traced window.

The program's own spans, ``edl.*`` (``repro_torch.obs.trace.span``, open
while a profiler records), split that device time by what the program was
doing. The step's seven (``PHASES``): ``edl.step`` around
``ElasticTrainer.step()``, ``edl.data`` around the batch's assembly and
its copies to the cards, ``edl.forward`` and ``edl.backward`` around each
data group's forward and backward, ``edl.recompute`` around remat's
recomputation (on autograd's thread), ``edl.update`` around the optimizer
update and the gradient norm, ``edl.sync`` around the host's read of the
step's metrics. A device event is matched to its ``cuda_runtime`` /
``cuda_driver`` launch by ``args.correlation``; the spans open at the
launch are those open on its own thread, or, where that thread has none
open (autograd's device thread in the backward), those open on any thread
at that time.
"""
from __future__ import annotations

import bisect
import json

WINDOW = "edlbench.window"

# first match wins: the WKV6 kernels' names contain "fwd_kernel" too
GROUPS = (("wkv6_fwd", "wkv6_fwd_kernel"),
          ("wkv6_bwd_dr", "wkv6_bwd_dr_kernel"),
          ("wkv6_bwd_dk", "wkv6_bwd_dk_kernel"),
          ("wkv6_bwd_dv", "wkv6_bwd_dv_kernel"),
          ("flash_attn_fwd_tc", "fwd_tc_kernel"),
          ("flash_attn_bwd_dq_tc", "bwd_dq_tc_kernel"),
          ("flash_attn_bwd_dkdv_tc", "bwd_dkdv_tc_kernel"),
          ("flash_attn_fwd", "fwd_kernel"),
          ("flash_attn_bwd_dq", "bwd_dq_kernel"),
          ("flash_attn_bwd_dkdv", "bwd_dkdv_kernel"))
MATMUL_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "cublas", "nvjet")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SHORT_GAP_US = 10       # idle gaps shorter than this are counted unnamed

PREFIX = "edl."
# the step's spans: device time counts under the innermost of these, so
# that a span the program opens inside a phase leaves the phases as they
# are; ``span_within_s`` counts it under every open ``edl.*`` span
PHASES = ("edl.step", "edl.data", "edl.forward", "edl.backward",
          "edl.recompute", "edl.update", "edl.sync")
UNATTRIBUTED = "unattributed"
OUTSIDE = "outside"


def group_of(name: str) -> str:
    for group, mark in GROUPS:
        if mark in name:
            return group
    if any(m in name for m in MATMUL_MARKS):
        return "matmul"
    return "other"


def _device_of(e: dict):
    dev = (e.get("args") or {}).get("device")
    return dev if dev is not None else e.get("pid")


def _union(spans) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


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


class _Open:
    """Spans as (start, end, name), answering which are open at a time:
    the innermost is the latest-starting span that still runs then."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float):
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            a, b, name = self.spans[i]
            if b >= t:
                return name
        return None

    def every(self, t: float) -> set:
        return {name for a, b, name in
                self.spans[:bisect.bisect_right(self.starts, t)] if b >= t}


class _Launches:
    """The ``edl.*`` spans open at a launch: on its own thread, or on any
    thread where its own has none open."""

    def __init__(self, spans):
        self.anywhere = _Open(s[:3] for s in spans)
        self.phases = _Open(s[:3] for s in spans if s[2] in PHASES)
        by_tid: dict = {}
        for a, b, name, tid in spans:
            by_tid.setdefault(tid, []).append((a, b, name))
        self.on_thread = {tid: _Open(sp) for tid, sp in by_tid.items()}
        self.phases_on_thread = {
            tid: _Open(s for s in sp if s[2] in PHASES)
            for tid, sp in by_tid.items()}

    def phase(self, tid, ts: float):
        """The innermost of ``PHASES`` open at the launch."""
        own = self.phases_on_thread.get(tid)
        return (own.at(ts) if own is not None else None) \
            or self.phases.at(ts)

    def every(self, tid, ts: float) -> set:
        """Every ``edl.*`` span open at the launch."""
        own = self.on_thread.get(tid)
        return (own.every(ts) if own is not None else set()) \
            or self.anywhere.every(ts)


def summarize(events: list, top: int = 10) -> dict:
    """What the metric readers take from a trace's events (times in s):

    - ``window_s``, each device's ``busy_s``, device time by kernel group
      (``group_s``) and by name (``name_s``), ``copy_s``, kernel
      ``launches``; ``top_ops``, the device ops that took most time, and
      ``idle_gaps``, the longest idle gaps by the innermost host op (or
      harness span) running at each gap's middle;
    - ``span_device_s``: device seconds of kernels and copies by the
      innermost of ``PHASES`` open at their launch; device work launched
      under none, or with no launch found, is ``"unattributed"``;
      ``span_group_s`` and ``span_kernels``, the same by kernel group
      (copies and memsets as ``"copy"``) and the kernels launched;
    - ``span_within_s``: device seconds launched while each ``edl.*`` span
      was open, counted under every one open (a span nested in a phase
      holds a part of the phase's time);
    - ``span_host_s``: the host seconds of each ``edl.*`` name;
    - ``idle_by_span``: each device's idle gaps of ``SHORT_GAP_US`` or
      more, by the innermost ``edl.*`` span open at the gap's middle on
      any thread, ``"outside"`` where none is;
    - ``launch_host_s``: the host seconds inside CUDA runtime and driver
      calls (launches, copies, syncs); a launch that waits for room in the
      card's queue shows here;
    - ``host_own_s``: the host's own seconds in the steps: each
      ``edl.step``'s host time less the union of its ``edl.sync`` and of
      every CUDA runtime and driver call made during it on any thread, so
      that no wait for the card counts. What is left is Python, dispatch
      and the profiler's own recording of each op, on the thread that
      drives the card at the time."""
    wins = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not wins:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0 = min(e["ts"] for e in wins)
    w1 = max(e["ts"] + e["dur"] for e in wins)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid"))
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e and e["name"].startswith(PREFIX)]
    open_at = _Launches(spans)
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launched[corr] = (e.get("tid"), e["ts"])

    by_dev: dict = {}
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    span_group: dict[str, dict[str, float]] = {}
    span_kernels: dict[str, int] = {}
    within: dict[str, float] = {}
    copy_us = 0.0
    launches = 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        d = b - a
        by_dev.setdefault(_device_of(e), []).append((a, b))
        kernel = e["cat"] == "kernel"
        g = group_of(e["name"]) if kernel else "copy"
        if kernel:
            launches += 1
            by_group[g] = by_group.get(g, 0.0) + d
        else:
            copy_us += d
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
        phase, names = None, set()
        launch = launched.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            phase, names = open_at.phase(*launch), open_at.every(*launch)
        phase = phase or UNATTRIBUTED
        groups = span_group.setdefault(phase, {})
        groups[g] = groups.get(g, 0.0) + d
        span_kernels[phase] = span_kernels.get(phase, 0) + kernel
        for name in names:
            within[name] = within.get(name, 0.0) + d

    host_us: dict[str, float] = {}
    for a, b, name, _ in spans:
        d = min(b, w1) - max(a, w0)
        if d > 0:
            host_us[name] = host_us.get(name, 0.0) + d
    gaps = _gaps(by_dev, w0, w1)
    idle_us: dict[str, float] = {}
    for a, b in gaps:
        if b - a >= SHORT_GAP_US:
            name = open_at.anywhere.at((a + b) / 2) or OUTSIDE
            idle_us[name] = idle_us.get(name, 0.0) + (b - a)
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") in LAUNCH_CATS and "dur" in e]
    waits = calls + [(a, b) for a, b, name, _ in spans if name == "edl.sync"]
    own_us = 0.0
    for a, b, name, _ in spans:
        a, b = max(a, w0), min(b, w1)
        if name == "edl.step" and b > a:
            own_us += (b - a) - _union(_clipped(waits, a, b))

    def seconds(d):
        return {k: v / 1e6 for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])}
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": {dev: _union(sp) / 1e6 for dev, sp in by_dev.items()},
            "group_s": seconds(by_group), "name_s": seconds(by_name),
            "copy_s": copy_us / 1e6, "launches": launches,
            "top_ops": [[n, v] for n, v in
                        list(seconds(by_name).items())[:top]],
            "idle_gaps": _idle_gaps(events, gaps, top),
            "span_device_s": seconds({k: sum(v.values())
                                      for k, v in span_group.items()}),
            "span_group_s": {k: seconds(v) for k, v in span_group.items()},
            "span_kernels": span_kernels,
            "span_within_s": seconds(within),
            "span_host_s": seconds(host_us),
            "idle_by_span": seconds(idle_us),
            "launch_host_s": sum(b - a for a, b in
                                 _clipped(calls, w0, w1)) / 1e6,
            "host_own_s": own_us / 1e6}


def _idle_gaps(events, gaps, top) -> list:
    """The idle gaps of every device in the window, summed by the
    innermost host op (or harness span) running at each gap's middle."""
    host = _Open((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in HOST_CATS and "dur" in e
                 and e.get("name") != WINDOW)
    out: dict[str, float] = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US} us"
        else:
            name = host.at((a + b) / 2) or "host outside any op"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return [[n, v] for n, v in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:top]]


def load(path: str) -> dict:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
