"""Read a ``torch.profiler`` chrome trace of a run's traced stretch.

The grouping of kernel names is a copy of ``tools/torch_step_profile.py``'s
(``GROUPS``, ``MATMUL_MARKS``, ``group_of``). Two things differ from its
``kernel_breakdown``: busy time is the union of a device's own intervals,
one device at a time (a union over all devices lets one card's work hide
another's idle time), and device copies and memsets count as busy, so a
state move or a gather between cards is work, not idle time.

Only device events inside the harness's ``edlbench.window`` annotation are
read, clipped to it; its length is the traced window.
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
SHORT_GAP_US = 10       # idle gaps shorter than this are counted unnamed


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


def summarize(events: list, top: int = 10) -> dict:
    """What the metric readers take from a trace's events (times in s):
    the window, each device's busy time, device time by kernel group and
    by name, copy time, kernel launches, and the longest idle gaps named
    by the host op that ran across them."""
    wins = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not wins:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0 = min(e["ts"] for e in wins)
    w1 = max(e["ts"] + e["dur"] for e in wins)
    dev_events = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b > a:
            dev_events.append((e, a, b))
    by_dev: dict = {}
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    copy_us = 0.0
    launches = 0
    for e, a, b in dev_events:
        by_dev.setdefault(_device_of(e), []).append((a, b))
        d = b - a
        if e["cat"] == "kernel":
            launches += 1
            g = group_of(e["name"])
            by_group[g] = by_group.get(g, 0.0) + d
        else:
            copy_us += d
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d
    busy = {dev: _union(sp) / 1e6 for dev, sp in by_dev.items()}
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy,
            "group_s": {k: v / 1e6 for k, v in by_group.items()},
            "name_s": {k: v / 1e6 for k, v in by_name.items()},
            "copy_s": copy_us / 1e6, "launches": launches,
            "top_ops": [[n, v / 1e6] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": _idle_gaps(events, by_dev, w0, w1, top)}


def _idle_gaps(events, by_dev, w0, w1, top) -> list:
    """The idle gaps of every device in the window, summed by the
    innermost host op (or harness span) running at each gap's middle."""
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation",
                                      "python_function")
                  and "dur" in e and e.get("name") != WINDOW)
    gaps = []
    for spans in by_dev.values():
        prev = w0
        for a, b in sorted(spans):
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if w1 > prev:
            gaps.append((prev, w1))
    starts = [h[0] for h in host]
    out: dict[str, float] = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US} us"
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
            continue
        mid = (a + b) / 2
        name = "host outside any op"
        # the latest-starting host op that still runs at the gap's middle
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return [[n, v] for n, v in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:top]]


def load(path: str) -> dict:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
