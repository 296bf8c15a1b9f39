"""Render / validate a run's telemetry stream.

A copy of the reference package's ``repro.obs.report`` (the core behind
``tools/obs_report.py``), in the same schema: load a telemetry JSONL
(``--metrics-out``), validate every event against the schema, and render
the human summary —
a per-job timeline of allocation verbs plus the adjustment-latency
histogram (prep / stop / e2e percentiles from the committed switches'
``ScalingRecord`` summaries riding on ``adjust`` events).
"""
from __future__ import annotations

import json

from repro_torch.obs.events import validate_event


def load(path: str) -> list[dict]:
    """Read a telemetry JSONL into records. Unparseable lines become
    ``{"type": "corrupt", ...}`` records so validation can report them
    instead of dying on the first bad byte."""
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError as e:
                records.append({"type": "corrupt", "line": i + 1,
                                "error": str(e)})
    return records


def validate(records: list[dict]) -> list[str]:
    """Every ``event`` record must satisfy the envelope schema; corrupt
    lines and unknown record types are reported too."""
    problems = []
    n_events = 0
    for i, r in enumerate(records):
        rtype = r.get("type")
        if rtype == "corrupt":
            problems.append(f"line {r['line']}: unparseable JSON "
                            f"({r['error']})")
        elif rtype == "event":
            n_events += 1
            for p in validate_event(r):
                problems.append(f"record {i}: {p}")
        elif rtype == "metrics":
            if not isinstance(r.get("snapshot"), dict):
                problems.append(f"record {i}: metrics record without a "
                                f"snapshot dict")
        else:
            problems.append(f"record {i}: unknown record type {rtype!r}")
    if n_events == 0:
        problems.append("stream contains no events")
    return problems


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def summarize(records: list[dict]) -> dict:
    """Structured summary: per-job verb timeline + adjustment latency
    distribution. Works on bus-event records (``type == "event"``)."""
    events = [r for r in records if r.get("type") == "event"]
    jobs: dict[str, list] = {}
    for e in events:
        if e.get("job") is None:
            continue
        jobs.setdefault(e["job"], []).append(e)
    timeline = {}
    for name, evs in jobs.items():
        timeline[name] = [
            {"round": e.get("round"), "name": e["name"], "kind": e["kind"],
             **{k: e["data"][k] for k in ("from_p", "to_p")
                if k in e.get("data", {})}}
            for e in evs if e["kind"] != "adjust"]
    adjust = [e for e in events if e["kind"] == "adjust"]
    lat: dict[str, list] = {"prep_ms": [], "stop_ms": [], "e2e_ms": []}
    for e in adjust:
        d = e.get("data", {})
        for out_key, src_key in (("prep_ms", "prep_s"),
                                 ("stop_ms", "stop_s"),
                                 ("e2e_ms", "e2e_s")):
            if src_key in d:
                lat[out_key].append(d[src_key] * 1e3)
    dist = {}
    for key, vals in lat.items():
        vals = sorted(vals)
        dist[key] = {
            "n": len(vals),
            "p50": _percentile(vals, 0.50),
            "p90": _percentile(vals, 0.90),
            "max": vals[-1] if vals else None,
        }
    counts: dict[str, int] = {}
    for e in events:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return {"n_events": len(events), "event_counts": counts,
            "jobs": timeline, "adjustments": len(adjust),
            "adjustment_latency": dist}


def render(records: list[dict]) -> str:
    """The human report ``obs_report.py`` / ``cluster_bench --report``
    print."""
    s = summarize(records)
    lines = [f"telemetry: {s['n_events']} event(s), "
             f"{s['adjustments']} committed adjustment(s)"]
    for name in sorted(s["jobs"]):
        lines.append(f"job {name}:")
        for e in s["jobs"][name]:
            shape = (f"  p {e['from_p']} -> {e['to_p']}"
                     if "from_p" in e else "")
            rnd = e["round"] if e["round"] is not None else "-"
            lines.append(f"  round {rnd:>4}  [{e['kind']:>10s}] "
                         f"{e['name']}{shape}")
    lines.append("adjustment latency (ms):")
    for key in ("prep_ms", "stop_ms", "e2e_ms"):
        d = s["adjustment_latency"][key]
        if not d["n"]:
            lines.append(f"  {key:>8s}: no committed switches recorded")
            continue
        lines.append(f"  {key:>8s}: n={d['n']} p50={d['p50']:.3f} "
                     f"p90={d['p90']:.3f} max={d['max']:.3f}")
    return "\n".join(lines)
