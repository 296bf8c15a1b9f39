"""Typed telemetry events — the one schema every subsystem reports in.

Before this module the repo had four incompatible observability surfaces:
the executor's ad-hoc ``events`` list of dicts, ``FaultInjector.log``,
per-subsystem ``stats()`` dicts, and eight disjoint ``bench_*.json``
schemas. A ``TelemetryEvent`` is the common envelope: a *kind* (which
subsystem lane), a *name* (what happened), a wall-clock timestamp, the
scheduling round and job identity when one applies, and a free-form
JSON-serializable ``data`` payload carrying the subsystem-specific
fields. The envelope is schema-versioned so the history-driven "Brain"
(ROADMAP item 5) can consume archived runs across format revisions.

The executor's legacy ``events`` dicts stay exactly as they were (tests
and policies read them); ``from_legacy`` lifts each one onto the bus so
the two views are 1:1 by construction.
"""
from __future__ import annotations

import dataclasses
import json
import time

SCHEMA_VERSION = 1

# event kinds: which subsystem lane an event belongs to
KIND_SCHED = "sched"            # allocation verbs (scale/preempt/reshape…)
KIND_FAULT = "fault"            # chaos: kills, revocations, recoveries
KIND_CHECKPOINT = "checkpoint"  # save lifecycle (begin/fail/land)
KIND_SERVING = "serving"        # SLO breaches, reclaim signals
KIND_COMPILE = "compile"        # compile-service ticket transitions
KIND_ADJUST = "adjust"          # a committed switch's ScalingRecord
KIND_METRIC = "metric"          # periodic metric snapshots

KINDS = (KIND_SCHED, KIND_FAULT, KIND_CHECKPOINT, KIND_SERVING,
         KIND_COMPILE, KIND_ADJUST, KIND_METRIC)

# executor legacy op -> kind (every op _event() can emit must be here;
# an unknown op falls back to KIND_SCHED so new verbs degrade gracefully)
OP_KINDS = {
    "scale_out": KIND_SCHED,
    "scale_in": KIND_SCHED,
    "readmit": KIND_SCHED,
    "finish": KIND_SCHED,
    "migrate": KIND_SCHED,
    "profile": KIND_SCHED,
    "profile_grant": KIND_SCHED,
    "reshape": KIND_SCHED,
    "reshape_release": KIND_SCHED,
    "preempt": KIND_SCHED,
    "checkpoint": KIND_CHECKPOINT,
    "checkpoint_failed": KIND_CHECKPOINT,
    "slo_breach": KIND_SERVING,
    "worker_dead": KIND_FAULT,
    "revoke": KIND_FAULT,
    "recovered": KIND_FAULT,
    "inject_delay": KIND_FAULT,
}

# envelope keys every serialized event carries
REQUIRED_KEYS = ("schema", "kind", "name", "ts")


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One fact about the cluster, in the common envelope."""
    kind: str
    name: str
    ts: float = dataclasses.field(default_factory=time.time)
    round: int | None = None
    job: str | None = None
    jid: int | None = None
    data: dict = dataclasses.field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    def to_dict(self) -> dict:
        return {"schema": self.schema, "kind": self.kind,
                "name": self.name, "ts": self.ts, "round": self.round,
                "job": self.job, "jid": self.jid, "data": dict(self.data)}

    @classmethod
    def from_dict(cls, d: dict) -> "TelemetryEvent":
        return cls(kind=d["kind"], name=d["name"], ts=d["ts"],
                   round=d.get("round"), job=d.get("job"),
                   jid=d.get("jid"), data=dict(d.get("data") or {}),
                   schema=d.get("schema", SCHEMA_VERSION))

    @classmethod
    def from_legacy(cls, e: dict) -> "TelemetryEvent":
        """Lift one executor ``events`` dict onto the bus — same facts,
        typed envelope. The legacy dict itself is NOT mutated or retired:
        ``executor.events`` remains the backward-compatible view."""
        data = {k: v for k, v in e.items()
                if k not in ("round", "op", "job", "jid")}
        return cls(kind=OP_KINDS.get(e["op"], KIND_SCHED), name=e["op"],
                   round=e.get("round"), job=e.get("job"),
                   jid=e.get("jid"), data=data)


def validate_event(d: dict) -> list[str]:
    """Schema check for one serialized event dict. Returns a list of
    problems (empty = valid) instead of raising, so a validator can
    report every bad record in a stream at once."""
    problems = []
    for key in REQUIRED_KEYS:
        if key not in d:
            problems.append(f"missing required key {key!r}")
    if problems:
        return problems
    if d["schema"] != SCHEMA_VERSION:
        problems.append(f"unknown schema version {d['schema']!r} "
                        f"(expected {SCHEMA_VERSION})")
    if d["kind"] not in KINDS:
        problems.append(f"unknown kind {d['kind']!r}")
    if not isinstance(d["name"], str) or not d["name"]:
        problems.append(f"name must be a non-empty string, got {d['name']!r}")
    if not isinstance(d["ts"], (int, float)):
        problems.append(f"ts must be a number, got {d['ts']!r}")
    if d.get("round") is not None and not isinstance(d["round"], int):
        problems.append(f"round must be an int or null, got {d['round']!r}")
    if d.get("jid") is not None and not isinstance(d["jid"], int):
        problems.append(f"jid must be an int or null, got {d['jid']!r}")
    if d.get("job") is not None and not isinstance(d["job"], str):
        problems.append(f"job must be a string or null, got {d['job']!r}")
    data = d.get("data", {})
    if not isinstance(data, dict):
        problems.append(f"data must be a dict, got {type(data).__name__}")
    else:
        try:
            json.dumps(data)
        except (TypeError, ValueError) as err:
            problems.append(f"data is not JSON-serializable: {err}")
    return problems
