"""Event-log invariant auditor — per-device ownership as an interval
partition.

The chaos/serving/reshape suites each hand-rolled the same replay: walk
the executor's event log, track which job owns which device, and assert
nothing is double-granted or leaked. This module is that auditor,
generalized over EVERY event op that moves devices:

  grants   scale_out / readmit / profile_grant / reshape-with-devices —
           the granted devices must currently be owned by nobody and must
           not have been retired from the cluster;
  frees    scale_in / reshape_release / preempt / finish — the freed
           devices must all be owned by exactly the freeing job;
  condemn  worker_dead / revoke-against-a-job — the devices stay owned,
           but the moment they come home they are RETIRED: a retired
           device reappearing in any later grant is a violation
           ("condemned devices never reappear");
  retire   revoke from the free pool — unowned devices leave immediately.

``audit_device_ownership`` never raises — it returns every violation so
a property-style test can report the full story of a bad log at once.
"""
from __future__ import annotations

GRANT_OPS = ("scale_out", "readmit", "profile_grant")
FREE_OPS = ("scale_in", "reshape_release", "preempt", "finish")
CONDEMN_OPS = ("worker_dead", "revoke")


def audit_device_ownership(events: list[dict]) -> dict:
    """Replay ``events`` (the executor's legacy dicts, or bus events
    re-flattened) and check the ownership discipline. Returns::

        {"ok": bool, "violations": [str, ...],
         "owned_at_end": {device_id: jid},
         "retired": set, "n_audited": int}

    ``owned_at_end`` non-empty is NOT a violation by itself — a run can
    legitimately end at max_rounds with tenants still holding devices;
    callers that know every job finished assert it empty themselves.
    """
    owner: dict = {}            # device id -> jid
    condemned: set = set()      # owned, but leaves the cluster when freed
    retired: set = set()        # gone; must never reappear
    violations: list[str] = []
    audited = 0

    def where(e):
        return f"round {e.get('round')} {e.get('op')} job={e.get('job')}"

    for e in events:
        devs = e.get("devices")
        if not devs:
            continue
        audited += 1
        op, jid = e.get("op"), e.get("jid")
        devs = list(devs)
        if len(set(devs)) != len(devs):
            violations.append(f"{where(e)}: duplicate device ids {devs}")
        if op in GRANT_OPS or (op == "reshape" and devs):
            for d in devs:
                if d in owner:
                    violations.append(
                        f"{where(e)}: device {d} granted while owned by "
                        f"jid {owner[d]} (in two jobs at once)")
                elif d in retired:
                    violations.append(
                        f"{where(e)}: retired device {d} reappeared in a "
                        f"grant (condemned devices must never come back)")
                else:
                    owner[d] = jid
        elif op in FREE_OPS:
            for d in devs:
                if owner.get(d) != jid or d not in owner:
                    violations.append(
                        f"{where(e)}: device {d} freed by jid {jid} but "
                        f"owned by "
                        f"{owner.get(d, 'nobody') if d in owner else 'nobody'}")
                    continue
                del owner[d]
                if d in condemned:
                    condemned.discard(d)
                    retired.add(d)
        elif op in CONDEMN_OPS:
            if op == "revoke" and jid is None:
                # free-pool revocation: unowned devices leave NOW
                for d in devs:
                    if d in owner:
                        violations.append(
                            f"{where(e)}: free-pool revoke of device {d} "
                            f"owned by jid {owner[d]}")
                    retired.add(d)
                continue
            for d in devs:
                if owner.get(d) != jid:
                    violations.append(
                        f"{where(e)}: condemned device {d} not owned by "
                        f"jid {jid}")
                condemned.add(d)
    return {"ok": not violations, "violations": violations,
            "owned_at_end": dict(owner), "retired": retired,
            "n_audited": audited}


def assert_ownership(events: list[dict], *, require_empty: bool = False):
    """Test-facing wrapper: raise AssertionError listing every violation.
    ``require_empty`` additionally demands every device came home (all
    jobs finished)."""
    res = audit_device_ownership(events)
    assert res["ok"], "device-ownership violations:\n  " + \
        "\n  ".join(res["violations"])
    if require_empty:
        assert not res["owned_at_end"], \
            f"devices never released: {res['owned_at_end']}"
    return res
