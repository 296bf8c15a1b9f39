"""Pluggable scheduling for the live executor.

A policy is the same callable(view) -> {jid: p} that drives the
discrete-event simulator (repro_torch.sched.base) — ``p`` counted in device
GROUPS of ``job.mp`` devices each (one data-parallel replica; plain
tenants have mp=1 so a group is a device). This module supplies

  * ``make_policy(name, **kw)`` — registry of the paper's policies with
    defaults tuned for live smoke-scale jobs (quanta in attained GPU-seconds
    are tiny because a smoke mini-batch is ~0.1 s);
  * ``plan_actions(jobs, alloc, n_gpus)`` — the diff from a target
    allocation map to concrete elastic actions against live jobs. Shrinks
    (including preemptions) sort first so their freed devices fund the
    grows/starts.

A 0-GPU target for a RUNNING job is a full preemption: the executor
checkpoint-stops the job (core.stop_resume), returns ALL of its devices to
the pool, and parks it as re-admittable demand — Tiresias-style preemptive
time-sharing executes for real instead of being clamped to one slice.
A 0-GPU target for a job with no live trainer (pending or already
preempted) simply leaves it parked.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sched.base import MaxThroughput, StaticPolicy, \
    normalize_target
from repro_torch.sched.tiresias import Tiresias


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str   # "start" | "scale_out" | "scale_in" | "preempt" | "reshape"
    jid: int
    target_p: int       # desired GROUP count after the action (0 = preempt)
    target_mp: int = 0  # desired degree (0 = keep the job's current one)

    def shape(self, job) -> tuple[int, int]:
        return self.target_p, self.target_mp or getattr(job, "mp", 1)


def plan_actions(jobs: dict[int, object], alloc: dict[int, int],
                 n_gpus: int) -> list[Action]:
    """Diff the policy's target allocation (in device groups — plain ints
    at the job's current shape, or explicit ``(groups, mp)`` tuples from
    reshape-aware policies) against live job state. Targets are clamped
    to what the job can actually run: batch-divisible group counts that
    fit the cluster — an mp=2 tenant on an n_gpus=4 pool can never target
    more than 2 groups.

    A tuple whose mp differs from a RUNNING job's live degree becomes a
    ``reshape`` — the live reparallelization verb (the executor trades
    data-parallel for model-parallel degree stop-free, settling the
    device delta against the pool). ``start`` covers first admission and
    re-admission of a preempted job (the executor restores from the
    checkpoint handle when one exists — onto the target shape, which for
    an mp=auto tenant may differ from the shape the checkpoint was
    written at). Jobs absent from ``alloc`` — e.g. mid-checkpoint jobs
    the policy cannot see — are left untouched."""
    shrinks, grows = [], []
    for jid, raw in alloc.items():
        job = jobs.get(jid)
        if job is None or job.finish_time is not None:
            continue
        target, mp = normalize_target(job, raw)
        if mp != job.mp and not getattr(job, "mp_auto", False):
            # a rigid tenant is never re-meshed: reinterpret the tuple as
            # a device budget at the pinned degree instead of silently
            # reshaping past the spec's contract
            target, mp = (target * mp) // job.mp, job.mp
        target = job.feasible_p(min(target, n_gpus // mp))
        if job.trainer is None:
            if target > 0:
                grows.append(Action("start", jid, target, mp))
            continue
        cur, cur_mp = job.alloc, job.mp
        if target == 0:
            shrinks.append(Action("preempt", jid, 0))
        elif mp != cur_mp:
            # the device delta decides which side of the ledger the
            # reshape sits on: a footprint shrink frees devices (it can
            # fund grows), a growth consumes them
            act = Action("reshape", jid, target, mp)
            (shrinks if target * mp <= cur * cur_mp else grows).append(act)
        elif target < cur:
            shrinks.append(Action("scale_in", jid, target))
        elif target > cur:
            grows.append(Action("scale_out", jid, target))
    return shrinks + grows


class ScriptedPolicy:
    """Deterministic allocation script ``{round: {jid: target}}`` — targets
    in the same format live policies emit (plain group counts or
    ``(groups, mp)`` reshape tuples). Between scripted rounds the most
    recent entry keeps applying (before the first entry, keep-current).
    Drives reproducible executor scenarios: tests and the reshape
    benchmark script exact preempt/reshape sequences with it."""

    def __init__(self, script: dict):
        self.script = dict(script)

    def __call__(self, view) -> dict:
        past = [r for r in self.script if r <= view.now]
        if past:
            return self.script[max(past)]
        return {j.jid: j.alloc for j in view.running.values()}


_REGISTRY = {
    # quanta are attained GPU-seconds: smoke-scale mini-batches are ~50 ms,
    # so the live defaults are far below the simulator's (500, 10k)
    "tiresias": lambda **kw: Tiresias(**{
        "quanta": (0.5, 5.0), "starvation_s": 1_000.0, **kw}),
    "elastic-tiresias": lambda **kw: Tiresias(**{
        "elastic": True, "N": 0, "quanta": (0.5, 5.0),
        "starvation_s": 1_000.0, **kw}),
    "throughput": lambda **kw: MaxThroughput(**kw),
    "static": lambda **kw: StaticPolicy(**kw),
}


def make_policy(name: str, **kw):
    try:
        return _REGISTRY[name](**kw)
    except KeyError:
        raise ValueError(f"unknown policy {name!r}; "
                         f"one of {sorted(_REGISTRY)}") from None
