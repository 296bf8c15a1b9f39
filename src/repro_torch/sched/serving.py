"""Cross-tier scheduling: compose ANY training policy with the serving
tier's reclaim priority.

``Tiresias`` and ``MaxThroughput`` are natively serving-aware (they call
``sched.base.reserve_serving`` themselves), but policies that predate
tiers — ``StaticPolicy``, scripted test policies, user callables — know
nothing about traces. ``CrossTierPolicy`` wraps one of those: serving
tenants are funded at their trace demand first, then the wrapped policy
runs unchanged over a *training-only sub-view* whose ``n_gpus`` is the
remaining budget. Because the executor orders shrinks before grows, the
wrapped policy's smaller water line on a spike turns into stop-free loan
reclaims that fund the serving grants — the wrapped policy never learns
tiers exist.

Wrapping an already-serving-aware policy is harmless: its own
``reserve_serving`` pass sees a sub-view with no serving jobs and
becomes a no-op.
"""
from __future__ import annotations

from repro_torch.sched.base import alive_jobs, group_size, likely_next_shapes, \
    reserve_serving, serving_demand, tier_of


class _TrainingView:
    """The wrapped policy's world: the same view minus serving tenants,
    with the serving tier's devices already spent from the budget."""

    def __init__(self, view, budget: int):
        self.n_gpus = max(0, int(budget))
        self.now = view.now
        self.running = {jid: j for jid, j in view.running.items()
                        if tier_of(j) != "serving"}
        self.pending = [j for j in view.pending
                        if tier_of(j) != "serving"]
        self.throughput_model = getattr(view, "throughput_model", None)


class CrossTierPolicy:
    """``policy(view) -> {jid: target}`` with serving-first budgeting.

    ``headroom`` grants each serving tenant that many replica groups
    beyond its instantaneous demand when the pool affords it — a buffer
    against a spike arriving faster than a reschedule period."""

    def __init__(self, training_policy, *, headroom: int = 0):
        self.training_policy = training_policy
        self.headroom = int(headroom)

    def __call__(self, view) -> dict:
        alloc: dict = {}
        _, budget = reserve_serving(view, alloc, headroom=self.headroom)
        alloc.update(self.training_policy(_TrainingView(view, budget)))
        return alloc

    def likely_shapes(self, view, job):
        """Prefetch hook: serving tenants only ever move ±1 replica group
        at their fixed degree; training shapes come from the wrapped
        policy's own hook through the sub-view."""
        if tier_of(job) == "serving":
            gs = group_size(job)
            want = serving_demand(job, view.now)
            return [(want, gs), (job.alloc + 1, gs), (job.alloc - 1, gs)]
        sub = _TrainingView(view, view.n_gpus)
        return likely_next_shapes(self.training_policy, sub, job)


def serving_jobs(view) -> list:
    """The alive serving tenants in a view, arrival order."""
    return sorted((j for j in alive_jobs(view) if tier_of(j) == "serving"),
                  key=lambda j: (j.arrival, j.jid))
