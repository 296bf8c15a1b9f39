"""FaultInjector — replays a FaultPlan against a live ClusterExecutor.

The injector ONLY breaks things. A kill makes the worker stop sending
gradient-syncs (``trainer.inject_worker_failure``); the leader's
membership view then flags it dead after ``miss_threshold`` missed steps
and the EXECUTOR's recovery path — stop-free scale-in, or checkpoint
fallback when the survivor shape is infeasible — takes over. A
revocation calls ``executor.revoke_devices`` (free devices vanish,
held ones are reclaimed and condemned). A checkpoint crash arms a
one-shot save failure the executor's retry path must absorb. A delay
feeds the existing straggler machinery.

Every event's outcome (fired / dropped / deferred-and-retried) is
recorded in ``self.log`` so a chaos run can assert nothing was silently
swallowed.
"""
from __future__ import annotations

from repro_torch.chaos.plan import FaultEvent, FaultPlan


class FaultInjector:
    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.pending: list[FaultEvent] = list(plan.events)
        self.log: list[dict] = []

    # ------------------------------------------------------------- plumbing
    def _record(self, ex, event: FaultEvent, outcome: str, **extra):
        self.log.append({"round": ex.round, "outcome": outcome,
                         "event": event.to_dict(), **extra})
        obs = getattr(ex, "obs", None)
        if obs is not None:
            obs.on_fault(ex, f"inject_{event.kind}", outcome=outcome,
                         **extra, plan_event=event.to_dict())

    def _target_job(self, ex, event: FaultEvent):
        """Resolve the event's target among RUNNING jobs. None = not
        resolvable right now (deferred); raises LookupError when it can
        never fire (job finished)."""
        if event.jid is None:
            running = sorted(ex.running.values(),
                             key=lambda j: (-j.devices_held, j.jid))
            return running[0] if running else None
        job = ex.jobs.get(event.jid)
        if job is None or job.finish_time is not None:
            raise LookupError(f"job {event.jid} finished or unknown")
        return job if job.jid in ex.running else None

    # ------------------------------------------------------------------ tick
    def tick(self, ex):
        """Fire every due event. Called once per executor round, before
        jobs step. Events whose preconditions don't hold yet (target job
        parked, mid-switch) stay pending and retry next round."""
        for event in list(self.pending):
            if ex.round < event.at:
                continue
            try:
                done = self._fire(ex, event)
            except LookupError as e:
                self.pending.remove(event)
                self._record(ex, event, "dropped", reason=str(e))
                continue
            if done:
                self.pending.remove(event)

    def _fire(self, ex, event: FaultEvent) -> bool:
        kind = event.kind
        if kind == "crash_checkpoint":
            ex._crash_next_ckpt = True
            self._record(ex, event, "fired")
            return True
        if kind == "revoke_devices":
            # hand off in full: the executor owns any shortfall via its
            # deferred-revocation queue (retried every round) — the
            # injector must NOT also retry, or the revocation would be
            # double-counted once a target appears
            taken = ex.revoke_devices(event.n_devices, jid=event.jid)
            self._record(ex, event, "fired", devices=taken,
                         deferred=event.n_devices - taken)
            return True
        # kill_worker / delay_worker need a live target
        job = self._target_job(ex, event)
        if job is None:
            return False            # deferred: parked or not yet admitted
        trainer = job.trainer
        if event.step is not None and job.steps_done < event.step:
            return False            # step gate not reached yet
        wids = list(trainer.worker_ids)
        if not wids:
            return False
        wid = wids[(event.worker or 0) % len(wids)]
        if kind == "delay_worker":
            trainer.injected_delay[wid] = event.delay_s
            ex._event("inject_delay", job, job.alloc, job.alloc, loaned=0,
                      worker=wid, delay_s=event.delay_s)
            self._record(ex, event, "fired", worker=wid)
            return True
        # kill_worker
        inject = getattr(trainer, "inject_worker_failure", None)
        if inject is None:
            raise LookupError(
                f"trainer for job {job.jid} has no inject_worker_failure")
        inject(wid)
        self._record(ex, event, "fired", worker=wid)
        return True
