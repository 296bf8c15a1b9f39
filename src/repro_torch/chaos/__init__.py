"""Fault injection for the elastic cluster stack.

``FaultPlan`` (plan.py) is a seeded, serializable schedule of failure
events — kill worker w of job j, revoke n devices at round R, crash an
in-flight checkpoint save, delay a worker into a straggler.
``FaultInjector`` (inject.py) replays a plan against a running
``ClusterExecutor``; the executor's own detection/recovery machinery
(membership liveness -> stop-free scale-in -> checkpoint fallback) does
the rest — injection only breaks things, it never helps recovery.
"""
from repro_torch.chaos.inject import FaultInjector
from repro_torch.chaos.plan import FaultEvent, FaultPlan

__all__ = ["FaultEvent", "FaultPlan", "FaultInjector"]
