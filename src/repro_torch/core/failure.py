"""Failure recovery (EDL §4.2): forced exit is a special case of scale-in.

* consistent recovery — resume from the latest periodic checkpoint (model
  consistency guaranteed);
* approximate recovery — drop the failed worker, rebuild the topology with
  the survivors and redo the current mini-batch (bounded error, the model
  may have partially-aggregated gradients; acceptable for SGD).

Selected via USE_APPX_RECOVERY, mirroring the paper's env-var switch.
"""
from __future__ import annotations

import os
import time

import torch

from repro_torch.core.election import LeaderElection
from repro_torch.core.elastic_runtime import groups_to_tail
from repro_torch.core.scaling import ScalingRecord
from repro_torch.core.stop_resume import resume_from_checkpoint


def use_approximate() -> bool:
    return os.environ.get("USE_APPX_RECOVERY", "0") not in ("0", "", "false")


def fail_worker(trainer, worker_id: str) -> None:
    """Simulate a worker crash: it stops syncing; the leader detects it via
    missing gradient-sync requests (Membership.dead_workers). The failure
    is persistent — the step loop skips the crashed worker's sync from now
    on — and its liveness record is aged out so detection can fire
    immediately."""
    trainer.failed_workers.add(worker_id)
    trainer.membership.workers[worker_id].last_sync_step = -10**9


def recover(trainer, *, checkpoint_dir: str | None = None
            ) -> ScalingRecord | None:
    """Detect dead workers and recover with the chosen protocol."""
    dead = trainer.membership.dead_workers(trainer.step_idx)
    if not dead:
        return None
    if use_approximate():
        return _approximate(trainer, dead)
    return _consistent(trainer, dead, checkpoint_dir)


def _drop_dead(trainer, dead):
    # the dead workers' slot groups go to the pool's tail, as
    # handle_failure does, so the survivor topology is built on
    # devices[:p * mp], all live slots
    trainer.devices = groups_to_tail(
        trainer.devices, trainer.worker_ids,
        [w for w in trainer.worker_ids if w in dead],
        trainer.model_parallel)
    for wid in dead:
        trainer._remove_worker(wid, dead=True)
    if trainer.leader_id in dead:
        trainer.election.resign()
        trainer.election = LeaderElection(trainer.store, trainer.job_handle,
                                          trainer.worker_ids[0])
        trainer.leader_id = trainer.election.elect().leader_id


def _approximate(trainer, dead) -> ScalingRecord:
    rec = ScalingRecord("approx_recovery", trainer.p,
                        trainer.p - len(dead), t_request=time.monotonic())
    rec.t_prep_start = rec.t_request
    _drop_dead(trainer, dead)
    handle = trainer._build_exec(len(trainer.worker_ids))
    rec.t_prep_end = time.monotonic()
    rec.t_switch_start = rec.t_prep_end
    trainer.state, _ = trainer._state_for(handle, None)
    for dev in trainer._state_devices(trainer.state):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    trainer.exec = handle
    trainer.p = handle.p
    rec.t_switch_end = time.monotonic()
    trainer.controller.history.append(rec)
    return rec


def _consistent(trainer, dead, checkpoint_dir) -> ScalingRecord:
    """Reload the latest periodic checkpoint and restart with survivors."""
    if not checkpoint_dir:
        raise ValueError("consistent recovery needs a periodic checkpoint "
                         "(checkpoint_dir); USE_APPX_RECOVERY=1 selects "
                         "approximate recovery")
    rec = ScalingRecord("consistent_recovery", trainer.p,
                        trainer.p - len(dead), t_request=time.monotonic())
    rec.t_prep_start = rec.t_request
    _drop_dead(trainer, dead)
    target_p = len(trainer.worker_ids)
    trainer.state = None
    trainer.exec = None
    torch.cuda.empty_cache()
    handle = trainer._build_exec(target_p)
    rec.t_prep_end = time.monotonic()
    trainer.exec = handle
    trainer.p = target_p
    resume_from_checkpoint(trainer, checkpoint_dir)
    rec.t_switch_end = time.monotonic()
    rec.t_switch_start = rec.t_request   # everything was stopped
    trainer.controller.history.append(rec)
    return rec
