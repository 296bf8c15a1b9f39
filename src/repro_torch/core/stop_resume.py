"""Checkpoint-stop / resume-from-disk entry points, and the stop-resume
rescale baseline (the approach EDL replaces, §2.2).

  * ``stop_resume_rescale`` — the paper's Table-2 baseline: checkpoint, tear
    everything down (state, prepared handles, cached device memory),
    rebuild at the new parallelism from scratch, restore, resume. All
    workers are stopped for the whole duration.
  * ``checkpoint_save`` + ``teardown_trainer`` (``checkpoint_stop`` in one
    call) stop a RUNNING job to disk and return its slots;
    ``resume_from_checkpoint`` restores into a freshly built trainer —
    possibly at another parallelism — the train state, the data pipeline's
    progress and the step / sample counters, so training continues exactly
    where it stopped.

The npz holds whole arrays, whatever the writer's ``(dp, mp)``, so files
stay interchangeable with the JAX package; the writer's layout rides along
as its ``StateSpec``, and a restore onto another shape is planned from it
(``meta["reshard"]``) before the arrays land on the trainer's model shards.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.scaling import Busy, Phase, ScalingRecord
from repro_torch.parallel import require_model_parallel
from repro_torch.reshape import StateSpec, flatten_tree, gather_state, \
    place_state, plan_reshard
from repro_torch.training.step import join_shards, model_shards, \
    state_shapes


def checkpoint_save(trainer, checkpoint_dir: str) -> None:
    """Write ``trainer``'s full restorable state to ``checkpoint_dir``:
    train state (params + optimizer moments), step / sample counters, and
    the data pipeline's ``state_dict`` — whose serialization folds every
    in-flight partition assignment back into the returned-work queue, so a
    restore resumes exactly-once data consumption. The metadata also
    records the writer's parallelization: ``(p, mp)`` plus its
    ``StateSpec``; the arrays are written whole, gathered from the model
    shards. Read-only with respect to the trainer."""
    state = gather_state(trainer.exec.layout, model_shards(trainer.state))
    save_checkpoint(
        checkpoint_dir, state, step=trainer.step_idx,
        pipeline_state=trainer.pipeline.state_dict(),
        extra={"samples_seen": trainer.samples_seen, "p": trainer.p,
               "mp": trainer.model_parallel,
               "job_handle": trainer.job_handle,
               "virtual_workers": trainer.n_virtual,
               "seed": trainer.seed,
               "state_spec": StateSpec.for_trainer(trainer).to_json()})


def teardown_trainer(trainer) -> list:
    """Release everything a stopped job holds: drop the train state, the
    live handle and the prepared-handle cache, and return the job's whole
    slot pool to the caller."""
    devices, trainer.devices = list(trainer.devices), []
    trainer.state = None
    trainer.exec = None
    trainer._exec_cache.clear()
    return devices


def checkpoint_stop(trainer, checkpoint_dir: str) -> list:
    """Stop a RUNNING job to disk mid-run: checkpoint, then tear down.
    Returns the slots the job owned. Raises ``Busy`` (the paper's RETRY)
    while a scaling operation is in flight — a checkpoint taken mid-switch
    would capture a topology that no longer exists at restore time."""
    if trainer.controller.phase is not Phase.IDLE:
        raise Busy("scaling in flight; checkpoint-stop after it commits")
    checkpoint_save(trainer, checkpoint_dir)
    return teardown_trainer(trainer)


def _check_collection(want: dict, got: dict, what: str):
    """``got`` ({path: shape}) holds exactly the tensors of ``want``."""
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    if missing or unexpected:
        raise ValueError(f"{what} does not match this trainer's state: "
                         f"missing {missing}, unexpected {unexpected}")
    for path, shape in want.items():
        if tuple(got[path]) != tuple(shape):
            raise ValueError(f"{what}: {path} has shape "
                             f"{tuple(got[path])}, this trainer's is "
                             f"{tuple(shape)}")


def resume_from_checkpoint(trainer, checkpoint_dir: str) -> dict:
    """Restore a checkpoint into a freshly built trainer whose execution
    context (``trainer.exec``) already targets the new topology, at any
    ``(p, mp)``. The saved collection — the npz's tensors, and the writer's
    ``StateSpec`` when it recorded one — is checked path by path against
    this trainer's state tree (shapes and dtypes). A recorded spec plans
    the restore as a reshard from the writer's ``(dp, mp)`` onto the
    trainer's, reported under ``meta["reshard"]``; the whole arrays then
    land on the trainer's model shards. Restores the data pipeline's progress and the step / sample counters,
    and invalidates the worker iterators' local buffers so the first draw
    after the resume fetches fresh assignments from the restored
    pipeline."""
    restored, meta = load_checkpoint(checkpoint_dir)
    extra = meta.get("extra") or {}
    # deterministic elasticity: the virtual-worker count is part of the
    # trajectory's identity — a restore must keep it (the pipeline's own
    # load_state_dict then validates cursors against block layout)
    saved_nv = int(extra.get("virtual_workers", 0) or 0)
    if saved_nv != trainer.n_virtual:
        raise ValueError(
            f"checkpoint was written with virtual_workers={saved_nv} but "
            f"the target trainer runs virtual_workers={trainer.n_virtual}; "
            f"bitwise trajectory preservation requires the same fixed "
            f"virtual-worker count at every shape")
    want = flatten_tree(state_shapes(trainer.cfg, trainer.optimizer))
    flat = flatten_tree(restored)
    _check_collection({k: s for k, (s, _) in want.items()},
                      {k: t.shape for k, t in flat.items()}, "checkpoint")
    for path, (_, dtype) in want.items():
        if flat[path].dtype != dtype:
            raise ValueError(f"checkpoint: {path} is {flat[path].dtype}, "
                             f"this trainer's is {dtype}")
    layout = trainer.exec.layout
    if extra.get("state_spec") is not None:
        spec = StateSpec.from_json(extra["state_spec"])
        _check_collection({k: s for k, (s, _) in want.items()},
                          {t.path: t.shape for t in spec.tensors},
                          "checkpoint's state_spec")
        meta["reshard"] = plan_reshard(spec, layout).summary()
    homes = trainer.exec.devices[:layout.mp]
    trainer.state = join_shards(place_state(layout, restored, homes))
    for dev in dict.fromkeys(homes):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    trainer.pipeline.load_state_dict(meta["pipeline"])
    for it in trainer.iters.values():
        it.assignment = None
        it._buf = None
    trainer.step_idx = int(meta.get("step", 0))
    trainer.samples_seen = int(extra.get("samples_seen",
                                         trainer.samples_seen))
    return meta


def stop_resume_rescale(trainer, target_p: int,
                        *, target_mp: int | None = None,
                        checkpoint_dir: str | None = None
                        ) -> ScalingRecord:
    """Adjust ``trainer`` to ``target_p`` (and optionally a new
    model-parallel degree ``target_mp`` — the checkpoint-based
    reparallelization the in-memory RESHAPE verb is compared with) the
    stop-resume way. Training is fully stopped from t_request to
    t_switch_end (stop_time == e2e_time). A checkpoint directory this call
    makes for itself is removed after the restore."""
    if trainer.controller.plan is not None:
        raise Busy("scaling already in flight; retry")   # paper: RETRY
    target_mp = (target_mp if target_mp is not None
                 else trainer.model_parallel)
    require_model_parallel(trainer.cfg, target_mp)
    if target_p * target_mp > len(trainer.devices):
        raise ValueError(f"shape ({target_p}, {target_mp}) needs "
                         f"{target_p * target_mp} slots, trainer owns "
                         f"{len(trainer.devices)}")
    nv = trainer.n_virtual
    if nv and nv % target_p:
        raise ValueError(f"p={target_p} must divide virtual_workers={nv}")
    rec = ScalingRecord("stop_resume", trainer.p, target_p,
                        t_request=time.monotonic(),
                        from_mp=trainer.model_parallel, to_mp=target_mp)
    rec.t_prep_start = rec.t_request
    ckpt = checkpoint_dir or tempfile.mkdtemp(prefix="edl_sr_")
    try:
        # 1. checkpoint and stop
        checkpoint_save(trainer, ckpt)
        # 2. tear down: drop state, prepared handles and cached device
        #    memory — a restarted process pays context preparation from
        #    zero (its nvcc kernels it loads from the build directory)
        trainer.state = None
        trainer.exec = None
        trainer._exec_cache.clear()
        torch.cuda.empty_cache()
        # 3. rebuild the execution context at the new shape (foreground!)
        while len(trainer.worker_ids) > target_p:
            trainer._remove_worker(trainer.worker_ids[-1])
        while len(trainer.worker_ids) < target_p:
            trainer._add_worker()
        handle = trainer._build_exec(target_p, target_mp)
        rec.t_prep_end = time.monotonic()
        # 4. restore model + pipeline state onto the rebuilt topology
        trainer.exec = handle
        trainer.p = target_p
        trainer.model_parallel = target_mp
        meta = resume_from_checkpoint(trainer, ckpt)
        rec.reshard_bytes_moved = (meta.get("reshard") or {}).get(
            "bytes_moved", 0)
    finally:
        if checkpoint_dir is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    rec.t_switch_end = time.monotonic()
    # stop-resume stops everything: stop time is the whole window
    rec.t_switch_start = rec.t_request
    trainer.controller.history.append(rec)
    return rec
