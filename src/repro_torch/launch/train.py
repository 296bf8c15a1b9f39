"""Elastic training driver (end-to-end example + integration-test target).

Trains an elastic job under a scaling schedule and reports metrics, scaling
records and exactly-once data accounting as JSON, with the reference
driver's flags, schedule grammar and JSON keys.

  python -m repro_torch.launch.train --arch edl-paper --steps 200 \\
      --batch 8 --seq 1024 --init-p 1 --devices 2 --schedule out:1@30

``--devices N`` is the number of logical slots in the job's pool; they map
onto the visible cards (several slots on one card when there is one).
``--device cpu`` runs every slot on the CPU; the default is ``cuda``, and a
run that asks for CUDA without a card fails.

``--model-parallel M`` runs each data-parallel worker as a group of M slots
(tensor parallelism over the model axis); ``--devices`` counts slots, so
the job can grow to ``devices / M`` workers.

Schedule grammar: ``<op>:<n>@<step>`` with op in {out, in, migrate,
stop_resume_out, stop_resume_in, stop_resume_mp, straggler, fail, kill,
kill_leader}.
``kill:n`` crashes the last n workers WITHOUT an explicit recovery call:
they stop sending gradient-syncs, the leader's liveness view flags them
dead after ``miss_threshold`` missed steps, and the driver's detection loop
triggers an automatic stop-free ``handle_failure`` scale-in
(``kill_leader`` crashes the current leader instead, forcing a re-election
at the commit). ``fail`` is the blocking path (immediate ``recover``,
approximate under USE_APPX_RECOVERY=1). ``stop_resume_out:n`` and
``stop_resume_in:n`` checkpoint the job to disk, tear it down and resume it
at p ± n (the paper's stop-resume baseline). ``stop_resume_mp:M``
checkpoint-stops the job and resumes it reparallelized at model-parallel
degree M, its slot footprint held constant: (p, mp) -> (p mp / M, M).

``--virtual-workers K`` (or ``auto``) turns on deterministic elasticity:
the loss trajectory (the JSON ``losses`` field) is bitwise-identical
across every (p, mp) and every elastic schedule above, kills and
stop-resumes included.

The RWKV6 mixers have no tensor-parallel form yet: ``--arch rwkv6-1.6b``
with ``--model-parallel`` above 1, or a ``stop_resume_mp`` to it, is
refused when the arguments are parsed.
"""
import argparse
import json
import os
import sys
import time

OPS = ("out", "in", "migrate", "stop_resume_out", "stop_resume_in",
       "stop_resume_mp", "straggler", "fail", "kill", "kill_leader")


def parse_schedule(ap: argparse.ArgumentParser, text: str
                   ) -> dict[int, list[tuple[str, int]]]:
    schedule: dict[int, list[tuple[str, int]]] = {}
    if not text:
        return schedule
    for item in text.split(","):
        try:
            opn, rest = item.split(":")
            n, at = rest.split("@")
            n, at = int(n), int(at)
        except ValueError:
            ap.error(f"bad schedule entry {item!r}: expected <op>:<n>@<step>")
        if opn not in OPS:
            ap.error(f"unknown schedule op {opn!r}")
        schedule.setdefault(at, []).append((opn, n))
    return schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="edl-paper")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--init-p", type=int, default=2)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--devices", type=int,
                    default=int(os.environ.get("EDL_DEVICES", "8")),
                    help="logical slots in the job's pool")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--schedule", default="")
    ap.add_argument("--n-samples", type=int, default=1 << 14)
    ap.add_argument("--d-partitions", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--json", action="store_true", help="machine output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--virtual-workers", default=None, metavar="K",
                    help="fixed virtual-worker count (int or 'auto') — "
                         "deterministic elasticity: bitwise-identical "
                         "trajectories at every p")
    args = ap.parse_args(argv)
    vw = args.virtual_workers
    if vw is not None and vw != "auto":
        try:
            vw = int(vw)
        except ValueError:
            ap.error(f"--virtual-workers takes an int or 'auto', not {vw!r}")
    schedule = parse_schedule(ap, args.schedule)

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.parallel import require_model_parallel

    cfg = get_config(args.arch, smoke=args.smoke)
    try:
        for mp in {args.model_parallel} | {n for ops in schedule.values()
                                           for opn, n in ops
                                           if opn == "stop_resume_mp"}:
            require_model_parallel(cfg, mp)
    except NotImplementedError as e:
        ap.error(str(e))
    from repro_torch.core import ElasticTrainer, stop_resume_rescale
    from repro_torch.core.failure import fail_worker, recover
    from repro_torch.core.scaling import Busy, Phase
    from repro_torch.devices import slot_devices
    from repro_torch.optim import adamw

    def _apply_op(trainer, opn, n):
        if opn == "out":
            trainer.scale_out(n)
        elif opn == "in":
            trainer.scale_in(n)
        elif opn == "migrate":
            trainer.migrate(n)
        elif opn == "stop_resume_out":
            stop_resume_rescale(trainer, trainer.p + n)
        elif opn == "stop_resume_in":
            stop_resume_rescale(trainer, trainer.p - n)
        elif opn == "stop_resume_mp":
            # checkpoint-based reparallelization onto mp=n at a constant
            # slot footprint: (p, mp) -> (p*mp/n, n)
            stop_resume_rescale(
                trainer, max(1, trainer.p * trainer.model_parallel // n),
                target_mp=n)
        elif opn == "straggler":
            trainer.injected_delay[trainer.worker_ids[-1]] = 0.05
        elif opn == "fail":
            fail_worker(trainer, trainer.worker_ids[-1])
            recover(trainer)
        elif opn == "kill":
            # no recovery call here: detection (below) must find them
            for wid in list(reversed(trainer.worker_ids))[:n]:
                trainer.inject_worker_failure(wid)
        elif opn == "kill_leader":
            trainer.inject_worker_failure(trainer.leader_id)

    trainer = ElasticTrainer(
        cfg, global_batch=args.batch, seq_len=args.seq,
        init_parallelism=args.init_p, model_parallel=args.model_parallel,
        optimizer=adamw(args.lr),
        n_samples=args.n_samples, d_partitions=args.d_partitions,
        seed=args.seed, devices=slot_devices(args.devices, args.device),
        virtual_workers=vw)

    consumed_ids: list = []
    log = print if not args.json else (lambda *a, **k: None)
    t0 = time.monotonic()
    deadline = t0 + float(os.environ.get("EDL_WALL_LIMIT_S", "600"))

    def pending_ops():
        return any(k >= trainer.step_idx and v for k, v in schedule.items())

    with trainer:
        # main loop runs to --steps, then drains: pending (retried) schedule
        # entries and any in-flight background scaling commit before exit
        while (trainer.step_idx < args.steps or pending_ops()
               or trainer.controller.phase is not Phase.IDLE):
            if time.monotonic() > deadline:
                break
            for opn, n in schedule.pop(trainer.step_idx, []):
                try:
                    _apply_op(trainer, opn, n)
                except Busy:    # paper: scheduler retries after a delay
                    schedule.setdefault(trainer.step_idx + 5, []).append(
                        (opn, n))
            m = trainer.step()
            # automatic dead-worker recovery: the leader's liveness view
            # (missed gradient-syncs) drives a stop-free scale-in; training
            # continues through the background prep and the trajectory is
            # bitwise-preserved under --virtual-workers
            dead = trainer.dead_workers()
            if dead and trainer.controller.phase is Phase.IDLE:
                try:
                    trainer.handle_failure(dead)
                except (Busy, ValueError):
                    pass    # retried next step / no feasible survivor shape
            if m is None:
                if trainer.controller.phase is Phase.SCHEDULED:
                    trainer._commit_switch()
                continue
            consumed_ids.append(trainer._last_sample_ids)
            # straggler mitigation: leader removes flagged workers (§5.2)
            for wid in trainer._flagged_stragglers:
                trainer.injected_delay.pop(wid, None)
                try:
                    trainer.scale_in(1, victims=[wid])
                except (Busy, ValueError):
                    pass
            if m["step"] % 20 == 0:
                log(f"step {m['step']:5d} p={m['p']} loss={m['loss']:.4f} "
                    f"thr={trainer.throughput():.1f} samp/s")
    wall = time.monotonic() - t0

    ids = np.concatenate(consumed_ids) if consumed_ids else np.array([])
    epochs_done = trainer.pipeline.epoch
    summary = {
        "arch": cfg.name, "steps": trainer.step_idx, "final_p": trainer.p,
        "wall_s": round(wall, 2),
        "final_loss": trainer.metrics_log[-1]["loss"],
        "first_loss": trainer.metrics_log[0]["loss"],
        "losses": [m["loss"] for m in trainer.metrics_log],
        "virtual_workers": trainer.n_virtual,
        "throughput": trainer.throughput(),
        "scaling_events": [r.summary() for r in trainer.controller.history],
        "samples_seen": int(trainer.samples_seen),
        "unique_sample_frac": (float(len(set(ids.tolist())) / len(ids))
                               if len(ids) else 0.0),
        "epochs_done": epochs_done,
        "leader": trainer.leader_id,
    }
    # exactly-once check over any FULL epochs completed
    if epochs_done >= 1 and len(ids) >= trainer.dataset.n_samples:
        first_epoch = ids[:trainer.dataset.n_samples]
        summary["epoch0_exactly_once"] = bool(
            sorted(first_epoch.tolist()) ==
            list(range(trainer.dataset.n_samples)))
    print(json.dumps(summary) if args.json else
          json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
