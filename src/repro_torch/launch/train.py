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

Schedule grammar: ``<op>:<n>@<step>`` with op in {out, in, migrate,
straggler}. The reference's stop_resume_out, stop_resume_in,
stop_resume_mp, fail, kill and kill_leader ops, ``--virtual-workers`` and
``--model-parallel > 1`` are not yet ported and are refused when the
arguments are parsed.
"""
import argparse
import json
import os
import sys
import time

PORTED_OPS = ("out", "in", "migrate", "straggler")
NOT_PORTED_OPS = ("stop_resume_out", "stop_resume_in", "stop_resume_mp",
                  "fail", "kill", "kill_leader")


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
        if opn in NOT_PORTED_OPS:
            ap.error(f"schedule op {opn!r} is not yet ported")
        if opn not in PORTED_OPS:
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
                    help="not yet ported")
    args = ap.parse_args(argv)
    if args.virtual_workers is not None:
        ap.error("--virtual-workers is not yet ported")
    if args.model_parallel != 1:
        ap.error("--model-parallel > 1 is not yet ported")
    schedule = parse_schedule(ap, args.schedule)

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
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
        elif opn == "straggler":
            trainer.injected_delay[trainer.worker_ids[-1]] = 0.05

    cfg = get_config(args.arch, smoke=args.smoke)
    trainer = ElasticTrainer(
        cfg, global_batch=args.batch, seq_len=args.seq,
        init_parallelism=args.init_p, optimizer=adamw(args.lr),
        n_samples=args.n_samples, d_partitions=args.d_partitions,
        seed=args.seed, devices=slot_devices(args.devices, args.device))

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
