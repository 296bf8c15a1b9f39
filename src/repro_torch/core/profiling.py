"""profile(job, min_p, max_p) — EDL §5.2 (the reference's module, copied).

Start at max_p and *scale in* step by step (scale-in is nearly free), paying
execution-context preparation once instead of once per parallelism as
stop-resume profiling does. Returns a structured ``ProfileTable``
(throughput + per-GPU throughput + GPU efficiency per parallelism) that
the reference's ``sched.throughput.MeasuredModel.ingest`` consumes directly.

The sweep is transparent to the job: the trainer is restored to the
parallelism it entered with before profile() returns (earlier versions
left it parked at ``min_p``), and with ``release=True`` every scale-in
step above the restore target hands its devices back through the trainer's
``on_devices_released`` hook — which is how the cluster executor profiles
on transient idle devices without leaking them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ProfilePoint:
    p: int                  # data-parallel replicas (device GROUPS)
    throughput: float       # measured samples/s over the sweep window
    per_gpu: float          # throughput / (p * group_size): per DEVICE
    efficiency: float       # per_gpu normalized by the sweep's best per_gpu
    step_time: float        # seconds per mini-batch (batch / throughput)


@dataclasses.dataclass
class ProfileTable:
    """Structured result of one profile() sweep: ``entries[p]`` maps each
    visited parallelism to its measured ProfilePoint."""

    entries: dict[int, ProfilePoint]

    def __getitem__(self, p: int) -> ProfilePoint:
        return self.entries[p]

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, p: int) -> bool:
        return p in self.entries

    def items(self):
        return self.entries.items()

    @classmethod
    def from_throughputs(cls, thr: dict[int, float],
                         batch: float | None = None,
                         group_size: int = 1) -> "ProfileTable":
        """Build a table from raw {p: samples/s} measurements (tests,
        external profilers). ``p`` is in data-parallel replicas;
        ``group_size`` (the job's model-parallel degree) converts the
        per-replica numbers to true per-DEVICE throughput. Efficiency is
        group_size-invariant (the constant cancels in the normalization),
        so mp=1 tables are bit-identical to the pre-group format."""
        gs = max(1, int(group_size))
        best = max((t / (p * gs) for p, t in thr.items() if p > 0),
                   default=1.0)
        return cls({p: ProfilePoint(
            p=p, throughput=t, per_gpu=t / (p * gs),
            efficiency=(t / (p * gs)) / best if best > 0 else 0.0,
            step_time=(batch / t) if batch and t > 0 else float("nan"))
            for p, t in thr.items()})


def _feasible(trainer, p: int) -> bool:
    batch = getattr(trainer, "global_batch", None)
    return p >= 1 and (batch is None or batch % p == 0)


def profile(trainer, min_p: int, max_p: int, *, steps_per_p: int = 10,
            release: bool = False, restore_p: int | None = None
            ) -> ProfileTable:
    """Measure throughput/efficiency for feasible p in [min_p, max_p] via a
    scale-in sweep on a live trainer (must currently run at >= max_p or be
    scalable out to max_p from its own device pool).

    ``restore_p`` is the parallelism the trainer is returned to afterwards
    (default: whatever it ran at on entry). With ``release=True``, devices
    vacated by sweep steps that stay above ``restore_p`` are released to
    ``on_devices_released`` as they free up — the cluster executor's
    borrowed idle devices flow straight back to its pool. Parallelisms
    that do not divide the trainer's global batch are skipped.

    ``min_p``/``max_p`` and every sweep step are in data-parallel replicas
    (device groups): on an mp>1 trainer each scale-in step vacates a whole
    mp-sized group, and the returned table's per-device numbers divide by
    the group size so mixed-mp curves compare in one unit system.
    """
    if min_p > max_p:
        raise ValueError(f"min_p {min_p} > max_p {max_p}")
    p0 = trainer.p if restore_p is None else restore_p
    sweep = [p for p in range(max_p, min_p - 1, -1) if _feasible(trainer, p)]
    if not sweep:
        raise ValueError(f"no feasible parallelism in [{min_p}, {max_p}] "
                         f"for global batch "
                         f"{getattr(trainer, 'global_batch', None)}")
    if trainer.p < sweep[0]:
        trainer.scale_out(sweep[0] - trainer.p)
        trainer.wait_for_scaling()
    raw: dict[int, float] = {}
    for i, p in enumerate(sweep):
        if trainer.p != p:
            n = trainer.p - p
            # release only while the sweep stays at/above the restore
            # target: devices below it must stay in the trainer's pool so
            # the restore scale-out needs no new grant
            trainer.scale_in(n, block=True,
                             release=release and p >= p0)
        trainer.run(steps_per_p)
        raw[p] = trainer.throughput(max(steps_per_p - 2, 1))
    # restore the trainer's original parallelism — a profiling sweep must
    # be invisible to the job's schedule once it returns
    if trainer.p < p0:
        trainer.scale_out(p0 - trainer.p)
        trainer.wait_for_scaling()
    elif trainer.p > p0:
        trainer.scale_in(trainer.p - p0, block=True, release=release)
    batch = getattr(trainer, "global_batch", None)
    return ProfileTable.from_throughputs(
        raw, batch=batch,
        group_size=getattr(trainer, "model_parallel", 1))
