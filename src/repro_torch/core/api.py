"""EDL public API (paper Table 1).

Scheduler-facing:  scale_in / scale_out / profile / migrate on a job handle.
Framework-facing:  elastic_shard_generator / notify_batch_end on the trainer.

The paper's API listing spells the operators ``sclae_in``/``sclae_out``;
aliases with that spelling are provided for fidelity.
"""
from __future__ import annotations

from repro_torch.core.elastic_runtime import ElasticTrainer
from repro_torch.core.scaling import Busy


class EDLJob:
    """Scheduler's view of one elastic job."""

    _registry: dict[str, "EDLJob"] = {}

    def __init__(self, job_handle: str, trainer: ElasticTrainer):
        self.job_handle = job_handle
        self.trainer = trainer
        EDLJob._registry[job_handle] = self

    # ------------------------------------------------- scheduler API
    def scale_in(self, rmv_gpu_info: int | list[str] = 1, *,
                 block: bool = False):
        """Remove GPUs (slices) from the job. Returns ack record or raises
        Busy -> the scheduler should RETRY later (paper §3.1)."""
        victims = rmv_gpu_info if isinstance(rmv_gpu_info, list) else None
        n = len(victims) if victims else int(rmv_gpu_info)
        return self.trainer.scale_in(n, victims=victims, block=block)

    def scale_out(self, add_gpu_info: int = 1, *, block: bool = False):
        return self.trainer.scale_out(int(add_gpu_info), block=block)

    def profile(self, min_p: int | None = None, max_p: int | None = None,
                **kw):
        """EDL profile(): a scale-in sweep returning a ProfileTable; with
        no range, report the running job's current point only."""
        from repro_torch.core.profiling import ProfileTable, profile as _profile
        if min_p is None and max_p is None:     # running job: report current
            return ProfileTable.from_throughputs(
                {self.trainer.p: self.trainer.throughput()},
                batch=getattr(self.trainer, "global_batch", None),
                group_size=getattr(self.trainer, "model_parallel", 1))
        return _profile(self.trainer, min_p, max_p, **kw)

    def migrate(self, n: int = 1):
        return self.trainer.migrate(n)

    # paper-spelling aliases (Table 1)
    sclae_in = scale_in
    sclae_out = scale_out

    # ------------------------------------------------- framework API
    def elastic_shard_generator(self, worker_id: str):
        """Generator of partition meta-data for a DL-framework data loader."""
        it = self.trainer.iters[worker_id]
        while True:
            a = it.pipeline.next_assignment(worker_id)
            yield a

    def notify_batch_end(self):
        self.trainer.notify_batch_end()

    @classmethod
    def get(cls, job_handle: str) -> "EDLJob":
        return cls._registry[job_handle]


__all__ = ["EDLJob", "Busy"]
