"""Worker-side data flow: pulls partition assignments from the leader's
dynamic pipeline on demand, reads samples (synthetic stand-in for an HDFS
ranged read), and keeps a double-buffer prefetcher (EDL §4.4's ping-pong
buffer) so the accelerator never waits on I/O.

One iterator per PHYSICAL worker (data-parallel slice); the partitions it
streams through are the pipeline's logical read chunks, not a per-worker
static shard — the whole point of §4.3 is that the worker:partition ratio
is dynamic. The deterministic virtual-worker pipeline
(data.pipeline.VirtualWorkerPipeline) bypasses this iterator entirely:
there the leader assembles batches directly from per-virtual-worker
cursors, so physical workers hold no data-progress state at all.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from repro_torch.data.pipeline import DynamicDataPipeline, EpochExhausted


class WorkerDataIterator:
    """One per physical worker. ``draw(n)`` returns n samples, advancing the
    leader-side progress offsets; on partition exhaustion it transparently
    requests the next assignment from the dynamic pipeline."""

    def __init__(self, worker_id: str, pipeline: DynamicDataPipeline,
                 dataset, *, prefetch: bool = True):
        self.worker_id = worker_id
        self.pipeline = pipeline
        self.dataset = dataset
        self.assignment = None
        self._buf = None            # (dict arrays, cursor)
        self._next_buf = None       # prefetched (assignment, arrays)
        self._prefetch = prefetch
        self._pool = queue.Queue(maxsize=1) if prefetch else None
        self._thread = None

    # -------------------------------------------------------------- reading
    def _fetch(self, assignment):
        p = assignment.partition
        arr = self.dataset.read(p.start + assignment.offset,
                                assignment.remaining)
        return arr

    def _start_prefetch(self, assignment):
        def run():
            self._pool.put(self._fetch(assignment))
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _acquire(self) -> bool:
        """Get the next assignment + data into the active buffer."""
        try:
            a = self.pipeline.next_assignment(self.worker_id)
        except EpochExhausted:
            return False
        self.assignment = a
        if self._prefetch and self._thread is not None:
            arr = self._pool.get()
            self._thread = None
        else:
            arr = self._fetch(a)
        self._buf = ({k: v for k, v in arr.items()}, 0)
        return True

    def draw(self, n: int) -> dict | None:
        """n samples for this worker's share of the mini-batch, or None if
        the epoch is exhausted for this worker right now."""
        out: list[dict] = []
        need = n
        epoch0 = self.pipeline.epoch
        while need > 0:
            if self.assignment is None:
                # a draw never crosses an epoch boundary: batches are cut at
                # the boundary so per-epoch exactly-once accounting is exact
                if self.pipeline.epoch != epoch0:
                    break
                if not self._acquire():
                    if out:     # partial — put nothing back, keep semantics
                        break
                    return None
            arrs, cur = self._buf
            avail = len(arrs["sample_ids"]) - cur
            take = min(avail, need)
            out.append({k: v[cur:cur + take] for k, v in arrs.items()})
            self._buf = (arrs, cur + take)
            need -= take
            _, finished = self.pipeline.note_consumed(self.worker_id, take)
            if finished:
                self.assignment = None
                self._buf = None
        if not out:
            return None
        return {k: np.concatenate([o[k] for o in out]) for k in out[0]}

    # ----------------------------------------------------------- lifecycle
    def graceful_exit(self):
        """Return the unread remainder to the leader (EDL graceful exit)."""
        self.pipeline.release(self.worker_id)
        self.assignment = None
        self._buf = None

    def progress(self) -> tuple[int, int] | None:
        if self.assignment is None:
            return None
        inf = self.pipeline._in_flight.get(self.worker_id)
        return (self.assignment.partition.pid,
                inf.consumed if inf else self.assignment.offset)
