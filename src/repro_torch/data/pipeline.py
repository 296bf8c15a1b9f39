"""EDL's dynamic data pipeline (§4.3) and the static-allocation baseline.

Leader-side, on-demand partition assignment:
  * the leader holds a per-epoch random permutation of partition indices;
  * a worker calling ``next_assignment(worker)`` receives the next unassigned
    partition's metadata (or a partially-consumed one returned by an exiting
    worker — those are served first so nothing is lost or repeated);
  * workers report (partition, offset) progress with each gradient-sync
    (``report_progress``), so the leader can re-queue the unread remainder if
    the worker leaves or dies;
  * when every partition of the epoch is fully consumed the next epoch starts
    with a fresh permutation.

Guarantee: within an epoch every sample index is served exactly once,
regardless of the scaling schedule (property-tested in tests/test_pipeline.py).
Order may differ between runs — the paper's accepted consistency semantics.

``VirtualWorkerPipeline`` is the stronger, EasyScale-style alternative: a
fixed ``n_virtual`` of logical workers each own a contiguous sample block
and a private permutation stream, and physical workers host contiguous
blocks of virtual workers — so the global batch at step N is the same
sample SEQUENCE at every data parallelism, which is what makes elastic
training bitwise-reproducible (see docs/architecture.md, "Deterministic
elasticity").
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterator

import numpy as np

from repro_torch.data.partition import Partition, PartitionAssignment, \
    make_partitions, virtual_block


class EpochExhausted(Exception):
    """No data left in this epoch for now (assignments may still be in
    flight; the epoch rolls over once they complete)."""


@dataclasses.dataclass
class _InFlight:
    assignment: PartitionAssignment
    consumed: int       # samples the worker has reported done (>= offset)


class DynamicDataPipeline:
    def __init__(self, n_samples: int, d_partitions: int, *, seed: int = 0,
                 max_epochs: int | None = None):
        self.partitions = make_partitions(n_samples, d_partitions)
        self.n_samples = n_samples
        self.seed = seed
        self.epoch = 0
        self.max_epochs = max_epochs
        self._start_epoch()

    # ------------------------------------------------------------ epochs
    def _start_epoch(self):
        rng = np.random.default_rng(self.seed + 7919 * self.epoch)
        self._queue: deque[PartitionAssignment] = deque(
            PartitionAssignment(self.partitions[i], 0)
            for i in rng.permutation(len(self.partitions)))
        self._returned: deque[PartitionAssignment] = deque()
        self._in_flight: dict[str, _InFlight] = {}
        self._done_samples = 0

    def _maybe_roll_epoch(self):
        if (self._done_samples == self.n_samples and not self._queue
                and not self._returned and not self._in_flight):
            self.epoch += 1
            self._start_epoch()

    @property
    def exhausted(self) -> bool:
        return self.max_epochs is not None and self.epoch >= self.max_epochs

    # ------------------------------------------------------------ leader API
    def next_assignment(self, worker: str) -> PartitionAssignment:
        """Serve the next chunk of data to ``worker`` (partially-consumed
        returns first). Raises EpochExhausted when nothing is available."""
        assert worker not in self._in_flight, \
            f"{worker} must finish/return its partition first"
        if self._returned:
            a = self._returned.popleft()
        elif self._queue:
            a = self._queue.popleft()
        else:
            raise EpochExhausted
        self._in_flight[worker] = _InFlight(a, a.offset)
        return a

    def report_progress(self, worker: str, pid: int, offset: int):
        """Piggybacked on the per-mini-batch gradient-sync request."""
        inf = self._in_flight.get(worker)
        assert inf is not None and inf.assignment.partition.pid == pid
        assert inf.consumed <= offset <= inf.assignment.partition.count
        inf.consumed = offset

    def release(self, worker: str, *, dead: bool = False):
        """Graceful exit (or failure): re-queue the unread remainder of the
        worker's current partition so another worker picks it up."""
        inf = self._in_flight.pop(worker, None)
        if inf is None:
            return
        consumed = inf.consumed if not dead else inf.assignment.offset
        # on failure we conservatively replay from the last *reported* offset
        # (dead=False path) or the original offset under approximate recovery
        part = inf.assignment.partition
        done_now = consumed - inf.assignment.offset
        self._done_samples += done_now
        if consumed < part.count:
            self._returned.append(PartitionAssignment(part, consumed))
        self._maybe_roll_epoch()

    # ---------------------------------------------------------- accounting
    def note_consumed(self, worker: str, n: int) -> tuple[int, bool]:
        """Advance the worker's offset by n samples; returns (new_offset,
        finished). Used by the worker-side iterator."""
        inf = self._in_flight[worker]
        new = inf.consumed + n
        assert new <= inf.assignment.partition.count
        inf.consumed = new
        finished = new == inf.assignment.partition.count
        if finished:
            self._done_samples += new - inf.assignment.offset
            del self._in_flight[worker]
            self._maybe_roll_epoch()
        return new, finished

    # --------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Serializable state: the permutation queue + in-flight offsets.
        In-flight work is treated as returned (replayed from last report).
        The in-flight fold is sorted by partition id so the serialized
        state — and therefore the post-restore remaining sample order — is
        a canonical function of leader state, not of the dict-insertion
        (worker draw) order (regression-tested in tests/test_pipeline.py)."""
        returned = [(a.partition.pid, a.offset) for a in self._returned]
        returned += sorted(
            (i.assignment.partition.pid, i.consumed)
            for i in self._in_flight.values()
            if i.consumed < i.assignment.partition.count)
        return {
            "epoch": self.epoch, "seed": self.seed,
            "done_samples": self._done_samples + sum(
                i.consumed - i.assignment.offset
                for i in self._in_flight.values()),
            "queue": [a.partition.pid for a in self._queue],
            "returned": returned,
        }

    def load_state_dict(self, s: dict):
        self.epoch = s["epoch"]
        self.seed = s["seed"]
        by_pid = {p.pid: p for p in self.partitions}
        self._queue = deque(PartitionAssignment(by_pid[pid], 0)
                            for pid in s["queue"])
        self._returned = deque(PartitionAssignment(by_pid[pid], off)
                               for pid, off in s["returned"])
        self._in_flight = {}
        self._done_samples = s["done_samples"]


class VirtualWorkerPipeline:
    """EasyScale-style deterministic sampling: ``n_virtual`` fixed logical
    workers, each owning one contiguous sample block (``make_partitions``)
    and a private permutation stream seeded by ``(seed, vw, epoch)``.

    The batch for step N is the concatenation, in virtual-worker order
    0..n_virtual-1, of each virtual worker's next ``per_vw`` samples —
    physical worker ``w`` of ``dp`` hosts the contiguous block
    ``virtual_block(w, dp, n_virtual)``, so assembling per-worker draws in
    worker order reproduces the exact same global sequence at every dp.
    Draws wrap epochs per virtual worker (a fresh permutation each wrap),
    so batches are always full and composition never depends on where an
    epoch boundary falls relative to the device count.

    Progress is ``n_virtual`` cursors + epoch counters — device-free, so
    ``state_dict`` round-trips exactly and restores onto any (dp, mp).
    """

    def __init__(self, n_samples: int, n_virtual: int, *, seed: int = 0,
                 max_epochs: int | None = None):
        assert 0 < n_virtual <= n_samples
        self.blocks = make_partitions(n_samples, n_virtual)
        self.n_samples = n_samples
        self.n_virtual = n_virtual
        self.seed = seed
        self.max_epochs = max_epochs
        self.cursors = [0] * n_virtual      # position in the current perm
        self.epochs = [0] * n_virtual       # per-vw epoch counter
        self.samples_served = 0
        self._perms: dict[int, np.ndarray] = {}     # vw -> current perm

    # ------------------------------------------------------------ sampling
    def _perm(self, vw: int) -> np.ndarray:
        p = self._perms.get(vw)
        if p is None:
            blk = self.blocks[vw]
            rng = np.random.default_rng([self.seed, vw, self.epochs[vw]])
            p = blk.start + rng.permutation(blk.count)
            self._perms[vw] = p
        return p

    def draw_for(self, vw: int, n: int) -> np.ndarray:
        """The next ``n`` sample ids of virtual worker ``vw`` (wrapping its
        epoch as needed). Purely cursor-driven: the sequence served is a
        function of (seed, vw, #draws) only."""
        out = []
        while n > 0:
            perm = self._perm(vw)
            take = min(n, len(perm) - self.cursors[vw])
            out.append(perm[self.cursors[vw]:self.cursors[vw] + take])
            self.cursors[vw] += take
            n -= take
            if self.cursors[vw] == len(perm):   # epoch wrap for this vw
                self.cursors[vw] = 0
                self.epochs[vw] += 1
                del self._perms[vw]
        ids = np.concatenate(out) if len(out) != 1 else out[0]
        self.samples_served += len(ids)
        return ids

    def draw_block(self, worker_index: int, dp: int, per_vw: int
                   ) -> np.ndarray:
        """Sample ids for physical worker ``worker_index`` of ``dp``: its
        virtual workers' draws concatenated in virtual order."""
        vws = virtual_block(worker_index, dp, self.n_virtual)
        return np.concatenate([self.draw_for(vw, per_vw) for vw in vws])

    # --------------------------------------------------- trainer interface
    @property
    def epoch(self) -> int:
        """Completed epochs (the slowest virtual worker's count)."""
        return min(self.epochs)

    @property
    def exhausted(self) -> bool:
        return self.max_epochs is not None and self.epoch >= self.max_epochs

    def release(self, worker: str, *, dead: bool = False):
        """No-op: virtual cursors live leader-side and only ever advance at
        batch assembly, so a departing physical worker holds no sample
        state to hand back — its virtual workers are simply re-hosted by
        the next mapping."""

    # --------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Exact serialization: permutations are recomputed from
        (seed, vw, epoch), so cursors + epoch counters ARE the full
        sampling state — save/restore reproduces the identical remaining
        id stream (no replay, no loss)."""
        return {"virtual": True, "n_virtual": self.n_virtual,
                "n_samples": self.n_samples, "seed": self.seed,
                "cursors": list(self.cursors), "epochs": list(self.epochs),
                "samples_served": self.samples_served}

    def load_state_dict(self, s: dict):
        if s.get("n_virtual") != self.n_virtual or \
                s.get("n_samples") != self.n_samples:
            raise ValueError(
                f"virtual-worker state ({s.get('n_virtual')} vws over "
                f"{s.get('n_samples')} samples) does not match this "
                f"pipeline ({self.n_virtual} vws over {self.n_samples})")
        self.seed = s["seed"]
        self.cursors = list(s["cursors"])
        self.epochs = list(s["epochs"])
        self.samples_served = s["samples_served"]
        self._perms = {}


class StaticAllocationPipeline:
    """The baseline EDL argues against (§4.3): partitions are split among p
    workers up-front; re-partitioning is only possible at epoch boundaries."""

    def __init__(self, n_samples: int, d_partitions: int, n_workers: int,
                 *, seed: int = 0):
        self.partitions = make_partitions(n_samples, d_partitions)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.partitions))
        self.shards: dict[int, deque[Partition]] = {
            w: deque() for w in range(n_workers)}
        for i, pidx in enumerate(order):
            self.shards[i % n_workers].append(self.partitions[pidx])

    def next_partition(self, worker: int) -> Partition:
        if not self.shards[worker]:
            raise EpochExhausted
        return self.shards[worker].popleft()
