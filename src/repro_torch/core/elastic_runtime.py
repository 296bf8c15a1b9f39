"""ElasticTrainer — EDL's elasticity over the port's logical device slots.

A *worker* is one data-parallel slot; elasticity changes how many slots
step. The global batch is constant at every parallelism (per-slot batch =
global / p), so a training step computes the same math regardless of p.

Stop-free scale-out: the execution-context preparation for a new p is the
port's counterpart of the reference's AOT compile. It builds the handle —
``(p, slot devices, step callable)`` — and warms the step at the per-slot
shape on a side CUDA stream (kernel build at first use, CUDA context on a
new card, allocator growth for the shape), in a background thread while the
current handle keeps stepping. When it lands, the leader schedules the
switch at mini-batch ``t_cur + k`` (k = ceil(T_allowance / T_batch),
T_allowance = 500 ms — paper default); at that boundary the handle is
swapped. The train state stays on slot 0's device, which a switch does not
change, so the stop is the swap and the bookkeeping. Scale-in (graceful
exit) returns the exiting slots' partition remainders to the dynamic data
pipeline.

Not ported yet: virtual workers, ``reshape``, failure handling and dead
workers, device grant/release, the compile service, and staging the
switch's state move during the draining mini-batch.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.coordination import CoordinationStore
from repro_torch.core.election import LeaderElection
from repro_torch.core.membership import Membership, StragglerDetector
from repro_torch.core.scaling import Busy, Phase, ScalingController, \
    ScalingRecord
from repro_torch.data.pipeline import DynamicDataPipeline
from repro_torch.data.synthetic import SyntheticTokenDataset
from repro_torch.data.worker import WorkerDataIterator
from repro_torch.devices import default_pool, resolve_device
from repro_torch.kernels.launches import LAUNCHES
from repro_torch.models.model import param_spec_tree
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import Optimizer, adamw
from repro_torch.training.step import init_train_state, loss_and_grads, \
    make_train_step

TIME_ALLOWANCE_S = 0.5      # paper's T_a
EXEC_CACHE_MAX = 8          # prepared topologies retained per job (LRU)


@dataclasses.dataclass
class ExecHandle:
    """Everything tied to one shape: the 'communication topology'. ``p`` is
    the data-parallel slot count; slot s steps on ``devices[s]``."""
    p: int
    devices: tuple[torch.device, ...]
    step_fn: Callable


class ElasticTrainer:
    """One elastic training job: a synchronous data-parallel trainer whose
    parallelism can be changed stop-free while it runs.

    Public control surface (the scaling entry points raise ``Busy`` — the
    paper's RETRY — while another operation is in flight, and commit at the
    next mini-batch boundary after their background context prep lands):

      step()                 — one synchronous mini-batch on the current
                               topology; also the commit point for any
                               scheduled switch (``notify_batch_end``).
      scale_out/scale_in     — resize within the slots the job owns
                               (victims exit gracefully, returning their
                               data-partition remainders).
      migrate()              — fused scale-in + scale-out at constant p,
                               one topology switch (straggler mitigation).

    ``devices`` is the job's slot pool, one torch device per logical slot
    (several slots may share a card); by default one slot per visible card,
    or per CPU core when ``device`` is the CPU, as the reference's default
    pool is every device, and at least ``init_parallelism`` slots.
    ``use_aot`` warms each new shape during its prep, the counterpart of
    the reference's ahead-of-time compile. Call ``close()``
    (or use the trainer as a context manager) to join a prep still in
    flight before the interpreter exits.
    """

    def __init__(self, cfg, *, global_batch: int, seq_len: int,
                 init_parallelism: int, model_parallel: int = 1,
                 optimizer: Optimizer | None = None,
                 dataset: SyntheticTokenDataset | None = None,
                 n_samples: int = 1 << 14, d_partitions: int = 64,
                 job_handle: str = "job0",
                 store: CoordinationStore | None = None, seed: int = 0,
                 devices=None, use_aot: bool = True,
                 virtual_workers: int | str | None = None,
                 time_allowance_s: float = TIME_ALLOWANCE_S,
                 compile_service=None, device: str = "cuda"):
        if model_parallel != 1:
            raise NotImplementedError("model_parallel > 1 is not yet ported")
        if virtual_workers:
            raise NotImplementedError("virtual workers are not yet ported")
        if compile_service is not None:
            raise NotImplementedError("the compile service is not yet ported")
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.model_parallel = model_parallel
        self.optimizer = optimizer or adamw(1e-3)
        self.devices = ([resolve_device(d) for d in devices]
                        if devices is not None
                        else default_pool(init_parallelism, device))
        self.job_handle = job_handle
        self.store = store or CoordinationStore()
        self.use_aot = use_aot
        self.seed = seed
        self.time_allowance_s = time_allowance_s
        self.n_virtual = 0

        self.dataset = dataset or SyntheticTokenDataset(
            n_samples, seq_len, cfg.vocab, seed=seed,
            d_model=cfg.d_model, embeds=(cfg.frontend == "embeds"))
        self.pipeline = DynamicDataPipeline(self.dataset.n_samples,
                                            d_partitions, seed=seed)

        # control plane
        self.membership = Membership()
        self.controller = ScalingController()
        self.straggler_detector = StragglerDetector()
        self.injected_delay: dict[str, float] = {}

        # bring up the initial topology (this is job launch, not scaling)
        self._exec_cache: dict[tuple, ExecHandle] = {}
        self._exec_lock = threading.Lock()
        self._side_streams: dict[torch.device, torch.cuda.Stream] = {}
        self.p = init_parallelism
        self._worker_seq = 0
        self.worker_ids: list[str] = []
        self.iters: dict[str, WorkerDataIterator] = {}
        for _ in range(init_parallelism):
            self._add_worker()
        self.election = LeaderElection(self.store, job_handle,
                                       self.worker_ids[0])
        self.leader_id = self.election.elect().leader_id

        self.exec = self._build_exec(init_parallelism)
        gen = torch.Generator().manual_seed(seed)
        self.state = init_train_state(cfg, self.optimizer, gen,
                                      self.devices[0])

        self.step_idx = 0
        self.samples_seen = 0
        self.step_time_ema: float | None = None
        self.metrics_log: list[dict] = []
        self.throughput_log: list[tuple[float, int, float]] = []
        self._flagged_stragglers: list[str] = []
        self._prep_thread: threading.Thread | None = None
        self._prep_error: BaseException | None = None

    def close(self):
        """Join the in-flight context prep, if any."""
        t = self._prep_thread
        if t is not None:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- workers
    def _add_worker(self) -> str:
        wid = f"w{self._worker_seq}"
        self._worker_seq += 1
        self.worker_ids.append(wid)
        self.iters[wid] = WorkerDataIterator(
            wid, self.pipeline, self.dataset, prefetch=False)
        self.membership.register(wid, len(self.worker_ids) - 1,
                                 at_step=getattr(self, "step_idx", 0))
        return wid

    def _remove_worker(self, wid: str):
        self.iters.pop(wid).graceful_exit()     # return data remainder
        self.worker_ids.remove(wid)
        self.membership.remove(wid)
        self.straggler_detector.reset(wid)

    # ---------------------------------------------------------- exec handles
    def _exec_key(self, p: int) -> tuple:
        """The exec-cache identity of shape p on a slot-pool prefix, in the
        reference's ``(p, mp, devices)`` form."""
        return (p, self.model_parallel, tuple(str(d) for d in self.devices[:p]))

    def _warm(self, devices: tuple[torch.device, ...]):
        """Run one forward and backward at the per-slot shape on each
        distinct device, with zero params and tokens, on a side stream.
        Touches no trainer state; its kernel launches are tallied as
        warm-ups."""
        per = self.global_batch // len(devices)
        for dev in dict.fromkeys(devices):
            if dev.type != "cuda":
                with LAUNCHES.warming():
                    self._warm_once(dev, per)
                continue
            with torch.cuda.device(dev):
                side = self._side_streams.get(dev)
                if side is None:
                    side = self._side_streams[dev] = torch.cuda.Stream()
                with torch.cuda.stream(side), LAUNCHES.warming():
                    self._warm_once(dev, per)
                side.synchronize()

    def _warm_once(self, dev: torch.device, per: int):
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[self.cfg.param_dtype]
        params = tree_map(lambda s: torch.zeros(s.shape, dtype=dtype,
                                                device=dev),
                          param_spec_tree(self.cfg))
        toks = torch.zeros((per, self.seq_len), dtype=torch.long, device=dev)
        loss, _, _ = loss_and_grads(self.cfg, params,
                                    {"tokens": toks, "labels": toks})
        loss.item()

    def _build_exec(self, p: int) -> ExecHandle:
        """Execution-context preparation for p slots: the step callable over
        the first p slots of the pool, warmed at its shape. This is the cost
        stop-free scaling hides. Handles are cached per (p, mp, slot
        devices), LRU-bounded; a shape the job ran at before (migrate at
        constant p, a compact/expand cycle) skips the warm-up. The expensive
        part runs outside the cache lock."""
        devs = tuple(self.devices[:p])
        key = self._exec_key(p)
        with self._exec_lock:
            cached = self._exec_cache.get(key)
            if cached is not None:
                self._exec_cache[key] = self._exec_cache.pop(key)  # LRU
                return cached
        fn = make_train_step(self.cfg, self.optimizer, devs)
        if self.use_aot:
            self._warm(devs)
        handle = ExecHandle(p, devs, fn)
        with self._exec_lock:
            handle = self._exec_cache.setdefault(key, handle)
            while len(self._exec_cache) > EXEC_CACHE_MAX:
                self._exec_cache.pop(next(iter(self._exec_cache)))
        return handle

    # -------------------------------------------------------------- stepping
    def _assemble_batch(self) -> dict | None:
        """Draw global_batch samples as p per-worker draws (the per-worker
        data flow of the paper; progress offsets update leader-side).

        Epoch tails: draws never cross an epoch boundary, so the final batch
        of an epoch may come up short — it is padded by cycling the drawn
        samples (recorded sample_ids stay un-padded, preserving the
        exactly-once accounting; only the SGD step sees a few duplicates at
        the boundary, the paper-accepted consistency semantics)."""
        per = self.global_batch // self.p
        parts = []
        for wid in self.worker_ids:
            d = self.iters[wid].draw(per)
            if d is not None:
                parts.append(d)
        if not parts:
            return None         # epoch boundary, nothing drawn
        batch = {k: np.concatenate([p_[k] for p_ in parts])
                 for k in parts[0]}
        self._last_sample_ids = batch.pop("sample_ids")
        n = len(self._last_sample_ids)
        if n < self.global_batch:
            reps = -(-self.global_batch // n)
            batch = {k: np.concatenate([v] * reps)[:self.global_batch]
                     for k, v in batch.items()}
        if self.cfg.frontend == "embeds":
            batch = {"embeds": batch["embeds"], "labels": batch["labels"]}
        return batch

    def step(self) -> dict | None:
        """One synchronous mini-batch across the current topology."""
        if self._prep_error is not None:
            err, self._prep_error = self._prep_error, None
            raise RuntimeError("background context prep failed") from err
        t0 = time.monotonic()
        batch = self._assemble_batch()
        if batch is None:
            return None
        self.state, metrics = self.exec.step_fn(self.state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for it
        # simulated per-worker sync times (straggler injection adds delay)
        base = time.monotonic() - t0
        sync_times = {wid: base + self.injected_delay.get(wid, 0.0)
                      for wid in self.worker_ids}
        slowest = max(sync_times.values())
        if slowest > base:      # synchronous training waits for the straggler
            time.sleep(min(slowest - base, 0.05))
        t_step = time.monotonic() - t0
        self.step_idx += 1
        self.samples_seen += self.global_batch
        self.step_time_ema = (t_step if self.step_time_ema is None
                              else 0.7 * self.step_time_ema + 0.3 * t_step)
        for wid in self.worker_ids:
            self.membership.sync(wid, self.step_idx, sync_times[wid])
        self.throughput_log.append(
            (time.monotonic(), self.p, self.global_batch / t_step))
        out = dict(metrics, step=self.step_idx, p=self.p, step_time=t_step)
        self.metrics_log.append(out)
        self.notify_batch_end()
        return out

    # --------------------------------------------------- EDL control plane
    def notify_batch_end(self):
        """The paper's notify_batch_end(): scaling switches happen only at
        mini-batch boundaries; this is where a scheduled switch commits."""
        self._flagged_stragglers = self.straggler_detector.observe(
            {w.worker_id: (w.step_times[-1] if w.step_times else 0.0)
             for w in self.membership.workers.values()})
        plan = self.controller.plan
        if plan is not None and plan.ready and \
                self.step_idx >= plan.switch_step:
            self._commit_switch()

    def scale_out(self, n_new: int = 1, *, block: bool = False
                  ) -> ScalingRecord | None:
        """scale_out(): add n_new data-parallel slots, stop-free. Raises
        Busy (the paper's RETRY) if another scaling op is in flight."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        return self._request("scale_out", self.p + n_new, block=block)

    def scale_in(self, n_remove: int = 1, *, victims: list[str] | None = None,
                 block: bool = False) -> ScalingRecord | None:
        """scale_in(): remove slots via graceful exit. Raises Busy (the
        paper's RETRY) if another scaling op is in flight."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        if self.p - n_remove < 1:
            raise ValueError(f"cannot scale below 1 (p={self.p})")
        return self._request("scale_in", self.p - n_remove, block=block,
                             victims=victims)

    def migrate(self, n: int = 1, *, victims: list[str] | None = None,
                block: bool = True):
        """Fused scale-in + scale-out: one topology switch (§5.2). Pass
        ``victims`` to cycle specific workers (straggler mitigation)."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        victims = victims if victims is not None else self.worker_ids[-n:]
        return self._request("migrate", self.p, block=block,
                             victims=victims, n_join=len(victims))

    def _request(self, op: str, target_p: int, *, block: bool,
                 victims=None, n_join: int | None = None):
        if target_p > len(self.devices):
            raise ValueError(f"need {target_p} slots, have "
                             f"{len(self.devices)}")
        if self.global_batch % target_p:
            raise ValueError(f"global batch {self.global_batch} not "
                             f"divisible by p={target_p}")
        plan = self.controller.admit(op, self.p, target_p)  # raises Busy
        plan.exiting = tuple(victims or ())
        plan.joining = ("new",) * (n_join or max(0, target_p - self.p))
        steps_before = self.step_idx
        key = self._exec_key(target_p)
        plan.record.exec_cache_key = key
        with self._exec_lock:
            cache_hit = key in self._exec_cache
        plan.record.compile_cache_hit = cache_hit

        def finish(handle):
            k = max(1, math.ceil(self.time_allowance_s /
                                 max(self.step_time_ema or 0.01, 1e-4)))
            plan.record.steps_during_prep = self.step_idx - steps_before
            self.controller.prepared(self.step_idx + k, handle)

        def prepare():
            finish(self._build_exec(target_p))

        if block:
            prepare()
            # commit at the next boundary manually
            while self.controller.phase is Phase.SCHEDULED:
                if self.step() is None:
                    self._commit_switch()
            return self.controller.history[-1]
        if cache_hit:
            # warm shape: prep IS the cache lookup — schedule inline
            prepare()
            return None

        def run():
            try:
                prepare()
            except BaseException as e:  # re-raised by the next step()
                self._prep_error = e

        # not a daemon: the interpreter joins it before it exits, so a prep
        # never dies inside a CUDA call at shutdown
        self._prep_thread = threading.Thread(target=run, name="edl-prep")
        self._prep_thread.start()
        return None

    def _commit_switch(self):
        """The brief stop: graceful exits, joins and the handle swap."""
        plan = self.controller.plan
        self.controller.begin_switch()
        handle: ExecHandle = plan.exec_handle
        if plan.record.op in ("scale_in", "migrate"):
            victims = list(plan.exiting) or self.worker_ids[handle.p:]
            leader_leaving = self.leader_id in victims
            for wid in victims:
                self._remove_worker(wid)
            if leader_leaving:
                self.election.resign()
                self.election = LeaderElection(self.store, self.job_handle,
                                               self.worker_ids[0])
                self.leader_id = self.election.elect().leader_id
        while len(self.worker_ids) < handle.p:
            self._add_worker()
        # model broadcast: the state lives on slot 0's device; only a new
        # slot-0 device would move it
        home = handle.devices[0]
        if tree_leaves(self.state)[0][1].device != home:
            self.state = tree_map(lambda t: t.to(home), self.state)
        if home.type == "cuda":
            torch.cuda.synchronize(home)
        self.exec = handle
        self.p = handle.p
        return self.controller.complete()

    # ------------------------------------------------------------- helpers
    def run(self, n_steps: int, *, on_step=None):
        done = 0
        while done < n_steps:
            m = self.step()
            if m is None:       # epoch rolled; pipeline restarts itself
                if self.pipeline.exhausted:
                    break
                continue
            done += 1
            if on_step:
                on_step(m)
        return done

    def join_prep(self, timeout: float | None = None) -> bool:
        """Wait (bounded) for the in-flight context prep. Returns True when
        no prep remains in flight."""
        t = self._prep_thread
        if t is not None and t.is_alive():
            t.join(timeout)
            return not t.is_alive()
        return True

    def wait_for_scaling(self, max_steps: int = 10_000):
        """Keep training (stop-free!) until the in-flight scaling commits."""
        steps = 0
        while self.controller.phase is not Phase.IDLE and steps < max_steps:
            m = self.step()
            if m is None and self.controller.phase is Phase.SCHEDULED:
                self._commit_switch()
            steps += 1
        return self.controller.history[-1] if self.controller.history else None

    def throughput(self, last_n: int = 20) -> float:
        xs = self.throughput_log[-last_n:]
        return float(np.mean([t for _, _, t in xs])) if xs else 0.0
