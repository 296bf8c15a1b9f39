"""ElasticTrainer — EDL's elasticity over the port's logical device slots.

A *worker* is one data-parallel group of ``mp`` slots (mp = the
model-parallel degree; a group is one slot at mp = 1); elasticity changes
how many groups step. The global batch is constant at every parallelism
(per-group batch = global / p), so a training step computes the same math
regardless of p.

Stop-free scale-out: the execution-context preparation for a new p is the
port's counterpart of the reference's AOT compile. It builds the handle —
``(p, slot devices, step callable)`` — and warms the step at the per-slot
shape on a side CUDA stream (kernel build at first use, CUDA context on a
new card, allocator growth for the shape), in a background thread while the
current handle keeps stepping. When it lands, the leader schedules the
switch at mini-batch ``t_cur + k`` (k = ceil(T_allowance / T_batch),
T_allowance = 500 ms — paper default); at that boundary the handle is
swapped. Model shard m of the train state lives on slot m's device (the
whole state on slot 0's at mp = 1). A data-axis switch moves a shard only
when its slot's device changes (a failure hand-off that reorders the pool);
a ``reshape(p, mp)`` moves the state along a ``reshape.plan_reshard`` plan
(``reshape.apply_plan``). Either move is staged during the draining
mini-batch on the devices' side streams, so the stop is the swap and the
bookkeeping. Scale-in (graceful exit) returns the exiting groups'
partition remainders to the dynamic data pipeline.

The RWKV6 mixers have no tensor-parallel form yet: an rwkv6 job at
mp > 1 raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.cluster.job import feasible_parallelism
from repro_torch.core.compile_service import DONE, PRIO_COMMITTED
from repro_torch.core.coordination import CoordinationStore
from repro_torch.core.election import LeaderElection
from repro_torch.core.membership import Membership, StragglerDetector
from repro_torch.core.scaling import Busy, Phase, ScalingController, \
    ScalingRecord
from repro_torch.data.pipeline import DynamicDataPipeline, \
    VirtualWorkerPipeline
from repro_torch.data.synthetic import SyntheticTokenDataset
from repro_torch.data.worker import WorkerDataIterator
from repro_torch.devices import Slot, as_slots, default_pool
from repro_torch.kernels.launches import LAUNCHES
from repro_torch.models.model import param_spec_tree
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim import Optimizer, adamw
from repro_torch.parallel import model_dims, require_model_parallel
from repro_torch.reshape import StateSpec, apply_plan, flatten_tree, \
    place_state, plan_reshard, unflatten_tree
from repro_torch.training.step import group_loss_and_grads, \
    init_train_state, join_shards, make_train_step, model_shards, \
    port_layout, split_tree

TIME_ALLOWANCE_S = 0.5      # paper's T_a
EXEC_CACHE_MAX = 8          # prepared topologies retained per job (LRU)


@dataclasses.dataclass
class ExecHandle:
    """Everything tied to one (data, model) shape: the 'communication
    topology'. ``p`` is the data-parallel group count, ``mp`` the
    model-parallel degree; slot ``d * mp + m`` steps on ``devices[d * mp +
    m]``, and ``layout`` is the train state's ``StateSpec`` at (p, mp)."""
    p: int
    mp: int
    devices: tuple[torch.device, ...]
    step_fn: Callable
    layout: StateSpec


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
      reshape(p, mp)         — live reparallelization: trade data-parallel
                               for model-parallel degree in one stop-free
                               switch; the train state is resharded along
                               a repro_torch.reshape plan at the boundary.
      grant_devices(devs)    — a scheduler HANDS the job extra slots, in
                               whole groups of mp; the job owns them
                               immediately and scales out onto them
                               stop-free.
      release_devices(n)     — graceful scale-in that RETURNS slot
                               ownership: the freed slots leave
                               ``self.devices`` when the switch commits and
                               are handed to ``on_devices_released``.
      inject_worker_failure / dead_workers / handle_failure
                             — a crashed worker stops syncing; liveness
                               detection flags it and a stop-free scale-in
                               with the dead as victims recovers.

    Full preemption (checkpoint-stop to disk and later resume) is layered on
    top by ``core.stop_resume``.

    ``devices`` is the job's slot pool (``devices.Slot``: an id and the
    torch device it runs on; several slots may share a card), read in
    groups of ``model_parallel``; plain torch devices are wrapped in slots
    numbered in order. By default one slot per visible card,
    or per CPU core when ``device`` is the CPU, as the reference's default
    pool is every device, and at least ``init_parallelism`` slots.
    ``use_aot`` warms each new shape during its prep, the counterpart of
    the reference's ahead-of-time compile. With a ``compile_service`` the
    preps run as committed tickets in its bounded pool instead of a thread
    of their own. Call ``close()`` (or use the trainer as a
    context manager) to join a prep still in flight before the interpreter
    exits.

    ``virtual_workers=K`` (or ``"auto"``) turns on DETERMINISTIC
    elasticity: data and reduction order are keyed to K fixed virtual
    workers instead of the physical slots, so any elastic trajectory —
    resizes, kills, checkpoint round trips — gives bitwise-identical losses
    to the fixed-shape run. Every p the job runs at must divide K.
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
        require_model_parallel(cfg, model_parallel)
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.model_parallel = model_parallel
        self.optimizer = optimizer or adamw(1e-3)
        self.devices = (as_slots(devices) if devices is not None
                        else default_pool(init_parallelism, device))
        self.job_handle = job_handle
        self.store = store or CoordinationStore()
        self.use_aot = use_aot
        self.seed = seed
        self.time_allowance_s = time_allowance_s
        self.compile_service = compile_service
        self.n_virtual = self._resolve_virtual(virtual_workers,
                                               init_parallelism)

        # virtual mode assembles batches leader-side from per-virtual-worker
        # cursors, so slots carry no data state
        self.dataset = dataset or SyntheticTokenDataset(
            n_samples, seq_len, cfg.vocab, seed=seed,
            d_model=cfg.d_model, embeds=(cfg.frontend == "embeds"))
        if self.n_virtual:
            self.pipeline = VirtualWorkerPipeline(
                self.dataset.n_samples, self.n_virtual, seed=seed)
        else:
            self.pipeline = DynamicDataPipeline(self.dataset.n_samples,
                                                d_partitions, seed=seed)

        # control plane
        self.membership = Membership()
        self.controller = ScalingController()
        self.straggler_detector = StragglerDetector()
        self.injected_delay: dict[str, float] = {}
        # a worker in this set has crashed: it sends no more gradient-sync
        # requests, so the leader's liveness view goes stale until
        # dead-worker detection fires
        self.failed_workers: set[str] = set()

        # bring up the initial topology (this is job launch, not scaling)
        self._exec_cache: dict[tuple, ExecHandle] = {}
        self._exec_lock = threading.Lock()
        self._building: dict[tuple, threading.Event] = {}
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
        state = init_train_state(cfg, self.optimizer, gen,
                                 self.devices[0].device)
        self.state = join_shards(place_state(
            self.exec.layout, state, self.exec.devices[:model_parallel]))

        self.step_idx = 0
        self.samples_seen = 0
        self.step_time_ema: float | None = None
        self.metrics_log: list[dict] = []
        self.throughput_log: list[tuple[float, int, float]] = []
        self._flagged_stragglers: list[str] = []
        self._prep_thread: threading.Thread | None = None
        self._prep_ticket = None        # CompileTicket when service-backed
        self._prep_error: BaseException | None = None
        # called with (trainer, freed_devices) when a release commits;
        # _releasing_op names the verb that freed them during the call
        self.on_devices_released: Callable | None = None
        self._releasing_op: str | None = None

    def close(self):
        """Join the in-flight context prep, if any."""
        t = self._prep_thread
        if t is not None:
            t.join()
        if self._prep_ticket is not None:
            self._prep_ticket.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- workers
    def _resolve_virtual(self, virtual_workers, init_p: int) -> int:
        """0 = dynamic-pipeline mode. "auto" picks the max feasible p on
        the job's slot pool; an int is validated against the batch and
        launch shape (every p the job ever runs at must divide it — later
        resize targets are checked in ``_request``)."""
        if not virtual_workers:
            return 0
        if virtual_workers == "auto":
            nv = feasible_parallelism(
                self.global_batch,
                max(1, len(self.devices) // self.model_parallel))
        else:
            nv = int(virtual_workers)
        if nv < 1:
            raise ValueError(f"virtual_workers must be >= 1, got {nv}")
        if self.global_batch % nv:
            raise ValueError(f"global batch {self.global_batch} not "
                             f"divisible by virtual_workers={nv}")
        if nv % init_p:
            raise ValueError(f"init parallelism {init_p} must divide "
                             f"virtual_workers={nv}")
        return nv

    def _add_worker(self) -> str:
        wid = f"w{self._worker_seq}"
        self._worker_seq += 1
        self.worker_ids.append(wid)
        if not self.n_virtual:
            self.iters[wid] = WorkerDataIterator(
                wid, self.pipeline, self.dataset, prefetch=False)
        self.membership.register(wid, len(self.worker_ids) - 1,
                                 at_step=getattr(self, "step_idx", 0))
        return wid

    def _remove_worker(self, wid: str, *, dead: bool = False):
        self.failed_workers.discard(wid)
        it = self.iters.pop(wid, None)
        if it is None:              # virtual mode: no per-slot data state
            self.pipeline.release(wid, dead=dead)
        elif dead:
            self.pipeline.release(wid, dead=True)
        else:
            it.graceful_exit()      # return data remainder
        self.worker_ids.remove(wid)
        self.membership.remove(wid)
        self.straggler_detector.reset(wid)

    # ---------------------------------------------------------- exec handles
    def _exec_key(self, p: int, mp: int | None = None,
                  devices=None) -> tuple:
        """The exec-cache identity of shape (p, mp) on a slot-pool prefix
        (of ``devices``, by default the job's pool), in the reference's
        ``(p, mp, slot ids)`` form. Order matters: the same slots in another
        order are another topology."""
        mp = mp if mp is not None else self.model_parallel
        slots = as_slots(devices if devices is not None else self.devices)
        return (p, mp, tuple(s.id for s in slots[:p * mp]))

    def _side_stream(self, dev: torch.device) -> "torch.cuda.Stream":
        """This trainer's side stream on ``dev`` (preps and staged state
        moves run there, off the stream that steps)."""
        with self._exec_lock:
            side = self._side_streams.get(dev)
            if side is None:
                side = self._side_streams[dev] = torch.cuda.Stream(dev)
            return side

    @contextlib.contextmanager
    def _on_side_streams(self, devices, *, after_main: bool):
        """Make this trainer's side stream current on every CUDA device of
        ``devices`` (the first of them current too); with ``after_main``
        each side stream first waits for the work queued on its device's
        stream. Yields the side streams."""
        cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
        with contextlib.ExitStack() as stack:
            if cuda:
                stack.enter_context(torch.cuda.device(cuda[0]))
            sides = []
            for d in cuda:
                side = self._side_stream(d)
                if after_main:
                    side.wait_stream(torch.cuda.current_stream(d))
                stack.enter_context(torch.cuda.stream(side))
                sides.append(side)
            yield sides

    def _warm(self, groups: tuple[tuple[torch.device, ...], ...]):
        """Run one forward and backward at the step's shard shape on each
        distinct data group (``groups``: each group's slot devices), with
        zero params and tokens, on side streams: one virtual worker's shard
        on the group's first slot in virtual mode, else one data group's
        shard over its mp slots. Touches no trainer state; its kernel
        launches are tallied as warm-ups."""
        mp = len(groups[0])
        per = self.global_batch // (self.n_virtual or len(groups))
        dims = model_dims(port_layout(self.cfg, self.optimizer, len(groups),
                                      mp))
        for group in dict.fromkeys(groups):
            devs = group[:1] if self.n_virtual else group
            with self._on_side_streams(devs, after_main=False) as sides, \
                    LAUNCHES.warming():
                self._warm_once(devs, dims, per)
            for side in sides:
                side.synchronize()

    def _warm_once(self, devs, dims: dict, per: int):
        dtype = {"float32": torch.float32,
                 "bfloat16": torch.bfloat16}[self.cfg.param_dtype]
        params = tree_map(lambda s: torch.zeros(s.shape, dtype=dtype,
                                                device=devs[0]),
                          param_spec_tree(self.cfg))
        trees = split_tree(params, dims, devs)
        toks = torch.zeros((per, self.seq_len), dtype=torch.long,
                           device=devs[0])
        loss, _, _ = group_loss_and_grads(self.cfg, trees, dims, devs,
                                          {"tokens": toks, "labels": toks})
        loss.item()

    def _build_exec(self, p: int, mp: int | None = None,
                    devices=None) -> ExecHandle:
        """Execution-context preparation for shape (p, mp): the step
        callable over the first p * mp slots of the pool, warmed at its
        shape. This is the cost stop-free scaling hides. ``mp`` defaults to
        the job's current model-parallel degree; the RESHAPE verb passes
        another. ``devices`` overrides the job's pool: the speculative
        prefetch builds for a PREDICTED slot set (the pool plus the free
        slots a growth grant would append) without touching trainer state.
        Handles are cached per (p, mp, slot ids), LRU-bounded;
        a shape the job ran at before (migrate at constant p, a
        compact/expand cycle) skips the warm-up. A shape cached or in
        flight is never built again: a second caller waits for the build
        in flight and takes its handle. The expensive part runs outside the
        cache lock."""
        mp = mp if mp is not None else self.model_parallel
        slots = tuple(as_slots(devices if devices is not None
                               else self.devices)[:p * mp])
        devs = tuple(s.device for s in slots)
        key = self._exec_key(p, mp, slots)
        while True:
            with self._exec_lock:
                cached = self._exec_cache.get(key)
                if cached is not None:
                    self._exec_cache[key] = self._exec_cache.pop(key)  # LRU
                    return cached
                inflight = self._building.get(key)
                if inflight is None:
                    done = self._building[key] = threading.Event()
                    break
            inflight.wait()
        try:
            fn = make_train_step(self.cfg, self.optimizer, devs, mp=mp,
                                 n_virtual=self.n_virtual,
                                 global_batch=self.global_batch,
                                 seed=self.seed)
            if self.use_aot:
                self._warm(tuple(devs[d * mp:(d + 1) * mp]
                                 for d in range(p)))
            handle = ExecHandle(p, mp, devs, fn,
                                port_layout(self.cfg, self.optimizer, p, mp))
            with self._exec_lock:
                handle = self._exec_cache.setdefault(key, handle)
                while len(self._exec_cache) > EXEC_CACHE_MAX:
                    self._exec_cache.pop(next(iter(self._exec_cache)))
        finally:
            with self._exec_lock:
                del self._building[key]
            done.set()
        return handle

    # -------------------------------------------------------------- stepping
    def _assemble_batch(self) -> dict | None:
        """Draw global_batch samples as p per-worker draws (the per-worker
        data flow of the paper; progress offsets update leader-side).

        Epoch tails: draws never cross an epoch boundary, so the final batch
        of an epoch may come up short — it is padded by cycling the drawn
        samples (recorded sample_ids stay un-padded, preserving the
        exactly-once accounting; only the SGD step sees a few duplicates at
        the boundary, the paper-accepted consistency semantics).

        Virtual mode instead assembles the batch leader-side from the
        per-virtual-worker cursors, in fixed virtual order: identical
        sample sequence at every p, always full (per-vw epoch wrap), no
        padding — the data half of the bitwise-determinism contract."""
        if self.n_virtual:
            if self.pipeline.exhausted:
                return None
            per_vw = self.global_batch // self.n_virtual
            ids = np.concatenate([
                self.pipeline.draw_block(w, self.p, per_vw)
                for w in range(self.p)])
            batch = self.dataset.read_ids(ids)
            self._last_sample_ids = batch.pop("sample_ids")
            if self.cfg.frontend == "embeds":
                batch = {"embeds": batch["embeds"],
                         "labels": batch["labels"]}
            return batch
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
        # first chance: the switch is already due at this step's boundary
        # (the DRAINING mini-batch); CUDA launches are asynchronous, so a
        # state move staged now overlaps the step's device work
        self._maybe_stage_switch()
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for it
        # second chance: the prep landed DURING this step
        self._maybe_stage_switch()
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
            if wid in self.failed_workers:
                continue    # a crashed worker sends no gradient-sync: its
                # membership record ages out and dead_workers() flags it
                # after miss_threshold steps (EDL §4.1 liveness)
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
                 block: bool = False, release: bool = False
                 ) -> ScalingRecord | None:
        """scale_in(): remove slots via graceful exit. Raises Busy (the
        paper's RETRY) if another scaling op is in flight."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        if self.p - n_remove < 1:
            raise ValueError(f"cannot scale below 1 (p={self.p})")
        return self._request("scale_in", self.p - n_remove, block=block,
                             victims=victims, release=release)

    def migrate(self, n: int = 1, *, victims: list[str] | None = None,
                block: bool = True):
        """Fused scale-in + scale-out: one topology switch (§5.2). Pass
        ``victims`` to cycle specific workers (straggler mitigation)."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        victims = victims if victims is not None else self.worker_ids[-n:]
        return self._request("migrate", self.p, block=block,
                             victims=victims, n_join=len(victims))

    # ------------------------------------------------------ failure surface
    def inject_worker_failure(self, worker_id: str | None = None) -> str:
        """Chaos entry point: crash a worker. From now on it sends no
        gradient-sync requests, so ``membership.dead_workers`` flags it
        after ``miss_threshold`` missed steps — DETECTION, not injection,
        is what triggers recovery (the injector only breaks things)."""
        wid = worker_id if worker_id is not None else self.worker_ids[-1]
        if wid not in self.worker_ids:
            raise ValueError(f"unknown worker {wid!r}")
        self.failed_workers.add(wid)
        return wid

    def dead_workers(self) -> list[str]:
        """Workers the leader's liveness view currently believes dead."""
        return [w for w in self.membership.dead_workers(self.step_idx)
                if w in self.worker_ids]

    def handle_failure(self, dead: list[str], *, release: bool = True,
                       block: bool = False) -> ScalingRecord | None:
        """Automatic stop-free recovery (EDL §4.2: forced exit is a
        special case of scale-in). The dead workers' slot groups move to the
        tail of the pool so the survivor topology is built from live slots
        only,
        then a scale-in is requested with the dead workers as victims —
        plus, when the feasibility clamp (batch / ``n_virtual``
        divisibility) skips the shape right below, extra graceful victims.
        Training keeps stepping through the background context prep; at
        commit the dead workers' data partitions return via
        ``pipeline.release(dead=True)`` (replay from the original offset)
        and the freed slots go to ``on_devices_released`` when ``release``
        is set. A dead first group moves the train state's model shards to
        the new first group's devices at the commit (the leader-kill path).

        Raises ``Busy`` while another operation is in flight (caller
        retries) and ``ValueError`` when no feasible survivor shape
        exists — the caller's fallback is a checkpoint-stop."""
        dead = [w for w in dead if w in self.worker_ids]
        if not dead:
            return None
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        target = self.p - len(dead)
        while target >= 1 and (self.global_batch % target or
                               (self.n_virtual and
                                self.n_virtual % target)):
            target -= 1
        if target < 1:
            raise ValueError(
                f"no feasible parallelism below p={self.p} without the "
                f"{len(dead)} dead worker(s) (batch={self.global_batch}, "
                f"virtual_workers={self.n_virtual})")
        survivors = [w for w in self.worker_ids if w not in dead]
        victims = survivors[target:] + dead     # clamp-forced extras exit
        # re-order the pool: victims' groups to the tail, so the survivor
        # topology uses devices[:target * mp] (all live) and the commit
        # frees exactly the victims' (and any parked surplus) slots. Safe
        # pre-prep: the running handle holds its own device tuple.
        self.devices = groups_to_tail(self.devices, self.worker_ids, victims,
                                      self.model_parallel)
        return self._request("scale_in", target, block=block,
                             victims=victims, release=release,
                             dead=tuple(dead))

    def _request(self, op: str, target_p: int, *, block: bool,
                 victims=None, n_join: int | None = None,
                 release: bool = False, target_mp: int | None = None,
                 dead: tuple = ()):
        target_mp = (target_mp if target_mp is not None
                     else self.model_parallel)
        require_model_parallel(self.cfg, target_mp)
        avail = len(self.devices) // target_mp
        if target_p > avail:
            raise ValueError(f"need {target_p} groups of {target_mp} "
                             f"slot(s), have {avail}")
        if self.global_batch % target_p:
            raise ValueError(f"global batch {self.global_batch} not "
                             f"divisible by p={target_p}")
        if self.n_virtual and self.n_virtual % target_p:
            raise ValueError(
                f"p={target_p} must divide virtual_workers="
                f"{self.n_virtual} (virtual blocks stay contiguous and "
                f"equal-sized at every shape)")
        plan = self.controller.admit(op, self.p, target_p)  # raises Busy
        plan.record.from_mp = self.model_parallel
        plan.record.to_mp = target_mp
        plan.exiting = tuple(victims or ())
        plan.dead_exiting = tuple(dead)
        plan.joining = ("new",) * (n_join or max(0, target_p - self.p))
        plan.release_devices = release
        steps_before = self.step_idx
        key = self._exec_key(target_p, target_mp)
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
            finish(self._build_exec(target_p, target_mp))

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
        svc = self.compile_service
        if svc is not None:
            def on_ticket(t):
                if t.state != DONE:     # re-raised by the next step()
                    self._prep_error = t.error or RuntimeError(
                        f"prep of {t.key} was {t.state}")
                    return
                finish(t.value)

            # dedup/escalation: a prefetch of this shape already pending or
            # running is JOINED as committed
            self._prep_ticket = svc.submit(
                key, lambda: self._build_exec(target_p, target_mp),
                priority=PRIO_COMMITTED, owner=self.job_handle)
            self._prep_ticket.add_done_callback(on_ticket)
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

    def _home(self) -> torch.device:
        """The device that holds model shard 0 of the train state."""
        return tree_leaves(model_shards(self.state)[0])[0][1].device

    def _maybe_stage_switch(self):
        """Stage the state move when a ready switch commits at the current
        step's boundary."""
        plan = self.controller.plan
        if (plan is not None and plan.ready
                and self.step_idx + 1 >= plan.switch_step):
            self._stage_switch(plan)

    def _state_for(self, handle: ExecHandle, record: ScalingRecord | None
                   ) -> tuple[object, int]:
        """The train state laid out for ``handle``, and the bytes the move
        copies. A reshape goes through the planner (``record`` gets its
        byte accounting) and ``apply_plan``; any other switch moves each
        model shard whose slot's device changed, and hands the others over
        as they are (the live state itself when none moves)."""
        shards = model_shards(self.state)
        homes = handle.devices[:handle.mp]
        if record is not None and record.op == "reshape":
            src, dst = self.exec.layout, handle.layout
            rplan = plan_reshard(src, dst)
            record.reshard_bytes_moved = rplan.bytes_moved
            record.reshard_bytes_kept = rplan.bytes_kept
            flat = [flatten_tree(shards[i % src.mp])
                    for i in range(src.n_devices)]
            moved = [unflatten_tree(f) for f in apply_plan(rplan, flat, homes)]
            return join_shards(moved), rplan.bytes_moved
        moved, nbytes = [], 0
        for shard, home in zip(shards, homes):
            if tree_leaves(shard)[0][1].device != home:
                nbytes += sum(t.numel() * t.element_size()
                              for _, t in tree_leaves(shard))
                shard = tree_map(lambda t: t.to(
                    home, non_blocking=home.type == "cuda"), shard)
            moved.append(shard)
        return (join_shards(moved) if nbytes else self.state), nbytes

    def _state_devices(self, *states) -> list[torch.device]:
        return list(dict.fromkeys(t.device for state in states
                                  for shard in model_shards(state)
                                  for _, t in tree_leaves(shard)))

    def _stage_switch(self, plan):
        """Overlapped state move, issued on the side streams of the devices
        it touches behind the step that produces the current state, into
        fresh buffers. The staged tensors are the double buffer: the live
        state keeps its own until the commit's pointer swap, so training is
        untouched if the commit never consumes the staging (it falls back
        to the in-stop move). When no shard changes device and the switch
        is not a reshape, nothing is copied and the staged state is the
        live state."""
        if plan.staged_state is not None:
            return
        plan.record.t_stage_start = self.controller.clock()
        handle: ExecHandle = plan.exec_handle
        devs = self._state_devices(self.state) + list(
            handle.devices[:handle.mp])
        with self._on_side_streams(devs, after_main=True) as sides:
            staged, nbytes = self._state_for(handle, plan.record)
        if sides:
            side_of = {side.device: side for side in sides}
            for shard in model_shards(self.state):
                for _, t in tree_leaves(shard):
                    if t.is_cuda:       # read on the side stream
                        t.record_stream(side_of[t.device])
            for shard in model_shards(staged):
                for _, t in tree_leaves(shard):
                    if t.is_cuda:       # used on the stepping stream
                        t.record_stream(torch.cuda.current_stream(t.device))
        plan.record.bytes_moved_overlapped = nbytes
        plan.staged_state = staged
        plan.staged_from = self.state
        plan.record.t_stage_end = self.controller.clock()

    def _commit_switch(self):
        """The brief stop: graceful exits, joins, the state move (staged,
        or in the stop) and the handle swap."""
        plan = self.controller.plan
        self.controller.begin_switch()
        handle: ExecHandle = plan.exec_handle
        op = plan.record.op
        # a reshape that shrinks the data axis retires the surplus groups
        # exactly like a scale-in
        if op in ("scale_in", "migrate") or \
                (op == "reshape" and handle.p < len(self.worker_ids)):
            victims = list(plan.exiting) or self.worker_ids[handle.p:]
            leader_leaving = self.leader_id in victims
            for wid in victims:
                self._remove_worker(wid, dead=wid in plan.dead_exiting)
            if leader_leaving:
                self.election.resign()
                self.election = LeaderElection(self.store, self.job_handle,
                                               self.worker_ids[0])
                self.leader_id = self.election.elect().leader_id
        while len(self.worker_ids) < handle.p:
            self._add_worker()
        # model broadcast: model shard m lives on slot m's device
        if plan.staged_state is not None and plan.staged_from is self.state:
            if plan.staged_state is not self.state:
                # the staged move: wait on the side streams only
                for dev in self._state_devices(self.state,
                                               plan.staged_state):
                    if dev.type == "cuda":
                        side = self._side_stream(dev)
                        torch.cuda.current_stream(dev).wait_stream(side)
                        side.synchronize()
            self.state = plan.staged_state
        else:
            self.state, _ = self._state_for(handle, plan.record)
            plan.record.bytes_moved_overlapped = 0
            for dev in self._state_devices(self.state):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        self.exec = handle
        self.p = handle.p
        self.model_parallel = handle.mp
        freed = []
        if plan.release_devices:
            # hand every slot beyond the new topology back to the caller:
            # the job stops owning it
            in_use = handle.p * handle.mp
            freed, self.devices = self.devices[in_use:], \
                self.devices[:in_use]
        rec = self.controller.complete()
        if freed and self.on_devices_released is not None:
            # the hook learns WHICH verb frees the slots (a reshape's
            # surplus is not a data-parallel scale-in)
            self._releasing_op = rec.op
            try:
                self.on_devices_released(self, freed)
            finally:
                self._releasing_op = None
        return rec

    # ------------------------------------------------ device pool hand-off
    def _new_slots(self, devices) -> list[Slot]:
        """Granted ``devices`` as slots; plain torch devices are numbered
        after the highest slot id the job holds."""
        return as_slots(devices, first_id=1 + max(
            (s.id for s in self.devices), default=-1))

    def grant_devices(self, new_devices, *, block: bool = False
                      ) -> ScalingRecord | None:
        """Non-blocking hand-off path: a scheduler grants this job extra
        slots, in whole groups of ``model_parallel``, and the job scales out
        onto them, stop-free. The slots join the job's pool immediately;
        the topology switch commits at a mini-batch boundary."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        new = self._new_slots(new_devices)
        n_new, rem = divmod(len(new), self.model_parallel)
        if n_new < 1 or rem:
            # a partial group could never host a data-parallel group of
            # the (data, model) layout; refusing keeps the arithmetic exact
            raise ValueError(
                f"a grant moves at least one whole slot group: got "
                f"{len(new)} slot(s), group size is {self.model_parallel}")
        self.devices = self.devices + new
        try:
            return self._request("scale_out", self.p + n_new, block=block)
        except Exception:
            self.devices = self.devices[:len(self.devices) - len(new)]
            raise

    def release_devices(self, n_slices: int = 1, *,
                        victims: list[str] | None = None,
                        block: bool = False) -> ScalingRecord | None:
        """Graceful scale-in that RETURNS the freed groups' slots: once the
        switch commits, they leave ``self.devices`` and are handed to the
        ``on_devices_released`` hook (the reclaim side of a transient loan).
        Stop-free like any scale-in; raises Busy under a conflicting op."""
        return self.scale_in(n_slices, victims=victims, block=block,
                             release=True)

    def reshape(self, p: int, mp: int, *, new_devices=None,
                block: bool = False, release: bool = False
                ) -> ScalingRecord | None:
        """RESHAPE: trade data-parallel for model-parallel degree live —
        re-lay the job from ``(self.p, self.model_parallel)`` to ``(p, mp)``
        stop-free. The new handle is prepared in the background while
        training continues at the old shape; at the scheduled mini-batch
        boundary the train state is resharded along a
        ``reshape.plan_reshard`` plan (the record carries its byte
        accounting) and surplus data-parallel groups exit gracefully,
        returning their data remainders.

        Device arithmetic: ``new_devices`` joins the job's pool first (a
        scheduler funding a footprint-growing reshape); with ``release=
        True`` any slots beyond ``p * mp`` are handed to
        ``on_devices_released`` when the switch commits. Raises ``Busy``
        (the paper's RETRY) while another operation is in flight."""
        if self.controller.phase is not Phase.IDLE:
            raise Busy("scaling in flight; retry later")
        if mp < 1 or p < 1:
            raise ValueError(f"reshape target ({p}, {mp}) must be >= 1 "
                             f"on both axes")
        if p == self.p and mp == self.model_parallel:
            raise ValueError(f"already at shape ({p}, {mp})")
        new = self._new_slots(new_devices or ())
        self.devices = self.devices + new
        try:
            return self._request("reshape", p, block=block,
                                 release=release, target_mp=mp)
        except Exception:
            self.devices = self.devices[:len(self.devices) - len(new)]
            raise

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
        """Wait (bounded) for the in-flight context prep, whichever engine
        carries it — the private thread or a compile-service ticket.
        Returns True when no prep remains in flight."""
        ticket = self._prep_ticket
        if ticket is not None:
            done = ticket.wait(timeout)
            if done:
                self._prep_ticket = None
            return done
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


def groups_to_tail(devices: list, worker_ids: list[str], leaving, mp: int
                   ) -> list:
    """The slot pool with the slot groups of the ``leaving`` workers moved
    to its tail in ``leaving``'s order, after the groups that stay and
    before the parked surplus: worker i of ``worker_ids`` holds the group
    ``devices[i mp:(i + 1) mp]``."""
    group = {w: devices[i * mp:(i + 1) * mp]
             for i, w in enumerate(worker_ids)}
    surplus = devices[len(worker_ids) * mp:]
    return ([d for w in worker_ids if w not in leaving for d in group[w]]
            + [d for w in leaving for d in group[w]] + surplus)
