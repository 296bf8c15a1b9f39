"""CompileService — the priority queue for execution-context preparation.

The reference's service, copied: every background context prep — a
committed scaling switch, or a *speculative* build of a shape a policy is
likely to target next — is a ticket in ONE bounded host-thread pool
instead of a per-trainer thread. In the port a prep builds the step
callable for a shape and warms it on a side CUDA stream
(``ElasticTrainer._build_exec``); the pool bounds how many of them share
the host's cores while letting every job's prep make progress:

  * priority ordering — a COMMITTED ticket (a switch the trainer already
    admitted; training is waiting to land it) always dequeues before any
    SPECULATIVE one (a prefetch that merely warms the exec cache);
  * dedup by key — a second submit of a shape already pending/running
    returns the SAME ticket; a committed submit of a speculatively-pending
    shape escalates it in place, so prefetch work is never thrown away
    and never done twice;
  * cancellation — a re-plan that obsoletes a pending shape cancels its
    ticket before a worker ever picks it up (running preps are never
    interrupted: a finished handle still lands in the exec cache where it
    may yet be useful).

A shape whose build is already cached is never built again either: the
trainer's ticket function is ``_build_exec``, which answers a cached shape
from its exec cache and waits for a build of the same shape in flight.

Tickets are plain completion futures: ``wait()`` / ``result()`` /
``add_done_callback`` — the trainer's prep path blocks on the ticket
instead of sleeping a fixed quantum.
"""
from __future__ import annotations

import heapq
import itertools
import threading

# lower value dequeues first
PRIO_COMMITTED = 0      # an issued switch is waiting on this build
PRIO_SPECULATIVE = 1    # prefetch of a policy's likely-next shape

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"


class CompileTicket:
    """One requested build. Completion future + cancellation handle."""

    def __init__(self, key, fn, priority: int, owner):
        self.key = key
        self.fn = fn
        self.priority = priority
        self.owner = owner
        self.speculative = priority > PRIO_COMMITTED
        self.state = PENDING
        self.value = None
        self.error: BaseException | None = None
        self._done = threading.Event()
        self._callbacks: list = []

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise TimeoutError(f"compile of {self.key} still in flight")
        if self.state == CANCELLED:
            raise RuntimeError(f"compile of {self.key} was cancelled")
        if self.error is not None:
            raise self.error
        return self.value

    def add_done_callback(self, cb):
        """``cb(ticket)`` once the ticket settles (done/failed/cancelled).
        Fires on the worker thread — or immediately, on the caller's
        thread, when the ticket already settled (the speculative-hit
        path: a committed submit finds its shape prebuilt)."""
        fire = False
        with self._cb_lock():
            if self._done.is_set():
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            cb(self)

    # the service finalizes tickets under its own lock; callbacks must
    # fire OUTSIDE it (they re-enter trainer code), so the ticket carries
    # a tiny lock of its own for the settled/append race
    def _cb_lock(self):
        lock = getattr(self, "_cblock", None)
        if lock is None:
            lock = self._cblock = threading.Lock()
        return lock

    def _settle(self, state: str):
        with self._cb_lock():
            self.state = state
            self._done.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)


class CompileService:
    """Bounded worker pool draining a priority heap of compile tickets."""

    def __init__(self, workers: int = 2, name: str = "compile",
                 on_event=None):
        self.workers = max(1, int(workers))
        self.name = name
        # observability hook: ``on_event(transition, ticket)`` for every
        # ticket state change (submitted / deduped / escalated / running /
        # done / failed / cancelled). Always fired OUTSIDE the service
        # lock — sinks take their own locks — and never allowed to break
        # the compile pipeline.
        self.on_event = on_event
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._heap: list = []           # (priority, seq, ticket)
        self._seq = itertools.count()
        self._by_key: dict = {}         # key -> live (pending/running) ticket
        self._threads: list[threading.Thread] = []
        self._running = 0
        self._shutdown = False
        self._idle = threading.Condition(self._lock)
        # stats
        self.submitted = 0
        self.compiled = 0
        self.cancelled = 0
        self.failed = 0
        self.deduped = 0                # submits answered by a live ticket
        self.escalated = 0              # speculative -> committed promotions

    def _notify(self, transition: str, ticket):
        """Fire the observability hook; failures are contained (a broken
        sink must not kill a compile worker or the submitting trainer)."""
        if self.on_event is None:
            return
        try:
            self.on_event(transition, ticket)
        except Exception:
            pass

    # ------------------------------------------------------------- submit
    def submit(self, key, fn, *, priority: int = PRIO_SPECULATIVE,
               owner=None) -> CompileTicket:
        """Enqueue a build (or join the live ticket already covering
        ``key``). A committed submit of a speculatively-queued key
        escalates it — the prefetch becomes the committed prep."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError(f"{self.name} service is shut down")
            live = self._by_key.get(key)
            if live is not None and live.state in (PENDING, RUNNING):
                self.deduped += 1
                escalate = priority < live.priority
                if escalate:
                    live.priority = priority
                    live.speculative = False
                    self.escalated += 1
                    if live.state == PENDING:   # re-rank (lazy deletion:
                        heapq.heappush(         # stale entry skipped on pop)
                            self._heap, (priority, next(self._seq), live))
            else:
                live, escalate = None, False
                t = CompileTicket(key, fn, priority, owner)
                self._by_key[key] = t
                self.submitted += 1
                heapq.heappush(self._heap, (priority, next(self._seq), t))
                self._spawn_if_needed()
                self._work.notify()
        if live is not None:
            self._notify("escalated" if escalate else "deduped", live)
            return live
        self._notify("submitted", t)
        return t

    def _spawn_if_needed(self):
        # lazy pool: threads appear with demand, capped at ``workers``
        if len(self._threads) < self.workers and \
                len(self._threads) - self._running < len(self._heap):
            th = threading.Thread(target=self._worker, daemon=True,
                                  name=f"{self.name}-{len(self._threads)}")
            self._threads.append(th)
            th.start()

    # ------------------------------------------------------- cancellation
    def cancel(self, key) -> bool:
        """Cancel the PENDING ticket for ``key``. Running builds finish
        (their handle still lands in the exec cache); returns False then."""
        with self._lock:
            t = self._by_key.get(key)
            if t is None or t.state != PENDING:
                return False
            t.state = CANCELLED     # heap entry skipped on pop
            del self._by_key[key]
            self.cancelled += 1
        t._settle(CANCELLED)
        self._notify("cancelled", t)
        return True

    def cancel_owner(self, owner, *, keep=frozenset()) -> int:
        """Cancel every pending SPECULATIVE ticket of ``owner`` whose key
        is not in ``keep`` — the re-plan-obsoleted-this-shape path.
        Escalated (now committed) tickets are never cancelled here."""
        with self._lock:
            doomed = [t for t in self._by_key.values()
                      if t.owner == owner and t.speculative
                      and t.state == PENDING and t.key not in keep]
        return sum(self.cancel(t.key) for t in doomed)

    def pending_keys(self, owner=None) -> set:
        with self._lock:
            return {t.key for t in self._by_key.values()
                    if t.state in (PENDING, RUNNING)
                    and (owner is None or t.owner == owner)}

    # ------------------------------------------------------------ workers
    def _worker(self):
        while True:
            with self._lock:
                ticket = None
                while ticket is None:
                    while self._heap:
                        _, _, t = heapq.heappop(self._heap)
                        if t.state == PENDING:
                            ticket = t
                            break
                    if ticket is not None:
                        break
                    if self._shutdown:
                        return
                    self._idle.notify_all()
                    self._work.wait()
                ticket.state = RUNNING
                self._running += 1
            self._notify("running", ticket)
            try:
                ticket.value = ticket.fn()
                ok = True
            except BaseException as e:      # surfaced via result()/error
                ticket.error = e
                ok = False
            with self._lock:
                self._running -= 1
                if self._by_key.get(ticket.key) is ticket:
                    del self._by_key[ticket.key]
                self.compiled += ok
                self.failed += not ok
            ticket._settle(DONE if ok else FAILED)
            self._notify("done" if ok else "failed", ticket)

    # ---------------------------------------------------------- lifecycle
    def drain(self, timeout: float = 120.0) -> bool:
        """Block until no ticket is pending or running (bounded). A daemon
        thread still inside a CUDA call at interpreter exit can abort the
        process, so loop exits drain before returning."""
        import time
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._running or any(t.state == PENDING
                                       for _, _, t in self._heap):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._idle.wait(left)
        return True

    def shutdown(self, *, cancel_pending: bool = True):
        if cancel_pending:
            with self._lock:
                doomed = [t for t in self._by_key.values()
                          if t.state == PENDING]
            for t in doomed:
                self.cancel(t.key)
        self.drain()
        with self._lock:
            self._shutdown = True
            self._work.notify_all()

    def stats(self) -> dict:
        with self._lock:
            return {"workers": self.workers, "submitted": self.submitted,
                    "compiled": self.compiled, "cancelled": self.cancelled,
                    "failed": self.failed, "deduped": self.deduped,
                    "escalated": self.escalated,
                    "queued": len({id(t) for _, _, t in self._heap
                                   if t.state == PENDING}),
                    "running": self._running}
