"""The launch count of every hand-written kernel of the port, and the work
each call asks of it.

Each kernel wrapper adds one to ``LAUNCHES`` under its kernel's name where
it launches, and nowhere else, so a run can show that its path went through
the kernels. ``FAMILIES`` names every kernel once, grouped by the source
that holds it; each family's ops module takes its names from there.

``COSTS`` adds up the operations and bytes each call of a kernel's
autograd function asks of the kernel, on any device (the kernel on the
card, its plain version on the CPU, its output shapes alone on ``meta``),
by the formulas of the bounds in ``PERF.md`` §6: flash attention 4·D flops
a visible (query, key) pair forward, 6·D for dQ and 8·D for dK/dV; WKV6
5·hd² a token and head in each scan; bytes as each input read once and
each output written once (the optimizer's kernels: bytes alone, 22 a
bf16 parameter for AdamW). The dry-run (``launch/dryrun.py``) reads it,
since no aten op stands for a kernel's work.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.obs.trace import span

FAMILIES = {
    # csrc/flash_attn.cu (fp32), then csrc/flash_attn_tc.cu (bf16 on the
    # tensor cores) (kernels/attention/ops.py)
    "attention": ("flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkdv", "flash_attn_fwd_tc",
                  "flash_attn_bwd_dq_tc", "flash_attn_bwd_dkdv_tc"),
    # csrc/wkv6.cu (kernels/rwkv/ops.py)
    "rwkv": ("wkv6_fwd", "wkv6_bwd_dr", "wkv6_bwd_dk", "wkv6_bwd_dv"),
    # csrc/adamw.cu (kernels/optim/ops.py): a leaf's AdamW update, a leaf's
    # square-sum of the gradient norm, and a device's sum of those
    "optim": ("adamw_update", "grad_sq_sum", "grad_sq_sum_final"),
}
KERNELS = tuple(n for names in FAMILIES.values() for n in names)


class KernelRefusal(Exception):
    """A kernel's limit refused its inputs: a dtype, a head dim or a size
    the CUDA path cannot take (on the card, or on ``meta`` in the dry-run).
    Raised as ``RefusedValue`` or ``RefusedType``."""


class RefusedValue(KernelRefusal, ValueError):
    pass


class RefusedType(KernelRefusal, TypeError):
    pass


class LaunchCounter:
    """Launches per kernel name; thread-safe, since the trainer's prep
    thread launches kernels while the main thread steps. Launches that a
    thread makes inside ``warming()`` (the trainer's context preps) are also
    tallied apart, so a run can tell its training steps' launches from its
    warm-ups'. The flag is the calling thread's; the autograd Functions
    carry it from their forward to their backward, which autograd may run
    on a thread of its own, and the model carries it into the forward that
    remat recomputes there."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._n = dict.fromkeys(names, 0)
        self._warm = dict.fromkeys(names, 0)

    def add(self, name: str):
        with self._lock:
            self._n[name] += 1
            if self.is_warming():
                self._warm[name] += 1

    def is_warming(self) -> bool:
        return getattr(self._local, "warming", False)

    @contextlib.contextmanager
    def warming(self, on: bool = True):
        prev = self.is_warming()
        self._local.warming = on
        try:
            yield
        finally:
            self._local.warming = prev

    def reset(self):
        with self._lock:
            self._n = dict.fromkeys(self._n, 0)
            self._warm = dict.fromkeys(self._n, 0)

    def snapshot(self, *, warm: bool = False) -> dict[str, int]:
        """All launches since the last reset, or with ``warm`` only those
        made inside ``warming()``."""
        with self._lock:
            return dict(self._warm if warm else self._n)


LAUNCHES = LaunchCounter(KERNELS)


class CostCounter:
    """Flops and bytes per kernel name; thread-safe. With a ``locating``
    hook, also per slot: ``locate(tensor)`` names the slot of the call's
    first input."""

    def __init__(self, names):
        self._lock = threading.Lock()
        self._names = tuple(names)
        self._locate = None
        self.reset()

    def add(self, name: str, flops: int, nbytes: int, where=None):
        with self._lock:
            self._flops[name] += int(flops)
            self._bytes[name] += int(nbytes)
            if self._locate is not None and where is not None:
                slot = self._locate(where)
                f, b = self._by_slot.get(slot, (0, 0))
                self._by_slot[slot] = (f + int(flops), b + int(nbytes))

    @contextlib.contextmanager
    def locating(self, locate):
        self._locate = locate
        try:
            yield
        finally:
            self._locate = None

    def reset(self):
        with self._lock:
            self._flops = dict.fromkeys(self._names, 0)
            self._bytes = dict.fromkeys(self._names, 0)
            self._by_slot: dict[int, tuple[int, int]] = {}

    def snapshot(self) -> dict:
        """``{"flops": {name: n}, "bytes": {name: n}, "by_slot": {slot:
        (flops, bytes)}}`` since the last reset."""
        with self._lock:
            return {"flops": dict(self._flops), "bytes": dict(self._bytes),
                    "by_slot": dict(self._by_slot)}


COSTS = CostCounter(KERNELS)


def remat(fn, *args):
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint`` while
    autograd records (the backward keeps only ``args`` and recomputes the
    rest, the reference's ``nothing_saveable``), plainly otherwise; its
    recomputation counts launches as ``recompute_context`` says."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=recompute_context)


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: nothing around the
    forward, and around its recomputation, which autograd may run on a
    thread of its own, the warm-up flag of the thread that ran the forward,
    so that the kernels launched again count where the forward's did, and
    the ``edl.recompute`` span (``obs.trace.span``)."""
    return contextlib.nullcontext(), _recomputing(LAUNCHES.is_warming())


@contextlib.contextmanager
def _recomputing(warming: bool):
    with LAUNCHES.warming(warming), span("edl.recompute"):
        yield
