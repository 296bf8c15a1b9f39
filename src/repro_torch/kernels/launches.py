"""The launch count of every hand-written kernel of the port.

Each kernel wrapper adds one to ``LAUNCHES`` under its kernel's name where
it launches, and nowhere else, so a run can show that its path went through
the kernels. ``FAMILIES`` names every kernel once, grouped by the source
that holds it; each family's ops module takes its names from there.
"""
from __future__ import annotations

import contextlib
import threading

FAMILIES = {
    # csrc/flash_attn.cu (kernels/attention/ops.py)
    "attention": ("flash_attn_fwd", "flash_attn_bwd_dq",
                  "flash_attn_bwd_dkdv"),
    # csrc/wkv6.cu (kernels/rwkv/ops.py)
    "rwkv": ("wkv6_fwd", "wkv6_bwd_dr", "wkv6_bwd_dk", "wkv6_bwd_dv",
             "wkv6_bwd_du"),
}
KERNELS = tuple(n for names in FAMILIES.values() for n in names)


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


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint``: nothing around the
    forward, and around its recomputation, which autograd may run on a
    thread of its own, the warm-up flag of the thread that ran the forward,
    so that the kernels launched again count where the forward's did."""
    return contextlib.nullcontext(), LAUNCHES.warming(LAUNCHES.is_warming())
