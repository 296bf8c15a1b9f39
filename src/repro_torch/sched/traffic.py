"""Request-rate traffic traces for serving tenants (Aryl-style tiering).

A trace is a plain tuple of non-negative request rates, one entry per
*served* scheduling round — the serving tier replays it entry by entry
(``ServingSpec.rate_at`` indexes by rounds served, modulo the trace
length, so a diurnal trace repeats). Policies turn a rate into a replica
demand through the tenant's per-replica capacity
(``ServingSpec.demand``); the executor turns demand changes into the
same grant/reclaim verbs training tenants use.

Synthesis is deterministic: the optional noise is seeded, so a trace
spec string (``parse_trace``) names exactly one replay — fault plans,
benchmarks and tests can all share it.
"""
from __future__ import annotations

import math
import random


def flat(rounds: int, *, rate: float = 1.0) -> tuple[float, ...]:
    """Constant request rate — the degenerate trace (steady demand)."""
    _check(rounds)
    return (float(rate),) * rounds


def diurnal(rounds: int, *, period: int = 24, base: float = 1.0,
            peak: float = 8.0, phase: float = 0.0, noise: float = 0.0,
            seed: int = 0) -> tuple[float, ...]:
    """Sinusoidal day/night cycle: starts at ``base`` (the lull — idle
    replicas are loaned out), crests at ``peak`` mid-period (the spike —
    loans are reclaimed). ``noise`` adds seeded multiplicative jitter of
    up to that fraction; rates never leave [0, peak * (1 + noise)]."""
    _check(rounds)
    if period < 2:
        raise ValueError(f"period must be >= 2, got {period}")
    if peak < base:
        raise ValueError(f"peak {peak} below base {base}")
    rng = random.Random(seed)
    out = []
    for k in range(rounds):
        x = 0.5 * (1.0 - math.cos(2.0 * math.pi * (k + phase) / period))
        r = base + (peak - base) * x
        if noise:
            r *= 1.0 + noise * (2.0 * rng.random() - 1.0)
        out.append(max(0.0, r))
    return tuple(out)


def spike(rounds: int, *, at: int = 0, width: int = 4, base: float = 1.0,
          peak: float = 8.0) -> tuple[float, ...]:
    """Step spike: ``base`` everywhere except ``width`` rounds of ``peak``
    starting at round ``at`` — the sharpest reclaim scenario (no ramp)."""
    _check(rounds)
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    return tuple(float(peak) if at <= k < at + width else float(base)
                 for k in range(rounds))


def _check(rounds: int):
    if rounds < 1:
        raise ValueError(f"trace needs >= 1 round, got {rounds}")


def parse_trace(spec: str, rounds: int, **kw) -> tuple[float, ...]:
    """Trace-spec string -> trace tuple (the ``:serve=`` grammar value):
    ``diurnal`` / ``spike`` / ``flat`` pick a synthesizer (keyword knobs
    ride through), and a ``/``-separated number list (``2/2/8/8``) is a
    literal trace replayed as-is (``rounds`` and knobs ignored)."""
    spec = spec.strip()
    if "/" in spec or _is_number(spec):
        return tuple(float(tok) for tok in spec.split("/") if tok)
    kinds = {"diurnal": diurnal, "spike": spike, "flat": flat}
    if spec not in kinds:
        raise ValueError(f"unknown trace {spec!r}; one of "
                         f"{sorted(kinds)} or a '/'-separated rate list")
    return kinds[spec](rounds, **kw)


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def replicas_for(rate: float, capacity: float) -> int:
    """Replicas needed to serve ``rate`` requests per round in ONE wave
    when each replica serves ``capacity`` requests per wave."""
    if capacity <= 0:
        raise ValueError(f"capacity must be > 0, got {capacity}")
    return int(math.ceil(rate / capacity)) if rate > 0 else 0
