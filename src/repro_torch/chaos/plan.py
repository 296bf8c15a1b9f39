"""FaultPlan — a seeded, serializable schedule of failure events.

The plan is pure data: what breaks, where, and when. It can be written
to / read from JSON (``save``/``load``), so a revocation trace captured
from one run (or synthesized with ``FaultPlan.random``) replays
bit-identically against another — the bench's ``--faults trace.json``
mode and the chaos test suite both consume this format.

Event timing is in executor *rounds* (``at``), optionally gated on the
target job's own progress (``step``: fire only once ``steps_done``
reached it) — matching the two clocks the executor already runs on.
"""
from __future__ import annotations

import dataclasses
import json
import random

KINDS = ("kill_worker", "revoke_devices", "delay_worker",
         "crash_checkpoint")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure.

    kind        — one of ``KINDS``.
    at          — executor round the event becomes due (fires at the first
                  tick with ``executor.round >= at`` whose preconditions
                  hold; e.g. a kill waits for its target job to be RUNNING).
    jid         — target job id; None lets the injector pick
                  deterministically (the running job holding the most
                  devices, lowest jid on ties).
    worker      — worker index within the job (kill/delay); taken modulo
                  the job's live worker count at fire time.
    n_devices   — revocation size in DEVICES (revoke_devices).
    delay_s     — injected per-step delay (delay_worker).
    step        — optional extra gate: fire only once the target job's
                  ``steps_done`` >= step ("kill worker w of job j at
                  step N").
    """
    kind: str
    at: int
    jid: int | None = None
    worker: int | None = None
    n_devices: int = 1
    delay_s: float = 0.05
    step: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.at < 0:
            raise ValueError(f"event round must be >= 0, got {self.at}")
        if self.kind == "revoke_devices" and self.n_devices < 1:
            raise ValueError(f"revocation must take >= 1 device, "
                             f"got {self.n_devices}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # keep traces terse and diff-friendly: drop fields at their default
        for k, v in list(d.items()):
            if k != "kind" and k != "at" and \
                    v == getattr(type(self), k, None):
                del d[k]
        return d


@dataclasses.dataclass
class FaultPlan:
    """An ordered schedule of FaultEvents plus the seed that made it."""
    events: list[FaultEvent] = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.at, e.kind))

    # ------------------------------------------------------------ synthesis
    @classmethod
    def random(cls, seed: int, *, rounds: int = 40, n_jobs: int = 2,
               kills: int = 1, revokes: int = 0, delays: int = 0,
               crashes: int = 0, max_devices: int = 1,
               max_workers: int = 4) -> "FaultPlan":
        """Seeded random kill/revocation schedule. Events land in the
        first ~60% of the horizon so recovery has rounds left to play out
        (a kill in the last round proves nothing)."""
        rng = random.Random(seed)
        hi = max(3, int(rounds * 0.6))
        ev = []
        for _ in range(kills):
            ev.append(FaultEvent(
                "kill_worker", at=rng.randrange(2, hi),
                jid=rng.randrange(n_jobs),
                worker=rng.randrange(max_workers)))
        for _ in range(revokes):
            ev.append(FaultEvent(
                "revoke_devices", at=rng.randrange(2, hi),
                n_devices=rng.randint(1, max(1, max_devices))))
        for _ in range(delays):
            ev.append(FaultEvent(
                "delay_worker", at=rng.randrange(2, hi),
                jid=rng.randrange(n_jobs),
                worker=rng.randrange(max_workers),
                delay_s=rng.choice((0.02, 0.05))))
        for _ in range(crashes):
            ev.append(FaultEvent("crash_checkpoint",
                                 at=rng.randrange(2, hi)))
        return cls(events=ev, seed=seed)

    # -------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [e.to_dict() for e in self.events]},
                          indent=1)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        return cls(events=[FaultEvent(**e) for e in d.get("events", [])],
                   seed=int(d.get("seed", 0)))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Driver-flag front door: a path to a JSON trace, or an inline
        ``random:`` spec like ``random:seed=0,kills=2,revokes=1,rounds=40``
        (keys mirror ``FaultPlan.random`` keywords)."""
        import os
        if text.startswith("random:"):
            kv = {}
            for tok in text[len("random:"):].split(","):
                if not tok:
                    continue
                k, _, v = tok.partition("=")
                kv[k.strip()] = int(v)
            seed = kv.pop("seed", 0)
            allowed = {"rounds", "n_jobs", "kills", "revokes", "delays",
                       "crashes", "max_devices", "max_workers"}
            unknown = set(kv) - allowed
            if unknown:
                raise ValueError(f"--faults random: unknown key(s) "
                                 f"{sorted(unknown)}; allowed: "
                                 f"{sorted(allowed | {'seed'})}")
            return cls.random(seed, **kv)
        if os.path.exists(text):
            return cls.load(text)
        raise ValueError(f"--faults: {text!r} is neither a readable trace "
                         f"file nor a 'random:k=v,...' spec")
