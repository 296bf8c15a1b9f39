"""Device resolution and the logical slot pool.

The reference runs one process over ``jax.devices()``. The port runs one
process whose logical data-parallel slots map onto torch devices: every
slot on ``cpu`` when the caller asks for the CPU, one ``cuda:i`` per slot
on a host with enough cards, several slots per card otherwise. A slot is a
``Slot``: an integer ``id``, the identity that schedulers track ownership
by (the reference's ``jax.Device.id``), and the torch device it runs on.
Two slots on one card are two slots.
"""
from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class Slot:
    """One logical slot of a pool: its identity and its torch device."""
    id: int
    device: torch.device

    def __str__(self) -> str:
        return str(self.device)


def as_slots(devices, *, first_id: int = 0) -> list[Slot]:
    """``devices`` as slots: a ``Slot`` stays itself, a torch device or a
    device string becomes a slot numbered in order from ``first_id``."""
    out = []
    for d in devices:
        if not isinstance(d, Slot):
            d = Slot(first_id + len(out), resolve_device(d))
        out.append(d)
    return out


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``. A CUDA request without CUDA raises:
    nothing drops to the CPU unless the caller asked for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is false; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def slot_devices(n_slots: int, device: str | torch.device = "cuda"
                 ) -> list[Slot]:
    """``n_slots`` logical slots, ids 0 to n - 1, round-robin over the
    visible cards (all on one card when there is one)."""
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [Slot(i, dev) for i in range(n_slots)]
    n_cards = torch.cuda.device_count()
    return [Slot(i, torch.device("cuda", i % n_cards))
            for i in range(n_slots)]


def default_pool(min_slots: int, device: str | torch.device = "cuda"
                 ) -> list[Slot]:
    """The slot pool of a job that names none, as the reference's is every
    device in ``jax.devices()``: one slot per visible card, or per CPU core
    on the CPU, and never fewer than ``min_slots``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        n_visible = os.cpu_count() or 1
    elif dev.index is not None:
        n_visible = 1
    else:
        n_visible = torch.cuda.device_count()
    return slot_devices(max(min_slots, n_visible), dev)
