"""Device resolution and the logical slot pool.

The reference runs one process over ``jax.devices()``. The port runs one
process whose logical data-parallel slots map onto torch devices: every
slot on ``cpu`` when the caller asks for the CPU, one ``cuda:i`` per slot
on a host with enough cards, several slots per card otherwise.
"""
from __future__ import annotations

import os

import torch


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
                 ) -> list[torch.device]:
    """The device of each of ``n_slots`` logical slots, round-robin over the
    visible cards (all on one card when there is one)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n_slots
    if dev.index is not None:
        return [dev] * n_slots
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n_slots)]


def default_pool(min_slots: int, device: str | torch.device = "cuda"
                 ) -> list[torch.device]:
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
