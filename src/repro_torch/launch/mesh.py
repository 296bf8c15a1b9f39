"""The card's constants for the dry-run's roofline, and the production
layout.

Counterpart of the reference's ``launch/mesh.py``, whose TPU v5e figures
give way to NVIDIA's datasheet figures for the ``CARD`` (dense, at its
700 W limit): the same values as the bounds in ``PERF.md`` §6. They are
datasheet values, not measurements: a card set below 700 W runs slower.
The reference's ``make_mesh`` has its counterpart in the slot pool
(``devices.slot_devices``); a layout here is its axis sizes, ``(p, mp)``.
"""
from __future__ import annotations

CARD = "NVIDIA H100 SXM5 80GB"
PEAK_FLOPS_BF16 = 989e12        # bf16 on the tensor cores, dense, a card
PEAK_FLOPS_FP32 = 67e12         # fp32 on the CUDA cores, a card
HBM_BW = 3.35e12                # bytes/s a card (HBM3)
HBM_BYTES = 80e9                # bytes a card
NVLINK_BW = 450e9               # bytes/s a card, one direction (NVLink 4)
NODE_CARDS = 8                  # cards joined all to all by NVLink

PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_FP32}


def production_layout() -> tuple[int, int]:
    """The counterpart of ``make_production_mesh``: the reference's 256
    chips as 256 cards, ``(p, mp) = (32, 8)``, with each data group's
    model axis inside one node of ``NODE_CARDS`` cards, so its collectives
    run over NVLink."""
    return 256 // NODE_CARDS, NODE_CARDS
