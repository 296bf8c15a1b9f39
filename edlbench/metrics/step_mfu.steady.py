"""The whole step's share of the chip's bf16 peak in a steady cell."""
from edlbench.readers import step_mfu as read

LAYER = "the device"
MOVES = "train_tokens_per_s"
