"""The device's idle share of the traced window in a steady cell."""
from edlbench.readers import idle_share as read

LAYER = "the device"
MOVES = "train_tokens_per_s"
