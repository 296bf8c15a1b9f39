"""Training throughput: the tokens of every step completed in the window
over the window's seconds (host clock, the window ends with a step)."""
from edlbench.readers import tokens_per_s as read

LAYER = "end to end"
