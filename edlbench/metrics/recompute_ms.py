"""Device ms a traced step under the program's ``edl.recompute``: remat's
recomputation of each layer's forward, on autograd's thread."""
from edlbench.readers import span_ms

LAYER = "training/step.py (forward, backward and remat's recompute)"
MOVES = "train_tokens_per_s"


def read(run):
    return span_ms(run, "edl.recompute")
