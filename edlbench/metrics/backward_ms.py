"""Device ms a traced step under the program's ``edl.backward``: each data
group's backward and the gradients' reduction; remat's recompute is apart."""
from edlbench.readers import span_ms

LAYER = "training/step.py (forward, backward and remat's recompute)"
MOVES = "train_tokens_per_s"


def read(run):
    return span_ms(run, "edl.backward")
