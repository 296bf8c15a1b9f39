"""Device ms a traced step under the program's ``edl.forward``: each data
group's forward (projections, attention, MLPs, the chunked loss)."""
from edlbench.readers import span_ms

LAYER = "training/step.py (forward, backward and remat's recompute)"
MOVES = "train_tokens_per_s"


def read(run):
    return span_ms(run, "edl.forward")
