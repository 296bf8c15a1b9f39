"""Device kernel launches a traced step, summed over cards."""
from edlbench.readers import traced

LAYER = "training/step.py, parallel.py (the step's launches)"
MOVES = "train_tokens_per_s"


def read(run):
    t = traced(run)
    if t is None:
        return None
    tr, steps = t
    return tr["launches"] / len(steps)
