"""Device ms a traced step under the program's ``edl.update``: every slot's
optimizer update and the gradient norm."""
from edlbench.readers import span_ms

LAYER = "optim/optimizers.py, kernels/optim/ (the update)"
MOVES = "train_tokens_per_s"


def read(run):
    return span_ms(run, "edl.update")
