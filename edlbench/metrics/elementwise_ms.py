"""Device ms a traced step of the kernels that are neither GEMMs, nor the
port's own kernels, nor copies: norms, casts, activations, AdamW."""
from edlbench.readers import per_step_ms

LAYER = "models/* and optim/optimizers.py (elementwise work)"
MOVES = "train_tokens_per_s"


def read(run):
    return per_step_ms(run, lambda tr: tr["group_s"].get("other", 0.0))
