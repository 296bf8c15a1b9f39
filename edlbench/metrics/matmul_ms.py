"""GEMM device ms a traced step (projections, FFN, unembedding)."""
from edlbench.readers import per_step_ms

LAYER = "models/* (projections, FFN, unembedding)"
MOVES = "train_tokens_per_s"


def read(run):
    return per_step_ms(run, lambda tr: tr["group_s"].get("matmul", 0.0))
