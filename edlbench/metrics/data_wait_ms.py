"""Host ms a traced step in the program's ``edl.data``: the batch's
assembly and its copies to the cards."""
from edlbench.readers import per_step_ms

LAYER = "core/elastic_runtime.py (ElasticTrainer.step's host work)"
MOVES = "train_tokens_per_s"


def read(run):
    return per_step_ms(run, lambda tr: tr["span_host_s"].get("edl.data"))
