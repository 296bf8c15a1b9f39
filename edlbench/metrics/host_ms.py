"""The host's own ms a traced step (``trace.summarize``'s
``host_own_s``): the program's ``edl.step`` less its ``edl.sync`` and
every CUDA call's wait. Under the profiler, so it holds the profiler's
cost of each op too: an upper bound of how far the host paces the step."""
from edlbench.readers import per_step_ms

LAYER = "core/elastic_runtime.py (ElasticTrainer.step's host work)"
MOVES = "train_tokens_per_s"


def read(run):
    return per_step_ms(run, lambda tr: tr["host_own_s"]
                       if "edl.step" in tr["span_host_s"] else None)
