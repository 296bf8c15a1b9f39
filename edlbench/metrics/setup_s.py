"""Set-up: from the process's start to the window's first step (imports,
the kernels' build on a first run, the trainer, its warm-ups, the state,
the checked steps)."""

LAYER = "end to end"


def read(run):
    return run.get("setup_s")
