"""The plain reference the benchmark holds the program against: one
module a model kind, ``reference/<model>.py``, found by the configuration
file's ``"model"`` key (``kind``); ``model.py`` holds what every kind
shares. Plain PyTorch, nothing of the program."""
from __future__ import annotations

import importlib

# what a kind's module exports (``edlbench/__init__.py`` says what each is)
CONTRACT = ("PORT_FIELDS", "fixed", "param_specs", "loss_sum",
            "matmul_params", "mixer_forward_flops", "TINY")


def kind(m: dict):
    """The module of the configuration's model kind; a kind with no such
    module is refused by its name."""
    name = m.get("model")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"no reference module for the model kind {name!r}")
    full = f"{__name__}.{name}"
    try:
        mod = importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise ValueError(f"no reference module for the model kind {name!r}"
                         f" (edlbench/reference/{name}.py)") from None
    missing = [k for k in CONTRACT if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"the model kind {name!r} has no reference module: "
                         f"edlbench/reference/{name}.py lacks {missing}")
    return mod
