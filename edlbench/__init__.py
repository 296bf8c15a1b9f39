"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``run.py``.

Adding a configuration
----------------------

A cell is found by its names in ``BENCHMARK.json``, and each name by a file
of its own, so a configuration, with its cells, its reference and its
metrics, is added as new files and new entries there:

* ``configs/<config>.json``: the sizes as run; ``"model"`` names its kind,
  ``"arch"`` the port's config it sets. Keys beginning ``reference_`` are
  the reference's own (its chunk sizes).
* ``reference/<model>.py``, where the kind is new: plain PyTorch that
  imports nothing of the program, found by ``reference.kind``. It exports

  - ``PORT_FIELDS``: configuration key -> the port's ``ArchConfig``
    field, dotted into a nested config (``"kv_lora_rank":
    "mla.kv_lora"``); ``run.port_config`` refuses any other key;
  - ``fixed(m)``: the keys whose value the port fixes, and that value;
  - ``param_specs(m)``: (path, shape, init, std) of every leaf, the
    program's tree (``model.stacked_specs`` stacks a period of layers);
  - ``loss_sum(m, P, tokens, labels, low)``: the summed cross-entropy in
    float32, and under ``low`` the float8 control
    (``model.stacked_loss_sum`` runs a stack of one layer function);
  - ``matmul_params(m)`` and ``mixer_forward_flops(m, B, L)``, which
    ``counts.step_model_flops`` adds up;
  - ``TINY``: the sizes of the kind's CPU tests, which every test of
    ``tests/`` parametrised over the kinds found then runs.

  A kernel's bound goes in the kind's module or in a new file.
* ``traffic/<traffic>.json``: the mix; ``limits/<cell>.json``: the
  compared numbers' limits, set by ``probe.py``.
* ``metrics/<metric>.py``: one reader a metric, ``read(run)``. A span the
  program opens reads ``readers.span_ms(run, "edl.<name>", within=True)``,
  a number its ``step()`` returns ``readers.step_values(run, key)``.
"""
