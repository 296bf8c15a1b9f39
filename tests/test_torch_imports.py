"""The port imports with JAX blocked and loads nothing of the JAX package."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

MODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.devices",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.edl_paper", "repro_torch.configs.rwkv6_1p6b",
    "repro_torch.core", "repro_torch.core.coordination",
    "repro_torch.core.elastic_runtime", "repro_torch.core.election",
    "repro_torch.core.membership", "repro_torch.core.scaling",
    "repro_torch.data", "repro_torch.data.partition",
    "repro_torch.data.pipeline", "repro_torch.data.synthetic",
    "repro_torch.data.worker",
    "repro_torch.kernels", "repro_torch.kernels.build",
    "repro_torch.kernels.attention", "repro_torch.kernels.attention.ops",
    "repro_torch.kernels.launches", "repro_torch.kernels.rwkv",
    "repro_torch.kernels.rwkv.ops",
    "repro_torch.launch", "repro_torch.launch.train",
    "repro_torch.models", "repro_torch.models.attention",
    "repro_torch.models.blocks", "repro_torch.models.layers",
    "repro_torch.models.model", "repro_torch.models.params",
    "repro_torch.models.ssm",
    "repro_torch.optim", "repro_torch.optim.optimizers",
    "repro_torch.training", "repro_torch.training.step",
]

PROBE = """
import importlib, json, sys
sys.modules["jax"] = None
for m in {modules!r}:
    importlib.import_module(m)
loaded = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
print(json.dumps({{"repro": loaded,
                  "jax": [m for m in sys.modules
                          if m.startswith("jax") and sys.modules[m]]}}))
"""


def test_port_imports_without_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(modules=MODULES)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert loaded["repro"] == [], loaded["repro"]
    assert loaded["jax"] == [], loaded["jax"]


def test_every_port_module_is_listed():
    """The probe above covers every module of the package."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    found = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f),
                                  os.path.join(ROOT, "src"))[:-3]
            mod = rel.replace(os.sep, ".")
            found.append(mod[:-len(".__init__")] if
                         mod.endswith(".__init__") else mod)
    assert sorted(found) == sorted(MODULES)
