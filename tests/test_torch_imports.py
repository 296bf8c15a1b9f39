"""The port imports with JAX blocked and loads nothing of the JAX package."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

MODULES = [
    "repro_torch", "repro_torch.bridge", "repro_torch.devices",
    "repro_torch.prng",
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
    "repro_torch.chaos", "repro_torch.chaos.inject",
    "repro_torch.chaos.plan",
    "repro_torch.cluster", "repro_torch.cluster.executor",
    "repro_torch.cluster.job", "repro_torch.cluster.policy",
    "repro_torch.cluster.serving",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.edl_paper", "repro_torch.configs.rwkv6_1p6b",
    "repro_torch.configs.phi3_mini_3p8b",
    "repro_torch.configs.mistral_nemo_12b",
    "repro_torch.configs.qwen2p5_32b", "repro_torch.configs.starcoder2_15b",
    "repro_torch.configs.llava_next_mistral_7b",
    "repro_torch.configs.musicgen_medium",
    "repro_torch.configs.mixtral_8x7b",
    "repro_torch.configs.deepseek_v2_236b",
    "repro_torch.configs.jamba_v01_52b",
    "repro_torch.core", "repro_torch.core.api",
    "repro_torch.core.compile_service", "repro_torch.core.coordination",
    "repro_torch.core.elastic_runtime", "repro_torch.core.election",
    "repro_torch.core.failure", "repro_torch.core.membership",
    "repro_torch.core.profiling", "repro_torch.core.scaling",
    "repro_torch.core.serving", "repro_torch.core.stop_resume",
    "repro_torch.data", "repro_torch.data.partition",
    "repro_torch.data.pipeline", "repro_torch.data.synthetic",
    "repro_torch.data.worker",
    "repro_torch.kernels", "repro_torch.kernels.build",
    "repro_torch.kernels.attention", "repro_torch.kernels.attention.ops",
    "repro_torch.kernels.launches", "repro_torch.kernels.optim",
    "repro_torch.kernels.optim.ops", "repro_torch.kernels.rwkv",
    "repro_torch.kernels.rwkv.ops",
    "repro_torch.launch", "repro_torch.launch.cluster",
    "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
    "repro_torch.launch.train",
    "repro_torch.models", "repro_torch.models.attention",
    "repro_torch.models.blocks", "repro_torch.models.cache",
    "repro_torch.models.layers",
    "repro_torch.models.model", "repro_torch.models.moe",
    "repro_torch.models.params",
    "repro_torch.models.ssm",
    "repro_torch.obs", "repro_torch.obs.audit", "repro_torch.obs.bus",
    "repro_torch.obs.events", "repro_torch.obs.metrics",
    "repro_torch.obs.report", "repro_torch.obs.trace",
    "repro_torch.optim", "repro_torch.optim.optimizers",
    "repro_torch.parallel",
    "repro_torch.reshape", "repro_torch.reshape.apply",
    "repro_torch.reshape.plan", "repro_torch.reshape.spec",
    "repro_torch.sched", "repro_torch.sched.base",
    "repro_torch.sched.serving", "repro_torch.sched.simulator",
    "repro_torch.sched.throughput", "repro_torch.sched.tiresias",
    "repro_torch.sched.traffic", "repro_torch.sched.workload",
    "repro_torch.sharding",
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
