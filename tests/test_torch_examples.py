"""The examples ported onto the PyTorch port (``examples/torch/``), each run
on the CPU at small arguments in a subprocess in which neither ``jax`` nor
``repro`` can load (a ``sitecustomize`` on the subprocess's path blocks
them, in the processes it starts too): every script exits 0 and prints what
it should, and ``elastic_tiresias`` prints the lines of the reference's
``examples/elastic_tiresias.py``."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")

BLOCK = '''
import sys


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} may not load with the port")
        return None


sys.meta_path.insert(0, _Block())
'''

# script, arguments, lines the output must hold
CASES = {
    "quickstart": (["--device", "cpu", "--steps", "3", "--batch", "4",
                    "--seq", "32"], ["step   2", "generated:"]),
    "quickstart_dry_run": (["--dry-run", "--arch", "mixtral-8x7b"],
                           ["dry-run OK"]),
    "quickstart_embeds": (["--device", "cpu", "--steps", "2", "--batch", "2",
                           "--seq", "16", "--arch", "musicgen-medium"],
                          ["step   1"]),
    "elastic_training": (["--demo", "--device", "cpu", "--steps", "10",
                          "--batch", "4", "--seq", "32", "--devices", "4",
                          "--n-samples", "64", "--d-partitions", "8",
                          "--schedule", "out:2@3,in:2@6,migrate:1@8",
                          "--json"], ['"scaling_events"']),
    "elastic_serving": (["--device", "cpu", "--gen", "4"],
                        ["tok/s", "cache_pos=36"]),
    "elastic_tiresias": (["--jobs", "40", "--gpus", "16"], ["Mean JCT"]),
    "multi_tenant_cluster": (["--device", "cpu", "--devices", "2", "--jobs",
                              "a=vgg19:1:4@0,b=resnet50:1:4@1", "--batch",
                              "4", "--seq", "16", "--n-samples", "32",
                              "--d-partitions", "4", "--max-rounds", "60"],
                             ["device conservation: OK"]),
}


def _run(script: str, args: list, env: dict) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, script, *args],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)


@pytest.fixture(scope="module")
def blocked_env(tmp_path_factory):
    site = tmp_path_factory.mktemp("no_jax")
    (site / "sitecustomize.py").write_text(BLOCK)
    return {**os.environ, "OMP_NUM_THREADS": "1",
            "PYTHONPATH": os.pathsep.join([str(site),
                                           os.path.join(ROOT, "src")])}


def test_the_block_holds(blocked_env):
    run = subprocess.run([sys.executable, "-c", "import repro"],
                         capture_output=True, text=True, env=blocked_env)
    assert run.returncode != 0 and "may not load" in run.stderr


@pytest.mark.parametrize("case", sorted(CASES))
def test_example_runs_on_the_port(case, blocked_env):
    args, want = CASES[case]
    script = case.removesuffix("_dry_run").removesuffix("_embeds")
    run = _run(os.path.join(EXAMPLES, "torch", script + ".py"), args,
               blocked_env)
    assert run.returncode == 0, run.stderr[-3000:]
    for line in want:
        assert line in run.stdout, (line, run.stdout[-3000:])
    if case == "elastic_tiresias":
        ref = _run(os.path.join(EXAMPLES, "elastic_tiresias.py"), args,
                   {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
                    "JAX_PLATFORMS": "cpu"})
        assert ref.returncode == 0, ref.stderr[-3000:]
        assert run.stdout == ref.stdout
