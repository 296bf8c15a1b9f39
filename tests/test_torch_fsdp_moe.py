"""The MoE configs at p > 1 against the JAX trainer on the CPU: mixtral,
deepseek-v2 and jamba SMOKEs at (2, 1) and (2, 2) take 3 AdamW steps from
the JAX trainer's rescaled state on its data, at two token counts: B 4 x
L 32, where a routing group of the reference's global batch spans both
data groups, and B 4 x L 256, where each lies in one. The reference routes
the whole global batch in one program; the port's default step runs each
data group apart after a routing pre-pass, and its losses must hold the
JAX trainer's within ``TRAJ_RTOL`` (``test_torch_fsdp.py``'s set-up and
tolerance)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_fsdp import BATCH, D_PARTS, N_SAMPLES, OPT, ROOT, STEPS, \
    TRAJ_RTOL, _JAX_FSDP

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.reshape import unflatten_tree

ARCHS = ("mixtral-8x7b", "deepseek-v2-236b", "jamba-v0.1-52b")
LAYOUTS = ((2, 1), (2, 2))
SEQS = (32, 256)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer at (2, 1) and (2, 2) on four forced host devices for
    each arch and sequence length: its rescaled initial state and losses,
    one subprocess a sequence length."""
    runs = {}
    for seq in SEQS:
        out = str(tmp_path_factory.mktemp(f"jax_moe_{seq}"))
        script = _JAX_FSDP.format(
            tests=os.path.dirname(__file__), archs=ARCHS, layouts=LAYOUTS,
            b=BATCH, s=seq, n=N_SAMPLES, d=D_PARTS, steps=STEPS, out=out)
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
               "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
        run = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, env=env,
                             cwd=ROOT, timeout=900)
        assert run.returncode == 0, run.stderr[-3000:]
        for name, ls in json.loads(
                run.stdout.strip().splitlines()[-1]).items():
            with np.load(os.path.join(out, name + "_init.npz")) as z:
                init = {k: z[k] for k in z.files}
            runs[f"{name}_L{seq}"] = (init, np.array(ls))
    return runs


@pytest.mark.parametrize("seq", SEQS, ids=lambda s: f"L{s}")
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_at_p2_matches_the_jax_trainer(arch, layout, seq, jax_runs):
    p, mp = layout
    init, want = jax_runs[f"{arch}_{p}x{mp}_L{seq}"]
    with ElasticTrainer(get_config(arch, smoke=True), global_batch=BATCH,
                        seq_len=seq, init_parallelism=p, model_parallel=mp,
                        optimizer=OPT, n_samples=N_SAMPLES,
                        d_partitions=D_PARTS, seed=0, devices=["cpu"] * 4,
                        device="cpu", use_aot=False) as t:
        t.state = bridge.shard_state_from_numpy(unflatten_tree(init),
                                                t.exec.layout, t.exec.devices)
        got = np.array([t.step()["loss"] for _ in range(STEPS)])
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
