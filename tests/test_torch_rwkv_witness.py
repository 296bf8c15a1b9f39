"""What the rwkv6 path's loss on fresh batches does, in the JAX trainer and
in the port: from the reference's own init, at the reference's learning
rate (AdamW, 1e-3) and on the same synthetic stream of uniform-noise
tokens, the loss of fresh batches rises above an update-free run's, in the
JAX trainer as in the port, and the port's trajectory follows the JAX
trainer's.

Full width cannot run here, so the model is cut to a width whose layers
have the full width's gains: the reference's stacked init draws every layer
weight with std 1/sqrt(n_layers), so a layer scales its input by about
sqrt(d_in / n_layers), which is 9.2 (time-mix) and 17.3 (channel-mix
down-projection) both at full width (d_model 2048, d_ff 7168, 24 layers)
and here (512, 1792, 6 layers). The vocabulary is cut to 8192 tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread keeps parallel test workers from oversubscribing the
# cores
torch.set_num_threads(1)

import jax

from repro.configs import get_config as jax_get_config
from repro.core import ElasticTrainer as JaxElasticTrainer
from repro.optim import adamw as jax_adamw
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import ElasticTrainer
from repro_torch.optim import adamw

ARCH = "rwkv6-1.6b"
CUT = dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=1792,
           vocab=8192, param_dtype="float32", compute_dtype="float32",
           remat=False)
TRAINER = dict(global_batch=8, seq_len=64, init_parallelism=1,
               n_samples=1024, d_partitions=16, seed=0, use_aot=False)
STEPS, LR = 12, 1e-3
# From this init the training is sensitive to rounding: the JAX trainer's
# own fp32 losses drift from its float64 ones by up to 1.9e-3 over these 12
# steps (measured); the port's from the JAX trainer's by up to 1.8e-3
# (measured).
TRAJ_RTOL = 5e-3
# The mean, over the last 4 steps, of the loss at LR less the update-free
# run's loss on the same batch: measured 0.091 (JAX) and 0.087 (port),
# where over the first 6 steps the difference stays within 0.035 either way.
RISE, TAIL = 0.04, 4


def test_fresh_batch_loss_rises_in_jax_trainer_and_port():
    jt = JaxElasticTrainer(
        dataclasses.replace(jax_get_config(ARCH), **CUT),
        optimizer=jax_adamw(LR), devices=jax.devices()[:1], **TRAINER)
    state = jax.tree.map(np.asarray, jt.state)
    want = np.array([jt.step()["loss"] for _ in range(STEPS)])
    del jt

    def port_losses(lr):
        with ElasticTrainer(dataclasses.replace(get_config(ARCH), **CUT),
                            optimizer=adamw(lr), devices=["cpu"],
                            device="cpu", time_allowance_s=0,
                            **TRAINER) as pt:
            pt.state = [bridge.params_from_numpy(state, "cpu")]
            return np.array([pt.step()["loss"] for _ in range(STEPS)])

    got, frozen = port_losses(LR), port_losses(0.0)
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)
    for losses in (want, got):
        assert np.all(np.isfinite(losses))
        assert np.mean(losses[-TAIL:] - frozen[-TAIL:]) > RISE
        # the check the full-width path fails: the last loss is not below
        # the first
        assert losses[-1] > losses[0]
