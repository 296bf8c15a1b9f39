"""The plain reference against the program (``repro_torch``) on the CPU at
small sizes, in float32, where the two agree to rounding: every model kind
whose module is found, on its configuration files cut to its ``TINY``."""
import pytest
import torch

from edlbench import run
from edlbench.reference import model as ref
from repro_torch.models import model as M
from repro_torch.models.params import tree_leaves, tree_unflatten

from helpers import configs, kinds, small

KINDS = kinds()


def first_config(model: str) -> str:
    found = configs(model)
    assert found, f"no configuration file of the kind {model!r}"
    return found[0]


@pytest.mark.parametrize("model", KINDS)
def test_reference_tree_is_the_programs(model):
    for config in configs(model):
        for m in (small(config),
                  run.load_json(run.HERE / "configs" / f"{config}.json")):
            cfg = run.port_config(m)
            prog = {p: tuple(s.shape)
                    for p, s in tree_leaves(M.param_spec_tree(cfg))}
            assert prog == {p: s for p, s, _, _ in ref.param_specs(m)}


@pytest.mark.parametrize("model", KINDS)
def test_init_params_repeat_from_the_seed(model):
    m = small(first_config(model))
    a = ref.init_params(m, 2**31 + 5, "cpu")
    b = ref.init_params(m, 2**31 + 5, "cpu")
    c = ref.init_params(m, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unembed/w"], c["unembed/w"])
    assert a["unembed/w"].dtype == torch.bfloat16


@pytest.mark.parametrize("model", KINDS)
def test_loss_and_gradients_match_the_program(model):
    m = small(first_config(model))
    cfg = run.port_config(m)
    start = ref.init_params(m, 11, "cpu", dtype=torch.float32)
    tok = torch.randint(0, m["vocab_size"], (3, 49),
                        generator=torch.Generator().manual_seed(0))
    params = tree_unflatten((k, v.clone().requires_grad_())
                            for k, v in start.items())
    loss, _ = M.loss_fn(cfg, params, {"tokens": tok[:, :-1],
                                      "labels": tok[:, 1:]})
    leaves = tree_leaves(params)
    grads = dict(zip([p for p, _ in leaves], torch.autograd.grad(
        loss, [t for _, t in leaves])))
    P = {k: ([x.clone().requires_grad_() for x in v.unbind(0)]
             if k.startswith("layers/") else v.clone().requires_grad_())
         for k, v in start.items()}
    mine = ref.loss_sum(m, P, tok[:, :-1], tok[:, 1:]) / tok[:, 1:].numel()
    mine.backward()
    assert float(mine.detach()) == pytest.approx(float(loss.detach()),
                                                 rel=1e-6)
    for k, v in P.items():
        g = torch.stack([x.grad for x in v]) if isinstance(v, list) \
            else v.grad
        assert torch.allclose(g, grads[k], rtol=1e-3,
                              atol=1e-4 * float(grads[k].abs().max())), k


@pytest.mark.parametrize("model", KINDS)
def test_reference_training_repeats_and_splits_over_devices(model):
    """Three AdamW steps give the same numbers whether the rows run on one
    device or are split over two (on the CPU, both the CPU)."""
    m = small(first_config(model), "bfloat16")
    opt = {"lr": 1e-3, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
           "weight_decay": 0.01}
    gen = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(3):
        t = torch.randint(0, m["vocab_size"], (4, 17), generator=gen)
        batches.append((t[:, :-1], t[:, 1:]))
    one = ref.train(m, opt, 3, batches, [torch.device("cpu")], rows=2)
    two = ref.train(m, opt, 3, batches, [torch.device("cpu")] * 2, rows=1)
    assert one["loss"] == pytest.approx(two["loss"], rel=1e-6)
    for k in one["change_norm"]:
        assert one["change_norm"][k] == pytest.approx(
            two["change_norm"][k], rel=1e-3, abs=1e-9)
    assert one["loss"][2] < one["loss"][0]
