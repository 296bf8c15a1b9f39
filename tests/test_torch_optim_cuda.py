"""The AdamW update and the gradient norm's square-sum of
``src/repro_torch/kernels/csrc/adamw.cu`` on the card, against the eager
formulas on the same CUDA tensors.

These need an NVIDIA card and nvcc; without them every test here skips.
Run them on a machine with a card from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_optim_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.launches import LAUNCHES, KernelRefusal
from repro_torch.kernels.optim import ops

pytestmark = pytest.mark.cuda

HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
SIZES = [(1,), (3,), (1023,), (2 ** 20 + 7,), (16, 96, 256)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


def inputs(card, shape, p_dtype, g_dtype, count, seed=0):
    """Seeded p, g, m (signed), v (positive) and the bias corrections after
    ``count`` steps, formed as ``optim/optimizers.py: adam`` forms them."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def rnd(dtype, scale):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(
            dtype)

    p, g = rnd(p_dtype, 1.0), rnd(g_dtype, 1e-2)
    m, v = rnd(torch.float32, 1e-3), rnd(torch.float32, 1e-3).square()
    cf = torch.full((), count, dtype=torch.int32, device=card).float()
    bc1 = 1.0 - torch.full((), HYPER["b1"], device=card) ** cf
    bc2 = 1.0 - torch.full((), HYPER["b2"], device=card) ** cf
    return p, g, m, v, bc1, bc2


def assert_same_bits(got, want):
    for name, a, b in zip(("p", "m", "v"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), \
            f"{name}: {int((a != b).sum())} of {a.numel()} elements differ"


@pytest.mark.parametrize("shape", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("count", [1, 1000])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_update_gives_the_eager_formulas_bits(card, shape, count,
                                              weight_decay, dtype):
    """One launch a leaf, p', m' and v' bit for bit the eager formula's on
    the same CUDA tensors, and the inputs left as they were."""
    ins = inputs(card, shape, dtype, dtype, count)
    before = [t.clone() for t in ins]
    n0 = LAUNCHES.snapshot()["adamw_update"]
    got = ops.adamw_update(*ins, **HYPER, weight_decay=weight_decay)
    torch.cuda.synchronize()
    assert LAUNCHES.snapshot()["adamw_update"] == n0 + 1
    want = ops.adamw_update_plain(*ins, **HYPER, weight_decay=weight_decay)
    assert_same_bits(got, want)
    assert all(torch.equal(a, b) for a, b in zip(ins, before))


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_update_refuses_mixed_param_and_gradient_dtypes(card, p_dtype,
                                                        g_dtype):
    """Autograd gives each gradient its param's dtype: the kernel is built
    for that alone."""
    ins = inputs(card, (1023,), p_dtype, g_dtype, 7)
    with pytest.raises(KernelRefusal, match="its param's dtype"):
        ops.adamw_update(*ins, **HYPER, weight_decay=0.01)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_a_leaf_made_of_boxes_updates_as_the_whole(card, dtype):
    """A stacked leaf cut into FSDP-style boxes: copies along the first dim
    (as ``GradBoxes`` and the state's slots hold them), a view that does not
    start on a 16-byte boundary (taken one element at a time) and views
    across the last dim (not contiguous). Each box's update, laid back
    together, has the whole leaf's bits."""
    ins = inputs(card, (16, 96, 256), dtype, dtype, 5)
    whole = ops.adamw_update(*ins, **HYPER, weight_decay=0.01)
    cuts = {"rows": [(slice(a, a + 4),) for a in range(0, 16, 4)],
            "columns": [(slice(None), slice(None), slice(a, a + 64))
                        for a in range(0, 256, 64)]}
    for kind, boxes in cuts.items():
        out = [torch.empty_like(t) for t in whole]
        for box in boxes:
            parts = [t[box] for t in ins[:4]]
            if kind == "rows":
                parts = [t.clone() for t in parts]
            got = ops.adamw_update(*parts, *ins[4:], **HYPER,
                                   weight_decay=0.01)
            for o, t in zip(out, got):
                o[box] = t
        assert_same_bits(out, whole)
    # a box one element into its storage: not 16-byte aligned
    flat = [t.reshape(-1)[1:4097] for t in ins[:4]]
    got = ops.adamw_update(*flat, *ins[4:], **HYPER, weight_decay=0.01)
    assert_same_bits(got, [t.reshape(-1)[1:4097] for t in whole])


def test_update_refuses_what_the_kernel_does_not_take(card):
    p, g, m, v, bc1, bc2 = inputs(card, (64,), torch.float32, torch.float32, 1)
    with pytest.raises(KernelRefusal, match="float32 or bfloat16"):
        ops.adamw_update(p.half(), g, m, v, bc1, bc2, **HYPER,
                         weight_decay=0.0)
    with pytest.raises(KernelRefusal, match="float32 moments"):
        ops.adamw_update(p, g, m.double(), v, bc1, bc2, **HYPER,
                         weight_decay=0.0)


def test_update_copies_nothing_from_the_host(card):
    """The optimizer's whole update of a two-leaf tree, traced: no copy
    from the host (the bias corrections are filled on the card) and no
    aten op but the scalar ones around the kernel launches."""
    from repro_torch.optim import adamw

    opt = adamw(1e-3)
    params = {"a": torch.randn(1000, device=card).bfloat16(),
              "b": torch.randn(3, 64, device=card)}
    grads = {k: torch.randn_like(t) for k, t in params.items()}
    state = opt.init(params)
    opt.update(grads, state, params)            # builds and loads the kernel
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        opt.update(grads, state, params)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert not [n for n in names if "Memcpy" in n or "_to_copy" in n
                or "cudaStreamSynchronize" in n], names
    assert sum("adamw_update_kernel" in n for n in names) == 2


def test_bias_corrections_raised_to_the_int_count_as_to_its_float(card):
    """``adam`` raises the fp32 bases to the int32 count itself: the bits of
    raising them to the count cast to fp32 first."""
    c = torch.tensor([1, 2, 3, 10, 999, 1000, 123457], dtype=torch.int32,
                     device=card)
    for b in (HYPER["b1"], HYPER["b2"]):
        base = torch.full((), b, device=card)
        assert torch.equal(base ** c, base ** c.float())


def test_grad_sq_sum_repeats_its_bits_and_follows_eager(card):
    """Leaves in both dtypes, of 1 to 2^20 + 7 elements and one stacked, one
    not 16-byte aligned: the same bits twice, within 1e-6 of the eager sum;
    a launch a leaf and one for the device."""
    gen = torch.Generator(device=card).manual_seed(3)
    xs = [torch.randn(s, generator=gen, device=card).to(dt)
          for s in SIZES for dt in (torch.float32, torch.bfloat16)]
    xs.append(torch.randn(5000, device=card).bfloat16()[1:])
    before = LAUNCHES.snapshot()
    got = [ops.sq_sum(xs, card) for _ in range(2)]
    after = LAUNCHES.snapshot()
    assert after["grad_sq_sum"] - before["grad_sq_sum"] == 2 * len(xs)
    assert after["grad_sq_sum_final"] - before["grad_sq_sum_final"] == 2
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0], ops.sq_sum_plain(xs, card), rtol=1e-6,
                               atol=0)


def test_a_training_step_runs_the_optimizer_kernels(card):
    """edl_paper SMOKE's default step at (1, 1) with AdamW: one
    ``adamw_update`` and one ``grad_sq_sum`` a leaf, one
    ``grad_sq_sum_final``; the params after it are the eager formula's."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.reshape.apply import place_state
    from repro_torch.training.step import init_train_state, \
        make_train_step, port_layout

    cfg = get_config("edl-paper", smoke=True)
    opt = adamw(1e-3)
    state = place_state(port_layout(cfg, opt, 1, 1), init_train_state(
        cfg, opt, torch.Generator().manual_seed(0), card), [card])
    step = make_train_step(cfg, opt, [card])
    toks = torch.randint(0, cfg.vocab, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    n_leaves = len(tree_leaves(state[0]["params"]))
    LAUNCHES.reset()
    new, metrics = step(state, batch)
    torch.cuda.synchronize()
    launches = LAUNCHES.snapshot()
    assert (launches["adamw_update"], launches["grad_sq_sum"],
            launches["grad_sq_sum_final"]) == (n_leaves, n_leaves, 1)
    assert torch.isfinite(metrics["grad_norm"])
    assert int(new[0]["opt"]["count"]) == 1
