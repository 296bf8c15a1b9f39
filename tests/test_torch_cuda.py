"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc; without them every test here skips.
Run them on a machine with a card from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops
from repro_torch.kernels.launches import LAUNCHES

pytestmark = pytest.mark.cuda

CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype, tol
    (2, 4, 4, 256, 256, 64, True, 0, None, torch.float32, 1e-4),
    (1, 8, 2, 200, 200, 16, True, 32, None, torch.float32, 1e-4),
    (1, 4, 2, 130, 160, 32, False, 0, 150, torch.float32, 1e-4),
    (1, 4, 4, 128, 128, 128, True, 0, None, torch.bfloat16, 2e-2),
    # the backward's tiles: 64 q rows (dQ), 128 keys (dK/dV) at D <= 64;
    # lengths at a 128-key tile's edge, one short of it and one past it
    (1, 2, 2, 127, 127, 64, True, 0, None, torch.float32, 1e-4),
    (1, 2, 2, 128, 128, 64, True, 0, None, torch.float32, 1e-4),
    (1, 2, 2, 129, 129, 64, True, 0, None, torch.float32, 1e-4),
    (1, 2, 2, 65, 127, 64, False, 0, None, torch.float32, 1e-4),
    (1, 2, 2, 300, 300, 64, True, 100, None, torch.float32, 1e-4),  # window ends inside a tile
    (2, 8, 2, 256, 256, 64, True, 0, None, torch.float32, 1e-4),    # GQA, G = 4
    (1, 4, 4, 200, 200, 128, True, 0, None, torch.float32, 1e-4),   # D = 128 fp32
    (2, 4, 4, 256, 256, 64, True, 0, None, torch.bfloat16, 2e-2),   # bf16 at D = 64
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,window,kv_len,dtype,tol",
                         CASES)
def test_autograd_function_matches_plain(card, B, Hq, Hkv, Lq, Lk, D, causal,
                                         window, kv_len, dtype, tol):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen, device=card).to(dtype)
               for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
    do = torch.randn((B, Hq, Lq, D), generator=gen, device=card).to(dtype)
    before = LAUNCHES.snapshot()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_bhld(*leaves, causal=causal, window=window,
                                   kv_len=kv_len)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    assert all(after[n] == before[n] + 1 for n in ops.KERNELS)

    opts = dict(causal=causal, window=window, kv_len=kv_len)
    o_p, lse_p = ops.flash_attn_fwd_plain(q, k, v, **opts)
    want = ops.flash_attn_bwd_plain(q, k, v, o_p, lse_p, do, **opts)
    torch.testing.assert_close(out.float(), o_p.float(), atol=tol, rtol=tol)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_backward_kernels_are_deterministic(card, Hq, Hkv):
    """Two runs of the backward pair on the same inputs give the same bits:
    every element of dq, delta, dk and dv has one owning thread, and no
    kernel uses atomics."""
    gen = torch.Generator(device=card).manual_seed(2)
    B, L, D = 2, 384, 64
    q, do = (torch.randn((B, Hq, L, D), generator=gen, device=card)
             for _ in range(2))
    k, v = (torch.randn((B, Hkv, L, D), generator=gen, device=card)
            for _ in range(2))
    opts = dict(causal=True, window=0, scale=D ** -0.5, kv_len=L)
    o, lse = ops.flash_attn_fwd_cuda(q, k, v, **opts)
    runs = []
    for _ in range(2):
        dq, delta = ops.flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
        dk, dv = ops.flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)

def unaligned_randn(gen, card, *shape, scale=1.0):
    """Seeded values in a contiguous view one element into its storage: it
    does not start on a 16-byte boundary."""
    buf = torch.empty(math.prod(shape) + 1, device=card)
    x = buf[1:].view(shape)
    x.copy_(torch.randn(shape, generator=gen, device=card) * scale)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_backward_pair_on_unaligned_inputs(card, Hq, Hkv):
    """fp32 inputs one element into their storage are contiguous but do not
    start on a 16-byte boundary: the backward kernels stage them through
    the threads instead of cp.async, and must agree with the plain versions
    all the same."""
    gen = torch.Generator(device=card).manual_seed(4)
    B, L, D = 1, 200, 64
    q, do = (unaligned_randn(gen, card, B, Hq, L, D) for _ in range(2))
    k, v = (unaligned_randn(gen, card, B, Hkv, L, D) for _ in range(2))
    opts = dict(causal=True, window=0, scale=D ** -0.5, kv_len=L)
    o, lse = ops.flash_attn_fwd_cuda(q, k, v, **opts)
    dq, delta = ops.flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
    dk, dv = ops.flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
    torch.cuda.synchronize()
    dq_p, delta_p = ops.flash_attn_bwd_dq_plain(q, k, v, o, lse, do, **opts)
    dk_p, dv_p = ops.flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do,
                                               **opts)
    for got, want in ((dq, dq_p), (delta, delta_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_warm_up_launches_are_tallied_through_autograd(card):
    """The backward that autograd runs (on a thread of its own) counts as a
    warm-up when its forward ran inside ``warming()``, and not otherwise."""
    q, k, v = (torch.randn((1, 2, 128, 64), device=card).requires_grad_(True)
               for _ in range(3))
    for warm in (True, False):
        before = LAUNCHES.snapshot(warm=True)
        with LAUNCHES.warming(warm):
            out = ops.flash_attention_bhld(q, k, v)
        out.sum().backward()
        torch.cuda.synchronize()
        after = LAUNCHES.snapshot(warm=True)
        assert all(after[n] == before[n] + warm for n in ops.KERNELS)


WKV_CASES = [
    # B, L, H, hd, logw spread
    (2, 64, 4, 64, 0.5),
    (1, 100, 2, 32, 2.0),       # ragged L, a wide spread of decays
    (2, 37, 3, 16, 0.05),
]
# fp32 throughout; the kernels and the plain versions sum in other orders
WKV_TOL = 1e-4


@pytest.mark.parametrize("B,L,H,hd,spread", WKV_CASES)
def test_wkv6_function_matches_plain(card, B, L, H, hd, spread):
    """WKV6Fn on the card, forward and backward, against the plain versions
    on the same inputs; each of the four kernels launches once."""
    from repro_torch.kernels.rwkv import ops as wkv_ops

    gen = torch.Generator(device=card).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=card) * scale

    r, k, v = rnd(B, L, H, hd), rnd(B, L, H, hd), rnd(B, L, H, hd)
    logw = -torch.exp(rnd(B, L, H, hd, scale=spread))
    u, s0 = rnd(H, hd, scale=0.3), rnd(B, H, hd, hd, scale=0.1)
    dy, dsT = rnd(B, L, H, hd), rnd(B, H, hd, hd)
    before = LAUNCHES.snapshot()
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    y, sT = wkv_ops.wkv6(*leaves)
    grads = torch.autograd.grad((y, sT), leaves, (dy, dsT))
    torch.cuda.synchronize()
    after = LAUNCHES.snapshot()
    assert all(after[n] == before[n] + 1 for n in wkv_ops.KERNELS)

    y_p, sT_p = wkv_ops.wkv6_fwd_plain(r, k, v, logw, u, s0)
    want = wkv_ops.wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT)
    for got, w in zip((y, sT, *grads), (y_p, sT_p, *want)):
        torch.testing.assert_close(got, w, atol=WKV_TOL * float(w.abs().max()),
                                   rtol=WKV_TOL)



@pytest.mark.parametrize("aligned", [True, False])
def test_forward_kernels_are_deterministic_and_match_plain(card, aligned):
    """flash_attn_fwd (GQA, G = 4) and wkv6_fwd give the same bits on two
    runs and agree with their plain versions, on 16-byte aligned inputs
    (cp.async staging) and on inputs that are not (the threads' own
    staging)."""
    from repro_torch.kernels.rwkv import ops as wkv_ops

    gen = torch.Generator(device=card).manual_seed(6)

    def rnd(*shape, scale=1.0):
        if aligned:
            return torch.randn(shape, generator=gen, device=card) * scale
        return unaligned_randn(gen, card, *shape, scale=scale)

    B, L, D = 2, 300, 64
    q, k, v = rnd(B, 8, L, D), rnd(B, 2, L, D), rnd(B, 2, L, D)
    opts = dict(causal=True, window=0, scale=D ** -0.5, kv_len=L)
    runs = [ops.flash_attn_fwd_cuda(q, k, v, **opts) for _ in range(2)]
    o_p, lse_p = ops.flash_attn_fwd_plain(q, k, v, **opts)
    r, kk, vv = rnd(B, 77, 4, 64), rnd(B, 77, 4, 64), rnd(B, 77, 4, 64)
    logw = -torch.exp(rnd(B, 77, 4, 64))
    u, s0 = rnd(4, 64, scale=0.3), rnd(B, 4, 64, 64, scale=0.1)
    wruns = [wkv_ops.wkv6_fwd_cuda(r, kk, vv, logw, u, s0) for _ in range(2)]
    y_p, sT_p = wkv_ops.wkv6_fwd_plain(r, kk, vv, logw, u, s0)
    torch.cuda.synchronize()
    for a, b in (*zip(*runs), *zip(*wruns)):
        assert torch.equal(a, b)
    for got, want in zip(runs[0], (o_p, lse_p)):
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    for got, want in zip(wruns[0], (y_p, sT_p)):
        torch.testing.assert_close(got, want, rtol=WKV_TOL,
                                   atol=WKV_TOL * float(want.abs().max()))


@pytest.mark.parametrize("aligned", [True, False])
def test_backward_scans_are_deterministic_and_match_plain(card, aligned):
    """wkv6_bwd_dr, wkv6_bwd_dk (with du) and wkv6_bwd_dv give the same bits
    on two runs and agree with their plain versions (dk on dr's a terms and
    du partials), on 16-byte aligned inputs (cp.async staging) and on inputs
    that are not (the threads' own staging); L = 77 ends inside a stage, the
    one dv scans first."""
    from repro_torch.kernels.rwkv import ops as wkv_ops

    gen = torch.Generator(device=card).manual_seed(7)

    def rnd(*shape, scale=1.0):
        if aligned:
            return torch.randn(shape, generator=gen, device=card) * scale
        return unaligned_randn(gen, card, *shape, scale=scale)

    B, L, H, hd = 2, 77, 4, 64
    r, k, v, dy = (rnd(B, L, H, hd) for _ in range(4))
    logw = -torch.exp(rnd(B, L, H, hd))
    u, s0 = rnd(H, hd, scale=0.3), rnd(B, H, hd, hd, scale=0.1)
    dsT = rnd(B, H, hd, hd, scale=0.1)
    druns = [wkv_ops.wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy, dsT)
             for _ in range(2)]
    a, du_part = druns[0][1], druns[0][2]
    kruns = [wkv_ops.wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT, a, du_part)
             for _ in range(2)]
    vruns = [(wkv_ops.wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT),)
             for _ in range(2)]
    want = (*wkv_ops.wkv6_bwd_dr_plain(r, k, v, logw, u, s0, dy, dsT),
            *wkv_ops.wkv6_bwd_dk_plain(r, k, v, logw, u, dy, dsT, a, du_part),
            wkv_ops.wkv6_bwd_dv_plain(r, k, logw, u, dy, dsT))
    torch.cuda.synchronize()
    for x, y in (*zip(*druns), *zip(*kruns), *zip(*vruns)):
        assert torch.equal(x, y)
    for got, w in zip((*druns[0], *kruns[0], *vruns[0]), want):
        torch.testing.assert_close(got, w, rtol=WKV_TOL,
                                   atol=WKV_TOL * float(w.abs().max()))


def test_leader_kill_across_two_cards_stages_the_state_and_keeps_bits():
    """The leader's death on a two-card pool makes the other card slot 0:
    the train state is copied there on that card's side stream during the
    draining step (the staged move, not the in-stop one), and under
    virtual workers the losses equal the one-card static run's, step for
    step."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the state moves only when slot 0's "
                    "card changes")
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.core.scaling import Phase
    from repro_torch.models.params import tree_leaves

    steps = 12

    def trainer(devices):
        return ElasticTrainer(get_config("edl-paper", smoke=True),
                              global_batch=4, seq_len=64,
                              init_parallelism=len(devices), n_samples=256,
                              d_partitions=16, seed=0, devices=devices,
                              virtual_workers=4, time_allowance_s=0)

    with trainer(["cuda:0"]) as t:
        static = [t.step()["loss"] for _ in range(steps)]
    with trainer(["cuda:0", "cuda:1"]) as t:
        losses = [t.step()["loss"]]
        dead = t.inject_worker_failure(t.worker_ids[0])
        while len(losses) < steps:
            losses.append(t.step()["loss"])
            if t.dead_workers() and t.controller.phase is Phase.IDLE:
                t.handle_failure(t.dead_workers())
                assert t.join_prep(timeout=120)
        assert [r.op for r in t.controller.history] == ["scale_in"]
        rec = t.controller.history[0]
        assert (rec.from_p, rec.to_p, t.p) == (2, 1, 1)
        assert rec.bytes_moved_overlapped > 0, "the state move was not staged"
        assert t._home() == torch.device("cuda:1")
        assert all(x.device == torch.device("cuda:1")
                   for _, x in tree_leaves(t.state))
        assert t.leader_id != dead and dead not in t.worker_ids
    assert losses == static


def test_tensor_parallel_across_two_cards_keeps_bits():
    """Model shards on two cards: the tensor-parallel step's sums are
    ``.to(device)`` copies folded in slot order, so (1, 2) across
    ``cuda:0`` and ``cuda:1`` steps as (1, 2) on one card does; and under
    virtual workers a live reshape (2, 1) -> (1, 2) across the cards,
    whose planner move stages shard 1 onto ``cuda:1``, keeps the one-card
    static losses with ==."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the model shards share one card "
                    "otherwise")
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.models.params import tree_leaves

    def trainer(devices, p, mp, **kw):
        return ElasticTrainer(get_config("edl-paper", smoke=True),
                              global_batch=4, seq_len=64,
                              init_parallelism=p, model_parallel=mp,
                              n_samples=256, d_partitions=16, seed=0,
                              devices=devices, time_allowance_s=0, **kw)

    runs = []
    for devices in (["cuda:0", "cuda:0"], ["cuda:0", "cuda:1"]):
        with trainer(devices, 1, 2) as t:
            runs.append([t.step()["loss"] for _ in range(4)])
            assert [str(tree_leaves(s)[0][1].device) for s in t.state] == \
                devices
    assert runs[0] == pytest.approx(runs[1], rel=1e-6), runs

    steps = 8
    with trainer(["cuda:0"], 1, 1, virtual_workers=4) as t:
        static = [t.step()["loss"] for _ in range(steps)]
    with trainer(["cuda:0", "cuda:1"], 2, 1, virtual_workers=4) as t:
        t.run(2)
        rec = t.reshape(1, 2, block=True)
        t.run(steps - t.step_idx)
        losses = [m["loss"] for m in t.metrics_log][:steps]
        assert (rec.op, t.p, t.model_parallel) == ("reshape", 1, 2)
        assert rec.stop_time < rec.prep_time, rec.summary()
        assert [str(tree_leaves(s)[0][1].device) for s in t.state] == \
            ["cuda:0", "cuda:1"]
    assert losses == static


def test_two_full_width_tenants_loan_and_reclaim_on_two_slots(card):
    """The cluster tier on two slots of one card: a full-width edl_paper
    tenant alone is loaned the idle slot by the throughput policy; the
    second tenant's arrival reclaims it with a stop-free release, and the
    freed slot admits the newcomer. Both finish with finite losses, and
    the executor holds slot conservation every round."""
    from functools import partial

    from repro_torch.cluster import ClusterExecutor, JobSpec, make_policy
    from repro_torch.cluster.executor import default_trainer_factory
    from repro_torch.devices import slot_devices

    full = dict(arch="edl-paper", global_batch=8, seq_len=1024,
                n_samples=256, d_partitions=16)
    ex = ClusterExecutor([JobSpec("a", 1, 10, profile="vgg19", **full),
                          JobSpec("b", 1, 4, profile="resnet50",
                                  arrival=4.0, seed=1, **full)],
                         make_policy("throughput"),
                         devices=slot_devices(2, card), resched_every=2,
                         trainer_factory=partial(default_trainer_factory,
                                                 smoke=False))
    try:
        stats = ex.run(max_rounds=200)
    finally:
        ex.close()
    ops = [(e["op"], e["job"], e["from_p"], e["to_p"], e["loaned"])
           for e in stats["events"]]
    assert ("scale_out", "a", 1, 2, 1) in ops, ops
    assert ("scale_in", "a", 2, 1, 0) in ops, ops
    assert ("scale_out", "b", 0, 1, 0) in ops, ops
    assert ops.index(("scale_in", "a", 2, 1, 0)) < \
        ops.index(("scale_out", "b", 0, 1, 0))
    for job in ex.jobs.values():
        losses = [m["loss"] for m in job.trainer.metrics_log]
        assert all(math.isfinite(x) for x in losses), losses
        # a cold switch stops for less than its prep; one whose prep was a
        # cache lookup stops for the swap alone, well under a step
        recs = job.trainer.controller.history
        assert all(r.stop_time < 0.05 if r.compile_cache_hit
                   else r.stop_time < r.prep_time for r in recs), \
            [r.summary() for r in recs]
    assert stats["finished"] == 2 and stats["conserved"]
    assert [j["steps_done"] for j in stats["jobs"]] == [10, 4]
