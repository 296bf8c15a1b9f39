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


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_backward_pair_on_unaligned_inputs(card, Hq, Hkv):
    """fp32 inputs one element into their storage are contiguous but do not
    start on a 16-byte boundary: the backward kernels stage them through
    the threads instead of cp.async, and must agree with the plain versions
    all the same."""
    gen = torch.Generator(device=card).manual_seed(4)
    B, L, D = 1, 200, 64

    def unaligned(*shape):
        buf = torch.empty(math.prod(shape) + 1, device=card)
        x = buf[1:].view(shape)
        x.copy_(torch.randn(shape, generator=gen, device=card))
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        return x

    q, do = unaligned(B, Hq, L, D), unaligned(B, Hq, L, D)
    k, v = unaligned(B, Hkv, L, D), unaligned(B, Hkv, L, D)
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
    on the same inputs; each of the five kernels launches once."""
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
