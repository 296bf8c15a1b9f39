"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card and nvcc; without them every test here skips.
Run them on a machine with a card from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention import ops

pytestmark = pytest.mark.cuda

CASES = [
    # B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype, tol
    (2, 4, 4, 256, 256, 64, True, 0, None, torch.float32, 1e-4),
    (1, 8, 2, 200, 200, 16, True, 32, None, torch.float32, 1e-4),
    (1, 4, 2, 130, 160, 32, False, 0, 150, torch.float32, 1e-4),
    (1, 4, 4, 128, 128, 128, True, 0, None, torch.bfloat16, 2e-2),
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
    before = ops.LAUNCHES.snapshot()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention_bhld(*leaves, causal=causal, window=window,
                                   kv_len=kv_len)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    after = ops.LAUNCHES.snapshot()
    assert all(after[n] == before[n] + 1 for n in ops.KERNELS)

    opts = dict(causal=causal, window=window, kv_len=kv_len)
    o_p, lse_p = ops.flash_attn_fwd_plain(q, k, v, **opts)
    want = ops.flash_attn_bwd_plain(q, k, v, o_p, lse_p, do, **opts)
    torch.testing.assert_close(out.float(), o_p.float(), atol=tol, rtol=tol)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got.float(), w.float(), atol=tol, rtol=tol)


def test_warm_up_launches_are_tallied_through_autograd(card):
    """The backward that autograd runs (on a thread of its own) counts as a
    warm-up when its forward ran inside ``warming()``, and not otherwise."""
    q, k, v = (torch.randn((1, 2, 128, 64), device=card).requires_grad_(True)
               for _ in range(3))
    for warm in (True, False):
        before = ops.LAUNCHES.snapshot(warm=True)
        with ops.LAUNCHES.warming(warm):
            out = ops.flash_attention_bhld(q, k, v)
        out.sum().backward()
        torch.cuda.synchronize()
        after = ops.LAUNCHES.snapshot(warm=True)
        assert all(after[n] == before[n] + warm for n in ops.KERNELS)
