"""The port's flash attention on the CPU (its plain versions) against the
JAX package: the Pallas kernel in interpret mode and ``attention_ref`` for
the forward, ``jax.vjp`` of ``chunked_attention`` (what the JAX trainer
differentiates) for the backward. Inputs are made with numpy from a seed."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.kernels.attention.ops import flash_attention as jax_flash
from repro.kernels.attention.ref import attention_ref
from repro.models.attention import chunked_attention
from repro_torch.kernels.attention import ops
from repro_torch.kernels.launches import LAUNCHES, LaunchCounter

# the shapes of tests/test_kernels.py: SWEEP, and FUZZ_FALLBACK as
# (B, Hq, Hkv, Lq, Lk, D, causal, window) with its (lq, lk, g, hkv, win)
SWEEP = [
    # B, Hq, Hkv, Lq, Lk, D, causal, window, dtype
    (1, 1, 1, 64, 64, 32, True, 0, "float32"),
    (2, 4, 2, 128, 128, 64, True, 0, "float32"),
    (1, 2, 2, 256, 256, 32, True, 64, "float32"),
    (2, 2, 1, 128, 256, 64, False, 0, "float32"),
    (1, 4, 4, 128, 128, 128, True, 0, "bfloat16"),
    (1, 8, 2, 64, 128, 16, True, 32, "float32"),
]
FUZZ_FALLBACK = [
    # lq, lk, g, hkv, win, seed
    (1, 1, 1, 1, 0, 0),
    (3, 1, 2, 2, 0, 1),
    (1, 3, 3, 1, 48, 2),
    (2, 3, 2, 2, 48, 3),
    (3, 3, 1, 2, 0, 4),
]
CASES = SWEEP + [
    (1, hkv * g, hkv, lq * 32, max(lq, lk) * 32, 16, True, win, "float32")
    for lq, lk, g, hkv, win, _ in FUZZ_FALLBACK]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BWD_TOL = 1e-4      # fp32, against jax.vjp(chunked_attention)


def _inputs(B, Hq, Hkv, Lq, Lk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Lq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Lk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Lk, D), dtype=np.float32)
    do = rng.standard_normal((B, Hq, Lq, D), dtype=np.float32)
    return q, k, v, do


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,win,dtype", CASES)
def test_plain_forward_matches_pallas_and_ref(B, Hq, Hkv, Lq, Lk, D, causal,
                                              win, dtype):
    q, k, v, _ = _inputs(B, Hq, Hkv, Lq, Lk, D)
    G = Hq // Hkv
    qj, kj, vj = _j(q, dtype), _j(k, dtype), _j(v, dtype)
    ref = attention_ref(qj, kj, vj, causal=causal, window=win)
    pallas = jax_flash(qj.reshape(B, Hkv, G, Lq, D), kj, vj, causal=causal,
                       window=win).reshape(B, Hq, Lq, D)
    qt, kt, vt = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    o, lse = ops.flash_attn_fwd_plain(qt, kt, vt, causal=causal, window=win)
    grouped = ops.flash_attention(qt.reshape(B, Hkv, G, Lq, D), kt, vt,
                                  causal=causal, window=win)
    assert o.dtype == qt.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, Hq, Lq)
    tol = TOL[dtype]
    for want in (ref, pallas):
        np.testing.assert_allclose(_np(o), _np(want), atol=tol, rtol=tol)
    np.testing.assert_array_equal(_np(grouped.reshape(B, Hq, Lq, D)), _np(o))


def test_plain_forward_masks_padded_kv_tail():
    """``kv_len`` masks the tail of k/v as ``attention_ref(kv_len=...)``."""
    B, Hq, Hkv, Lq, Lk, D, kv_len = 1, 4, 2, 48, 80, 16, 57
    q, k, v, _ = _inputs(B, Hq, Hkv, Lq, Lk, D, seed=5)
    for causal in (True, False):
        ref = attention_ref(_j(q), _j(k), _j(v), causal=causal, kv_len=kv_len)
        o, _ = ops.flash_attn_fwd_plain(_t(q), _t(k), _t(v), causal=causal,
                                        kv_len=kv_len)
        np.testing.assert_allclose(_np(o), _np(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Hq,Hkv,Lq,Lk,D,causal,win,dtype",
                         [c for c in CASES if c[-1] == "float32"])
def test_plain_backward_matches_jax_vjp_and_autograd(B, Hq, Hkv, Lq, Lk, D,
                                                     causal, win, dtype):
    q, k, v, do = _inputs(B, Hq, Hkv, Lq, Lk, D, seed=1)
    G = Hq // Hkv
    out, vjp = jax.vjp(
        lambda q_, k_, v_: chunked_attention(q_, k_, v_, causal=causal,
                                             window=win),
        _j(q).reshape(B, Hkv, G, Lq, D), _j(k), _j(v))
    dq_j, dk_j, dv_j = vjp(_j(do).reshape(B, Hkv, G, Lq, D))

    qt, kt, vt, dot = (_t(a) for a in (q, k, v, do))
    o, lse = ops.flash_attn_fwd_plain(qt, kt, vt, causal=causal, window=win)
    np.testing.assert_allclose(_np(o), _np(out).reshape(B, Hq, Lq, D),
                               atol=2e-5, rtol=2e-5)
    dq, dk, dv = ops.flash_attn_bwd_plain(qt, kt, vt, o, lse, dot,
                                          causal=causal, window=win)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(_np(got).reshape(want.shape), _np(want),
                                   atol=BWD_TOL, rtol=BWD_TOL)

    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    o_ad, _ = ops.flash_attn_fwd_plain(*leaves, causal=causal, window=win)
    grads = torch.autograd.grad(o_ad, leaves, dot)
    for got, want in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=BWD_TOL,
                                   rtol=BWD_TOL)


@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, None), (True, 5, None), (False, 0, 8), (True, 4, 9)])
def test_autograd_function_gradcheck(causal, window, kv_len):
    """The autograd.Function's own backward against finite differences,
    float64 on the CPU, GQA with G = 2."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 4, 9, 4)))
    k = torch.from_numpy(rng.standard_normal((1, 2, 10, 4)))
    v = torch.from_numpy(rng.standard_normal((1, 2, 10, 4)))
    args = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ops.flash_attention_bhld(
            q_, k_, v_, causal=causal, window=window, kv_len=kv_len),
        args, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_cpu_path_launches_no_kernel():
    before = LAUNCHES.snapshot()
    q, k, v, do = (_t(a) for a in _inputs(1, 2, 1, 16, 16, 16))
    q.requires_grad_(True)
    ops.flash_attention_bhld(q, k, v).backward(do)
    assert LAUNCHES.snapshot() == before
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_launch_counter_tallies_warm_ups_per_thread():
    """A launch inside ``warming()`` counts in the total and among the
    warm-ups; one made meanwhile on another thread counts only in the
    total."""
    c = LaunchCounter(ops.KERNELS)
    with c.warming():
        c.add("flash_attn_fwd")
        t = threading.Thread(target=c.add, args=("flash_attn_bwd_dq",))
        t.start()
        t.join()
        with c.warming(False):
            c.add("flash_attn_fwd")
        assert c.is_warming()
    assert not c.is_warming()
    assert c.snapshot() == {"flash_attn_fwd": 2, "flash_attn_bwd_dq": 1,
                            "flash_attn_bwd_dkdv": 0}
    assert c.snapshot(warm=True) == {"flash_attn_fwd": 1,
                                     "flash_attn_bwd_dq": 0,
                                     "flash_attn_bwd_dkdv": 0}
    c.reset()
    assert set(c.snapshot().values()) == set(c.snapshot(warm=True).values()
                                             ) == {0}


@pytest.mark.parametrize("bad", [
    dict(q=(1, 3, 8, 16), k=(1, 2, 8, 16)),          # 3 heads over 2
    dict(q=(1, 2, 8, 16), k=(1, 2, 8, 32)),          # head dims differ
    dict(q=(2, 2, 8, 16), k=(1, 2, 8, 16)),          # batches differ
    dict(q=(1, 2, 8, 16), k=(1, 2, 8, 16), kv_len=9),
    dict(q=(1, 2, 8, 16), k=(1, 2, 8, 16), window=-1),
    dict(q=(1, 2, 8, 16), k=(1, 2, 8, 16), dtype=torch.float16),
    # meta (the dry-run) is held to the CUDA path: no float64
    dict(q=(1, 2, 8, 16), k=(1, 2, 8, 16), dtype=torch.float64,
         device="meta"),
])
def test_wrapper_refuses_what_it_does_not_take(bad):
    dtype = bad.get("dtype", torch.float32)
    dev = bad.get("device", "cpu")
    q = torch.zeros(bad["q"], dtype=dtype, device=dev)
    k = torch.zeros(bad["k"], dtype=dtype, device=dev)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention_bhld(q, k, k.clone(), kv_len=bad.get("kv_len"),
                                 window=bad.get("window", 0))
