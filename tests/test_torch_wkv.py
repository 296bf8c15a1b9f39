"""The port's WKV6 on the CPU (its plain versions, through the autograd
Function) against the JAX package: the Pallas kernel in interpret mode and
``wkv6_ref`` for the forward, ``jax.vjp`` of ``wkv6_scan`` (what the JAX
trainer differentiates) for the backward. Inputs are made with numpy from a
seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread each keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from repro.kernels.rwkv.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv.ref import wkv6_ref
from repro.models.ssm import wkv6_scan as jax_wkv6_scan
from repro_torch.kernels.launches import LAUNCHES
from repro_torch.kernels.rwkv import ops
from repro_torch.models import ssm

# tests/test_kernels.py: WKV_SWEEP, (B, L, H, hd, chunk); L = 80 pads to 96
# in the Pallas wrapper and is ragged for the port, which pads nothing
WKV_SWEEP = [
    (1, 32, 1, 8, 16),
    (2, 96, 3, 16, 32),
    (1, 64, 2, 32, 32),
    (2, 80, 2, 16, 32),
]
# the forward against the Pallas kernel and wkv6_ref, as tests/test_kernels.py
# holds the Pallas kernel against wkv6_ref
FWD_TOL = 2e-4
# The backward against jax.vjp(wkv6_scan) in fp32, element-wise with a floor
# of BWD_TOL x the gradient's largest entry. Measured over the sweep and two
# wider ones (hd 64, L up to 512, decay spreads 0.05 to 2), two seeds each,
# both against the same vjp in float64: the JAX fp32 gradients err by at
# most 5.0e-7 of their largest entry, the port's by at most 7.1e-7 (du;
# dlogw, a cumulative sum over the sequence, 6.1e-7), and the two differ by
# at most 8.2e-7. Near-zero entries of dlogw differ by up to 6e-4 of
# themselves, so the floor, not the rtol, carries those.
BWD_TOL = 1e-5
BWD_RTOL = 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _inputs(B, L, H, hd, seed=0, spread=0.5):
    """r, k, v, logw, u, s0, dy, dsT as float32 numpy, in the model's
    [B, L, H, hd] layout."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, L, H, hd), dtype=np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, L, H, hd)) * spread)
    u = rng.standard_normal((H, hd)) * 0.3
    s0 = rng.standard_normal((B, H, hd, hd)) * 0.1
    dy = rng.standard_normal((B, L, H, hd))
    dsT = rng.standard_normal((B, H, hd, hd))
    return [np.asarray(a, np.float32) for a in
            (r, k, v, logw, u, s0, dy, dsT)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _np(x):
    return x.detach().double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float64)


@pytest.mark.parametrize("B,L,H,hd,chunk", WKV_SWEEP)
def test_plain_forward_matches_pallas_and_ref(B, L, H, hd, chunk):
    r, k, v, logw, u, s0, _, _ = _inputs(B, L, H, hd)
    pallas_y, pallas_sT = jax_wkv6(*(jnp.asarray(a) for a in
                                     (r, k, v, logw, u, s0)), chunk=chunk)
    tr = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    ref_y, ref_sT = wkv6_ref(tr(r), tr(k), tr(v), tr(logw), jnp.asarray(u),
                             jnp.asarray(s0))
    y, sT = ops.wkv6(*_t(r, k, v, logw, u, s0))
    assert y.shape == (B, L, H, hd) and sT.shape == (B, H, hd, hd)
    for want_y, want_sT in ((pallas_y, pallas_sT), (tr(ref_y), ref_sT)):
        np.testing.assert_allclose(_np(y), _np(want_y), atol=FWD_TOL,
                                   rtol=FWD_TOL)
        np.testing.assert_allclose(_np(sT), _np(want_sT), atol=FWD_TOL,
                                   rtol=FWD_TOL)


@pytest.mark.parametrize("lw_val", [-20.0, -1e-4])
def test_extreme_decay_stays_finite(lw_val):
    """Near-zero decay (logw very negative) and near-one decay (logw ~ 0),
    forward and backward, as tests/test_kernels.py checks the Pallas
    kernel."""
    r, k, v, _, _, _, dy, dsT = _inputs(1, 64, 1, 8, seed=4)
    logw = np.full_like(r, lw_val)
    u = np.zeros((1, 8), np.float32)
    s0 = np.zeros((1, 1, 8, 8), np.float32)
    leaves = [t.requires_grad_(True) for t in _t(r, k, v, logw, u, s0)]
    y, sT = ops.wkv6(*leaves)
    grads = torch.autograd.grad((y, sT), leaves, _t(dy, dsT))
    assert torch.isfinite(y).all() and torch.isfinite(sT).all()
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("B,L,H,hd,chunk", WKV_SWEEP)
def test_plain_backward_matches_jax_vjp_of_scan(B, L, H, hd, chunk):
    """dr, dk, dv, dlogw, du and ds0 from the autograd Function's plain
    route against jax.vjp of wkv6_scan, w = exp(logw), dsT nonzero."""
    r, k, v, logw, u, s0, dy, dsT = _inputs(B, L, H, hd, seed=1)
    _, vjp = jax.vjp(
        lambda r_, k_, v_, lw, u_, s_: jax_wkv6_scan(r_, k_, v_, jnp.exp(lw),
                                                      u_, s_),
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dsT)))
    leaves = [t.requires_grad_(True) for t in _t(r, k, v, logw, u, s0)]
    got = torch.autograd.grad(ops.wkv6(*leaves), leaves, _t(dy, dsT))
    for name, g, w in zip(NAMES, got, want):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=BWD_RTOL,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("lw_val", [-20.0, -54.5])
def test_dlogw_is_accurate_where_the_decay_is_tiny(lw_val):
    """Where w = exp(logw) is tiny, dlogw = w . rowsum(G . S) is tiny too,
    while the terms of the identity that share no decay factor are not: the
    plain backward (as the dk kernel) leaves those out instead of letting
    them cancel, so dlogw keeps its own precision. Held against autograd of
    the plain serial scan in float64 (-54.5: near the model's clip, -e^4)."""
    r, k, v, logw, u, s0, dy, dsT = _inputs(2, 48, 2, 16, seed=6)
    logw = np.full_like(logw, lw_val)
    leaves = [t.requires_grad_(True) for t in _t(r, k, v, logw, u, s0)]
    dlogw = torch.autograd.grad(ops.wkv6(*leaves), leaves[3], _t(dy, dsT))[0]
    leaves64 = [torch.from_numpy(a.astype(np.float64)).requires_grad_(True)
                for a in (r, k, v, logw, u, s0)]
    y, sT = ops.wkv6_scan_plain(*leaves64[:3], torch.exp(leaves64[3]),
                                *leaves64[4:])
    want = torch.autograd.grad((y, sT), leaves64[3],
                               [t.double() for t in _t(dy, dsT)])[0]
    assert float(want.abs().max()) < 1e-6      # w itself is below 3e-9
    np.testing.assert_allclose(_np(dlogw), _np(want), rtol=BWD_RTOL,
                               atol=BWD_TOL * float(want.abs().max()))


def test_backward_kernels_plain_parts_compose():
    """The three backward kernels' plain versions, chained as the CUDA
    backward chains the kernels, give the gradient that autograd takes of
    the plain serial scan (float64, where both are exact to rounding)."""
    arrays = [a.astype(np.float64) for a in _inputs(2, 13, 3, 16, seed=2)]
    r, k, v, logw, u, s0, dy, dsT = _t(*arrays)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u, s0)]
    y, sT = ops.wkv6_scan_plain(*leaves[:3], torch.exp(leaves[3]),
                                *leaves[4:])
    want = torch.autograd.grad((y, sT), leaves, (dy, dsT))
    dr, a, du_part = ops.wkv6_bwd_dr_plain(r, k, v, logw, u, s0, dy, dsT)
    dk, dlogw, ds0, du = ops.wkv6_bwd_dk_plain(r, k, v, logw, u, dy, dsT, a,
                                               du_part)
    dv = ops.wkv6_bwd_dv_plain(r, k, logw, u, dy, dsT)
    assert du_part.shape == (2, 3, 16) and du.shape == (3, 16)
    for name, g, w in zip(NAMES, (dr, dk, dv, dlogw, du, ds0), want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


@pytest.mark.parametrize("B,L,H,hd,chunk", WKV_SWEEP)
def test_chunked_form_equals_serial_form(B, L, H, hd, chunk):
    """The plain chunked parallel form (chunk fitted to L, as the reference
    fits it) against the plain serial scan, fp32."""
    r, k, v, logw, u, s0, _, _ = _t(*_inputs(B, L, H, hd, seed=3))
    y_c, s_c = ssm.wkv6_chunked(r, k, v, logw, u, s0, chunk=chunk)
    y_s, s_s = ssm.wkv6_scan(r, k, v, torch.exp(logw), u, s0)
    torch.testing.assert_close(y_c, y_s, rtol=FWD_TOL, atol=FWD_TOL)
    torch.testing.assert_close(s_c, s_s, rtol=FWD_TOL, atol=FWD_TOL)


def test_gradcheck_float64():
    """torch.autograd.gradcheck of the plain route at a tiny size."""
    arrays = [a.astype(np.float64) for a in _inputs(2, 5, 2, 4, seed=5)]
    leaves = [t.requires_grad_(True) for t in _t(*arrays[:6])]
    assert torch.autograd.gradcheck(ops.wkv6, leaves, eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_cpu_path_launches_no_kernel():
    before = LAUNCHES.snapshot()
    r, k, v, logw, u, s0, dy, dsT = _t(*_inputs(1, 16, 1, 16))
    r.requires_grad_(True)
    y, sT = ops.wkv6(r, k, v, logw, u, s0)
    torch.autograd.backward((y, sT), (dy, dsT))
    assert LAUNCHES.snapshot() == before
    assert r.grad is not None and torch.isfinite(r.grad).all()


def test_launch_counter_names_every_kernel():
    """One counter holds every kernel of the port: the attention kernels'
    and the WKV6 kernels'."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels import build, launches
    assert launches.KERNELS == attn_ops.KERNELS + ops.KERNELS
    assert set(LAUNCHES.snapshot()) == set(launches.KERNELS)
    assert build.SOURCES["wkv6"] == "wkv6.cu"
    assert (build.CSRC / "wkv6.cu").is_file()


@pytest.mark.parametrize("bad", [
    dict(k=(1, 8, 2, 16)),                              # k's L differs
    dict(u=(2, 8)),                                     # u's hd differs
    dict(s0=(1, 2, 16, 8)),                             # s0 not hd x hd
    dict(r=(1, 0, 2, 16)),                              # no steps
    dict(dtype=torch.bfloat16),
    dict(device="meta", dtype=torch.float64),    # meta: the CUDA path's
])
def test_wrapper_refuses_what_it_does_not_take(bad):
    dtype = bad.get("dtype", torch.float32)
    dev = bad.get("device", "cpu")
    rs = bad.get("r", (1, 4, 2, 16))
    B, L, H, hd = rs
    shapes = dict(r=rs, k=rs, v=rs, logw=rs, u=(H, hd), s0=(B, H, hd, hd))
    shapes.update({n: s for n, s in bad.items() if n in shapes})
    ts = {n: torch.zeros(s, dtype=dtype, device=dev)
          for n, s in shapes.items()}
    with pytest.raises((ValueError, TypeError)):
        ops.wkv6(ts["r"], ts["k"], ts["v"], ts["logw"], ts["u"], ts["s0"])
