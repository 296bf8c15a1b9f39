"""RWKV6 WKV: the hand-written CUDA kernels, their plain PyTorch versions,
and the differentiable wrapper the model calls.

Counterpart of ``repro/kernels/rwkv/{kernel,ops,ref}.py``. The kernels
(``kernels/csrc/wkv6.cu``) take CUDA tensors; a tensor on the CPU goes to
the plain versions in this module: the serial scan of the reference's
``wkv6_ref``, and the backward's formulas written out step by step. A CUDA
tensor never reaches a plain version: it launches the kernels, or the call
raises.

Every function takes the model's layout: r, k, v, logw and y
``[B, L, H, hd]``, u ``[H, hd]``, states ``[B, H, hd, hd]``. With
``w = exp(logw)`` and G_t the gradient with respect to the state after
step t (G_L = dsT, G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ), the backward is

    dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t·dy_t)        (wkv6_bwd_dr)
    dk_t = G_t v_t + u ⊙ r_t (v_t·dy_t)             (wkv6_bwd_dk)
    dlogw_t = Σ_{m≥t} a_m − Σ_{t≤m<L} b_m
    ds0 = G_0
    dv_t = G_tᵀ k_t + (Σ_i r_ti u_i k_ti) dy_t      (wkv6_bwd_dv)
    du = Σ_{b,t} r_t ⊙ k_t (v_t·dy_t)               (wkv6_bwd_du)

with a_m = r_{m+1} ⊙ w_m ⊙ (S_{m-1} dy_{m+1}) for m < L and
a_L = w_L ⊙ rowsum(dsT ⊙ S_{L-1}), which ``wkv6_bwd_dr`` writes, and
b_m = k_m ⊙ w_{m+1} ⊙ (G_{m+1} v_m); ``wkv6.cu`` derives the dlogw
identity, which equals w_t ⊙ rowsum(G_t ⊙ S_{t-1}).

Each kernel wrapper adds one to the port's launch count
(``kernels/launches.py``) where it launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launches import FAMILIES, LAUNCHES

KERNELS = FAMILIES["rwkv"]
CUDA_HEAD_DIMS = (16, 32, 64)
_CPU_DTYPES = (torch.float32, torch.float64)


# ------------------------------------------------------------ plain versions
def _prep(dtype, *ts):
    ct = torch.float64 if dtype == torch.float64 else torch.float32
    return [t.to(ct) for t in ts]


def _outer(a, b):
    """[B,H,hd] x [B,H,hd] -> [B,H,hd,hd], a_i b_j."""
    return a[..., :, None] * b[..., None, :]


def wkv6_scan_plain(r, k, v, w, u, s0):
    """The serial recurrence with the decay ``w`` itself, as the reference's
    ``ssm.wkv6_scan``: y_t = r_tᵀ(S_{t-1} + diag(u) k_t v_tᵀ),
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ. Returns (y, S_L)."""
    S, ys = s0, []
    for t in range(r.shape[1]):
        kv = _outer(k[:, t], v[:, t])
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               S + u[..., None] * kv))
        S = w[:, t, ..., None] * S + kv
    return torch.stack(ys, 1), S


def wkv6_fwd_plain(r, k, v, logw, u, s0):
    """What ``wkv6_fwd`` computes: the serial scan with w = exp(logw).
    Returns (y, sT) in fp32 (fp64 for fp64 inputs)."""
    r, k, v, logw, u, s0 = _prep(r.dtype, r, k, v, logw, u, s0)
    return wkv6_scan_plain(r, k, v, torch.exp(logw), u, s0)


def wkv6_bwd_dr_plain(r, k, v, logw, u, s0, dy, dsT):
    """What ``wkv6_bwd_dr`` computes, scanning forward: dr, the a terms of
    dlogw and the per-(b, h) partial of du [B,H,hd]. Returns (dr, a,
    du_part)."""
    r, k, v, logw, u, s0, dy, dsT = _prep(r.dtype, r, k, v, logw, u, s0, dy,
                                          dsT)
    w = torch.exp(logw)
    L = r.shape[1]
    S, drs, as_ = s0, [], []
    du_part = torch.zeros_like(r[:, 0])
    for t in range(L):
        if t + 1 < L:
            a_t = r[:, t + 1] * w[:, t] * torch.einsum("bhij,bhj->bhi", S,
                                                       dy[:, t + 1])
        else:
            a_t = w[:, t] * (dsT * S).sum(-1)
        sdy = torch.einsum("bhij,bhj->bhi", S, dy[:, t])
        vdy = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)
        drs.append(sdy + u * k[:, t] * vdy)
        as_.append(a_t)
        du_part = du_part + r[:, t] * k[:, t] * vdy
        S = w[:, t, ..., None] * S + _outer(k[:, t], v[:, t])
    return torch.stack(drs, 1), torch.stack(as_, 1), du_part


def wkv6_bwd_dk_plain(r, k, v, logw, u, dy, dsT, a):
    """What ``wkv6_bwd_dk`` computes, scanning G backward from dsT: dk, dlogw
    (the a terms less the b terms, summed from the end) and ds0 = G_0.
    Returns (dk, dlogw, ds0)."""
    r, k, v, logw, u, dy, dsT, a = _prep(r.dtype, r, k, v, logw, u, dy, dsT,
                                         a)
    w = torch.exp(logw)
    L = r.shape[1]
    G, dks, dlogws = dsT, [], []
    for t in reversed(range(L)):
        gv = torch.einsum("bhij,bhj->bhi", G, v[:, t])
        vdy = (v[:, t] * dy[:, t]).sum(-1, keepdim=True)
        dks.append(gv + u * r[:, t] * vdy)
        # b_t = k_t w_{t+1} (G_{t+1} v_t), with G_{t+1} v_t from step t + 1
        acc = a[:, t] if t == L - 1 else \
            acc + (a[:, t] - k[:, t] * w[:, t + 1] * gv_next)
        dlogws.append(acc)
        if t > 0:
            gv_next = torch.einsum("bhij,bhj->bhi", G, v[:, t - 1])
        G = w[:, t, ..., None] * G + _outer(r[:, t], dy[:, t])
    return torch.stack(dks[::-1], 1), torch.stack(dlogws[::-1], 1), G


def wkv6_bwd_dv_plain(r, k, logw, u, dy, dsT):
    """What ``wkv6_bwd_dv`` computes, scanning G backward from dsT."""
    r, k, logw, u, dy, dsT = _prep(r.dtype, r, k, logw, u, dy, dsT)
    w = torch.exp(logw)
    G, dvs = dsT, []
    for t in reversed(range(r.shape[1])):
        gk = torch.einsum("bhij,bhi->bhj", G, k[:, t])
        ruk = (r[:, t] * u * k[:, t]).sum(-1, keepdim=True)
        dvs.append(gk + ruk * dy[:, t])
        G = w[:, t, ..., None] * G + _outer(r[:, t], dy[:, t])
    return torch.stack(dvs[::-1], 1)


def wkv6_bwd_du_plain(du_part):
    """What ``wkv6_bwd_du`` computes: du [H,hd], the partials summed over b."""
    return du_part.sum(0)


def wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT):
    """The whole backward from its plain parts. Returns (dr, dk, dv, dlogw,
    du, ds0)."""
    dr, a, du_part = wkv6_bwd_dr_plain(r, k, v, logw, u, s0, dy, dsT)
    dk, dlogw, ds0 = wkv6_bwd_dk_plain(r, k, v, logw, u, dy, dsT, a)
    dv = wkv6_bwd_dv_plain(r, k, logw, u, dy, dsT)
    return dr, dk, dv, dlogw, wkv6_bwd_du_plain(du_part), ds0


# ------------------------------------------------------------ CUDA kernels
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # pointers..., B, L, H, head_dim, stream
    "wkv6_fwd": [_P] * 8 + [_I] * 4 + [_P],
    "wkv6_bwd_dr": [_P] * 11 + [_I] * 4 + [_P],
    "wkv6_bwd_dk": [_P] * 11 + [_I] * 4 + [_P],
    "wkv6_bwd_dv": [_P] * 7 + [_I] * 4 + [_P],
    # du_part, du; B, H, head_dim; stream
    "wkv6_bwd_du": [_P] * 2 + [_I] * 3 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    if not getattr(lib, "_typed", False):
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wkv6_error_string.argtypes = [ctypes.c_int]
        lib.wkv6_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _launch(name: str, device: torch.device, tensors, ints):
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in tensors), *ints,
                                 stream)
    if err != 0:
        msg = lib.wkv6_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} (cudaError {err})")
    LAUNCHES.add(name)


def wkv6_fwd_cuda(r, k, v, logw, u, s0):
    """Launch ``wkv6_fwd``. Returns (y, sT)."""
    y, sT = torch.empty_like(r), torch.empty_like(s0)
    _launch("wkv6_fwd", r.device, (r, k, v, logw, u, s0, y, sT),
            list(r.shape))
    return y, sT


def wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy, dsT):
    """Launch ``wkv6_bwd_dr``. Returns (dr, a, du_part)."""
    B, _, H, hd = r.shape
    dr, a = torch.empty_like(r), torch.empty_like(r)
    du_part = torch.empty((B, H, hd), dtype=r.dtype, device=r.device)
    _launch("wkv6_bwd_dr", r.device,
            (r, k, v, logw, u, s0, dy, dsT, dr, a, du_part), list(r.shape))
    return dr, a, du_part


def wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT, a):
    """Launch ``wkv6_bwd_dk``. Returns (dk, dlogw, ds0)."""
    dk, dlogw, ds0 = (torch.empty_like(r), torch.empty_like(r),
                      torch.empty_like(dsT))
    _launch("wkv6_bwd_dk", r.device,
            (r, k, v, logw, u, dy, dsT, a, dk, dlogw, ds0), list(r.shape))
    return dk, dlogw, ds0


def wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT):
    """Launch ``wkv6_bwd_dv``. Returns dv."""
    dv = torch.empty_like(r)
    _launch("wkv6_bwd_dv", r.device, (r, k, logw, u, dy, dsT, dv),
            list(r.shape))
    return dv


def wkv6_bwd_du_cuda(du_part):
    """Launch ``wkv6_bwd_du``. Returns du [H, hd]."""
    B, H, hd = du_part.shape
    du = torch.empty((H, hd), dtype=du_part.dtype, device=du_part.device)
    _launch("wkv6_bwd_du", du_part.device, (du_part, du), [B, H, hd])
    return du


def wkv6_bwd_cuda(r, k, v, logw, u, s0, dy, dsT):
    """The four backward kernels on one stream: dr (which also writes the
    a terms of dlogw and the du partials), then dk with dlogw and ds0, dv
    and du. Returns (dr, dk, dv, dlogw, du, ds0)."""
    dr, a, du_part = wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy, dsT)
    dk, dlogw, ds0 = wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT, a)
    dv = wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT)
    return dr, dk, dv, dlogw, wkv6_bwd_du_cuda(du_part), ds0


# ---------------------------------------------------------------- wrapper
def _check(r, k, v, logw, u, s0):
    if r.dim() != 4:
        raise ValueError(f"r must be [B,L,H,hd], got {tuple(r.shape)}")
    B, L, H, hd = r.shape
    for name, t, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("logw", logw, r.shape), ("u", u, (H, hd)),
                           ("s0", s0, (B, H, hd, hd))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}: expected {tuple(shape)}")
    if L < 1:
        raise ValueError("wkv6 needs at least one step")
    ts = (r, k, v, logw, u, s0)
    if len({t.device for t in ts}) != 1:
        raise ValueError("wkv6's inputs must be on one device")
    if len({t.dtype for t in ts}) != 1:
        raise ValueError("wkv6's inputs must have one dtype")
    if r.is_cuda:
        if r.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, not {r.dtype}")
        if hd not in CUDA_HEAD_DIMS:
            raise ValueError(f"the CUDA kernels take head_dim in "
                             f"{CUDA_HEAD_DIMS}, not {hd}")
    elif r.device.type == "cpu":
        if r.dtype not in _CPU_DTYPES:
            raise TypeError(f"unsupported dtype {r.dtype}")
    else:
        raise ValueError(f"unsupported device {r.device}")


class WKV6Fn(torch.autograd.Function):
    """WKV6 with its own backward. Saves the inputs: the backward rescans
    the state from s0 instead of storing it per step."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        if r.is_cuda:
            y, sT = wkv6_fwd_cuda(r, k, v, logw, u, s0)
        else:
            y, sT = wkv6_fwd_plain(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.warming = LAUNCHES.is_warming()
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        dy, dsT = dy.contiguous(), dsT.contiguous()
        if r.is_cuda:
            with LAUNCHES.warming(ctx.warming):
                return wkv6_bwd_cuda(r, k, v, logw, u, s0, dy, dsT)
        return wkv6_bwd_plain(r, k, v, logw, u, s0, dy, dsT)


def wkv6(r, k, v, logw, u, s0):
    """Differentiable WKV6 in the model's layout: r/k/v/logw [B,L,H,hd]
    (logw the log of the per-step decay, <= 0), u [H,hd], s0 [B,H,hd,hd].
    Returns (y [B,L,H,hd], sT [B,H,hd,hd]). Any L >= 1: nothing is padded.
    Gradients reach all six inputs."""
    _check(r, k, v, logw, u, s0)
    return WKV6Fn.apply(*(t.contiguous() for t in (r, k, v, logw, u, s0)))
