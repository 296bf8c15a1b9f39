"""RWKV6 time-mix and channel-mix: the train branch of the reference's
``models/ssm.py``.

Same parameter paths and ``[d_in, d_out]`` layout as the reference. The
time-mix's WKV recurrence always goes through the port's WKV6 op
(``kernels/rwkv/ops.wkv6``): on the card its CUDA kernels and their
backward, on the CPU their plain versions. ``wkv6_scan`` and
``wkv6_chunked`` are the reference's plain forms, kept as the semantics the
op is held to. The decode caches and Mamba are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv import ops as rwkv_ops
from repro_torch.models.layers import apply_linear, dt, linear_specs, \
    rmsnorm_specs
from repro_torch.models.params import ShardedInit, fit_chunk


def rwkv_tm_specs(cfg) -> dict:
    D = cfg.d_model
    lora = 64
    return {
        "mix": {"w": ShardedInit((5, D), (None, "embed"), "normal", 0.1)},
        "wr": linear_specs(D, D, "embed", "ssm_inner"),
        "wk": linear_specs(D, D, "embed", "ssm_inner"),
        "wv": linear_specs(D, D, "embed", "ssm_inner"),
        "wg": linear_specs(D, D, "embed", "ssm_inner"),
        "w0": {"w": ShardedInit((D,), ("ssm_inner",), "zeros")},
        "w_lora_a": {"w": ShardedInit((D, lora), ("embed", "lora"))},
        "w_lora_b": {"w": ShardedInit((lora, D), ("lora", "ssm_inner"),
                                      "normal", 0.1)},
        "u": {"w": ShardedInit((D,), ("ssm_inner",), "normal", 0.5)},
        "ln_x": rmsnorm_specs(D),
        "wo": linear_specs(D, D, "ssm_inner", "embed"),
    }


def rwkv_cm_specs(cfg) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mix": {"w": ShardedInit((2, D), (None, "embed"), "normal", 0.1)},
        "wk": linear_specs(D, F_, "embed", "mlp"),
        "wv": linear_specs(F_, D, "mlp", "embed"),
        "wr": linear_specs(D, D, "embed", None),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """prev: [B, D] last token of the previous step (zeros at sequence
    start)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def wkv6_scan(r, k, v, w, u, state):
    """Serial WKV6 recurrence (the semantic reference). r/k/v/w: [B,L,H,hd]
    fp32; u: [H,hd]; state [B,H,hd,hd].

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ);  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    """
    return rwkv_ops.wkv6_scan_plain(r, k, v, w, u, state)


def wkv6_chunked(r, k, v, logw, u, state, *, chunk: int = 32):
    """Chunked parallel WKV6, the form of the TPU kernel. Every decay factor
    is exp of a difference of cumulative log-decays, <= 0, so nothing
    overflows at any chunk size.

    r/k/v: [B,L,H,hd] fp32; logw: [B,L,H,hd] (log of the per-step decay,
    <= 0); u: [H,hd]; state: [B,H,hd,hd]. Returns (y [B,L,H,hd], final
    state)."""
    L = r.shape[1]
    chunk = fit_chunk(L, chunk)
    t_idx = torch.arange(chunk, device=r.device)
    strict = (t_idx[:, None] > t_idx[None, :])[None, :, :, None, None]
    eye = torch.eye(chunk, dtype=r.dtype, device=r.device)
    S, ys = state, []
    for c0 in range(0, L, chunk):
        r_c, k_c, v_c, lw = (a[:, c0:c0 + chunk] for a in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=1)                      # logP_t
        cum_shift = cum - lw                               # logP_{t-1}
        # intra-chunk attention-like matrix (strictly causal) + u-bonus diag:
        # A[t,s] = sum_d r_t k_s exp(logP_{t-1} - logP_s)   (t > s)
        decay_diff = cum_shift[:, :, None] - cum[:, None]  # [B,t,s,H,hd]
        factor = torch.exp(torch.where(strict, decay_diff, 0.0)) * strict
        A = torch.einsum("bthd,bshd,btshd->btsh", r_c, k_c, factor)
        diag = torch.einsum("bthd,bthd,hd->bth", r_c, k_c, u.to(r.dtype))
        A = A + diag[:, :, None] * eye[None, :, :, None]
        y = torch.einsum("btsh,bshd->bthd", A, v_c)
        # cross-chunk: y += (r_t * P_{t-1}) . S
        y = y + torch.einsum("bthi,bhij->bthj", r_c * torch.exp(cum_shift), S)
        # state update: S' = P_last * S + sum_s (P_last / P_s) k_s v_s^T
        last = cum[:, -1:]
        k_dec = k_c * torch.exp(last - cum)
        S = torch.exp(last[:, 0])[..., None] * S + \
            torch.einsum("bshi,bshj->bhij", k_dec, v_c)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def rwkv_tm_forward(cfg, p, x: torch.Tensor, *, cache=None, **_):
    """Time-mix, train mode. x: [B,L,D]. Returns (out, None)."""
    if cache is not None:
        raise NotImplementedError("the RWKV6 decode cache is not yet ported")
    B, L, D = x.shape
    hd = cfg.ssm.rwkv_head_dim
    H = D // hd
    cd = dt(cfg, "compute")
    xs = _token_shift(x, torch.zeros((B, D), dtype=x.dtype, device=x.device))
    mix = p["mix"]["w"].to(x.dtype)                         # [5, D]
    xr, xk, xv, xw, xg = (x + (xs - x) * mix[i] for i in range(5))
    r = apply_linear(p["wr"], xr, cd).reshape(B, L, H, hd)
    k = apply_linear(p["wk"], xk, cd).reshape(B, L, H, hd)
    v = apply_linear(p["wv"], xv, cd).reshape(B, L, H, hd)
    g = apply_linear(p["wg"], xg, cd)
    # data-dependent decay (the RWKV6 signature): w = exp(-exp(w0 + lora(xw)))
    lora = xw.to(cd) @ p["w_lora_a"]["w"].to(cd)
    lora = torch.tanh(lora) @ p["w_lora_b"]["w"].to(cd)
    raw = p["w0"]["w"].float() + lora.float()
    decay_log = -torch.exp(torch.clamp(raw, -8.0, 4.0)).reshape(B, L, H, hd)
    u = p["u"]["w"].float().reshape(H, hd)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    y, _ = rwkv_ops.wkv6(r.float(), k.float(), v.float(), decay_log, u,
                         state)
    # per-head group norm; jnp.var is the population variance
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y_n = y.reshape(B, L, D) * p["ln_x"]["scale"].float()
    return apply_linear(p["wo"], y_n.to(cd) * F.silu(g), cd), None


def rwkv_cm_forward(cfg, p, x: torch.Tensor, *, cache=None, **_):
    """Channel-mix, train mode. x: [B,L,D]. Returns (out, None)."""
    if cache is not None:
        raise NotImplementedError("the RWKV6 decode cache is not yet ported")
    B, _, D = x.shape
    cd = dt(cfg, "compute")
    xs = _token_shift(x, torch.zeros((B, D), dtype=x.dtype, device=x.device))
    mix = p["mix"]["w"].to(x.dtype)
    xk, xr = x + (xs - x) * mix[0], x + (xs - x) * mix[1]
    k = torch.square(F.relu(apply_linear(p["wk"], xk, cd)))
    vv = apply_linear(p["wv"], k, cd)
    return torch.sigmoid(apply_linear(p["wr"], xr, cd)) * vv, None
