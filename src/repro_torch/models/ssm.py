"""State-space mixers: Mamba (S6, for Jamba) and the RWKV6 time-mix and
channel-mix, the reference's ``models/ssm.py``, each with its
train/prefill branch and its decode branch against the cache.

Same parameter paths and ``[d_in, d_out]`` layout as the reference. Mamba's
selective scan has no kernel in the reference (a chunked ``jnp``
associative scan) and none here: it is plain PyTorch, scanning time in
chunks of ``cfg.mamba_chunk`` with a doubling scan inside each chunk
(``_assoc_scan``). The time-mix's WKV recurrence always goes through the
port's WKV6 op (``kernels/rwkv/ops.wkv6``): on the card its CUDA kernels
and their backward, on the CPU their plain versions. In decode each mixer
carries its state from the cache (Mamba's ``conv`` and ``ssm``, RWKV6's
``wkv``, each cast to fp32 for the recurrence and back to the cache's dtype
after) and writes it back in place, as it does RWKV6's token shifts
``shift_tm`` and ``shift_cm``. ``wkv6_scan`` and ``wkv6_chunked`` are the
reference's plain forms, kept as the semantics the op is held to. Each
mixer and the channel-mix has a train-mode form over the model axis
(``mamba_forward_tp``, ``rwkv_tm_forward_tp``, ``rwkv_cm_forward_tp``),
built from the same helpers as the plain form.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.launches import remat
from repro_torch.kernels.rwkv import ops as rwkv_ops
from repro_torch.models.layers import apply_linear, dt, linear_specs, \
    rmsnorm_specs
from repro_torch.models.params import ShardedInit, fit_chunk
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model, regroup_columns


# ===================================================================== Mamba
def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def mamba_specs(cfg) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    di = s.expand * D
    dtr = _dt_rank(cfg)
    return {
        "in_proj": linear_specs(D, 2 * di, "embed", "ssm_inner"),
        "conv_w": {"w": ShardedInit((s.d_conv, di), ("conv", "ssm_inner"),
                                    "normal", 0.5)},
        "conv_b": {"b": ShardedInit((di,), ("ssm_inner",), "zeros")},
        "x_proj": linear_specs(di, dtr + 2 * s.d_state, "ssm_inner", None),
        "dt_proj": linear_specs(dtr, di, None, "ssm_inner", bias=True),
        "A_log": {"w": ShardedInit((di, s.d_state), ("ssm_inner", "ssm_state"),
                                   "alog")},
        "D_skip": {"w": ShardedInit((di,), ("ssm_inner",), "ones")},
        "out_proj": linear_specs(di, D, "ssm_inner", "embed"),
    }


def mamba_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    """``conv``: the last ``d_conv - 1`` inputs of the conv [B, K-1, di];
    ``ssm``: the scan's state [B, di, N]."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {"conv": ShardedInit((batch, s.d_conv - 1, di),
                                ("batch", "conv", "ssm_inner"), "zeros"),
            "ssm": ShardedInit((batch, di, s.d_state),
                               ("batch", "ssm_inner", "ssm_state"), "zeros")}


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """The linear recurrence h_t = a_t h_{t-1} + b_t over dim 1 (time) as
    a doubling (Hillis-Steele) scan of the reference's combine, (a1, b1) o
    (a2, b2) = (a1 a2, a2 b1 + b2): log2(T) steps of whole-tensor products.
    Returns (P_t, Q_t) with h_t = P_t h_0 + Q_t."""
    T, d = a.shape[1], 1
    while d < T:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return a, b


def _mamba_chunk(h, A, d_c, b_c, c_c, x_c):
    """One time chunk of the selective scan from state ``h`` [B,di,N]:
    (the state after it, y [B,c,di]). All fp32."""
    dA = torch.exp(d_c[..., None] * A)                     # [B,c,di,N]
    dBx = d_c[..., None] * b_c[:, :, None, :] * x_c[..., None]
    P, Q = _assoc_scan(dA, dBx)
    h_t = P * h[:, None] + Q
    return h_t[:, -1], torch.einsum("bcdn,bcn->bcd", h_t, c_c)


def _mamba_conv(p, x_in: torch.Tensor, pad: torch.Tensor, cd):
    """The causal depthwise conv of ``x_in`` [B,L,c] after ``pad`` (the
    last K - 1 inputs, or zeros), in fp32, then ``conv_b`` and silu, in
    ``cd``: (x_c, the conv's new state)."""
    L = x_in.shape[1]
    conv_w = p["conv_w"]["w"].float()                      # [K, c]
    K = conv_w.shape[0]
    x_pad = torch.cat([pad, x_in], dim=1)
    new_conv_state = x_pad[:, -(K - 1):]
    x_pad = x_pad.float()
    # causal depthwise conv: sum_k w[k] * x[t - (K-1) + k]
    conv = sum(conv_w[k] * x_pad[:, k:k + L] for k in range(K))
    return F.silu(conv + p["conv_b"]["b"].float()).to(cd), new_conv_state


def _mamba_scan(cfg, p, x_c, z, x_db, h, cd):
    """From the conv's output ``x_c`` and the gate ``z`` [B,L,c] on c
    channels, ``x_proj``'s output ``x_db`` and the scan's state ``h``
    [B,c,N]: (y [B,L,c], the state after). ``delta``, A, the chunked scan
    and the ``D_skip`` term in fp32."""
    s = cfg.ssm
    L = x_c.shape[1]
    dt_r, B_, C_ = x_db.split([_dt_rank(cfg), s.d_state, s.d_state], dim=-1)
    delta = F.softplus(apply_linear(p["dt_proj"], dt_r, torch.float32))
    A = -torch.exp(p["A_log"]["w"].float())                # [c, N]
    B32, C32, x32 = B_.float(), C_.float(), x_c.float()
    chunk = fit_chunk(L, cfg.mamba_chunk)
    ys = []
    for c0 in range(0, L, chunk):
        h, y = remat(_mamba_chunk, h, A, *(a[:, c0:c0 + chunk]
                                           for a in (delta, B32, C32, x32)))
        ys.append(y)
    y = torch.cat(ys, dim=1) + p["D_skip"]["w"].float() * x32
    return y.to(cd) * F.silu(z), h


def mamba_forward(cfg, p, x: torch.Tensor, *, cache=None, **_):
    """Mamba. x: [B,L,D]; ``cache`` ({"conv", "ssm"}) in decode, both
    written in place. ``in_proj``, ``x_proj``, ``out_proj`` and the gate
    run in the compute dtype; the conv, ``delta`` (``dt_proj`` in fp32,
    then softplus), A = -exp(A_log), the scan and the ``D_skip`` term in
    fp32, as in the reference. The scan runs in chunks of
    ``fit_chunk(L, cfg.mamba_chunk)``, each checkpointed under autograd
    (the reference's ``nothing_saveable`` chunk body): a backward keeps
    one chunk's [B, c, di, N] state at a time. Returns (out, cache or
    None)."""
    s = cfg.ssm
    B, L, D = x.shape
    di = s.expand * D
    cd = dt(cfg, "compute")
    x_in, z = apply_linear(p["in_proj"], x, cd).chunk(2, dim=-1)
    K = p["conv_w"]["w"].shape[0]
    pad = (cache["conv"].to(x_in.dtype) if cache is not None else
           torch.zeros((B, K - 1, di), dtype=x_in.dtype, device=x.device))
    x_c, new_conv_state = _mamba_conv(p, x_in, pad, cd)
    x_db = apply_linear(p["x_proj"], x_c, cd)
    h = (cache["ssm"].float() if cache is not None else
         torch.zeros((B, di, s.d_state), dtype=torch.float32,
                     device=x.device))
    y, h = _mamba_scan(cfg, p, x_c, z, x_db, h, cd)
    out = apply_linear(p["out_proj"], y, cd)
    if cache is not None:
        cache["conv"].copy_(new_conv_state)
        cache["ssm"].copy_(h)
    return out, cache


def mamba_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor, **_
                     ) -> torch.Tensor:
    """Mamba over the model axis, train mode, di/mp channels a shard.
    Shard m's ``in_proj`` columns are the contiguous ``[m 2di/mp, (m + 1)
    2di/mp)`` of the stored ``[D, 2 di]`` leaf (at mp = 2 all of x's half
    on shard 0 and all of z's on shard 1), so each shard forms its columns
    of ``x @ in_proj`` and ``regroup_columns`` hands shard m channels
    ``[m di/mp, (m + 1) di/mp)`` of both x and z. The conv, ``dt_proj``,
    A, the scan and ``D_skip`` run on them; ``x_proj`` is a row split whose
    partial dt_r, B and C are summed in shard order on the first slot and
    copied back out; ``out_proj`` row shards are summed there. Run whole
    when the rules left a leaf replicated (an mp that does not divide
    di)."""
    if not sp.split():
        return mamba_forward(cfg, sp.whole(), x)[0]
    s = cfg.ssm
    B = x.shape[0]
    c = s.expand * cfg.d_model // sp.mp
    cd = dt(cfg, "compute")
    xz = regroup_columns([apply_linear(t["in_proj"], xm, cd) for t, xm in
                          zip(sp.trees, copy_to_model(x, sp.devices))], 2,
                         sp.devices)
    x_ins, zs = zip(*(part.chunk(2, dim=-1) for part in xz))
    convs = [_mamba_conv(t, x_in, x_in.new_zeros((B, s.d_conv - 1, c)),
                         cd)[0] for t, x_in in zip(sp.trees, x_ins)]
    x_db = copy_to_model(reduce_from_model(
        [apply_linear(t["x_proj"], x_c, cd)
         for t, x_c in zip(sp.trees, convs)], x.device), sp.devices)
    outs = []
    for t, x_c, z, x_db_m in zip(sp.trees, convs, zs, x_db):
        h = torch.zeros((B, c, s.d_state), dtype=torch.float32,
                        device=x_c.device)
        outs.append(apply_linear(t["out_proj"], _mamba_scan(
            cfg, t, x_c, z, x_db_m, h, cd)[0], cd))
    return reduce_from_model(outs, x.device)


# ===================================================================== RWKV6
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


def rwkv_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    D = cfg.d_model
    hd = cfg.ssm.rwkv_head_dim
    H = D // hd
    return {
        "shift_tm": ShardedInit((batch, D), ("batch", "embed"), "zeros"),
        "shift_cm": ShardedInit((batch, D), ("batch", "embed"), "zeros"),
        "wkv": ShardedInit((batch, H, hd, hd),
                           ("batch", "heads", None, None), "zeros"),
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


def _prev_token(x: torch.Tensor, cache, key: str) -> torch.Tensor:
    """The token before x's first: the cache's shift state, or zeros at a
    sequence's start."""
    if cache is not None:
        return cache[key].to(x.dtype)
    return torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                       device=x.device)


def _rwkv_tm_inputs(cfg, p, x: torch.Tensor, cache):
    """The time-mix's token shift and its five mixes of x [B,L,D], and the
    decay LoRA's first half, ``tanh(xw @ w_lora_a)``: (xr, xk, xv, xg,
    lora_h), the leaves the rules replicate."""
    cd = dt(cfg, "compute")
    xs = _token_shift(x, _prev_token(x, cache, "shift_tm"))
    mix = p["mix"]["w"].to(x.dtype)                         # [5, D]
    xr, xk, xv, xw, xg = (x + (xs - x) * mix[i] for i in range(5))
    lora_h = torch.tanh(xw.to(cd) @ p["w_lora_a"]["w"].to(cd))
    return xr, xk, xv, xg, lora_h


def _rwkv_tm_heads(cfg, p, ln_scale, xr, xk, xv, xg, lora_h, state):
    """The time-mix from its mixes on the heads whose columns ``p``'s
    ``wr``, ``wk``, ``wv``, ``wg``, ``w_lora_b``, ``w0``, ``u`` and ``wo``
    rows hold (all of them, or one model shard's), ``ln_scale`` the group
    norm's scale on those channels: (the output or its partial sum, the
    WKV state after)."""
    B, L, _ = xr.shape
    hd = cfg.ssm.rwkv_head_dim
    width = p["wr"]["w"].shape[1]
    H = width // hd
    cd = dt(cfg, "compute")
    r = apply_linear(p["wr"], xr, cd).reshape(B, L, H, hd)
    k = apply_linear(p["wk"], xk, cd).reshape(B, L, H, hd)
    v = apply_linear(p["wv"], xv, cd).reshape(B, L, H, hd)
    g = apply_linear(p["wg"], xg, cd)
    # data-dependent decay (the RWKV6 signature): w = exp(-exp(w0 + lora(xw)))
    lora = lora_h @ p["w_lora_b"]["w"].to(cd)
    raw = p["w0"]["w"].float() + lora.float()
    decay_log = -torch.exp(torch.clamp(raw, -8.0, 4.0)).reshape(B, L, H, hd)
    u = p["u"]["w"].float().reshape(H, hd)
    y, S = rwkv_ops.wkv6(r.float(), k.float(), v.float(), decay_log, u,
                         state)
    # per-head group norm; jnp.var is the population variance
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y_n = y.reshape(B, L, width) * ln_scale.float()
    return apply_linear(p["wo"], y_n.to(cd) * F.silu(g), cd), S


def rwkv_tm_forward(cfg, p, x: torch.Tensor, *, cache=None, **_):
    """Time-mix. x: [B,L,D]; ``cache`` ({"shift_tm", "wkv", ...}) in
    decode, None in train/prefill, its ``shift_tm`` and ``wkv`` written in
    place. Returns (out, cache or None)."""
    B, _, D = x.shape
    hd = cfg.ssm.rwkv_head_dim
    H = D // hd
    state = (cache["wkv"].float() if cache is not None else
             torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device))
    out, S = _rwkv_tm_heads(cfg, p, p["ln_x"]["scale"], *_rwkv_tm_inputs(
        cfg, p, x, cache), state)
    if cache is not None:
        cache["shift_tm"].copy_(x[:, -1])
        cache["wkv"].copy_(S)
    return out, cache


# the time-mix's leaves the rules leave whole: the mixes, the decay LoRA's
# first half and the group norm's scale
RWKV_TM_REPLICATED = ("mix", "w_lora_a", "ln_x")


def rwkv_tm_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor, **_
                       ) -> torch.Tensor:
    """The time-mix over the model axis, train mode: the token shift, the
    five mixes and ``tanh(xw @ w_lora_a)`` once on the first slot, copied
    out; shard m runs its H/mp heads (column shards of ``wr``, ``wk``,
    ``wv``, ``wg`` and ``w_lora_b``, its parts of ``w0`` and ``u``) through
    the WKV6 op, the group norm on them with its D/mp slice of ``ln_x``,
    and its ``wo`` row shard; the partial outputs are summed in shard
    order on the first slot. Run whole when the rules left a leaf
    replicated or a shard would split a head."""
    mp = sp.mp
    H = cfg.d_model // cfg.ssm.rwkv_head_dim
    if not sp.split(but=RWKV_TM_REPLICATED) or H % mp:
        return rwkv_tm_forward(cfg, sp.whole(), x)[0]
    B, _, D = x.shape
    hd = cfg.ssm.rwkv_head_dim
    w = D // mp
    inputs = [copy_to_model(a, sp.devices)
              for a in _rwkv_tm_inputs(cfg, sp.trees[0], x, None)]
    scales = copy_to_model(sp.trees[0]["ln_x"]["scale"], sp.devices)
    outs = []
    for m, (t, dev) in enumerate(zip(sp.trees, sp.devices)):
        state = torch.zeros((B, H // mp, hd, hd), dtype=torch.float32,
                            device=dev)
        outs.append(_rwkv_tm_heads(
            cfg, t, scales[m][m * w:(m + 1) * w], *(a[m] for a in inputs),
            state)[0])
    return reduce_from_model(outs, x.device)


def _rwkv_cm_mixes(p, x: torch.Tensor, cache):
    xs = _token_shift(x, _prev_token(x, cache, "shift_cm"))
    mix = p["mix"]["w"].to(x.dtype)
    return x + (xs - x) * mix[0], x + (xs - x) * mix[1]


def _rwkv_cm_value(p, xk: torch.Tensor, cd) -> torch.Tensor:
    return apply_linear(p["wv"], torch.square(F.relu(
        apply_linear(p["wk"], xk, cd))), cd)


def rwkv_cm_forward(cfg, p, x: torch.Tensor, *, cache=None, **_):
    """Channel-mix. x: [B,L,D]; ``cache`` ({"shift_cm", ...}) in decode,
    its ``shift_cm`` written in place. Returns (out, cache or None)."""
    cd = dt(cfg, "compute")
    xk, xr = _rwkv_cm_mixes(p, x, cache)
    vv = _rwkv_cm_value(p, xk, cd)
    out = torch.sigmoid(apply_linear(p["wr"], xr, cd)) * vv
    if cache is not None:
        cache["shift_cm"].copy_(x[:, -1])
    return out, cache


def rwkv_cm_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor
                       ) -> torch.Tensor:
    """The channel-mix over the model axis, train mode: the token shift and
    mixes on the first slot; ``wk`` column shards and ``wv`` row shards by
    ``mlp``, their partial values summed in shard order there, where the
    replicated ``wr`` gates them. Run whole when the rules left ``wk`` or
    ``wv`` replicated (an mp that does not divide d_ff)."""
    if not sp.split(but=("mix", "wr")):
        return rwkv_cm_forward(cfg, sp.whole(), x)[0]
    cd = dt(cfg, "compute")
    p0 = sp.trees[0]
    xk, xr = _rwkv_cm_mixes(p0, x, None)
    vv = reduce_from_model([_rwkv_cm_value(t, xm, cd) for t, xm in zip(
        sp.trees, copy_to_model(xk, sp.devices))], x.device)
    return torch.sigmoid(apply_linear(p0["wr"], xr, cd)) * vv
