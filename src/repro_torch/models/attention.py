"""Attention: the reference's ``gqa_forward`` and ``mla_forward``, each
with its train/prefill branch and its decode branch against the cache.

q is laid out [B,Hkv,G,L,D] and k/v [B,Hkv,L,D], as in the reference. GQA's
train and prefill go through the port's flash op: the CUDA kernels on the
card, their plain versions on the CPU. Over the model axis
(``attention_forward_tp``) each shard runs the same branch on its heads.
MLA attends as MQA over its compressed KV, whose k (``kv_lora +
qk_rope_dim`` wide) and v (``kv_lora``) differ in width; its train and
prefill run ``chunked_attention``, the reference's chunked online softmax,
as the reference runs it; over the model axis (``mla_forward_tp``) each
shard runs its heads against the whole compressed head. Decode (one
token against the cache) is ``decode_attention``, plain PyTorch, as the
reference computes it outside any Pallas kernel. The window-pruned branch
is not ported: windowed GQA runs the flash op's window mask.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.launches import remat
from repro_torch.models.layers import apply_linear, apply_rmsnorm, \
    apply_rope, dt, linear_specs, rmsnorm_specs
from repro_torch.models.params import ShardedInit, fit_chunk
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model

NEG_INF = -1e30


def _online_update(m_prev, l_prev, acc_prev, q, k_c, v_c, mask,
                   scale: float):
    """One kv chunk of the online softmax. q: [B,Hkv,G,Lq,Dk]; k_c:
    [B,Hkv,C,Dk]; v_c: [B,Hkv,C,Dv]; mask [Lq,C] (True: visible). The
    scores, the running max ``m`` and sum ``l`` and the accumulator are
    fp32; q and k enter the product as fp32 copies of their values, as the
    reference's ``preferred_element_type=float32`` product sees them."""
    s = torch.einsum("bhgqd,bhcd->bhgqc", q.float(), k_c.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(-1)
    acc_new = acc_prev * corr[..., None] + torch.einsum(
        "bhgqc,bhcd->bhgqd", p, v_c.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 1024,
                      scale: float | None = None) -> torch.Tensor:
    """The reference's ``chunked_attention``: q [B,Hkv,G,Lq,Dk], k
    [B,Hkv,Lk,Dk], v [B,Hkv,Lk,Dv] (k and v may differ in width), kv in
    chunks of ``fit_chunk(Lk, chunk)`` under a running fp32 softmax; the
    causal mask aligns query i with key i. Returns [B,Hkv,G,Lq,Dv] in q's
    dtype. Under autograd each chunk is checkpointed, as the reference's
    ``nothing_saveable`` chunk body is, so a backward keeps no chunk's
    scores: it recomputes them from the chunk's inputs."""
    B, Hkv, G, Lq, Dk = q.shape
    Lk, Dv = k.shape[2], v.shape[3]
    scale = Dk ** -0.5 if scale is None else scale
    chunk = fit_chunk(Lk, chunk)
    q_pos = torch.arange(Lq, device=q.device)
    m = torch.full((B, Hkv, G, Lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Lq, Dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Lk, chunk):
        k_pos = c0 + torch.arange(chunk, device=q.device)
        mask = (q_pos[:, None] >= k_pos[None, :] if causal else
                torch.ones((Lq, chunk), dtype=torch.bool, device=q.device))
        m, l, acc = remat(_online_update, m, l, acc, q,
                          k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk],
                          mask, scale)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def gqa_specs(cfg) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": linear_specs(D, H * Dh, "embed", "heads", bias=cfg.qkv_bias),
        "wk": linear_specs(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wv": linear_specs(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wo": linear_specs(H * Dh, D, "heads", "embed"),
    }


def gqa_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    """k and v [B,Hkv,S,Dh]: S = max_seq, or a ring of ``cfg.window``
    slots under a sliding window."""
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    S = min(max_seq, cfg.window) if cfg.window > 0 else max_seq
    ax = ("batch", "kv_heads", "seq_shard", None)
    return {"k": ShardedInit((batch, Hkv, S, Dh), ax, "zeros"),
            "v": ShardedInit((batch, Hkv, S, Dh), ax, "zeros")}


def decode_attention(q, k, v, kv_valid, *, scale: float | None = None):
    """Single-token decode. q: [B,Hkv,G,1,Dk]; k/v: [B,Hkv,S,D];
    ``kv_valid`` a 0-d tensor, the tokens written (current position + 1).
    Keys from ``min(kv_valid, S)`` on are masked, so a ring buffer of
    ``window`` slots has every slot valid once kv_valid >= S, which is all
    a window needs. Scores and softmax in fp32."""
    Dk, S = q.shape[-1], k.shape[2]
    scale = Dk ** -0.5 if scale is None else scale
    s = torch.einsum("bhgqd,bhcd->bhgqc", q.float(), k.float()) * scale
    valid = torch.arange(S, device=k.device) < torch.clamp(kv_valid, max=S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqc,bhcd->bhgqd", p, v.float())
    return out.to(q.dtype)


def gqa_forward(cfg, p, x: torch.Tensor, *, positions: torch.Tensor,
                cache=None):
    """x: [B,L,D]; positions: [B,L]. Train/prefill with ``cache`` None;
    decode (L == 1, ``positions[:, 0]`` the current index) against
    ``cache`` ({"k", "v"}), writing this token's k and v in place at slot
    ``pos``, or ``pos % S`` under a window, so a token moves one slot of
    the cache and not all of it. Returns (out, cache or None)."""
    B, L, D = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // Hkv
    cd = dt(cfg, "compute")
    q = apply_linear(p["wq"], x, cd).reshape(B, L, Hkv, G, Dh)
    k = apply_linear(p["wk"], x, cd).reshape(B, L, Hkv, Dh)
    v = apply_linear(p["wv"], x, cd).reshape(B, L, Hkv, Dh)
    q = apply_rope(q, positions[:, :, None, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, :, None], cfg.rope_theta)
    q = q.permute(0, 2, 3, 1, 4)                     # [B,Hkv,G,L,Dh]
    k = k.permute(0, 2, 1, 3)                        # [B,Hkv,L,Dh]
    v = v.permute(0, 2, 1, 3)
    if cache is not None:                            # decode (L == 1)
        S = cache["k"].shape[2]
        pos = positions[0, 0]
        slot = (pos % S if cfg.window > 0 else pos).long().reshape(1)
        cache["k"].index_copy_(2, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(2, slot, v.to(cache["v"].dtype))
        out = decode_attention(q, cache["k"], cache["v"], pos + 1)
    else:
        out = attn_ops.flash_attention(q, k, v, causal=True,
                                       window=cfg.window)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, L, H * Dh)
    return apply_linear(p["wo"], out, cd), cache


def mla_specs(cfg) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": linear_specs(D, m.q_lora, "embed", "lora"),
        "q_norm": rmsnorm_specs(m.q_lora),
        "wq_b": linear_specs(m.q_lora, H * qk, "lora", "heads"),
        "wkv_a": linear_specs(D, m.kv_lora + m.qk_rope_dim, "embed", "lora"),
        "kv_norm": rmsnorm_specs(m.kv_lora),
        "w_uk": {"w": ShardedInit((H, m.kv_lora, m.qk_nope_dim),
                                  ("heads", "lora", None))},
        "w_uv": {"w": ShardedInit((H, m.kv_lora, m.v_head_dim),
                                  ("heads", "lora", None))},
        "wo": linear_specs(H * m.v_head_dim, D, "heads", "embed"),
    }


def mla_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    """The compressed cache: ``ckv`` [B,1,S,kv_lora] and ``krope``
    [B,1,S,qk_rope_dim]."""
    m = cfg.mla
    ax = ("batch", None, "seq_shard", None)
    return {"ckv": ShardedInit((batch, 1, max_seq, m.kv_lora), ax, "zeros"),
            "krope": ShardedInit((batch, 1, max_seq, m.qk_rope_dim), ax,
                                 "zeros")}


def _mla_latents(cfg, p, x: torch.Tensor, positions: torch.Tensor):
    """MLA's replicated head: the normed query latent ``q_lat`` [B,L,q_lora]
    and the compressed KV's ``ckv`` [B,1,L,kv_lora] and roped ``krope``
    [B,1,L,qk_rope_dim], in the compute dtype."""
    m = cfg.mla
    cd = dt(cfg, "compute")
    q_lat = apply_rmsnorm(p["q_norm"], apply_linear(p["wq_a"], x, cd),
                          cfg.norm_eps)
    kv_a = apply_linear(p["wkv_a"], x, cd)
    ckv, k_rope = kv_a.split([m.kv_lora, m.qk_rope_dim], dim=-1)
    ckv = apply_rmsnorm(p["kv_norm"], ckv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions[:, :, None],
                        cfg.rope_theta)[:, :, 0]
    return q_lat, ckv[:, None], k_rope[:, None].to(cd)


def _mla_query(cfg, p, q_lat, positions: torch.Tensor) -> torch.Tensor:
    """The absorbed queries [B,1,H,L,kv_lora + qk_rope_dim] of the heads
    whose ``wq_b`` columns and ``w_uk`` rows ``p`` holds."""
    m = cfg.mla
    B, L, _ = q_lat.shape
    H = p["w_uk"]["w"].shape[0]
    cd = dt(cfg, "compute")
    q = apply_linear(p["wq_b"], q_lat, cd).reshape(
        B, L, H, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions[:, :, None], cfg.rope_theta)
    # absorb W_uk: [B,L,H,nope] x [H,lora,nope] -> [B,L,H,lora]
    q_abs = torch.einsum("blhn,hkn->blhk", q_nope.to(cd),
                         p["w_uk"]["w"].to(cd))
    q_full = torch.cat([q_abs, q_rope.to(cd)], dim=-1)
    return q_full.permute(0, 2, 1, 3)[:, None]             # [B,1,H,L,qk']


def _mla_out(cfg, p, out: torch.Tensor) -> torch.Tensor:
    """The attention output [B,1,H,L,kv_lora] of ``p``'s heads through
    their ``w_uv`` and ``wo`` rows: the output, or its partial sum."""
    B, _, H, L, _ = out.shape
    cd = dt(cfg, "compute")
    # out: [B,1,H,L,lora] -> W_uv -> [B,L,H,v_dim]
    out = torch.einsum("bhlk,hkv->blhv", out[:, 0].to(cd),
                       p["w_uv"]["w"].to(cd))
    out = out.reshape(B, L, H * cfg.mla.v_head_dim)
    return apply_linear(p["wo"], out, cd)


def _mla_scale(cfg) -> float:
    return (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5


def mla_forward(cfg, p, x: torch.Tensor, *, positions: torch.Tensor,
                cache=None, **_):
    """MLA as MQA over the compressed KV: k = [c_kv ; k_rope] (one head,
    read by all ``n_heads`` queries), v = c_kv, with each head's ``w_uk``
    absorbed into its query and ``w_uv`` applied to the attention output.
    The scores scale by ``(qk_nope_dim + qk_rope_dim) ** -0.5``, not by the
    key's width. Decode writes this token's ``ckv`` and ``krope`` in place
    at slot ``pos``. Returns (out, cache or None)."""
    cd = dt(cfg, "compute")
    q_lat, ckv_n, krope_n = _mla_latents(cfg, p, x, positions)
    q_full = _mla_query(cfg, p, q_lat, positions)
    scale = _mla_scale(cfg)
    if cache is not None:                                  # decode (L == 1)
        pos = positions[0, 0]
        slot = pos.long().reshape(1)
        cache["ckv"].index_copy_(2, slot, ckv_n.to(cache["ckv"].dtype))
        cache["krope"].index_copy_(2, slot, krope_n.to(cache["krope"].dtype))
        c = cache["ckv"].to(cd)
        k_full = torch.cat([c, cache["krope"].to(cd)], dim=-1)
        out = decode_attention(q_full, k_full, c, pos + 1, scale=scale)
    else:
        k_full = torch.cat([ckv_n.to(cd), krope_n], dim=-1)
        out = chunked_attention(q_full, k_full, ckv_n.to(cd), causal=True,
                                chunk=cfg.attn_chunk, scale=scale)
    return _mla_out(cfg, p, out), cache


# MLA's leaves the rules leave whole (their axes are ``embed`` and
# ``lora``): the compressed head's projections and norms
MLA_REPLICATED = ("wq_a", "q_norm", "wkv_a", "kv_norm")


def mla_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor, *,
                   positions: torch.Tensor) -> torch.Tensor:
    """MLA over the model axis, train mode: the query latent and the
    compressed ``ckv``/``krope`` head once on the first slot, copied out;
    shard m takes H/mp heads (``wq_b`` columns, ``w_uk``/``w_uv`` rows)
    against the whole compressed head and its ``wo`` row shard, the
    partial outputs summed in shard order there. Run whole when the rules
    left a head leaf replicated (an mp that does not divide H)."""
    if not sp.split(but=MLA_REPLICATED):
        return mla_forward(cfg, sp.whole(), x, positions=positions)[0]
    cd = dt(cfg, "compute")
    q_lat, ckv_n, krope_n = _mla_latents(cfg, sp.trees[0], x, positions)
    k_full = torch.cat([ckv_n.to(cd), krope_n], dim=-1)
    outs = []
    for t, dev, q_m, k_m, v_m in zip(
            sp.trees, sp.devices, copy_to_model(q_lat, sp.devices),
            copy_to_model(k_full, sp.devices),
            copy_to_model(ckv_n.to(cd), sp.devices)):
        q_full = _mla_query(cfg, t, q_m, positions.to(dev))
        out = chunked_attention(q_full, k_m, v_m, causal=True,
                                chunk=cfg.attn_chunk, scale=_mla_scale(cfg))
        outs.append(_mla_out(cfg, t, out))
    return reduce_from_model(outs, x.device)


def attention_specs(cfg) -> dict:
    return mla_specs(cfg) if cfg.attn_kind == "mla" else gqa_specs(cfg)


def attention_forward(cfg, p, x, **kw):
    fn = mla_forward if cfg.attn_kind == "mla" else gqa_forward
    return fn(cfg, p, x, **kw)


def attention_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    if cfg.attn_kind == "mla":
        return mla_cache_spec(cfg, batch, max_seq)
    return gqa_cache_spec(cfg, batch, max_seq)


def attention_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor, *,
                         positions: torch.Tensor) -> torch.Tensor:
    """Attention over the model axis. MLA goes to ``mla_forward_tp``. GQA:
    ``wq``/``wk``/``wv`` column shards by heads and kv_heads, so shard m
    runs the flash kernels on its H/mp heads, and ``wo`` row shards by
    heads, whose partial outputs are summed in shard order onto ``x``'s
    device. Run whole when the rules left a leaf replicated or a shard
    would split a KV group (Hkv % mp != 0)."""
    if cfg.attn_kind == "mla":
        return mla_forward_tp(cfg, sp, x, positions=positions)
    mp = sp.mp
    if not sp.split() or cfg.n_kv_heads % mp:
        return gqa_forward(cfg, sp.whole(), x, positions=positions)[0]
    shard_cfg = dataclasses.replace(
        cfg, n_heads=cfg.n_heads // mp, n_kv_heads=cfg.n_kv_heads // mp,
        head_dim=cfg.resolved_head_dim)
    xs = copy_to_model(x, sp.devices)
    return reduce_from_model(
        [gqa_forward(shard_cfg, t, xm, positions=positions.to(dev))[0]
         for t, xm, dev in zip(sp.trees, xs, sp.devices)], x.device)
