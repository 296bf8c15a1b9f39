"""Attention: the reference's ``gqa_forward``, its train/prefill branch and
its decode branch against the KV cache.

q is laid out [B,Hkv,G,L,D] and k/v [B,Hkv,L,D], as in the reference. Train
and prefill go through the port's flash op: the CUDA kernels on the card,
their plain versions on the CPU. Over the model axis
(``attention_forward_tp``) each shard runs the same branch on its heads.
Decode (one token against the cache) is ``decode_attention``, plain
PyTorch, as the reference computes it outside any Pallas kernel. MLA and
the window-pruned branch are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.layers import apply_linear, apply_rope, dt, \
    linear_specs
from repro_torch.models.params import ShardedInit
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model

NEG_INF = -1e30


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


def attention_specs(cfg) -> dict:
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
    return gqa_specs(cfg)


def attention_forward(cfg, p, x, **kw):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
    return gqa_forward(cfg, p, x, **kw)


def attention_cache_spec(cfg, batch: int, max_seq: int) -> dict:
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
    return gqa_cache_spec(cfg, batch, max_seq)


def attention_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor, *,
                         positions: torch.Tensor) -> torch.Tensor:
    """Attention over the model axis: ``wq``/``wk``/``wv`` column shards by
    heads and kv_heads, so shard m runs the flash kernels on its H/mp
    heads, and ``wo`` row shards by heads, whose partial outputs are summed
    in shard order onto ``x``'s device. Run whole when the rules left a
    leaf replicated or a shard would split a KV group (Hkv % mp != 0)."""
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
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
