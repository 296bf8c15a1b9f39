"""Attention: the GQA train branch of the reference's ``gqa_forward``.

q is laid out [B,Hkv,G,L,D] and k/v [B,Hkv,L,D], as in the reference, and
attention goes through the port's flash op: the CUDA kernels on the card,
their plain versions on the CPU. Over the model axis
(``attention_forward_tp``) each shard runs the same branch on its heads.
Decode caches, MLA and the window-pruned
branch are not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.layers import apply_linear, apply_rope, dt, \
    linear_specs
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model


def gqa_specs(cfg) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": linear_specs(D, H * Dh, "embed", "heads", bias=cfg.qkv_bias),
        "wk": linear_specs(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wv": linear_specs(D, Hkv * Dh, "embed", "kv_heads", bias=cfg.qkv_bias),
        "wo": linear_specs(H * Dh, D, "heads", "embed"),
    }


def gqa_forward(cfg, p, x: torch.Tensor, *, positions: torch.Tensor,
                cache=None) -> tuple[torch.Tensor, None]:
    """x: [B,L,D]; positions: [B,L]. Train/prefill only (``cache`` None)."""
    if cache is not None:
        raise NotImplementedError("decode attention is not yet ported")
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
    out = attn_ops.flash_attention(q, k, v, causal=True, window=cfg.window)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, L, H * Dh)
    return apply_linear(p["wo"], out, cd), None


def attention_specs(cfg) -> dict:
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
    return gqa_specs(cfg)


def attention_forward(cfg, p, x, **kw):
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.attn_kind} attention is not yet ported")
    return gqa_forward(cfg, p, x, **kw)


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
