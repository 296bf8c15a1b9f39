"""Attention: the GQA train branch of the reference's ``gqa_forward``.

q is laid out [B,Hkv,G,L,D] and k/v [B,Hkv,L,D], as in the reference, and
attention goes through the port's flash op: the CUDA kernels on the card,
their plain versions on the CPU. Decode caches, MLA and the window-pruned
branch are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.models.layers import apply_linear, apply_rope, dt, \
    linear_specs


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
