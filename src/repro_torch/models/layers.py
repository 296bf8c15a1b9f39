"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, linear helpers.

Parameters are plain nested dicts of tensors in the reference's layout
(``[d_in, d_out]`` weights, applied as ``x @ w``); each module also exposes a
``*_specs`` function returning the same tree of :class:`ShardedInit`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ShardedInit
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def dt(cfg, kind: str) -> torch.dtype:
    return _DTYPES[cfg.param_dtype if kind == "param" else cfg.compute_dtype]


# ---------------------------------------------------------------- linear
def linear_specs(d_in: int, d_out: int, in_axis: str | None, out_axis: str | None,
                 bias: bool = False, scale: float = 1.0) -> dict:
    s = {"w": ShardedInit((d_in, d_out), (in_axis, out_axis), "normal", scale)}
    if bias:
        s["b"] = ShardedInit((d_out,), (out_axis,), "zeros")
    return s


def apply_linear(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------- rmsnorm
def rmsnorm_specs(d: int) -> dict:
    return {"scale": ShardedInit((d,), (None,), "ones")}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half RoPE. x: [..., L, D]; positions: broadcastable to [..., L]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # [D/2]
    angles = positions[..., None].float() * freqs             # [..., L, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- swiglu mlp
def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "wi_gate": ShardedInit((d_model, d_ff), ("embed", "mlp")),
        "wi_up": ShardedInit((d_model, d_ff), ("embed", "mlp")),
        "wo": ShardedInit((d_ff, d_model), ("mlp", "embed")),
    }


def apply_mlp(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    cd = compute_dtype
    xc = x.to(cd)
    g = xc @ p["wi_gate"].to(cd)
    u = xc @ p["wi_up"].to(cd)
    return (F.silu(g) * u) @ p["wo"].to(cd)


# ---------------------------------------------------------------- embedding
def embed_specs(vocab: int, d_model: int) -> dict:
    return {"table": ShardedInit((vocab, d_model), ("vocab", "embed"),
                                 "normal", 1.0)}


def apply_embed(p: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return F.embedding(tokens, p["table"].to(compute_dtype))


def apply_mlp_tp(sp: ShardedParams, x: torch.Tensor, compute_dtype
                 ) -> torch.Tensor:
    """The MLP over the model axis: ``wi_gate`` and ``wi_up`` column shards
    and ``wo`` row shards by ``mlp``, each shard's partial output summed in
    shard order onto ``x``'s device. Run whole when the rules left the
    leaves replicated (an mp that does not divide d_ff)."""
    if not sp.split():
        return apply_mlp(sp.whole(), x, compute_dtype)
    xs = copy_to_model(x, sp.devices)
    return reduce_from_model([apply_mlp(t, xm, compute_dtype)
                              for t, xm in zip(sp.trees, xs)], x.device)


def apply_embed_tp(sp: ShardedParams, tokens: torch.Tensor, compute_dtype
                   ) -> torch.Tensor:
    """The vocab-parallel embedding: shard m holds rows ``[m V/mp, (m + 1)
    V/mp)`` of the table, looks up the tokens in its range and gives exact
    zeros for the rest, and the shards are summed in shard order onto
    ``tokens``' device — the lookup's bits. Run whole when the rules left
    the table replicated."""
    if not sp.split():
        return apply_embed(sp.whole(), tokens, compute_dtype)
    parts = []
    for m, (t, dev) in enumerate(zip(sp.trees, sp.devices)):
        rows = t["table"].shape[0]
        local = tokens.to(dev) - m * rows
        own = (local >= 0) & (local < rows)
        e = F.embedding(local.clamp(0, rows - 1), t["table"].to(compute_dtype))
        parts.append(torch.where(own[..., None], e, 0.0))
    return reduce_from_model(parts, tokens.device)


def unembed_specs(d_model: int, vocab: int) -> dict:
    return {"w": ShardedInit((d_model, vocab), ("embed", "vocab"))}
