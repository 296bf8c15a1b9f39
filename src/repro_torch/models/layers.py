"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, linear helpers.

Parameters are plain nested dicts of tensors in the reference's layout
(``[d_in, d_out]`` weights, applied as ``x @ w``); each module also exposes a
``*_specs`` function returning the same tree of :class:`ShardedInit`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ShardedInit

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


def unembed_specs(d_model: int, vocab: int) -> dict:
    return {"w": ShardedInit((d_model, vocab), ("embed", "vocab"))}
