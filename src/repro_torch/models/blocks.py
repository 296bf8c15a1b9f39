"""Decoder blocks and the per-architecture layer plan.

A block = pre-norm mixer (+residual) then pre-norm FFN (+residual).
``layer_plan(cfg)`` expands the architecture into a per-layer (mixer, ffn)
list; ``scan_plan`` folds it into the smallest repeating period, whose
stacked ``[n_periods, ...]`` parameter leaves are the reference's layout.
Only the dense ``attn`` + ``mlp`` block is ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention
from repro_torch.models.layers import apply_mlp, apply_rmsnorm, dt, \
    mlp_specs, rmsnorm_specs


def layer_plan(cfg) -> list[tuple[str, str]]:
    plan = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm" and cfg.ssm.kind == "rwkv6":
            mixer = "rwkv_tm"
        elif cfg.hybrid_pattern:
            mixer = {"m": "mamba", "a": "attn"}[
                cfg.hybrid_pattern[i % len(cfg.hybrid_pattern)]]
        else:
            mixer = "attn"
        if mixer == "rwkv_tm":
            ffn = "rwkv_cm"
        elif cfg._layer_is_moe(i):
            ffn = "moe"
        else:
            ffn = "mlp"
        plan.append((mixer, ffn))
    return plan


def scan_plan(cfg) -> tuple[list[tuple[str, str]], int]:
    """Returns (slots, n_periods): plan == slots * n_periods."""
    plan = layer_plan(cfg)
    n = len(plan)
    for period in range(1, n + 1):
        if n % period == 0 and all(plan[i] == plan[i % period]
                                   for i in range(n)):
            return plan[:period], n // period
    return plan, 1


def _require_dense(mixer: str, ffn: str):
    if (mixer, ffn) != ("attn", "mlp"):
        raise NotImplementedError(f"block ({mixer}, {ffn}) is not yet ported")


def block_specs(cfg, mixer: str, ffn: str) -> dict:
    _require_dense(mixer, ffn)
    return {"norm1": rmsnorm_specs(cfg.d_model),
            "mixer": attention.attention_specs(cfg),
            "norm2": rmsnorm_specs(cfg.d_model),
            "ffn": mlp_specs(cfg.d_model, cfg.d_ff)}


def block_forward(cfg, p, x: torch.Tensor, *, mixer: str, ffn: str,
                  positions: torch.Tensor):
    """Returns (x, aux_loss)."""
    _require_dense(mixer, ffn)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix_out, _ = attention.attention_forward(cfg, p["mixer"], h,
                                             positions=positions)
    x = x + mix_out
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    f = apply_mlp(p["ffn"], h, dt(cfg, "compute"))
    return x + f, torch.zeros((), dtype=torch.float32, device=x.device)
