"""Decoder blocks and the per-architecture layer plan.

A block = pre-norm mixer (+residual) then pre-norm FFN (+residual).
``layer_plan(cfg)`` expands the architecture into a per-layer (mixer, ffn)
list; ``scan_plan`` folds it into the smallest repeating period, whose
stacked ``[n_periods, ...]`` parameter leaves are the reference's layout.
Ported mixers: ``attn`` (GQA) and ``rwkv_tm``; ffns: ``mlp`` and
``rwkv_cm``. Any other block raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, ssm
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


MIXERS = {
    "attn": (attention.attention_specs, attention.attention_forward),
    "rwkv_tm": (ssm.rwkv_tm_specs, ssm.rwkv_tm_forward),
}
FFNS = {
    "mlp": (lambda cfg: mlp_specs(cfg.d_model, cfg.d_ff),
            lambda cfg, p, h: (apply_mlp(p, h, dt(cfg, "compute")), None)),
    "rwkv_cm": (ssm.rwkv_cm_specs, ssm.rwkv_cm_forward),
}


def _require_ported(mixer: str, ffn: str):
    if mixer not in MIXERS or ffn not in FFNS:
        raise NotImplementedError(f"block ({mixer}, {ffn}) is not yet ported")


def block_specs(cfg, mixer: str, ffn: str) -> dict:
    _require_ported(mixer, ffn)
    return {"norm1": rmsnorm_specs(cfg.d_model),
            "mixer": MIXERS[mixer][0](cfg),
            "norm2": rmsnorm_specs(cfg.d_model),
            "ffn": FFNS[ffn][0](cfg)}


def block_forward(cfg, p, x: torch.Tensor, *, mixer: str, ffn: str,
                  positions: torch.Tensor):
    """Returns (x, aux_loss)."""
    _require_ported(mixer, ffn)
    h = apply_rmsnorm(p["norm1"], x, cfg.norm_eps)
    mix_out, _ = MIXERS[mixer][1](cfg, p["mixer"], h, positions=positions)
    x = x + mix_out
    h = apply_rmsnorm(p["norm2"], x, cfg.norm_eps)
    f, _ = FFNS[ffn][1](cfg, p["ffn"], h)
    return x + f, torch.zeros((), dtype=torch.float32, device=x.device)
