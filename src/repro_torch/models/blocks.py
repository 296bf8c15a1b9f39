"""Decoder blocks and the per-architecture layer plan.

A block = pre-norm mixer (+residual) then pre-norm FFN (+residual).
``layer_plan(cfg)`` expands the architecture into a per-layer (mixer, ffn)
list; ``scan_plan`` folds it into the smallest repeating period, whose
stacked ``[n_periods, ...]`` parameter leaves are the reference's layout.
Mixers: ``attn`` (GQA or MLA, by ``cfg.attn_kind``), ``mamba`` and
``rwkv_tm``; ffns: ``mlp``, ``moe`` and ``rwkv_cm``.
``block_forward`` runs a block over the model axis: the norms whole on
the residual stream's device, the mixer and the FFN at mp > 1 in their
tensor-parallel forms (``MIXERS_TP``, ``FFNS_TP``: every mixer and FFN has
one), each of which runs whole where the rules left its leaves
replicated; at mp = 1 the plain ones (``MIXERS``, ``FFNS``), so the block
is the plain one, op for op. With a decode cache (the block's slice of
it, a ``ShardedParams`` split as ``models/cache.py: cache_dims`` says)
the mixer and the FFN write their parts of it in place, at every mp: each
shard its part of a split leaf, the first slot the replicated ones. The
block returns the FFN's auxiliary loss (MoE's load-balance loss; zero for
the others).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention, moe, ssm
from repro_torch.models.layers import apply_mlp, apply_mlp_tp, \
    apply_rmsnorm, dt, mlp_specs, rmsnorm_specs
from repro_torch.parallel import ShardedParams


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
    "mamba": (ssm.mamba_specs, ssm.mamba_forward),
    "rwkv_tm": (ssm.rwkv_tm_specs, ssm.rwkv_tm_forward),
}
MIXER_CACHES = {"attn": attention.attention_cache_spec,
                "mamba": ssm.mamba_cache_spec,
                "rwkv_tm": ssm.rwkv_cache_spec}
# ffn: (specs, forward (cfg, p, h, cache=None, share=None) -> (out, aux
# loss or None)); ``share`` is MoE's part of the global routing
FFNS = {
    "mlp": (lambda cfg: mlp_specs(cfg.d_model, cfg.d_ff),
            lambda cfg, p, h, cache=None, share=None: (
                apply_mlp(p, h, dt(cfg, "compute")), None)),
    "moe": (moe.moe_specs,
            lambda cfg, p, h, cache=None, share=None: moe.moe_forward(
                cfg, p, h, share)),
    "rwkv_cm": (ssm.rwkv_cm_specs,
                lambda cfg, p, h, cache=None, share=None: (
                    ssm.rwkv_cm_forward(cfg, p, h, cache=cache)[0], None)),
}


def block_specs(cfg, mixer: str, ffn: str) -> dict:
    return {"norm1": rmsnorm_specs(cfg.d_model),
            "mixer": MIXERS[mixer][0](cfg),
            "norm2": rmsnorm_specs(cfg.d_model),
            "ffn": FFNS[ffn][0](cfg)}


def block_cache_spec(cfg, mixer: str, batch: int, max_seq: int) -> dict:
    """The block's decode cache; the RWKV6 mixer's also holds the
    channel-mix's shift state."""
    return MIXER_CACHES[mixer](cfg, batch, max_seq)


# over the model axis: mixer (cfg, sp, h, positions=, cache=) -> out; ffn
# (cfg, sp, h, cache=, share=) -> (out, aux loss or None); ``cache`` the
# block's ShardedParams slice in decode, else None
MIXERS_TP = {"attn": attention.attention_forward_tp,
             "mamba": ssm.mamba_forward_tp,
             "rwkv_tm": ssm.rwkv_tm_forward_tp}
FFNS_TP = {"mlp": lambda cfg, sp, h, cache=None, share=None: (
               apply_mlp_tp(sp, h, dt(cfg, "compute")), None),
           "moe": lambda cfg, sp, h, cache=None, share=None:
               moe.moe_forward_tp(cfg, sp, h, share),
           "rwkv_cm": lambda cfg, sp, h, cache=None, share=None: (
               ssm.rwkv_cm_forward_tp(cfg, sp, h, cache=cache), None)}


def block_mix(cfg, sp: ShardedParams, x: torch.Tensor, *, mixer: str,
              positions: torch.Tensor, cache: ShardedParams | None = None):
    """A block's first half over the model axis of a data group: ``x``
    plus the mixer's output, and the FFN's input, its norm. Returns (x,
    h)."""
    h = apply_rmsnorm(sp["norm1"].whole(), x, cfg.norm_eps)
    if sp.mp > 1:
        mix_out = MIXERS_TP[mixer](cfg, sp["mixer"], h, positions=positions,
                                   cache=cache)
    else:
        mix_out, _ = MIXERS[mixer][1](
            cfg, sp["mixer"].whole(), h, positions=positions,
            cache=None if cache is None else cache.trees[0])
    x = x + mix_out
    return x, apply_rmsnorm(sp["norm2"].whole(), x, cfg.norm_eps)


def block_ffn(cfg, sp: ShardedParams, h: torch.Tensor, *, ffn: str,
              cache: ShardedParams | None = None,
              share: "moe.Share | None" = None):
    """A block's FFN on its input ``h``, with MoE's ``share`` of the global
    routing where one is given. Returns (out, aux_loss)."""
    if sp.mp > 1:
        f, aux = FFNS_TP[ffn](cfg, sp["ffn"], h, cache=cache, share=share)
    else:
        f, aux = FFNS[ffn][1](
            cfg, sp["ffn"].whole(), h,
            cache=None if cache is None else cache.trees[0], share=share)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return f, aux


def block_forward(cfg, sp: ShardedParams, x: torch.Tensor, *, mixer: str,
                  ffn: str, positions: torch.Tensor,
                  cache: ShardedParams | None = None,
                  share: "moe.Share | None" = None):
    """One block over the model axis of a data group; ``x`` is the residual
    stream on the group's first slot. At mp = 1 the mixer and the FFN run
    their plain forms there, against the one tree of a decode ``cache``;
    at mp > 1 their tensor-parallel forms, against its shards. ``share``
    is an MoE FFN's part of the global routing. Returns (x, aux_loss)."""
    x, h = block_mix(cfg, sp, x, mixer=mixer, positions=positions,
                     cache=cache)
    f, aux = block_ffn(cfg, sp, h, ffn=ffn, cache=cache, share=share)
    return x + f, aux
