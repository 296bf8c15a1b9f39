"""Mixture-of-Experts: token-choice top-k routing with a capacity factor,
group-wise einsum dispatch, optional shared experts (DeepSeek-V2), and the
switch load-balance auxiliary loss.

Counterpart of the reference's ``models/moe.py``, op for op: tokens route
in groups of ``min(GROUP_SIZE, B·L)``; the router's softmax is fp32 and the
top-k gate values are renormalised; each expert takes at most ``C`` claims
a group, choice 0 claiming first (the claims ordered by (k, s)); dispatch
and combine are one-hot ``[G, S, E, C]`` tensors and every product is an
einsum, so no scatter and no atomics touch the sums and a rerun gives the
same bits. The expert SwiGLU runs in the compute dtype, dispatch and
combine cast to it as the reference casts them. The reference computes all
of this outside any Pallas kernel, so the products stay library matmuls.
The expert leaves ``[E, D, F]`` split over the model axis in the layout,
but the port runs MoE at mp = 1 only (``parallel.require_model_parallel``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dt, mlp_specs
from repro_torch.models.params import ShardedInit

GROUP_SIZE = 512


def moe_specs(cfg) -> dict:
    m = cfg.moe
    D, E, Ff = cfg.d_model, m.n_experts, m.d_ff_expert
    s = {
        "router": {"w": ShardedInit((D, E), ("embed", None), "normal")},
        "wi_gate": {"w": ShardedInit((E, D, Ff),
                                     ("experts", "embed", "expert_mlp"))},
        "wi_up": {"w": ShardedInit((E, D, Ff),
                                   ("experts", "embed", "expert_mlp"))},
        "wo": {"w": ShardedInit((E, Ff, D), ("experts", "expert_mlp", "embed"))},
    }
    if m.n_shared:
        s["shared"] = mlp_specs(D, m.n_shared * Ff)
    return s


def _capacity(group_size: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(group_size * top_k / n_experts * cf)
    return max(4, -(-c // 4) * 4)           # round up to multiple of 4, min 4


def route(cfg, p, x: torch.Tensor) -> dict:
    """The routing of ``x`` [B, L, D] in groups: ``xf`` [G, S, D], the
    router's ``probs`` [G, S, E] (fp32), the renormalised top-k ``gate``
    values and ``expert`` ids [G, S, K], their ``onehot`` [G, S, K, E], each
    claim's position ``pos`` in its expert's queue [G, S, K] and the
    capacity ``C``: a claim is kept where ``pos < C``."""
    m = cfg.moe
    B, L, D = x.shape
    E, K = m.n_experts, m.top_k
    N = B * L
    S = min(GROUP_SIZE, N)
    G = N // S
    if G * S != N:      # where the reference's reshape fails
        raise ValueError(f"{N} tokens do not split into groups of {S}")
    xf = x.reshape(G, S, D)
    logits = torch.einsum("gsd,de->gse", xf.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)             # [G,S,K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert, E).to(torch.int32)           # [G,S,K,E]
    # claims ordered by (k, s): cumulative count of prior claims per expert
    oh_ks = onehot.transpose(1, 2).reshape(G, K * S, E)
    pos_ks = torch.cumsum(oh_ks, dim=1, dtype=torch.int32) - oh_ks
    pos = pos_ks.reshape(G, K, S, E).transpose(1, 2)        # [G,S,K,E]
    return {"xf": xf, "probs": probs, "gate": gate, "expert": expert,
            "onehot": onehot, "pos": (pos * onehot).sum(-1),
            "C": _capacity(S, E, K, m.capacity_factor)}


def moe_forward(cfg, p, x: torch.Tensor):
    """x: [B, L, D] -> (out [B, L, D], aux_loss 0-d fp32)."""
    m = cfg.moe
    E = m.n_experts
    cd = dt(cfg, "compute")
    r = route(cfg, p, x)
    xf, onehot, pos, C = r["xf"], r["onehot"], r["pos"], r["C"]
    within = onehot.float() * (pos < C)[..., None]          # [G,S,K,E]
    # a claim past the capacity has no slot: a zero row, as one_hot gives
    pos_oh = (pos[..., None] == torch.arange(C, device=x.device)).float()
    dispatch = torch.einsum("gske,gskc->gsec", within, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", within, pos_oh, r["gate"])

    exp_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), xf.to(cd))
    g = torch.einsum("gecd,edf->gecf", exp_in, p["wi_gate"]["w"].to(cd))
    u = torch.einsum("gecd,edf->gecf", exp_in, p["wi_up"]["w"].to(cd))
    h = F.silu(g) * u
    exp_out = torch.einsum("gecf,efd->gecd", h, p["wo"]["w"].to(cd))
    out = torch.einsum("gsec,gecd->gsd", combine.to(cd), exp_out)
    if m.n_shared:
        out = out + apply_mlp(p["shared"], xf, cd)

    # switch aux loss: E * sum_e(frac_tokens_e * mean_prob_e), on choice 0
    frac = onehot[:, :, 0].float().mean(dim=(0, 1))         # [E]
    mean_p = r["probs"].mean(dim=(0, 1))
    aux = E * (frac * mean_p).sum()
    return out.reshape(x.shape), aux
