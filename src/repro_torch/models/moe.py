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
Over the model axis (``moe_forward_tp``) the expert leaves ``[E, D, F]``
split as the layout splits them: by experts where mp divides E, else by
``expert_mlp``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, apply_mlp_tp, dt, \
    mlp_specs
from repro_torch.models.params import ShardedInit
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model, send

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


def _dispatch(r: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot ``dispatch`` and the gated ``combine`` [G, S, E, C] of a
    routing: claim k of token s takes slot ``pos`` of its expert's queue
    where ``pos < C``."""
    within = r["onehot"].float() * (r["pos"] < r["C"])[..., None]
    # a claim past the capacity has no slot: a zero row, as one_hot gives
    pos_oh = (r["pos"][..., None] == torch.arange(r["C"], device=device)
              ).float()
    dispatch = torch.einsum("gske,gskc->gsec", within, pos_oh)
    combine = torch.einsum("gske,gskc,gsk->gsec", within, pos_oh, r["gate"])
    return dispatch, combine


def _experts(p, exp_in: torch.Tensor, cd) -> torch.Tensor:
    """The expert SwiGLU on each expert's slots ``exp_in`` [G, E, C, D]."""
    g = torch.einsum("gecd,edf->gecf", exp_in, p["wi_gate"]["w"].to(cd))
    u = torch.einsum("gecd,edf->gecf", exp_in, p["wi_up"]["w"].to(cd))
    return torch.einsum("gecf,efd->gecd", F.silu(g) * u, p["wo"]["w"].to(cd))


def _aux_loss(r: dict, n_experts: int) -> torch.Tensor:
    """The switch aux loss: E * sum_e(frac_tokens_e * mean_prob_e), on
    choice 0."""
    frac = r["onehot"][:, :, 0].float().mean(dim=(0, 1))   # [E]
    mean_p = r["probs"].mean(dim=(0, 1))
    return n_experts * (frac * mean_p).sum()


def moe_forward(cfg, p, x: torch.Tensor):
    """x: [B, L, D] -> (out [B, L, D], aux_loss 0-d fp32)."""
    m = cfg.moe
    cd = dt(cfg, "compute")
    r = route(cfg, p, x)
    xf = r["xf"]
    dispatch, combine = _dispatch(r, x.device)
    exp_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), xf.to(cd))
    out = torch.einsum("gsec,gecd->gsd", combine.to(cd),
                       _experts(p, exp_in, cd))
    if m.n_shared:
        out = out + apply_mlp(p["shared"], xf, cd)
    return out.reshape(x.shape), _aux_loss(r, m.n_experts)


def moe_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor):
    """MoE over the model axis: the replicated router runs once on the
    first slot (top-k, capacity and aux loss unchanged). Where the layout
    splits ``experts`` (mp divides E), shard m takes the dispatch and
    combine of its E/mp experts and runs them; where it splits
    ``expert_mlp`` instead, every shard runs every expert on its F/mp
    columns (``wo`` rows) from one dispatch. Each shard's partial output
    is summed in shard order on the first slot; the shared experts run as
    the tensor-parallel MLP. Run whole when the rules left an expert leaf
    replicated. Returns (out, aux_loss)."""
    if not sp.split(but=("router", "shared")):
        return moe_forward(cfg, sp.whole(), x)
    m = cfg.moe
    cd = dt(cfg, "compute")
    r = route(cfg, sp.trees[0], x)
    xf = r["xf"]
    dispatch, combine = _dispatch(r, x.device)
    if sp.dims["wi_gate"]["w"] == 0:        # E/mp experts a shard
        n = m.n_experts // sp.mp
        xs = copy_to_model(xf.to(cd), sp.devices)
        parts = []
        for i, (t, xm, dev) in enumerate(zip(sp.trees, xs, sp.devices)):
            own = slice(i * n, (i + 1) * n)
            exp_in = torch.einsum("gsec,gsd->gecd", send(
                dispatch[:, :, own].to(cd), dev, 0, i, "moe_dispatch"), xm)
            parts.append(torch.einsum("gsec,gecd->gsd", send(
                combine[:, :, own].to(cd), dev, 0, i, "moe_dispatch"),
                _experts(t, exp_in, cd)))
    else:                                   # every expert, F/mp a shard
        exp_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), xf.to(cd))
        parts = [torch.einsum("gsec,gecd->gsd", cm, _experts(t, em, cd))
                 for t, em, cm in zip(sp.trees,
                                      copy_to_model(exp_in, sp.devices),
                                      copy_to_model(combine.to(cd),
                                                    sp.devices))]
    out = reduce_from_model(parts, x.device)
    if m.n_shared:
        out = out + apply_mlp_tp(sp["shared"], xf, cd)
    return out.reshape(x.shape), _aux_loss(r, m.n_experts)
