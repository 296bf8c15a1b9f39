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

Over the data axis the reference routes the whole global batch at once
(its default step is one GSPMD program), while the port's default step
runs each data group's shard apart. A ``Share`` hands one data group its
part of the global routing: its tokens sit at their global places in the
reference's routing groups (``route`` pads a group that the shard fills
only in part, and the padding claims nothing), each claim's queue position
adds ``before``, the claims that other data groups' parts of the same
routing group put ahead of it, and the aux loss takes the global
choice-0 fractions ``frac``. ``share_out`` fills both from every group's
``claims`` at one layer; ``models/model.py: route_globally`` walks the
groups' forwards in lockstep to get them.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class Share:
    """One data group's part of an MoE layer's routing over the global
    batch: ``total`` tokens in all (B·L of the global batch, flattened
    batch-major), the group's first at index ``first``. Filled by
    ``share_out``: ``before`` [G, K, E] int32, for each of the routing
    groups the part touches, choice and expert, the claims ahead of the
    part's own in that expert's queue; ``frac`` [E], the choice-0
    fractions of all ``total`` tokens; ``claims``, the part's own counts
    as ``share_out`` was given them. A ``route`` that finds other counts
    appends True to ``mismatches`` (a device flag, read once by the
    step)."""
    total: int
    first: int
    before: torch.Tensor | None = None
    frac: torch.Tensor | None = None
    claims: torch.Tensor | None = None
    mismatches: list = dataclasses.field(default_factory=list)

    def groups(self, n: int) -> tuple[int, int, int]:
        """(S, lead, G) for a part of ``n`` tokens: the routing groups' size,
        the place of its first token in its routing group, and the number
        of routing groups it touches."""
        S = min(GROUP_SIZE, self.total)
        lead = self.first % S
        return S, lead, -(-(lead + n) // S)


def route(cfg, p, x: torch.Tensor, share: Share | None = None) -> dict:
    """The routing of ``x`` [B, L, D] in groups: ``xf`` [G, S, D], the
    router's ``probs`` [G, S, E] (fp32), the renormalised top-k ``gate``
    values and ``expert`` ids [G, S, K], their ``onehot`` [G, S, K, E], each
    claim's position ``pos`` in its expert's queue [G, S, K], the capacity
    ``C``, the ``claims`` [G, K, E] made, and the ``span`` (lead, n) of
    ``x``'s tokens in ``xf``: a claim is kept where ``pos < C``. With a
    ``share``, ``x`` is that part of the global batch: its tokens take
    their global places in the routing groups it touches, zero rows filling
    the rest (they claim nothing), and ``pos`` counts ``share.before``."""
    m = cfg.moe
    B, L, D = x.shape
    E, K = m.n_experts, m.top_k
    n = B * L
    share = share or Share(n, 0)
    S, lead, G = share.groups(n)
    if share.total % S:     # where the reference's reshape fails
        raise ValueError(f"{share.total} tokens do not split into groups "
                         f"of {S}")
    pad = G * S - n
    xf = x.reshape(n, D)
    if pad:
        xf = F.pad(xf, (0, 0, lead, pad - lead))
    xf = xf.reshape(G, S, D)
    logits = torch.einsum("gsd,de->gse", xf.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)             # [G,S,K]
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(expert, E).to(torch.int32)           # [G,S,K,E]
    if pad:
        ours = torch.zeros(G * S, dtype=torch.int32, device=x.device)
        ours[lead:lead + n] = 1
        onehot = onehot * ours.view(G, S, 1, 1)
    # claims ordered by (k, s): cumulative count of prior claims per expert
    oh_ks = onehot.transpose(1, 2).reshape(G, K * S, E)
    pos_ks = (torch.cumsum(oh_ks, dim=1, dtype=torch.int32) - oh_ks
              ).reshape(G, K, S, E)
    claims = oh_ks.reshape(G, K, S, E).sum(2, dtype=torch.int32)
    if share.before is not None:
        pos_ks = pos_ks + share.before[:, :, None]
    if share.claims is not None:
        share.mismatches.append((claims != share.claims).any())
    pos = pos_ks.transpose(1, 2)                            # [G,S,K,E]
    return {"xf": xf, "probs": probs, "gate": gate, "expert": expert,
            "onehot": onehot, "pos": (pos * onehot).sum(-1),
            "C": _capacity(S, E, K, m.capacity_factor), "claims": claims,
            "span": (lead, n), "frac": share.frac}


def share_out(shares: list[Share], claims: list[torch.Tensor], home
              ) -> None:
    """Fill each data group's ``Share`` of one MoE layer from every group's
    ``claims`` [G_d, K, E] (``route``'s, on the group's device): the
    claims of choice < k to an expert by the other groups' parts of a
    routing group, and those of choice k by the earlier groups' parts, come
    before a part's own claims of choice k, as the reference orders them
    (by choice, then token); ``frac`` counts choice 0 over every token.
    Integer sums on ``home``, sent back to each group's device."""
    total = shares[0].total
    S = min(GROUP_SIZE, total)
    K, E = claims[0].shape[1:]
    table = torch.zeros((len(shares), total // S, K, E), dtype=torch.int32,
                        device=home)
    spans = []
    for d, (sh, c) in enumerate(zip(shares, claims)):
        g0 = sh.first // S
        spans.append(slice(g0, g0 + c.shape[0]))
        table[d, spans[-1]] = c.to(home)
    others = table.sum(0, keepdim=True, dtype=torch.int32) - table
    before = (torch.cumsum(others, 2, dtype=torch.int32) - others
              + torch.cumsum(table, 0, dtype=torch.int32) - table)
    frac = table[:, :, 0].sum((0, 1)).float() / total
    for d, (sh, c, span) in enumerate(zip(shares, claims, spans)):
        sh.before = before[d, span].to(c.device)
        sh.frac = frac.to(c.device)
        sh.claims = c


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
    choice 0; for a share of the global batch, its tokens' mean prob
    against the global ``frac``."""
    if r["frac"] is None:
        frac = r["onehot"][:, :, 0].float().mean(dim=(0, 1))   # [E]
        mean_p = r["probs"].mean(dim=(0, 1))
    else:
        lead, n = r["span"]
        frac = r["frac"]
        mean_p = r["probs"].reshape(-1, n_experts)[lead:lead + n].mean(0)
    return n_experts * (frac * mean_p).sum()


def _tokens(r: dict, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out`` [G, S, D] back at ``x``'s shape: its rows of ``x``'s
    tokens."""
    lead, n = r["span"]
    out = out.reshape(-1, out.shape[-1])
    if out.shape[0] != n:
        out = out[lead:lead + n]
    return out.reshape(x.shape)


def moe_forward(cfg, p, x: torch.Tensor, share: Share | None = None):
    """x: [B, L, D] -> (out [B, L, D], aux_loss 0-d fp32); ``x`` a data
    group's ``share`` of the global batch where one is given."""
    m = cfg.moe
    cd = dt(cfg, "compute")
    r = route(cfg, p, x, share)
    xf = r["xf"]
    dispatch, combine = _dispatch(r, x.device)
    exp_in = torch.einsum("gsec,gsd->gecd", dispatch.to(cd), xf.to(cd))
    out = torch.einsum("gsec,gecd->gsd", combine.to(cd),
                       _experts(p, exp_in, cd))
    out = _tokens(r, out, x)
    if m.n_shared:
        out = out + apply_mlp(p["shared"], x, cd)
    return out, _aux_loss(r, m.n_experts)


def moe_forward_tp(cfg, sp: ShardedParams, x: torch.Tensor,
                   share: Share | None = None):
    """MoE over the model axis: the replicated router runs once on the
    first slot (top-k, capacity and aux loss unchanged). Where the layout
    splits ``experts`` (mp divides E), shard m takes the dispatch and
    combine of its E/mp experts and runs them; where it splits
    ``expert_mlp`` instead, every shard runs every expert on its F/mp
    columns (``wo`` rows) from one dispatch. Each shard's partial output
    is summed in shard order on the first slot; the shared experts run as
    the tensor-parallel MLP. Run whole when the rules left an expert leaf
    replicated. ``share`` as in ``moe_forward``. Returns (out,
    aux_loss)."""
    if not sp.split(but=("router", "shared")):
        return moe_forward(cfg, sp.whole(), x, share)
    m = cfg.moe
    cd = dt(cfg, "compute")
    r = route(cfg, sp.trees[0], x, share)
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
    out = _tokens(r, reduce_from_model(parts, x.device), x)
    if m.n_shared:
        out = out + apply_mlp_tp(sp["shared"], x, cd)
    return out, _aux_loss(r, m.n_experts)
