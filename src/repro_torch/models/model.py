"""Top-level language model: param specs, init, the train-mode forward over
the stacked block periods, and the chunked cross-entropy loss.

The reference scans the periods with ``lax.scan``; here the forward is a
Python loop over them, reading period i of each stacked ``[n_periods, ...]``
leaf. With ``cfg.remat`` each period is rematerialized in the backward, as
the reference's ``jax.checkpoint(..., nothing_saveable)`` does in train
mode: only the period's input is kept. The reference's ``_barrier`` steers
XLA and has no counterpart; grouped remat (``remat_group > 1``) is not
ported yet.

There is one path: ``forward_tp`` and ``loss_fn_tp`` run over the model
axis of one data group (``parallel.ShardedParams``) — vocab-parallel
embedding, tensor-parallel blocks, and a vocab-parallel unembedding and
cross-entropy at the same ``loss_chunk`` — and each leaf the layout leaves
whole runs its plain layer. ``forward`` and ``loss_fn`` call them on the
one shard of mp = 1, where every leaf is whole.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.launches import recompute_context
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_embed_tp, \
    apply_rmsnorm, dt, embed_specs, rmsnorm_specs, unembed_specs
from repro_torch.models.params import ShardedInit, fit_chunk, tree_leaves, \
    tree_map, tree_unflatten
from repro_torch.parallel import ShardedParams, copy_to_model, \
    reduce_from_model


# ------------------------------------------------------------------- specs
def param_spec_tree(cfg) -> dict:
    slots, n_periods = B.scan_plan(cfg)

    def stack(s: ShardedInit) -> ShardedInit:
        return ShardedInit((n_periods,) + s.shape, ("layers",) + s.axes,
                           s.init, s.scale)

    layers = {f"slot{j}": tree_map(stack, B.block_specs(cfg, mixer, ffn))
              for j, (mixer, ffn) in enumerate(slots)}
    tree = {"layers": layers,
            "final_norm": rmsnorm_specs(cfg.d_model),
            "unembed": unembed_specs(cfg.d_model, cfg.vocab)}
    if cfg.frontend == "tokens":
        tree["embed"] = embed_specs(cfg.vocab, cfg.d_model)
    return tree


def init_params(cfg, generator: torch.Generator, device) -> dict:
    """Draw every leaf, in sorted-path order, from ``generator`` (a CPU
    generator; the values do not depend on ``device``)."""
    dtype = dt(cfg, "param")
    return tree_unflatten(
        (path, spec.materialize(generator, dtype, torch.device(device)))
        for path, spec in tree_leaves(param_spec_tree(cfg)))


# ------------------------------------------------------------------ forward
def forward(cfg, params, batch, *, mode: str = "train"):
    """mode 'train' -> (hidden [B,L,D], aux): ``forward_tp`` on the one
    shard of mp = 1."""
    if mode != "train":
        raise NotImplementedError(f"mode {mode!r} is not yet ported")
    return forward_tp(cfg, ShardedParams.one(params), batch)


def chunked_xent(cfg, params, hidden: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
    """Mean cross-entropy, unembedding ``loss_chunk`` positions at a time
    in fp32."""
    Bsz, L, _ = hidden.shape
    chunk = fit_chunk(L, cfg.loss_chunk)
    w = params["unembed"]["w"].float()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, L, chunk):
        logits = hidden[:, c0:c0 + chunk].float() @ w
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, c0:c0 + chunk, None])[..., 0]
        total = total + (lse - gold).sum()
    return total / (Bsz * L)


def loss_fn(cfg, params, batch):
    """``loss_fn_tp`` on the one shard of mp = 1."""
    return loss_fn_tp(cfg, ShardedParams.one(params), batch)


# ------------------------------------------------------- over the model axis
def forward_tp(cfg, sp: ShardedParams, batch):
    """The train-mode forward over the model axis of one data group;
    ``batch`` lies on the group's first slot, which carries the residual
    stream. Returns (hidden [B,L,D], aux)."""
    if cfg.remat and cfg.remat_group > 1:
        raise NotImplementedError("grouped remat is not yet ported")
    cd = dt(cfg, "compute")
    if cfg.frontend == "embeds":
        x = batch["embeds"].to(cd)
    else:
        x = apply_embed_tp(sp["embed"], batch["tokens"], cd)
    Bsz, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(Bsz, L)
    slots, _ = B.scan_plan(cfg)

    def period(x, p_i):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (mixer, ffn) in enumerate(slots):
            x, aux = B.block_forward(cfg, p_i[f"slot{j}"], x, mixer=mixer,
                                     ffn=ffn, positions=positions)
            aux_total = aux_total + aux
        return x, aux_total

    auxes = []
    for p_i in sp["layers"].periods():
        if cfg.remat:
            x, aux = checkpoint(period, x, p_i, use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=recompute_context)
        else:
            x, aux = period(x, p_i)
        auxes.append(aux)
    x = apply_rmsnorm(sp["final_norm"].whole(), x, cfg.norm_eps)
    return x, torch.stack(auxes).mean()


def chunked_xent_tp(cfg, sp: ShardedParams, hidden: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """``chunked_xent`` with the unembedding split by vocab: per chunk of
    ``loss_chunk`` positions, shard m forms its V/mp logits in fp32 and
    their log-sum-exp; the log-sum-exp across shards combines them (its
    max taken first), and the target logit comes from the shard that owns
    the label, the others giving exact zeros. Run whole when the rules left
    the unembedding replicated."""
    u = sp["unembed"]
    if not u.split():
        return chunked_xent(cfg, {"unembed": u.whole()}, hidden, labels)
    Bsz, L, _ = hidden.shape
    chunk = fit_chunk(L, cfg.loss_chunk)
    lead = hidden.device
    ws = [t["w"].float() for t in u.trees]
    cols = ws[0].shape[1]
    labels_m = [labels.to(d) for d in u.devices]
    total = torch.zeros((), dtype=torch.float32, device=lead)
    for c0 in range(0, L, chunk):
        hs = copy_to_model(hidden[:, c0:c0 + chunk].float(), u.devices)
        lses, golds = [], []
        for m, (h, w, lab) in enumerate(zip(hs, ws, labels_m)):
            logits = h @ w
            lses.append(torch.logsumexp(logits, dim=-1).to(lead))
            local = lab[:, c0:c0 + chunk] - m * cols
            own = (local >= 0) & (local < cols)
            gold = logits.gather(-1, local.clamp(0, cols - 1)[..., None])
            golds.append(torch.where(own, gold[..., 0], 0.0))
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        total = total + (lse - reduce_from_model(golds, lead)).sum()
    return total / (Bsz * L)


def loss_fn_tp(cfg, sp: ShardedParams, batch):
    """The loss over the model axis of one data group."""
    hidden, aux = forward_tp(cfg, sp, batch)
    loss = chunked_xent_tp(cfg, sp, hidden, batch["labels"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return loss + aux_w * aux, {"xent": loss, "aux": aux}
