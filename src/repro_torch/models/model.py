"""Top-level language model: param specs, init, the train-mode forward over
the stacked block periods, and the chunked cross-entropy loss.

The reference scans the periods with ``lax.scan``; here the forward is a
Python loop over them, reading period i of each stacked ``[n_periods, ...]``
leaf. With ``cfg.remat`` each period is rematerialized in the backward, as
the reference's ``jax.checkpoint(..., nothing_saveable)`` does in train
mode: only the period's input is kept. The reference's ``_barrier`` steers
XLA and has no counterpart; grouped remat (``remat_group > 1``) is not
ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.launches import recompute_context
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_embed, apply_rmsnorm, dt, \
    embed_specs, rmsnorm_specs, unembed_specs
from repro_torch.models.params import ShardedInit, fit_chunk, tree_leaves, \
    tree_map, tree_unflatten


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
def embed_inputs(cfg, params, batch) -> torch.Tensor:
    cd = dt(cfg, "compute")
    if cfg.frontend == "embeds":
        return batch["embeds"].to(cd)
    return apply_embed(params["embed"], batch["tokens"], cd)


def forward(cfg, params, batch, *, mode: str = "train"):
    """mode 'train' -> (hidden [B,L,D], aux)."""
    if mode != "train":
        raise NotImplementedError(f"mode {mode!r} is not yet ported")
    if cfg.remat and cfg.remat_group > 1:
        raise NotImplementedError("grouped remat is not yet ported")
    x = embed_inputs(cfg, params, batch)
    Bsz, L, _ = x.shape
    positions = torch.arange(L, device=x.device).expand(Bsz, L)
    slots, n_periods = B.scan_plan(cfg)

    def period(x, p_slots):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (mixer, ffn) in enumerate(slots):
            x, aux = B.block_forward(cfg, p_slots[f"slot{j}"], x, mixer=mixer,
                                     ffn=ffn, positions=positions)
            aux_total = aux_total + aux
        return x, aux_total

    # one unbind per stacked leaf: its backward is a single stack, where
    # indexing each period would scatter into a full-size zero tensor
    periods = tree_map(lambda a: a.unbind(0), params["layers"])
    auxes = []
    for i in range(n_periods):
        p_i = tree_map(lambda t: t[i], periods)
        if cfg.remat:
            x, aux = checkpoint(period, x, p_i, use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=recompute_context)
        else:
            x, aux = period(x, p_i)
        auxes.append(aux)
    x = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.stack(auxes).mean()


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
    hidden, aux = forward(cfg, params, batch, mode="train")
    loss = chunked_xent(cfg, params, hidden, batch["labels"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return loss + aux_w * aux, {"xent": loss, "aux": aux}
