"""Top-level language model: param specs, init, the forward over the
stacked block periods (train / prefill / decode), the chunked cross-entropy
loss, and the serving entry points ``prefill`` and ``serve_step``.

The reference scans the periods with ``lax.scan``; here the forward is a
Python loop over them, reading period i of each stacked ``[n_periods, ...]``
leaf. With ``cfg.remat`` each period is rematerialized in the backward, as
the reference's ``jax.checkpoint(..., nothing_saveable)`` does in train
mode: only the period's input is kept. Grouped remat (``remat_group = g
> 1``, under the reference's condition) checkpoints groups of g periods,
each period's own checkpoint nested inside, so only every g-th period's
input is kept between the forward and the backward. The reference's
``_barrier`` steers XLA and has no counterpart.

There is one path: ``forward_tp`` and ``loss_fn_tp`` run over the model
axis of one data group (``parallel.ShardedParams``) — vocab-parallel
embedding, tensor-parallel blocks, and a vocab-parallel unembedding and
cross-entropy at the same ``loss_chunk`` — and each leaf the layout leaves
whole runs its plain layer. ``forward`` and ``loss_fn`` call them on the
one shard of mp = 1, where every leaf is whole. The prefill and decode
modes run at mp = 1, where the reference's live serving engine runs; at
mp > 1 they raise (ROADMAP A7). Decode hands period i a view of row i of
each stacked cache leaf, which its blocks write in place, and advances
``pos`` in place: a token moves its own slots of the cache, where the
reference's scan returns a new one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.launches import remat
from repro_torch.models import blocks as B
from repro_torch.models.layers import apply_embed_tp, apply_linear, \
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
    """Draw every leaf, in sorted-path order, from ``generator`` (with a
    CPU generator the values do not depend on ``device``; see
    ``ShardedInit.materialize``)."""
    dtype = dt(cfg, "param")
    return tree_unflatten(
        (path, spec.materialize(generator, dtype, torch.device(device)))
        for path, spec in tree_leaves(param_spec_tree(cfg)))


# ------------------------------------------------------------------ forward
MODES = ("train", "prefill", "decode")


def forward(cfg, params, batch, *, mode: str = "train", cache=None):
    """mode 'train' -> (hidden [B,L,D], aux); 'prefill' -> (last-position
    logits [B,V] fp32, aux); 'decode' -> (logits [B,1,V] fp32, cache), the
    cache updated in place: ``forward_tp`` on the one shard of mp = 1."""
    return forward_tp(cfg, ShardedParams.one(params), batch, mode=mode,
                      cache=cache)


def prefill(cfg, params, batch):
    """The last prompt position's logits [B,V] (fp32), no cache."""
    logits, _ = forward(cfg, params, batch, mode="prefill")
    return logits


def serve_step(cfg, params, batch, cache):
    """ONE new token against the cache, which it updates in place. Returns
    (next_token_ids [B] int32, cache)."""
    logits, cache = forward(cfg, params, batch, mode="decode", cache=cache)
    return logits[:, -1].argmax(dim=-1).to(torch.int32), cache


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
def forward_tp(cfg, sp: ShardedParams, batch, *, mode: str = "train",
               cache=None):
    """The forward over the model axis of one data group; ``batch`` lies on
    the group's first slot, which carries the residual stream. Returns
    (hidden [B,L,D], aux) in train mode; prefill and decode (mp = 1 only)
    as ``forward``. Remat applies in train mode only, as in the
    reference."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if mode != "train" and sp.mp > 1:
        raise NotImplementedError(
            f"{mode} at model_parallel={sp.mp} is not yet ported (ROADMAP "
            f"A7); serving runs at mp = 1")
    if (mode == "decode") != (cache is not None):
        raise ValueError("decode takes a cache, and only decode does")
    train = mode == "train"
    cd = dt(cfg, "compute")
    if cfg.frontend == "embeds":
        x = batch["embeds"].to(cd)
    else:
        x = apply_embed_tp(sp["embed"], batch["tokens"], cd)
    Bsz, L, _ = x.shape
    if mode == "decode":
        positions = cache["pos"].expand(Bsz, 1)
    else:
        positions = torch.arange(L, device=x.device).expand(Bsz, L)
    slots, n_periods = B.scan_plan(cfg)

    def period(x, p_i, c_i=None):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (mixer, ffn) in enumerate(slots):
            x, aux = B.block_forward(
                cfg, p_i[f"slot{j}"], x, mixer=mixer, ffn=ffn,
                positions=positions,
                cache=None if c_i is None else c_i[f"slot{j}"])
            aux_total = aux_total + aux
        return x, aux_total

    def body(x, p_i):
        return remat(period, x, p_i) if train and cfg.remat else \
            period(x, p_i)

    def group(x, *p_group):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for p_i in p_group:
            x, aux = body(x, p_i)
            aux_total = aux_total + aux
        return x, aux_total

    periods = sp["layers"].periods()
    g = max(1, cfg.remat_group)
    auxes = []
    if (cfg.scan_layers and train and g > 1 and n_periods % g == 0
            and n_periods // g > 1):
        # grouped remat, the reference's condition and aux: the mean over
        # groups of each group's summed aux, over g
        for g0 in range(0, n_periods, g):
            x, aux = remat(group, x, *periods[g0:g0 + g])
            auxes.append(aux)
        aux = torch.stack(auxes).mean() / g
    else:
        for i, p_i in enumerate(periods):
            if mode == "decode":
                x, aux = period(x, p_i, tree_map(lambda a: a[i],
                                                 cache["layers"]))
            else:
                x, aux = body(x, p_i)
            auxes.append(aux)
        aux = torch.stack(auxes).mean()
    x = apply_rmsnorm(sp["final_norm"].whole(), x, cfg.norm_eps)
    if train:
        return x, aux
    unembed = sp["unembed"].whole()
    if mode == "prefill":
        return apply_linear(unembed, x[:, -1], torch.float32), aux
    logits = apply_linear(unembed, x, torch.float32)
    cache["pos"].add_(1)
    return logits, cache


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
