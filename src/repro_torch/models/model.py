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
``_barrier`` steers XLA and has no counterpart. The default train step
hands in ``parallel.FsdpParams``, whose period i is gathered over the
data axis when the loop reads it, inside the checkpointed function, as
the reference's scan gathers each period's FSDP boxes in its body.

There is one path: ``forward_tp`` and ``loss_fn_tp`` run over the model
axis of one data group (``parallel.ShardedParams``) — vocab-parallel
embedding, tensor-parallel blocks, and a vocab-parallel unembedding and
cross-entropy at the same ``loss_chunk`` — and each leaf the layout leaves
whole runs its plain layer. ``forward``, ``prefill``, ``serve_step`` and
``loss_fn`` take the params as one tree (the one shard of mp = 1, where
every leaf is whole) or as a ``ShardedParams``. Prefill and decode run
at any mp, as training does: decode takes the cache as one tree at mp = 1
or split over the model axis
(``models/cache.py: init_cache_shards``), hands period i a view of row i
of each stacked cache leaf (each shard's part of it), which its blocks
write in place, and advances ``pos`` (on the first slot) in place: a
token moves its own slots of the cache, where the reference's scan
returns a new one. Their logits come from the vocab-parallel unembedding:
shard m forms its V/mp columns and ``gather_from_model`` puts them side by
side on the first slot, [B, V] floats, where joining the ``[D, V]``
matrix there (``whole()``) would move D/B times as many bytes every step.

In train mode with an ``rng`` key and ``cfg.dropout > 0`` the embedded
input is dropped as the reference drops it, with its threefry bits
(``prng.bernoulli``). With a ``routing`` plan (``route_globally``) each MoE
layer routes its part of the global batch as the reference routes the
whole (``models/moe.py: Share``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels.launches import remat
from repro_torch.models import blocks as B
from repro_torch.models import moe
from repro_torch.models.layers import apply_embed_tp, apply_linear, \
    apply_rmsnorm, dt, embed_specs, rmsnorm_specs, unembed_specs
from repro_torch.models.params import ShardedInit, fit_chunk, tree_leaves, \
    tree_map, tree_unflatten
from repro_torch.parallel import ShardedParams, copy_to_model, \
    gather_from_model, reduce_from_model, send


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


def sharded(tree) -> ShardedParams:
    """``tree`` as a ``ShardedParams``: itself if it is one, else the one
    shard of mp = 1."""
    return tree if isinstance(tree, ShardedParams) else ShardedParams.one(
        tree)


def forward(cfg, params, batch, *, mode: str = "train", cache=None,
            rng=None, routing=None):
    """mode 'train' -> (hidden [B,L,D], aux); 'prefill' -> (last-position
    logits [B,V] fp32, aux); 'decode' -> (logits [B,1,V] fp32, cache), the
    cache updated in place: ``forward_tp`` on ``params``, one tree (the
    one shard of mp = 1) or a ``ShardedParams``. The outputs lie on the
    first slot."""
    return forward_tp(cfg, sharded(params), batch, mode=mode, cache=cache,
                      rng=rng, routing=routing)


def prefill(cfg, params, batch):
    """The last prompt position's logits [B,V] (fp32), no cache."""
    logits, _ = forward(cfg, params, batch, mode="prefill")
    return logits


def serve_step(cfg, params, batch, cache):
    """ONE new token against the cache (one tree, or split over the model
    axis as ``params`` is), which it updates in place. Returns
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


def loss_fn(cfg, params, batch, *, rng=None, routing=None):
    """``loss_fn_tp`` on ``params``, one tree or a ``ShardedParams``."""
    return loss_fn_tp(cfg, sharded(params), batch, rng=rng, routing=routing)


# ------------------------------------------------------- over the model axis
def embed_tp(cfg, sp: ShardedParams, batch, rng=None) -> torch.Tensor:
    """The model's input [B, L, D] in the compute dtype on the first slot:
    the ``embeds`` as given, or the vocab-parallel embedding of the
    ``tokens``; with an ``rng`` key and ``cfg.dropout > 0``, dropped as the
    reference drops it (``where(mask, x / keep, 0)`` in x's dtype, the mask
    ``bernoulli(rng, keep)``)."""
    cd = dt(cfg, "compute")
    if cfg.frontend == "embeds":
        x = batch["embeds"].to(cd)
    else:
        x = apply_embed_tp(sp["embed"], batch["tokens"], cd)
    if rng is not None and cfg.dropout > 0.0:
        keep = 1.0 - cfg.dropout
        mask = prng.bernoulli(rng.to(x.device), keep, tuple(x.shape))
        x = torch.where(mask, x / torch.tensor(keep, dtype=x.dtype,
                                               device=x.device),
                        torch.zeros((), dtype=x.dtype, device=x.device))
    return x


def forward_tp(cfg, sp: ShardedParams, batch, *, mode: str = "train",
               cache=None, rng=None, routing: dict | None = None):
    """The forward over the model axis of one data group; ``batch`` lies on
    the group's first slot, which carries the residual stream. Returns
    (hidden [B,L,D], aux) in train mode; prefill and decode as
    ``forward``, decode against ``cache`` (one tree at mp = 1, or a
    ``ShardedParams`` split over the group's slots). Remat applies in
    train mode only, as in the reference. In train mode ``rng`` keys the
    input's dropout and ``routing`` (``route_globally``'s plan of this
    group: an ``moe.Share`` by (period, slot)) routes each MoE layer over
    the global batch."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, not {mode!r}")
    if (mode == "decode") != (cache is not None):
        raise ValueError("decode takes a cache, and only decode does")
    sc = None if cache is None else sharded(cache)
    if sc is not None and sc.mp != sp.mp:
        raise ValueError(f"a cache split {sc.mp} ways for params split "
                         f"{sp.mp} ways")
    train = mode == "train"
    x = embed_tp(cfg, sp, batch, rng if train else None)
    routing = (routing or {}) if train else {}
    Bsz, L, _ = x.shape
    if mode == "decode":
        positions = sc.trees[0]["pos"].expand(Bsz, 1)
    else:
        positions = torch.arange(L, device=x.device).expand(Bsz, L)
    slots, n_periods = B.scan_plan(cfg)

    def period(x, p_i, i: int, c_i: ShardedParams | None = None):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (mixer, ffn) in enumerate(slots):
            x, aux = B.block_forward(
                cfg, p_i[f"slot{j}"], x, mixer=mixer, ffn=ffn,
                positions=positions,
                cache=None if c_i is None else c_i[f"slot{j}"],
                share=routing.get((i, j)))
            aux_total = aux_total + aux
        return x, aux_total

    # period i's params are read inside the function that remat
    # checkpoints, so a form that gathers them on use (``parallel.
    # FsdpGroup``) gathers them there and again in the recomputation
    periods = sp["layers"].periods()

    def period_at(x, i: int):
        return period(x, periods[i], i)

    def body(x, i: int):
        return remat(period_at, x, i) if train and cfg.remat else \
            period_at(x, i)

    def group(x, g0: int):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(g0, g0 + g):
            x, aux = body(x, i)
            aux_total = aux_total + aux
        return x, aux_total

    g = max(1, cfg.remat_group)
    auxes = []
    if (cfg.scan_layers and train and g > 1 and n_periods % g == 0
            and n_periods // g > 1):
        # grouped remat, the reference's condition and aux: the mean over
        # groups of each group's summed aux, over g
        for g0 in range(0, n_periods, g):
            x, aux = remat(group, x, g0)
            auxes.append(aux)
        aux = torch.stack(auxes).mean() / g
    else:
        rows = sc["layers"].periods() if mode == "decode" else None
        for i in range(n_periods):
            if mode == "decode":
                x, aux = period(x, periods[i], i, rows[i])
            else:
                x, aux = body(x, i)
            auxes.append(aux)
        aux = torch.stack(auxes).mean()
    x = apply_rmsnorm(sp["final_norm"].whole(), x, cfg.norm_eps)
    if train:
        return x, aux
    if mode == "prefill":
        return unembed_tp(sp["unembed"], x[:, -1]), aux
    logits = unembed_tp(sp["unembed"], x)
    sc.trees[0]["pos"].add_(1)
    return logits, cache


def unembed_tp(u: ShardedParams, x: torch.Tensor) -> torch.Tensor:
    """The fp32 logits of ``x`` on its slot (the first): vocab-parallel,
    shard m's V/mp columns gathered in shard order, or the whole matrix
    where the rules left it replicated."""
    if not u.split():
        return apply_linear(u.whole(), x, torch.float32)
    return gather_from_model(
        [apply_linear(t, xm, torch.float32)
         for t, xm in zip(u.trees, copy_to_model(x, u.devices))], x.device)


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
            lses.append(send(torch.logsumexp(logits, dim=-1), lead, m, 0,
                             "xent_lse"))
            local = lab[:, c0:c0 + chunk] - m * cols
            own = (local >= 0) & (local < cols)
            gold = logits.gather(-1, local.clamp(0, cols - 1)[..., None])
            golds.append(torch.where(own, gold[..., 0], 0.0))
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        total = total + (lse - reduce_from_model(golds, lead)).sum()
    return total / (Bsz * L)


def loss_fn_tp(cfg, sp: ShardedParams, batch, *, rng=None, routing=None):
    """The loss over the model axis of one data group (``rng`` and
    ``routing`` as in ``forward_tp``)."""
    hidden, aux = forward_tp(cfg, sp, batch, rng=rng, routing=routing)
    loss = chunked_xent_tp(cfg, sp, hidden, batch["labels"])
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return loss + aux_w * aux, {"xent": loss, "aux": aux}


# ------------------------------------------- MoE routed over the data axis
def route_globally(cfg, groups: list[ShardedParams], batches: list[dict],
                   p: int) -> list[dict]:
    """Each data group's plan for routing every MoE layer over the global
    batch as the reference does (``moe.Share`` by (period, slot)), from a
    forward of the groups in lockstep without autograd: at each MoE layer
    every group routes its part (``moe.route``), ``moe.share_out`` fills
    the shares from all their claims, and each group runs the layer with
    its share before any goes on, since the claims a layer drops shape the
    next layer's input. It ends after the last MoE layer. ``groups`` and
    ``batches`` are data groups 0 .. len(groups) - 1 of ``p`` (their
    params, and their shards of the batch on their first slots); the claims
    of the groups past them are stand-ins of their shapes, all zero (the
    dry-run walks group 0 alone). Groups given one params object read
    each period once (on one card the step gives all of them one), and
    only the period that runs is held (``parallel.FsdpGroup`` gathers it
    on use)."""
    slots, n_periods = B.scan_plan(cfg)
    at = [(i, j) for i in range(n_periods)
          for j, (_, ffn) in enumerate(slots) if ffn == "moe"]
    plans: list[dict] = [{} for _ in groups]
    if not at:
        return plans
    with torch.no_grad():
        xs = [embed_tp(cfg, sp, b) for sp, b in zip(groups, batches)]
        n = xs[0].shape[0] * xs[0].shape[1]
        home = xs[0].device
        positions = [torch.arange(x.shape[1], device=x.device).expand(
            x.shape[0], x.shape[1]) for x in xs]
        # one sequence of periods for each params object: groups that
        # share one read (and gather) each period once
        layers = {id(sp): sp["layers"].periods() for sp in groups}

        def walk(i: int) -> bool:
            """Period i of every group, in lockstep; True at the last MoE
            layer. Its params go when it returns."""
            rows = {k: per[i] for k, per in layers.items()}
            periods = [rows[id(sp)] for sp in groups]
            for j, (mixer, ffn) in enumerate(slots):
                blocks = [p_i[f"slot{j}"] for p_i in periods]
                hs = []
                for d, blk in enumerate(blocks):
                    xs[d], h = B.block_mix(cfg, blk, xs[d], mixer=mixer,
                                           positions=positions[d])
                    hs.append(h)
                shares = [None] * len(blocks)
                if ffn == "moe":
                    shares = [moe.Share(n * p, d * n) for d in range(p)]
                    claims = [moe.route(cfg, blk["ffn"].trees[0], h,
                                        sh)["claims"]
                              for blk, h, sh in zip(blocks, hs, shares)]
                    K, E = claims[0].shape[1:]
                    claims += [torch.zeros((sh.groups(n)[2], K, E),
                                           dtype=torch.int32, device=home)
                               for sh in shares[len(blocks):]]
                    moe.share_out(shares, claims, home)
                    for plan, sh in zip(plans, shares):
                        plan[(i, j)] = sh
                    if (i, j) == at[-1]:
                        return True
                for d, blk in enumerate(blocks):
                    xs[d] = xs[d] + B.block_ffn(cfg, blk, hs[d], ffn=ffn,
                                                share=shares[d])[0]
            return False

        for i in range(n_periods):
            if walk(i):
                break
    return plans
