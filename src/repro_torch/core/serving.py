"""The serve loop: batched prefill + decode against the KV/SSM cache.

One wave = prefill a prompt batch by teacher-forcing it through
``serve_step`` (cache construction), then autoregressively decode
``gen_len`` new tokens. This is the unit of work a serving replica does per
request batch; the cluster's serving tier
(``repro_torch.cluster.serving.LiveServingEngine``) calls it, so its
measured wave latency is this code path's. Counterpart of the reference's
``core/serving.py``: the loop is the same, run eagerly under
``torch.inference_mode()`` (no compiled step yet), on the device of the
prompts and params. The params may be a ``parallel.ShardedParams`` over
the model axis of one data group (``trainer_params`` builds it from a
trainer's state): the cache is then split over the group's slots and the
prompts and ids lie on its first slot.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.cache import init_cache, init_cache_shards
from repro_torch.parallel import ShardedParams, model_dims
from repro_torch.training.step import model_shards


def make_decode_fn(cfg):
    """Single-step decode ``(params, batch, cache) -> (ids, cache)`` for a
    tokens-frontend config: ``serve_step`` under ``inference_mode``, with
    ``params`` a tree or a ``ShardedParams``. Build once per replica and
    pass to ``serve_batch``."""
    if cfg.frontend != "tokens":
        raise ValueError(f"{cfg.name}: serving needs a tokens frontend, "
                         f"got {cfg.frontend!r}")

    def decode(params, batch, cache):
        with torch.inference_mode():
            return M.serve_step(cfg, params, batch, cache)
    return decode


def trainer_params(trainer) -> ShardedParams:
    """The params of an ``ElasticTrainer``'s state as a ``ShardedParams``
    over the model axis of its first data group, where the state's model
    shards live: a tenant trained at (p, mp) serves at (1, mp) from them,
    no copy made."""
    ex = trainer.exec
    return ShardedParams([s["params"] for s in model_shards(trainer.state)],
                         model_dims(ex.layout), tuple(ex.devices[:ex.mp]))


def serve_batch(cfg, params, prompts: torch.Tensor, gen_len: int, *,
                decode=None, cache=None):
    """Serve one wave: prefill ``prompts`` ([batch, prompt_len] token ids)
    then decode ``gen_len`` tokens. ``params`` is one tree, on the
    prompts' device, or a ``ShardedParams``: then the prompts are moved to
    its first slot and the cache is split over its slots
    (``init_cache_shards``). Returns ``(generated, cache)`` with
    ``generated`` a [batch, gen_len] int32 tensor of greedy ids; the device
    is synchronized before the return, so wall clock around the call
    measures the wave's true latency."""
    batch, prompt_len = prompts.shape
    if prompt_len < 1 or gen_len < 1:
        raise ValueError(f"need prompt_len >= 1 and gen_len >= 1, got "
                         f"({prompt_len}, {gen_len})")
    if decode is None:
        decode = make_decode_fn(cfg)
    if isinstance(params, ShardedParams):
        prompts = prompts.to(params.devices[0])
        if cache is None:
            cache = init_cache_shards(cfg, batch, prompt_len + gen_len,
                                      params.devices)
    elif cache is None:
        cache = init_cache(cfg, batch, prompt_len + gen_len,
                           device=prompts.device)

    with torch.inference_mode():
        ids = None
        for t in range(prompt_len):
            ids, cache = decode(params, {"tokens": prompts[:, t:t + 1]},
                                cache)
        generated = []
        tok = ids[:, None]
        for _ in range(gen_len):
            ids, cache = decode(params, {"tokens": tok}, cache)
            tok = ids[:, None]
            generated.append(ids)
        out = torch.stack(generated, dim=1)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    return out, cache
