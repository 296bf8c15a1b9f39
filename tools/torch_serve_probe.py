#!/usr/bin/env python3
"""Two probes of the PyTorch port's serving path.

``--part decode`` (card only): full-width edl_paper (fp32) decode at batch 8
against caches of ``--max-seqs`` slots (default 128 and 2048), each filled
to position 64. After one untimed step it times ``--steps`` steps with a host
clock around work that ends in ``torch.cuda.synchronize()``, then traces as
many more with ``torch.profiler``: kernels a step, the device's busy time a
step (the union of kernel intervals) and its idle share, and the peak of
allocated device memory over the traced steps above what was allocated
before them. A decode step that copied its whole cache would add
device time and memory in proportion to the cache; one that writes its own
slots adds only the reads of ``decode_attention``.

``--part tf``: teacher forcing at each of ``--points``
(``ARCH:DTYPE:D_MODEL:N_LAYERS``, comma-separated; the full configs at
other widths and depths, KV heads and ``d_ff`` in proportion to the
width).
For each point it draws params from seed 0 and ``--batch`` prompts of
``--prompt`` tokens (8 and 64) from seed 1, lets ``serve_batch`` generate
``--gen`` (64) more (an ``embeds`` config takes that many seeded
embeddings instead), and holds the decode's logits over those tokens
against the train-mode forward's: max |diff| over max |train-mode logit|,
as ``chip_smoke.py`` phases 10 and 11 do. It does so at the reference's
init, whose stacked layer matrices have std 1/sqrt(n_periods), and with
them rescaled to 1/sqrt(d_in) (``fan_in_scaled``, the well-conditioned
point of ``tests/test_torch_model.py``).

``--src DIR`` imports ``repro_torch`` from another tree (e.g. an earlier
revision unpacked with ``git archive``), so two versions run in one call.
Prints one JSON line per measurement beside the card's name and power
limit. Run from the repo root:

    python3 tools/torch_serve_probe.py --part decode [--src DIR]
    python3 tools/torch_serve_probe.py --part tf [--device cpu] \\
        [--points rwkv6-1.6b:bfloat16:256:24,edl-paper:float32:768:12] \\
        [--batch 4 --prompt 32 --gen 32]
"""
import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

BATCH, PROMPT, GEN = 8, 64, 64
DEFAULT_POINTS = ",".join(
    ["edl-paper:float32:768:12"]
    + [f"rwkv6-1.6b:bfloat16:2048:{n}" for n in (1, 4, 8, 24)]
    + [f"rwkv6-1.6b:bfloat16:{d}:24" for d in (256, 512, 1024)]
    + [f"rwkv6-1.6b:float32:{d}:{n}"
       for d, n in ((2048, 4), (2048, 24), (256, 24))])


def fan_in_scaled(params: dict) -> dict:
    """``params`` with every stacked layer matrix ``[n_periods, d_in,
    d_out]`` (and every stacked expert matrix ``[n_periods, E, d_in,
    d_out]``) rescaled from the reference's std 1/sqrt(n_periods) to
    1/sqrt(d_in); the other leaves are shared."""
    from repro_torch.models.params import tree_leaves, tree_unflatten

    def one(path, t):
        if path.startswith("layers/") and t.dim() >= 3:
            return t * math.sqrt(t.shape[0] / t.shape[-2])
        return t
    return tree_unflatten((p, one(p, t)) for p, t in tree_leaves(params))


def inputs(cfg, x) -> dict:
    """The model's input dict for ``x``: token ids [B, T], or embeddings
    [B, T, D] for an ``embeds`` frontend."""
    return {"embeds" if cfg.frontend == "embeds" else "tokens": x}


def decode_gaps(cfg, params, tokens, prompt_len: int):
    """Decode ``tokens`` (ids [B, T], or embeddings [B, T, D] for an
    ``embeds`` frontend) one at a time from a fresh cache against the
    train-mode forward over all of them (remat off: the same math).
    Returns (max |diff| at each position [B, T] over max |train-mode
    logit|, the decode's logits after the first ``prompt_len`` tokens)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.cache import init_cache
    B, T = tokens.shape[:2]
    with torch.inference_mode():
        hidden, _ = M.forward(dataclasses.replace(cfg, remat=False), params,
                              inputs(cfg, tokens))
        ref = hidden.float() @ params["unembed"]["w"].float()
        del hidden
        cache = init_cache(cfg, B, T, device=tokens.device)
        err = torch.zeros((B, T), device=tokens.device)
        after_prompt = None
        for t in range(T):
            lg, cache = M.forward(cfg, params, inputs(cfg, tokens[:, t:t + 1]),
                                  mode="decode", cache=cache)
            err[:, t] = (lg[:, 0] - ref[:, t]).abs().amax(-1)
            if t == prompt_len - 1:
                after_prompt = lg[:, 0]
    return err / ref.abs().max(), after_prompt


def teacher_forced(cfg, params, tokens, prompt_len: int):
    """``decode_gaps`` at its largest: (max |diff| / max |train-mode
    logit| over every position, the decode's logits after the first
    ``prompt_len`` tokens)."""
    gaps, after_prompt = decode_gaps(cfg, params, tokens, prompt_len)
    return float(gaps.max()), after_prompt


def point_config(arch: str, dtype: str, d_model: int, n_layers: int):
    """The full config of ``arch`` at another width and depth: KV heads
    (at least one), ``d_ff`` and the experts' ``d_ff`` scale with
    ``d_model``; the head width and the q heads a KV head stay."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)

    def scaled(n):
        return n * d_model // cfg.d_model
    kv = max(1, scaled(cfg.n_kv_heads))
    moe = cfg.moe and dataclasses.replace(
        cfg.moe, d_ff_expert=scaled(cfg.moe.d_ff_expert))
    return dataclasses.replace(
        cfg, d_model=d_model, n_layers=n_layers,
        n_heads=kv * (cfg.n_heads // cfg.n_kv_heads), n_kv_heads=kv,
        d_ff=scaled(cfg.d_ff), moe=moe, head_dim=cfg.resolved_head_dim,
        param_dtype=dtype, compute_dtype=dtype)


def served_inputs(torch, cfg, params, batch: int, prompt: int, gen: int):
    """The inputs a teacher-forcing reading decodes: ``batch`` prompts of
    ``prompt`` ids from seed 1 and the ``gen`` ids ``serve_batch``
    generates after them; for an ``embeds`` frontend (no generation from
    ids), ``prompt + gen`` embeddings from seed 1, std 0.02 as the
    reference's tests draw them."""
    from repro_torch.core import make_decode_fn, serve_batch
    device = next(iter(params["unembed"].values())).device
    gen_ = torch.Generator().manual_seed(1)
    if cfg.frontend == "embeds":
        x = torch.randn((batch, prompt + gen, cfg.d_model), generator=gen_)
        return (x * 0.02).to(device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen_,
                            dtype=torch.int32).to(device)
    ids, _ = serve_batch(cfg, params, prompts, gen,
                         decode=make_decode_fn(cfg))
    return torch.cat([prompts, ids], dim=1)


def tf_point(torch, spec: str, device: str, batch: int, prompt: int,
             gen: int) -> dict:
    from repro_torch.models import model as M
    arch, dtype, d_model, n_layers = spec.split(":")
    cfg = point_config(arch, dtype, int(d_model), int(n_layers))
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = served_inputs(torch, cfg, params, batch, prompt, gen)
    rec = {"point": spec, "batch": batch, "prompt": prompt, "gen": gen}
    for name, ps in (("init", params), ("fan_in", fan_in_scaled(params))):
        rec[name], _ = teacher_forced(cfg, ps, tokens, prompt)
        del ps
    return rec


def decode_at(torch, cfg, params, max_seq: int, steps: int) -> dict:
    from repro_torch.core import make_decode_fn
    from repro_torch.models.cache import cache_bytes, init_cache
    from torch.profiler import ProfilerActivity, profile
    from torch_step_profile import kernel_breakdown
    decode = make_decode_fn(cfg)
    cache = init_cache(cfg, BATCH, max_seq, pos=PROMPT, device="cuda")
    tok = torch.zeros((BATCH, 1), dtype=torch.int32, device="cuda")

    def run(n):
        nonlocal cache, tok
        for _ in range(n):
            ids, cache = decode(params, {"tokens": tok}, cache)
            tok = ids[:, None]
        torch.cuda.synchronize()
    run(1)
    t0 = time.monotonic()
    run(steps)
    wall_ms = (time.monotonic() - t0) * 1e3 / steps
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(ROOT, "build", "profile", f"decode_{max_seq}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    prof.export_chrome_trace(path)
    bd = kernel_breakdown(path)
    return {"max_seq": max_seq, "cache_bytes": cache_bytes(cfg, BATCH,
                                                           max_seq),
            "steps": steps, "wall_ms_per_step": wall_ms,
            "kernels_per_step": bd["n_kernels"] / steps,
            "busy_ms_per_step": bd["busy_ms"] / steps,
            "idle_share": bd["idle_share"],
            "kernel_ms_per_step": {k: v / steps
                                   for k, v in bd["kernel_ms"].items()},
            "peak_above_start_mib": (torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 20}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("decode", "tf"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch is imported")
    ap.add_argument("--max-seqs", default="128,2048")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--points", default=DEFAULT_POINTS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--prompt", type=int, default=PROMPT)
    ap.add_argument("--gen", type=int, default=GEN)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    if args.part == "decode":
        if args.device == "cpu":
            print("--part decode measures the card", file=sys.stderr)
            return 1
        from repro_torch.configs import get_config
        from repro_torch.models import model as M
        cfg = get_config("edl-paper")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for s in args.max_seqs.split(","):
            rec = decode_at(torch, cfg, params, int(s), args.steps)
            print(json.dumps({"decode": rec, "src": args.src,
                              "card": card}), flush=True)
            torch.cuda.empty_cache()
        return 0
    for spec in args.points.split(","):
        t0 = time.monotonic()
        rec = tf_point(torch, spec, args.device, args.batch, args.prompt,
                       args.gen)
        rec["seconds"] = time.monotonic() - t0
        print(json.dumps({"teacher_forcing": rec, "card": card}), flush=True)
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
