#!/usr/bin/env python3
"""Three probes of the PyTorch port: its serving path, and deepseek's MLA
block.

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
point of ``tests/test_torch_model.py``). A MoE config's reading is also
taken over the held positions alone: in each row, those before the first
token that the teacher-forced pass routed otherwise than the decode did,
or whose claim it dropped (``moe_routes``, ``routing_gap``); and at
"fan_in" from its fp32 control (``fp32_control``: the same params cast to
fp32, capacity_factor E / K, so that no claim drops).

``--part mla``: one MLA attention block of deepseek-v2-236b at its
published widths (149 M parameters), drawn in bf16 from seed 0, forward
and backward at ``--batch`` x ``--seq`` against an fp32 copy of the same
bf16 values: the output, the input's gradient and each weight's gradient
as |bf16 - fp32| / |fp32| in the Frobenius norm; with the bf16 pass's
time and, on the card, its peak memory.

``--src DIR`` imports ``repro_torch`` from another tree (e.g. an earlier
revision unpacked with ``git archive``), so two versions run in one call.
Prints one JSON line per measurement beside the card's name and power
limit. Run from the repo root:

    python3 tools/torch_serve_probe.py --part decode [--src DIR]
    python3 tools/torch_serve_probe.py --part mla [--device cpu] \\
        [--batch 4 --seq 1024]
    python3 tools/torch_serve_probe.py --part tf [--device cpu] \\
        [--points rwkv6-1.6b:bfloat16:256:24,edl-paper:float32:768:12] \\
        [--batch 4 --prompt 32 --gen 32]
"""
import argparse
import contextlib
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
        c = _fan_in(path, t)
        return t * c if c != 1 else t
    return tree_unflatten((p, one(p, t)) for p, t in tree_leaves(params))


def _fan_in(path: str, t) -> float:
    """The factor that takes a stacked layer matrix from std
    1/sqrt(n_periods) to 1/sqrt(d_in); 1 for any other leaf."""
    if path.startswith("layers/") and t.dim() >= 3:
        return math.sqrt(t.shape[0] / t.shape[-2])
    return 1


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


@contextlib.contextmanager
def moe_routes(records: list):
    """Record, for every MoE layer call, its tokens' experts [B, L, K]
    (sorted), whether each token [B, L] lost a claim to the capacity, and
    its kept and made claims, counted from the router weights with
    ``models.moe.route`` (the forward's own routing)."""
    from repro_torch.models import blocks, moe
    specs, forward = blocks.FFNS["moe"]

    def recorded(cfg, p, h, cache=None):
        r = moe.route(cfg, p, h)
        B, L = h.shape[:2]
        lost = (r["pos"] >= r["C"]).reshape(B, L, -1).any(-1)
        records.append({
            "L": L,
            "experts": r["expert"].reshape(B, L, -1).sort(dim=-1).values.cpu(),
            "lost": lost.cpu(),
            "kept": int((r["pos"] < r["C"]).sum()), "made": r["pos"].numel()})
        return forward(cfg, p, h, cache)
    blocks.FFNS["moe"] = (specs, recorded)
    try:
        yield
    finally:
        blocks.FFNS["moe"] = (specs, forward)


def routing_gap(torch, records: list):
    """The teacher-forced pass's routing against the decode's (one MoE
    layer call each for the pass, then one a MoE layer for each decoded
    token): claims dropped in each, and the (token, MoE layer) pairs whose
    experts differ. Returns (a record, whether each token [B, T] was routed
    otherwise or lost a claim in the teacher-forced pass, in some layer)."""
    train = [r for r in records if r["L"] > 1]
    dec = [r for r in records if r["L"] == 1]
    n_moe, T = len(train), train[0]["L"]
    flips, flagged = 0, None
    for layer, r in enumerate(train):
        steps = torch.stack([dec[t * n_moe + layer]["experts"][:, 0]
                             for t in range(T)], dim=1)
        differ = (steps != r["experts"]).any(-1)
        flips += int(differ.sum())
        differ = differ | r["lost"]
        flagged = differ if flagged is None else flagged | differ
    return {"dropped_claims": sum(r["made"] - r["kept"] for r in train),
            "decode_dropped_claims": sum(r["made"] - r["kept"] for r in dec),
            "claims": sum(r["made"] for r in train),
            "tokens_routed_otherwise": flips,
            "token_layers": sum(r["experts"].shape[0] * T for r in train)}, \
        flagged


def held_gap(torch, gaps, flagged) -> tuple[float, float]:
    """The largest of ``gaps`` [B, T] over the held positions, those before
    each row's first ``flagged`` token, and their share of all positions
    (nan where none is held)."""
    gaps, flagged = gaps.cpu(), flagged.cpu()
    T = gaps.shape[1]
    first = torch.where(flagged.any(1), flagged.float().argmax(1),
                        torch.full_like(flagged[:, 0], T, dtype=torch.long))
    held = torch.arange(T)[None, :] < first[:, None]
    gap = float(gaps[held].max()) if held.any() else math.nan
    return gap, float(held.float().mean())


def moe_decode_gaps(torch, cfg, params, tokens, prompt_len: int) -> dict:
    """``decode_gaps`` of a MoE config with its routing recorded: the gap
    over every position, over the held positions and their share, and the
    routing record."""
    records: list = []
    with moe_routes(records):
        gaps, _ = decode_gaps(cfg, params, tokens, prompt_len)
    rec, flagged = routing_gap(torch, records)
    held, share = held_gap(torch, gaps, flagged)
    return dict(rec, teacher_forcing=float(gaps.max()), held=held,
                held_share=share)


def fp32_control(cfg, params: dict):
    """A MoE config's control: (``cfg`` in fp32 with capacity_factor E / K,
    so that a group's capacity is all its tokens and no claim drops;
    ``params`` cast to fp32 and rescaled to fan_in). Each leaf of
    ``params`` is replaced as it is cast, so the old copy is freed leaf by
    leaf (a bf16 model and its fp32 copy need not fit at once) and the
    caller's tree becomes the control's."""
    import torch

    from repro_torch.models.params import tree_leaves
    m = cfg.moe
    ctl = dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k))
    # the paths only: a list of the leaves would keep every old one alive
    for path in [p for p, _ in tree_leaves(params)]:
        *parents, last = path.split("/")
        node = params
        for k in parents:
            node = node[k]
        t = node.pop(last)
        node[last] = t.to(torch.float32, copy=True).mul_(_fan_in(path, t))
        del t
    return ctl, params


def mla_block(torch, device, batch: int, seq: int, reps: int = 3) -> dict:
    """deepseek-v2-236b's MLA block (``attention.mla_forward``, train mode)
    at ``batch`` x ``seq``: bf16 params and input from seed 0, forward and
    backward of sum(out * r) for a seeded r, against an fp32 copy of the
    same values. Returns the norm-wise errors of the output, the input's
    gradient (``x``) and every weight's gradient (``grads``, and their
    largest ``grad_max``), the bf16 pass's median ms of ``reps`` and its
    peak GiB (card only)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.params import tree_leaves, tree_unflatten
    cfg = get_config("deepseek-v2-236b")
    gen = torch.Generator().manual_seed(0)
    specs = tree_leaves(attention.mla_specs(cfg))
    p16 = tree_unflatten((k, s.materialize(gen, torch.bfloat16, device))
                         for k, s in specs)
    x16 = torch.randn((batch, seq, cfg.d_model), generator=gen).to(
        device, torch.bfloat16)
    r = torch.randn((batch, seq, cfg.d_model), generator=gen).to(device)
    pos = torch.arange(seq, device=device).expand(batch, seq)
    cuda = torch.device(device).type == "cuda"

    def run(c, dtype):
        def leaf(t):
            return t.to(dtype, copy=True).requires_grad_(True)
        ps = tree_unflatten((k, leaf(t)) for k, t in tree_leaves(p16))
        x = leaf(x16)
        out, _ = attention.mla_forward(c, ps, x, positions=pos)
        (out.float() * r).sum().backward()
        return out.detach().float(), x.grad.float(), {
            k: t.grad.float() for k, t in tree_leaves(ps)}
    if cuda:
        run(cfg, torch.bfloat16)                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(reps):
        t0 = time.monotonic()
        out, gx, grads = run(cfg, torch.bfloat16)
        if cuda:
            torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    out32, gx32, grads32 = run(dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"), torch.float32)

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    errs = {k: rel(grads[k], g) for k, g in grads32.items()}
    params = sum(t.numel() for _, t in tree_leaves(p16))
    return {"batch": batch, "seq": seq, "params": params,
            "out": rel(out, out32), "x": rel(gx, gx32), "grads": errs,
            "grad_max": max(errs.values()), "ms": sorted(ms)[len(ms) // 2],
            "peak_gib": peak}


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
        if cfg.moe:
            r = moe_decode_gaps(torch, cfg, ps, tokens, prompt)
            rec[name], rec[f"{name}_moe"] = r["teacher_forcing"], r
        else:
            rec[name], _ = teacher_forced(cfg, ps, tokens, prompt)
        del ps
    if cfg.moe:
        ctl, ps = fp32_control(cfg, params)
        rec["fp32_control"] = moe_decode_gaps(torch, ctl, ps, tokens, prompt)
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
    ap.add_argument("--part", choices=("decode", "tf", "mla"), required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the tree whose repro_torch is imported")
    ap.add_argument("--max-seqs", default="128,2048")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--points", default=DEFAULT_POINTS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--prompt", type=int, default=PROMPT)
    ap.add_argument("--gen", type=int, default=GEN)
    ap.add_argument("--seq", type=int, default=1024)
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
    if args.part == "mla":
        rec = mla_block(torch, args.device, args.batch, args.seq)
        print(json.dumps({"mla_block": rec, "card": card}), flush=True)
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
