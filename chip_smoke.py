#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them;
2. build: compile every kernel source under ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, one nvcc per source, all started together;
3. attention kernels: call each flash-attention kernel's wrapper on CUDA
   tensors at the edl_paper path's shape and at GQA, window, ragged,
   non-causal, head-dim and bf16 cases, and hold it against its plain
   PyTorch version on the same inputs; run the backward pair twice on the
   main and GQA cases and require the same bits; time kernel, plain
   version and ``F.scaled_dot_product_attention`` (a yardstick only: the
   port never calls it), and the backward pair against SDPA's backward
   under its default and under each backend that takes fp32
   (``EFFICIENT_ATTENTION``, ``MATH``; the others are recorded as
   refusing), naming the default's backend by its time;
4. edl_paper path: ``repro_torch.launch.train.main`` trains the full-width
   ``edl_paper`` decoder through a stop-free scale-out;
5. WKV6 kernels: call each WKV6 kernel's wrapper at the rwkv6 path's shape
   (one slot shard at p = 1 and at p = 2), at ragged L, at RWKV6's training
   context, at extreme decays and at head dims 16, 32 and 64, with nonzero
   s0 and dsT, inputs drawn from a seeded CPU generator, and hold it against
   its plain PyTorch version on the same inputs; time kernel and plain
   version (no single PyTorch call computes WKV6);
6. rwkv6 path: ``repro_torch.launch.train.main`` trains the full-width
   ``rwkv6_1p6b`` (bf16, remat) through a stop-free scale-out, timing the
   host-side init of its parameters; then the same trainer refits one batch
   four times, and its loss must fall at every step; a held-out batch's
   loss must stay above the tokens' entropy less a margin; and one slot
   shard's loss and gradients must be the same with remat on and off.

Each path runs with the launch counts reset just before and read just after;
the loss must be finite, the scale-out commit stop-free, the data
exactly-once, every kernel of the path launched and no other. On the
edl_paper path the last loss must be below the first; on the rwkv6 path,
where from the reference's init the loss of fresh noise tokens rises in
the JAX trainer as in the port, the refit and held-out checks take its
place. The launches
made by the context preps' warm-ups are counted apart, the rest is divided
by the slot shards stepped, and both must equal what the code predicts: one
launch of each kernel per layer for each shard's forward and backward, with
remat's recomputation a second forward launch. Then print
``{"backward_pair": {...}}`` (the two backward kernels together against
SDPA's backward), ``{"kernels": [...]}``, the paths' step times, the card
line, and last
``{"ok": true, "device": {...}}``.

Peaks for the bounds are NVIDIA's published H100 SXM figures at 700 W.
"""
import contextlib
import gc
import io
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FP32_FLOPS = 67e12      # H100 SXM, fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12   # H100 SXM HBM3
ATT = {"source": "src/repro_torch/kernels/csrc/flash_attn.cu",
       "replaces": "src/repro/kernels/attention/kernel.py:85"}
WKV = {"source": "src/repro_torch/kernels/csrc/wkv6.cu",
       "replaces": "src/repro/kernels/rwkv/kernel.py:73"}

# name, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype
ATT_MAIN_CASE = ("main_p1", 8, 12, 12, 1024, 1024, 64, True, 0, None,
                 "float32")
ATT_CASES = [
    ATT_MAIN_CASE,
    ("main_p2", 4, 12, 12, 1024, 1024, 64, True, 0, None, "float32"),
    ("gqa", 2, 8, 2, 512, 512, 64, True, 0, None, "float32"),
    ("window", 2, 4, 4, 1024, 1024, 64, True, 200, None, "float32"),
    ("ragged", 2, 4, 2, 1000, 1000, 64, True, 0, None, "float32"),
    ("kv_len_cross", 1, 4, 2, 300, 384, 32, False, 0, 333, "float32"),
    ("d128_bf16", 1, 4, 4, 384, 384, 128, True, 0, None, "bfloat16"),
    ("d16_window_gqa", 1, 8, 2, 200, 200, 16, True, 32, None, "float32"),
    ("bf16", 2, 12, 12, 1024, 1024, 64, True, 0, None, "bfloat16"),
]
ATT_TOL = {"float32": {"fwd": 2e-5, "bwd": 1e-4},
           "bfloat16": {"fwd": 2e-2, "bwd": 2e-2}}
# the backward pair runs twice on these cases and must give the same bits
DETERMINISM_CASES = ("main_p1", "gqa")

# name, B, L, H, hd, logw: "model" draws -exp(clip(2 N(0,1), -8, 4)), the
# range the model's clip allows; a number sets every logw to it
WKV_MAIN_CASE = ("main_p1", 8, 1024, 32, 64, "model")
WKV_CASES = [
    WKV_MAIN_CASE,
    ("main_p2", 4, 1024, 32, 64, "model"),
    ("ragged", 2, 1000, 32, 64, "model"),
    ("context_4096", 2, 4096, 32, 64, "model"),
    ("logw_-20", 2, 512, 8, 64, -20.0),
    ("logw_-1e-4", 2, 512, 8, 64, -1e-4),
    ("hd16", 2, 300, 8, 16, "model"),
    ("hd32", 2, 300, 8, 32, "model"),
]
# fp32 kernels against fp32 plain versions that sum in another order: each
# output within WKV_TOL of the plain output's largest entry
WKV_TOL = 1e-4
# a held-out batch of 8192 noise tokens: the spread of its mean loss is
# about 0.01 (per-token spread ~1 over sqrt(8192)), so a loss more than
# 0.1 below ln(vocab) is no chance
HOLD_OUT_MARGIN = 0.1
# remat on and off run the same bf16 math; a remat fault (another input or
# weight recomputed) moves the gradients by O(1)
REMAT_RTOL = 1e-2

MAIN_BATCH, MAIN_INIT_P = 8, 1
PATH_ARGS = ["--batch", str(MAIN_BATCH), "--seq", "1024", "--devices", "2",
             "--init-p", str(MAIN_INIT_P), "--schedule", "out:1@3",
             "--steps", "12", "--n-samples", "1024", "--d-partitions", "16",
             "--json", "--device", "cuda"]
EDL_ARGS = ["--arch", "edl-paper", *PATH_ARGS]
RWKV_ARGS = ["--arch", "rwkv6-1.6b", *PATH_ARGS]


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def visible_pairs(torch, Lq, Lk, causal, window, kv_len) -> int:
    """(query, key) pairs that the mask lets through: the work these inputs
    need."""
    qp = torch.arange(Lq)[:, None]
    kp = torch.arange(Lk)[None, :]
    m = kp < kv_len
    if causal:
        m = m & (qp >= kp)
    if window > 0:
        m = m & ((qp - kp) < window)
    return int(m.sum())


def excess(a, b, tol: float) -> tuple[float, bool]:
    """(max |a - b|, whether every element has |a - b| <= tol (1 + |b|))."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    return float(err.max()), bool((err <= tol * (1 + b.abs())).all())


# SDPA's default backward must take within this share of the time of one
# backend, the one it picks; on fp32 inputs at the main shape the backends
# that take them differ by ~70 % (PERF.md §7)
SDPA_MATCH = 0.15


def sdpa_backends(torch, q, k, v, do, causal) -> dict:
    """``F.scaled_dot_product_attention``'s backward on these inputs (the
    yardstick; the port never calls it): the time under the default and
    under each backend, timed in turns (A B C C B A) so that they share the
    card's state, or why the backend refused the inputs; and the backend
    the default picks, read from the times: the one whose time is nearest
    the default's, which must be within ``SDPA_MATCH`` of it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    F = torch.nn.functional
    out = {"ms": {}, "refused": {}}
    graphs = {}   # name: (output, leaves), the backward kept for timing
    for backend in (None, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH,
                    SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        name = "default" if backend is None else backend.name
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        try:
            with (contextlib.nullcontext() if backend is None
                  else sdpa_kernel(backend)):
                o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            torch.autograd.grad(o, leaves, do, retain_graph=True)
            graphs[name] = (o, leaves)
        except RuntimeError as e:
            out["refused"][name] = str(e).strip().splitlines()[0][:160]
    turns = {name: [] for name in graphs}
    for name in list(graphs) + list(graphs)[::-1]:
        o, leaves = graphs[name]
        turns[name].append(cuda_ms(torch, lambda: torch.autograd.grad(
            o, leaves, do, retain_graph=True)))
    del graphs
    out["ms"] = {name: sum(t) / len(t) for name, t in turns.items()}
    ms = dict(out["ms"])
    default = ms.pop("default", None)
    if default is None or not ms:
        fail(f"SDPA's backward did not run on these inputs: {out['refused']}")
    nearest = min(ms, key=lambda n: abs(ms[n] - default))
    gap = abs(ms[nearest] - default) / default
    if gap > SDPA_MATCH:
        fail(f"SDPA's default backward ({default:.3f} ms) matches no "
             f"backend's time: {ms}")
    out.update(default_backend=nearest, default_gap=gap)
    return out


def backward_is_deterministic(torch, ops, q, k, v, o, lse, do, opts) -> bool:
    """Two runs of the backward pair on the same inputs give the same bits
    in dq, dk, dv and delta."""
    runs = []
    for _ in range(2):
        dq, delta = ops.flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
        dk, dv = ops.flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def check_attention(torch, ops):
    """Phase 3. Returns per-kernel records at the main case's shape, and the
    record of the backward pair."""
    F = torch.nn.functional
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (name, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len,
         dname) in ATT_CASES:
        dtype = getattr(torch, dname)
        kv_len = Lk if kv_len is None else kv_len

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, do = rnd(B, Hq, Lq, D), rnd(B, Hq, Lq, D)
        k, v = rnd(B, Hkv, Lk, D), rnd(B, Hkv, Lk, D)
        scale = D ** -0.5
        opts = dict(causal=causal, window=window, scale=scale, kv_len=kv_len)
        o, lse = ops.flash_attn_fwd_cuda(q, k, v, **opts)
        dq, delta = ops.flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
        dk, dv = ops.flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
        torch.cuda.synchronize()
        o_p, lse_p = ops.flash_attn_fwd_plain(q, k, v, **opts)
        # each backward kernel against its plain version on the same inputs
        dq_p, delta_p = ops.flash_attn_bwd_dq_plain(q, k, v, o, lse, do,
                                                    **opts)
        dk_p, dv_p = ops.flash_attn_bwd_dkdv_plain(q, k, v, lse, delta, do,
                                                   **opts)
        tol = ATT_TOL[dname]
        errs = {
            "flash_attn_fwd": [excess(o, o_p, tol["fwd"]),
                               excess(lse, lse_p, tol["fwd"])],
            "flash_attn_bwd_dq": [excess(dq, dq_p, tol["bwd"]),
                                  excess(delta, delta_p, tol["bwd"])],
            "flash_attn_bwd_dkdv": [excess(dk, dk_p, tol["bwd"]),
                                    excess(dv, dv_p, tol["bwd"])],
        }
        mags = {"flash_attn_fwd": o_p.abs().max(),
                "flash_attn_bwd_dq": dq_p.abs().max(),
                "flash_attn_bwd_dkdv": torch.maximum(dk_p.abs().max(),
                                                     dv_p.abs().max())}
        for kname, pairs in errs.items():
            t = tol["fwd" if kname == "flash_attn_fwd" else "bwd"]
            err = max(e for e, _ in pairs)
            ok = all(o_ for _, o_ in pairs)
            print(f"  case {name:15s} {kname:20s} max_abs_err {err:.3e} "
                  f"tol {t:g} (|a-b| <= tol(1+|b|)) {'ok' if ok else 'FAIL'}"
                  f" max|plain| {float(mags[kname]):.3g}", flush=True)
            if not ok:
                fail(f"{kname} disagrees with its plain version in case "
                     f"{name}: max_abs_err {err:.3e}")
            if name == ATT_MAIN_CASE[0]:
                records[kname] = {"max_abs_err": err, "tolerance": t}
        if name in DETERMINISM_CASES:
            same = backward_is_deterministic(torch, ops, q, k, v, o, lse, do,
                                             opts)
            print(f"  case {name:15s} backward pair run twice: dq, dk, dv and "
                  f"delta {'bit-identical' if same else 'DIFFER'}", flush=True)
            if not same:
                fail(f"the backward pair is not deterministic in case {name}")

        if name != ATT_MAIN_CASE[0]:
            continue
        # time kernel, plain version and the library call at the main shape
        esz = q.element_size()
        n_qo = B * Hq * Lq * D * esz        # one [B,Hq,Lq,D] tensor
        n_kv = B * Hkv * Lk * D * esz       # one [B,Hkv,Lk,D] tensor
        n_row = B * Hq * Lq * 4             # lse or delta, fp32
        pairs = B * Hq * visible_pairs(torch, Lq, Lk, causal, window, kv_len)
        work = {   # (bytes: inputs read once + outputs written once, flops)
            # q, k, v -> o, lse; matmuls S = QK^T, O = PV
            "flash_attn_fwd": (2 * n_qo + 2 * n_kv + n_row, 4 * D * pairs),
            # q, o, dO, k, v, lse -> dq, delta; S, dP, dQ
            "flash_attn_bwd_dq": (4 * n_qo + 2 * n_kv + 2 * n_row,
                                  6 * D * pairs),
            # q, dO, k, v, lse, delta -> dk, dv; S, dP, dV, dK
            "flash_attn_bwd_dkdv": (2 * n_qo + 4 * n_kv + 2 * n_row,
                                    8 * D * pairs),
        }
        kern = {
            "flash_attn_fwd": lambda: ops.flash_attn_fwd_cuda(q, k, v,
                                                              **opts),
            "flash_attn_bwd_dq": lambda: ops.flash_attn_bwd_dq_cuda(
                q, k, v, o, lse, do, **opts),
            "flash_attn_bwd_dkdv": lambda: ops.flash_attn_bwd_dkdv_cuda(
                q, k, v, lse, delta, do, **opts),
        }
        plain = {
            "flash_attn_fwd": lambda: ops.flash_attn_fwd_plain(q, k, v,
                                                               **opts),
            "flash_attn_bwd_dq": lambda: ops.flash_attn_bwd_dq_plain(
                q, k, v, o, lse, do, **opts),
            "flash_attn_bwd_dkdv": lambda: ops.flash_attn_bwd_dkdv_plain(
                q, k, v, lse, delta, do, **opts),
        }
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl,
                                                  is_causal=causal)
        lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, (ql, kl, vl), do, retain_graph=True))
        del sdpa_out, ql, kl, vl
        library = {"flash_attn_fwd": lib_fwd, "flash_attn_bwd_dq": lib_bwd,
                   "flash_attn_bwd_dkdv": lib_bwd}
        for kname in kern:
            nbytes, flops = work[kname]
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = flops / FP32_FLOPS * 1e3
            records[kname].update(
                ms=cuda_ms(torch, kern[kname]),
                plain_ms=cuda_ms(torch, plain[kname], reps=3, warm=1),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                bytes=nbytes, flops=flops,
                library_ms=library[kname],
                shape=dict(B=B, Hq=Hq, Hkv=Hkv, L=Lq, D=D, causal=causal,
                           window=window, dtype=dname))
        # the backward pair against SDPA's backward, which computes dq, dk
        # and dv in one call
        dq_name, kv_name = "flash_attn_bwd_dq", "flash_attn_bwd_dkdv"
        sdpa = sdpa_backends(torch, q, k, v, do, causal)
        pair_ms = cuda_ms(torch, lambda: ops.flash_attn_bwd_cuda(q, k, v, o,
                                                                 lse, do,
                                                                 **opts))
        # the pair's own function: q, k, v, o, dO, lse -> dq, dk, dv,
        # delta; S, dP, dV, dK and dQ once each (the two kernels form S and
        # dP twice, a choice of the design that the bound does not count)
        nbytes, flops = 4 * n_qo + 4 * n_kv + 2 * n_row, 10 * D * pairs
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        pair = {"ms": pair_ms,
                "dq_ms_plus_dkdv_ms": records[dq_name]["ms"]
                + records[kv_name]["ms"],
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes > t_ops else "operations",
                "bytes": nbytes, "flops": flops,
                # the two kernels' own bounds added: S and dP counted twice
                "sum_of_kernel_bounds_ms": records[dq_name]["bound_ms"]
                + records[kv_name]["bound_ms"],
                "share_of_bound": max(t_bytes, t_ops) / pair_ms,
                "sdpa_backward_ms": lib_bwd,
                "sdpa_share_of_bound": max(t_bytes, t_ops) / lib_bwd,
                "ratio_to_sdpa": pair_ms / lib_bwd,
                "sdpa_default_backend": sdpa["default_backend"],
                "sdpa_default_gap": sdpa["default_gap"],
                "sdpa_backward_ms_by_backend": sdpa["ms"],
                "sdpa_refused": sdpa["refused"],
                "shape": records[dq_name]["shape"]}
    return records, pair


def wkv_inputs(torch, B, L, H, hd, logw_kind, seed):
    """r, k, v, logw, u, s0, dy, dsT on the card, drawn on the CPU from a
    seeded generator."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    r, k, v = rnd(B, L, H, hd), rnd(B, L, H, hd), rnd(B, L, H, hd)
    if logw_kind == "model":
        logw = -torch.exp(torch.clamp(rnd(B, L, H, hd, scale=2.0), -8.0, 4.0))
    else:
        logw = torch.full((B, L, H, hd), float(logw_kind), device="cuda")
    u, s0 = rnd(H, hd, scale=0.5), rnd(B, H, hd, hd, scale=0.1)
    dy, dsT = rnd(B, L, H, hd), rnd(B, H, hd, hd, scale=0.1)
    return r, k, v, logw, u, s0, dy, dsT


def wkv_work(B, L, H, hd) -> dict:
    """(bytes: inputs read once + outputs written once, flops) of each WKV6
    kernel. Per (b, t, h) each scan does 5 hd^2 flops: a matrix-vector
    product with the hd x hd state (2 hd^2) and its update diag(w) S + x y^T
    (3 hd^2)."""
    seq = B * L * H * hd * 4            # one [B,L,H,hd] fp32 tensor
    st = B * H * hd * hd * 4            # one [B,H,hd,hd] state
    vec = B * H * hd * 4                # one [B,H,hd] per-(b, h) vector
    u = H * hd * 4
    scan = 5 * B * L * H * hd * hd
    return {
        # r, k, v, logw, u, s0 -> y, sT
        "wkv6_fwd": (5 * seq + 2 * st + u, scan),
        # r, k, v, logw, dy, u, s0, dsT -> dr, a, du_part
        "wkv6_bwd_dr": (7 * seq + 2 * st + u + vec, scan),
        # r, k, v, logw, dy, a, u, dsT -> dk, dlogw, ds0
        "wkv6_bwd_dk": (8 * seq + 2 * st + u, scan),
        # r, k, logw, dy, u, dsT -> dv
        "wkv6_bwd_dv": (5 * seq + st + u, scan),
        # du_part -> du: B - 1 adds per (h, i)
        "wkv6_bwd_du": (vec + u, (B - 1) * H * hd),
    }


def check_wkv(torch, wops):
    """Phase 5. Returns per-kernel records at the main case's shape."""
    records = {}
    for seed, (name, B, L, H, hd, logw_kind) in enumerate(WKV_CASES):
        r, k, v, logw, u, s0, dy, dsT = wkv_inputs(torch, B, L, H, hd,
                                                   logw_kind, seed)
        y, sT = wops.wkv6_fwd_cuda(r, k, v, logw, u, s0)
        dr, a, du_part = wops.wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy, dsT)
        dk, dlogw, ds0 = wops.wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT, a)
        dv = wops.wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT)
        du = wops.wkv6_bwd_du_cuda(du_part)
        torch.cuda.synchronize()
        # each kernel against its plain version on the same inputs
        pairs = {
            "wkv6_fwd": ((y, sT), wops.wkv6_fwd_plain(r, k, v, logw, u, s0)),
            "wkv6_bwd_dr": ((dr, a, du_part), wops.wkv6_bwd_dr_plain(
                r, k, v, logw, u, s0, dy, dsT)),
            "wkv6_bwd_dk": ((dk, dlogw, ds0), wops.wkv6_bwd_dk_plain(
                r, k, v, logw, u, dy, dsT, a)),
            "wkv6_bwd_dv": ((dv,), (wops.wkv6_bwd_dv_plain(
                r, k, logw, u, dy, dsT),)),
            "wkv6_bwd_du": ((du,), (wops.wkv6_bwd_du_plain(du_part),)),
        }
        for kname, (got, want) in pairs.items():
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
            mags = [float(w.abs().max()) for w in want]
            ok = finite and all(e <= WKV_TOL * m for e, m in zip(errs, mags))
            err = max(errs)
            rel = max(e / max(m, 1e-30) for e, m in zip(errs, mags))
            print(f"  case {name:13s} {kname:12s} max_abs_err {err:.3e} "
                  f"max err/max|plain| {rel:.2e} tol {WKV_TOL:g} "
                  f"{'ok' if ok else 'FAIL'} max|plain| {max(mags):.3g}",
                  flush=True)
            if not ok:
                fail(f"{kname} disagrees with its plain version in case "
                     f"{name} (finite {finite}): errors {errs}, largest "
                     f"plain entries {mags}")
            if name == WKV_MAIN_CASE[0]:
                records[kname] = {"max_abs_err": err, "tolerance": WKV_TOL}

        if name != WKV_MAIN_CASE[0]:
            continue
        kern = {
            "wkv6_fwd": lambda: wops.wkv6_fwd_cuda(r, k, v, logw, u, s0),
            "wkv6_bwd_dr": lambda: wops.wkv6_bwd_dr_cuda(r, k, v, logw, u,
                                                         s0, dy, dsT),
            "wkv6_bwd_dk": lambda: wops.wkv6_bwd_dk_cuda(r, k, v, logw, u,
                                                         dy, dsT, a),
            "wkv6_bwd_dv": lambda: wops.wkv6_bwd_dv_cuda(r, k, logw, u, dy,
                                                         dsT),
            "wkv6_bwd_du": lambda: wops.wkv6_bwd_du_cuda(du_part),
        }
        plain = {
            "wkv6_fwd": lambda: wops.wkv6_fwd_plain(r, k, v, logw, u, s0),
            "wkv6_bwd_dr": lambda: wops.wkv6_bwd_dr_plain(r, k, v, logw, u,
                                                          s0, dy, dsT),
            "wkv6_bwd_dk": lambda: wops.wkv6_bwd_dk_plain(r, k, v, logw, u,
                                                          dy, dsT, a),
            "wkv6_bwd_dv": lambda: wops.wkv6_bwd_dv_plain(r, k, logw, u, dy,
                                                          dsT),
            "wkv6_bwd_du": lambda: wops.wkv6_bwd_du_plain(du_part),
        }
        for kname, (nbytes, flops) in wkv_work(B, L, H, hd).items():
            t_bytes = nbytes / HBM_BYTES_S * 1e3
            t_ops = flops / FP32_FLOPS * 1e3
            records[kname].update(
                ms=cuda_ms(torch, kern[kname]),
                plain_ms=cuda_ms(torch, plain[kname], reps=2, warm=1),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                bytes=nbytes, flops=flops, library_ms=None,
                shape=dict(B=B, L=L, H=H, hd=hd, logw=logw_kind,
                           dtype="float32"))
    return records


def slot_steps(summary: dict, init_p: int) -> int:
    """Slot shards that the run's training steps ran: a step at p runs p. A
    switch commits after step ``switch_step``, so that step ran at the old
    p."""
    total, p, prev = 0, init_p, 0
    for e in sorted(summary["scaling_events"], key=lambda e: e["switch_step"]):
        total += (e["switch_step"] - prev) * p
        p, prev = e["to_p"], e["switch_step"]
    return total + (summary["steps"] - prev) * p


@contextlib.contextmanager
def timed_state_init(torch, seconds: list):
    """Time the trainer's draw and placement of its initial train state
    (``init_train_state``, on the host's generator) while the entry point
    runs."""
    from repro_torch.core import elastic_runtime
    inner = elastic_runtime.init_train_state

    def timed(*args, **kw):
        t0 = time.monotonic()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.monotonic() - t0)
        return out

    elastic_runtime.init_train_state = timed
    try:
        yield
    finally:
        elastic_runtime.init_train_state = inner


def run_path(torch, launches_of, train, args, kernels, per_shard: dict, *,
             loss_must_fall: bool = True):
    """Phases 4 and 6: the port's trainer through its entry point, with the
    launch counts reset just before and read just after. ``per_shard``
    predicts each kernel's launches per slot shard of a step (and of a
    warm-up); with ``loss_must_fall`` the last loss must be below the first.
    Returns a record of the run."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_s: list = []
    buf = io.StringIO()
    launches_of.reset()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf), timed_state_init(torch, init_s):
        rc = train.main(args)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = launches_of.snapshot()
    warm = launches_of.snapshot(warm=True)
    if rc != 0:
        fail(f"repro_torch.launch.train.main returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = summary["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if loss_must_fall and not summary["final_loss"] < summary["first_loss"]:
        fail(f"loss did not fall: {losses}")
    outs = [e for e in summary["scaling_events"] if e["op"] == "scale_out"]
    if len(outs) != 1 or summary["final_p"] != 2:
        fail(f"expected one committed scale_out to p=2: "
             f"{summary['scaling_events']}, final_p {summary['final_p']}")
    if not outs[0]["stop_s"] < outs[0]["prep_s"]:
        fail(f"scale_out was not stop-free: {outs[0]}")
    if summary["unique_sample_frac"] != 1.0:
        fail(f"unique_sample_frac {summary['unique_sample_frac']}")
    missing = [k for k in kernels if launches[k] <= 0]
    strays = {k: n for k, n in launches.items() if k not in kernels and n}
    if missing or strays:
        fail(f"kernels of the path not launched: {missing}; kernels off "
             f"the path launched: {strays}")
    n_slot_steps = slot_steps(summary, MAIN_INIT_P)
    # the launch prep and each cold scaling prep warm one shard each (all
    # slots share the one card)
    n_preps = 1 + sum(not e["cache_hit"] for e in summary["scaling_events"])
    per_slot_step = {k: (launches[k] - warm[k]) / n_slot_steps
                     for k in kernels}
    want_warm = {k: n_preps * per_shard[k] for k in kernels}
    if per_slot_step != per_shard or {k: warm[k] for k in kernels} != \
            want_warm:
        fail(f"launches differ from the prediction: warm-ups "
             f"{ {k: warm[k] for k in kernels} } (predicted {want_warm}), "
             f"per slot shard of a step {per_slot_step} (predicted "
             f"{per_shard})")
    steps = summary["steps"]
    step_ms = 1e3 * MAIN_BATCH / summary["throughput"]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses {['%.4f' % x for x in losses]}")
    print(f"  scaling_events {json.dumps(summary['scaling_events'])}")
    print(f"  {steps} steps in {seconds:.2f} s (train state drawn and placed "
          f"in {sum(init_s):.2f} s); mean step {step_ms:.1f} ms, "
          f"{summary['throughput']:.2f} samples/s over the last "
          f"{min(steps, 20)} steps; peak {peak_gib:.2f} GiB allocated; "
          f"launches { {k: launches[k] for k in kernels} }, of which "
          f"context-prep warm-ups { {k: warm[k] for k in kernels} } "
          f"({n_preps} preps); {n_slot_steps} slot shards stepped, so per "
          f"slot shard of a step {per_slot_step}, as predicted", flush=True)
    return {"arch": summary["arch"], "steps": steps, "seconds": seconds,
            "init_state_s": sum(init_s), "mean_step_ms": step_ms,
            "samples_per_s": summary["throughput"], "peak_gib": peak_gib,
            "first_loss": summary["first_loss"],
            "final_loss": summary["final_loss"],
            "scaling_events": summary["scaling_events"],
            "launches": launches, "warmup_launches": warm,
            "launches_per_slot_step": per_slot_step}


def refit_and_hold_out(torch, arch: str, steps: int = 4) -> dict:
    """Phase 6's learning checks, on the trainer that ``launch/train.py``
    builds (same seed and data, AdamW at its default lr 1e-3, one slot).

    The synthetic tokens are uniform noise, and from the reference's init
    the loss of a fresh batch of them rises under AdamW at lr 1e-3, in the
    JAX trainer as in the port (PERF.md §7,
    ``tests/test_torch_rwkv_witness.py``), so the last loss of the path is
    not required to be below its first. Instead:

    - refit: ``steps`` updates on the first batch must lower its loss at
      every step (the gradient carries the labels through the stack);
    - held out: the loss of a batch that no step saw, after the refit, must
      not fall below the tokens' entropy ln(vocab) by more than
      ``HOLD_OUT_MARGIN``: a fresh noise token cannot be predicted, so a
      lower loss means the labels leaked into the inputs;
    - remat: on one slot shard of that batch at the refitted weights, the
      loss and gradients with remat off equal those with remat on within
      ``REMAT_RTOL`` (norm-wise per leaf), so remat recomputes what the
      forward computed at full width in bf16.
    """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.training.step import loss_and_grads, shard_batch
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    with ElasticTrainer(cfg, global_batch=MAIN_BATCH, seq_len=1024,
                        init_parallelism=1, optimizer=adamw(1e-3),
                        n_samples=1024, d_partitions=16, devices=["cuda:0"],
                        use_aot=False) as t:
        batch, held = (t.dataset.read(s, MAIN_BATCH)
                       for s in (0, MAIN_BATCH))
        for b in (batch, held):
            b.pop("sample_ids")
        held_dev = shard_batch(held, 1, ["cuda:0"])[0]

        def held_loss():
            with torch.no_grad():
                return float(M.loss_fn(cfg, t.state["params"], held_dev)[0])

        held_before = held_loss()
        losses = []
        for _ in range(steps):
            t.state, m = t.exec.step_fn(t.state, batch)
            losses.append(float(m["loss"]))
        held_after = held_loss()
        shard = {k: v[:MAIN_BATCH // 2] for k, v in held_dev.items()}
        outs = [loss_and_grads(dataclasses.replace(cfg, remat=remat),
                               t.state["params"], shard)
                for remat in (True, False)]
        remat_err = max(
            float((b.float() - a.float()).norm() / a.float().norm())
            for (_, a), (_, b) in zip(tree_leaves(outs[0][2]),
                                      tree_leaves(outs[1][2])))
        remat_losses = [float(o[0]) for o in outs]
        del outs
    entropy = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses) or \
            any(b >= a for a, b in zip(losses, losses[1:])):
        fail(f"refitting one batch did not lower its loss: {losses}")
    print(f"  one batch refit {steps} times: losses "
          f"{['%.4f' % x for x in losses]}, each below the one before",
          flush=True)
    if not (math.isfinite(held_after)
            and held_after >= entropy - HOLD_OUT_MARGIN):
        fail(f"held-out loss {held_after} after the refit is below "
             f"ln(vocab) {entropy:.4f} - {HOLD_OUT_MARGIN}: the labels leak")
    print(f"  held-out batch: loss {held_before:.4f} before the refit, "
          f"{held_after:.4f} after; ln(vocab) = {entropy:.4f}, floor "
          f"{entropy - HOLD_OUT_MARGIN:.4f}", flush=True)
    loss_err = abs(remat_losses[1] - remat_losses[0]) / abs(remat_losses[0])
    if not (loss_err <= REMAT_RTOL and remat_err <= REMAT_RTOL):
        fail(f"remat off differs from remat on: loss {remat_losses}, "
             f"largest norm-wise gradient difference {remat_err}")
    print(f"  remat on/off, one slot shard: losses {remat_losses[0]:.6f} / "
          f"{remat_losses[1]:.6f}, largest norm-wise gradient difference "
          f"{remat_err:.3e} (tolerance {REMAT_RTOL})", flush=True)
    return {"refit_losses": losses, "held_out_loss_before": held_before,
            "held_out_loss_after": held_after, "ln_vocab": entropy,
            "remat_losses": remat_losses, "remat_grad_err": remat_err}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.launches import LAUNCHES
    from repro_torch.kernels.rwkv import ops as wops
    from repro_torch.launch import train

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/7] device: {kind} ({card}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    built = build.build_all(force=True)
    print(f"[2/7] built {sorted(built)} with {build.nvcc_path()} "
          f"{' '.join(build.NVCC_FLAGS)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    if sorted(built) != sorted(build.SOURCES):
        fail(f"built {sorted(built)}, sources {sorted(build.SOURCES)}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3/7] attention kernels against their plain versions", flush=True)
    records, pair = check_attention(torch, aops)

    edl = get_config("edl-paper")
    print("[4/7] edl_paper path: python -m repro_torch.launch.train "
          + " ".join(EDL_ARGS), flush=True)
    # forward, dq and dkdv once per layer and shard
    paths = {"edl-paper": run_path(
        torch, LAUNCHES, train, EDL_ARGS, aops.KERNELS,
        dict.fromkeys(aops.KERNELS, edl.n_layers))}

    print("[5/7] WKV6 kernels against their plain versions", flush=True)
    records.update(check_wkv(torch, wops))

    rwkv = get_config("rwkv6-1.6b")
    print("[6/7] rwkv6 path: python -m repro_torch.launch.train "
          + " ".join(RWKV_ARGS), flush=True)
    # each kernel once per layer and shard; remat runs the forward again
    rwkv_shard = dict.fromkeys(wops.KERNELS, rwkv.n_layers)
    rwkv_shard["wkv6_fwd"] = rwkv.n_layers * (2 if rwkv.remat else 1)
    # on fresh batches of noise tokens the loss rises from this init, in
    # the JAX trainer too: learning is checked by refit_and_hold_out
    paths["rwkv6-1.6b"] = run_path(torch, LAUNCHES, train, RWKV_ARGS,
                                   wops.KERNELS, rwkv_shard,
                                   loss_must_fall=False)
    paths["rwkv6-1.6b"].update(refit_and_hold_out(torch, "rwkv6-1.6b"))

    kernels = []
    for kernel_names, family, path in ((aops.KERNELS, ATT, "edl-paper"),
                                       (wops.KERNELS, WKV, "rwkv6-1.6b")):
        run = paths[path]
        for kname in kernel_names:
            r = records[kname]
            kernels.append({
                "name": kname, "route": "cuda", **family,
                "launches": run["launches"][kname],
                "warmup_launches": run["warmup_launches"][kname],
                "launches_per_slot_step": run["launches_per_slot_step"][kname],
                "path": path, "max_abs_err": r["max_abs_err"],
                "tolerance": r["tolerance"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "bytes": r["bytes"],
                "flops": r["flops"], "library_ms": r["library_ms"],
                "shape": r["shape"], "card": card})
    print("[7/7] results; library_ms is F.scaled_dot_product_attention for "
          "the attention kernels (its forward for flash_attn_fwd, its whole "
          "backward for both backward kernels) and null for WKV6, which no "
          "single PyTorch call computes", flush=True)
    print(json.dumps({"backward_pair": {**pair, "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_paths": {
        name: {k: v for k, v in run.items()
               if k not in ("launches", "warmup_launches")}
        for name, run in paths.items()}, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
