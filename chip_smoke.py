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
   tensors at the edl_paper path's shape, at one virtual worker's shard of
   it (B 1), at the tensor-parallel shard shapes (H 6 at mp = 2, H 3 at
   mp = 4), and at GQA, window, ragged, non-causal, head-dim and bf16
   cases, and hold it against its plain PyTorch version on the same
   inputs; run the forward and the backward pair twice on the main, mp = 2
   and GQA cases and require the same bits; time kernel, plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) at the main, virtual-worker and tensor-parallel shapes, and
   the backward
   pair against SDPA's backward under its default and under each backend
   that takes fp32 (``EFFICIENT_ATTENTION``, ``MATH``; the others are
   recorded as refusing), naming the default's backend by its time;
4. edl_paper path: ``repro_torch.launch.train.main`` trains the full-width
   ``edl_paper`` decoder through a stop-free scale-out;
5. edl_paper virtual-worker path: ``repro_torch.launch.train.main`` with
   ``--virtual-workers 8`` on four slots of the card runs (a) static at
   p = 1, (b) 1 -> 4 -> 2, (c) p = 4 with a worker killed (detection
   scales in to 2) and (d) a stop-resume 2 -> 1; the losses of (b), (c)
   and (d) must equal (a)'s bit for bit, step for step; (b)'s switches
   must be stop-free and (d)'s stop more than 10x (b)'s scale-out's;
6. edl_paper model-parallel path, on four slots of the card: (a)
   ``repro_torch.launch.train.main`` at (p, mp) = (1, 2) through a
   stop-free scale-out to (2, 2); (b) an ``ElasticTrainer`` built directly
   and driven through ``reshape`` (the API the reference's cluster
   executor calls): (4, 1) -> (2, 2) -> (1, 4), each switch stop-free, the
   planner's bytes moved and kept recorded; (c) the same with
   ``virtual_workers=8``, whose losses must equal phase 5's static run's
   bit for bit, step for step; (d) ``main`` with ``--virtual-workers 8
   --init-p 4 --schedule stop_resume_mp:2@5`` (checkpoint, tear down,
   resume at (2, 2)), whose losses must equal the static run's too;
   (a)'s first loss must hold phase 4's at (1, 1) within
   ``TP_LOSS_RTOL``, and (e) one step's loss and gradients of the
   full-width model at (1, 2) and (1, 4) must hold (1, 1)'s within
   ``TP_LOSS_RTOL`` and ``TP_GRAD_RTOL``, which the same step at bf16
   compute (the control) must miss;
7. WKV6 kernels: call each WKV6 kernel's wrapper at the rwkv6 path's shape
   (one slot shard at p = 1 and at p = 2), at ragged L, at RWKV6's training
   context, at extreme decays and at head dims 16, 32 and 64, with nonzero
   s0 and dsT, inputs drawn from a seeded CPU generator, and hold it against
   its plain PyTorch version on the same inputs (du as an output of dk);
   run every WKV6 kernel twice on the main case and require the same bits;
   time kernel and plain version (no single PyTorch call computes a WKV6
   kernel's outputs; ``du_part.sum(0)``, the one call that computes dk's
   du, is timed beside dk);
8. rwkv6 path: ``repro_torch.launch.train.main`` trains the full-width
   ``rwkv6_1p6b`` (bf16, remat) through a stop-free scale-out, timing the
   host-side init of its parameters; then the same trainer refits one batch
   four times, and its loss must fall at every step; a held-out batch's
   loss must stay above the tokens' entropy less a margin; and one slot
   shard's loss and gradients must be the same with remat on and off;
9. the cluster tier: ``repro_torch.cluster.ClusterExecutor`` on four slots
   of the card, its tenants full-width ``edl_paper`` trainers (the trainer
   ``default_trainer_factory`` builds, from CONFIG) at batch 8, sequence
   1024: (a) the throughput policy with telemetry and a trace, where c's
   arrival must be funded by a stop-free shrink of a live tenant, every
   tenant's loss must fall, every telemetry record must be valid and every
   committed switch must be a span tree with its commit; (b) Tiresias
   (quanta 0.1, 1000) checkpoint-stops the ``vw=8`` tenant a to disk and
   re-admits it on other slots, and its losses must equal a static
   single-slot run's bit for bit; (c) a worker of x dies and a slot of y is
   revoked: two recoveries, and exactly those two slots leave the pool;
   (d) ``repro_torch.launch.cluster.main`` with the reference's default
   jobs at their SMOKE width for 12 rounds must report conservation. In
   (a)-(c) every tenant finishes its steps with finite losses and
   exactly-once data, every committed switch is stop-free (``stop_s <
   prep_s``, or under ``STOP_HIT_S`` where the prep was a cache lookup),
   and the executor asserts slot conservation every round.

Each path runs with the launch counts reset just before and read just after;
the loss must be finite, the scale-out commit stop-free, the data
exactly-once, every kernel of the path launched and no other. On the
edl_paper path the last loss must be below the first; on the rwkv6 path,
where from the reference's init the loss of fresh noise tokens rises in
the JAX trainer as in the port, the refit and held-out checks take its
place. The launches
made by the context preps' warm-ups are counted apart, the rest is divided
by the slot shards stepped (p x mp a step), and both must equal what the
code predicts: one launch of each kernel per layer for each slot shard's
forward and backward, with remat's recomputation a second forward launch;
a prep warms one data group, mp slot shards (all groups share the card);
in virtual-worker mode a step runs K shards at every (p, mp), so each
kernel launches layers x K times a step, and a prep warms one shard. Then
print
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
# one virtual worker's shard of the main case (batch 8, K = 8)
ATT_VW_CASE = ("vw_b1", 1, 12, 12, 1024, 1024, 64, True, 0, None, "float32")
# one model shard of the main case at mp = 2 and mp = 4 (H / mp heads)
ATT_MP_CASES = [("main_mp2", 8, 6, 6, 1024, 1024, 64, True, 0, None,
                 "float32"),
                ("main_mp4", 8, 3, 3, 1024, 1024, 64, True, 0, None,
                 "float32")]
ATT_CASES = [
    ATT_MAIN_CASE,
    ("main_p2", 4, 12, 12, 1024, 1024, 64, True, 0, None, "float32"),
    ATT_VW_CASE,
    *ATT_MP_CASES,
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
# the forward and the backward pair run twice on these cases and must give
# the same bits
DETERMINISM_CASES = ("main_p1", "main_mp2", "gqa")
# the cases whose kernels are timed beside their bounds and SDPA
TIMED_CASES = (ATT_MAIN_CASE[0], ATT_VW_CASE[0]) + tuple(
    c[0] for c in ATT_MP_CASES)

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
VW_K, VW_STEPS = 8, 12
VW_ARGS = ["--arch", "edl-paper", "--batch", str(MAIN_BATCH), "--seq", "1024",
           "--devices", "4", "--virtual-workers", str(VW_K), "--steps",
           str(VW_STEPS), "--n-samples", "1024", "--d-partitions", "16",
           "--json", "--device", "cuda"]
VW_RUNS = {"static": ["--init-p", "1"],
           "elastic": ["--init-p", "1", "--schedule", "out:3@3,in:2@6"],
           "kill": ["--init-p", "4", "--schedule", "kill:1@4"],
           "stop_resume": ["--init-p", "2", "--schedule",
                           "stop_resume_in:1@5"]}
# phase 6: (a) through the entry point at mp = 2, (b) and (c) through
# reshape, (d) a stop-resume onto mp = 2
MP_ARGS = ["--arch", "edl-paper", "--batch", str(MAIN_BATCH), "--seq", "1024",
           "--devices", "4", "--init-p", "1", "--model-parallel", "2",
           "--schedule", "out:1@3", "--steps", "12", "--n-samples", "1024",
           "--d-partitions", "16", "--json", "--device", "cuda"]
MP_INIT = (1, 2)
RESHAPES = ((2, 2), (1, 4))     # from (4, 1)
MP_STOP_RESUME = ["--init-p", "4", "--schedule", "stop_resume_mp:2@5"]
# phase 6 (e): one step of the full-width fp32 model on one batch at
# (1, mp) against (1, 1). The two sum the same fp32 terms in another order
# (the row-parallel partial sums, the vocab shards' log-sum-exp): the loss
# within TP_LOSS_RTOL of (1, 1)'s, each gradient leaf within TP_GRAD_RTOL
# of it, norm-wise. The same step at bf16 compute, the control, must
# miss them, or they could not tell the runs apart. (a)'s first loss holds
# phase 4's at (1, 1) within TP_LOSS_RTOL too. Its later losses are
# printed, not held: AdamW's first updates are +-lr on every element
# whatever its gradient's size, so a gradient near 0 whose sign another
# summation order flips moves its weight by 2 lr, and any two orders drift
# apart step by step, data-parallel ones too (PERF.md §6).
TP_MPS = (2, 4)
TP_LOSS_RTOL = 1e-5
TP_GRAD_RTOL = 1e-3
# a stop-resume must stop training for more than this many stop-free
# scale-outs (the reference's test_stop_resume_is_much_slower)
STOP_RESUME_RATIO = 10
STOP_RESOLUTION_S = 1e-4        # ScalingRecord.summary rounds stop_s to it


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


def same_bits_twice(torch, fn) -> bool:
    """Two calls of ``fn`` (kernel launches returning a tuple of tensors) on
    the same inputs give the same bits in every output."""
    runs = [fn() for _ in range(2)]
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(*runs))


def backward_pair(ops, q, k, v, o, lse, do, opts):
    """dq, delta, dk and dv from the two backward kernels."""
    dq, delta = ops.flash_attn_bwd_dq_cuda(q, k, v, o, lse, do, **opts)
    dk, dv = ops.flash_attn_bwd_dkdv_cuda(q, k, v, lse, delta, do, **opts)
    return dq, delta, dk, dv


def check_attention(torch, ops):
    """Phase 3. Returns per-kernel records of each case of
    ``TIMED_CASES`` (case: kernel: record) and the record of the backward
    pair."""
    F = torch.nn.functional
    timed = {name: {} for name in TIMED_CASES}    # case: kernel: record
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
            if name in timed:
                timed[name][kname] = {"max_abs_err": err, "tolerance": t,
                                  "tolerance_scale": "1 + |plain| per element"}
        if name in DETERMINISM_CASES:
            fwd_same = same_bits_twice(
                torch, lambda: ops.flash_attn_fwd_cuda(q, k, v, **opts))
            bwd_same = same_bits_twice(torch, lambda: backward_pair(
                ops, q, k, v, o, lse, do, opts))
            print(f"  case {name:15s} run twice: forward o and lse "
                  f"{'bit-identical' if fwd_same else 'DIFFER'}; backward "
                  f"pair dq, dk, dv and delta "
                  f"{'bit-identical' if bwd_same else 'DIFFER'}", flush=True)
            if not (fwd_same and bwd_same):
                fail(f"the {'forward' if not fwd_same else 'backward pair'} "
                     f"is not deterministic in case {name}")

        if name not in timed:
            continue
        # time kernel, plain version and the library call at the main,
        # the virtual-worker and the tensor-parallel shapes
        records = timed[name]
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
        if name != ATT_MAIN_CASE[0]:
            continue
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
    return timed, pair


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
        # r, k, v, logw, dy, a, u, dsT, du_part -> dk, dlogw, ds0, du; du
        # adds B - 1 partials per (h, i)
        "wkv6_bwd_dk": (8 * seq + 2 * st + 2 * u + vec,
                        scan + (B - 1) * H * hd),
        # r, k, logw, dy, u, dsT -> dv
        "wkv6_bwd_dv": (5 * seq + st + u, scan),
    }


def check_wkv(torch, wops):
    """Phase 7. Returns per-kernel records at the main case's shape."""
    records = {}
    for seed, (name, B, L, H, hd, logw_kind) in enumerate(WKV_CASES):
        r, k, v, logw, u, s0, dy, dsT = wkv_inputs(torch, B, L, H, hd,
                                                   logw_kind, seed)
        y, sT = wops.wkv6_fwd_cuda(r, k, v, logw, u, s0)
        dr, a, du_part = wops.wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy, dsT)
        dk, dlogw, ds0, du = wops.wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT,
                                                   a, du_part)
        dv = wops.wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT)
        torch.cuda.synchronize()
        # each kernel against its plain version on the same inputs
        pairs = {
            "wkv6_fwd": ((y, sT), wops.wkv6_fwd_plain(r, k, v, logw, u, s0)),
            "wkv6_bwd_dr": ((dr, a, du_part), wops.wkv6_bwd_dr_plain(
                r, k, v, logw, u, s0, dy, dsT)),
            "wkv6_bwd_dk": ((dk, dlogw, ds0, du), wops.wkv6_bwd_dk_plain(
                r, k, v, logw, u, dy, dsT, a, du_part)),
            "wkv6_bwd_dv": ((dv,), (wops.wkv6_bwd_dv_plain(
                r, k, logw, u, dy, dsT),)),
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
                # the check compares max err / max|plain| with WKV_TOL
                records[kname] = {"max_abs_err": err, "max_rel_err": rel,
                                  "tolerance": WKV_TOL,
                                  "tolerance_scale": "max|plain|"}

        if name != WKV_MAIN_CASE[0]:
            continue
        for kname, outs, run in (
                ("wkv6_fwd", "y and sT",
                 lambda: wops.wkv6_fwd_cuda(r, k, v, logw, u, s0)),
                ("wkv6_bwd_dr", "dr, a and du_part",
                 lambda: wops.wkv6_bwd_dr_cuda(r, k, v, logw, u, s0, dy,
                                               dsT)),
                ("wkv6_bwd_dk", "dk, dlogw, ds0 and du",
                 lambda: wops.wkv6_bwd_dk_cuda(r, k, v, logw, u, dy, dsT,
                                               a, du_part)),
                ("wkv6_bwd_dv", "dv",
                 lambda: (wops.wkv6_bwd_dv_cuda(r, k, logw, u, dy, dsT),))):
            same = same_bits_twice(torch, run)
            print(f"  case {name:13s} {kname} run twice: {outs} "
                  f"{'bit-identical' if same else 'DIFFER'}", flush=True)
            if not same:
                fail(f"{kname} is not deterministic in the main case")
        kern = {
            "wkv6_fwd": lambda: wops.wkv6_fwd_cuda(r, k, v, logw, u, s0),
            "wkv6_bwd_dr": lambda: wops.wkv6_bwd_dr_cuda(r, k, v, logw, u,
                                                         s0, dy, dsT),
            "wkv6_bwd_dk": lambda: wops.wkv6_bwd_dk_cuda(r, k, v, logw, u,
                                                         dy, dsT, a, du_part),
            "wkv6_bwd_dv": lambda: wops.wkv6_bwd_dv_cuda(r, k, logw, u, dy,
                                                         dsT),
        }
        plain = {
            "wkv6_fwd": lambda: wops.wkv6_fwd_plain(r, k, v, logw, u, s0),
            "wkv6_bwd_dr": lambda: wops.wkv6_bwd_dr_plain(r, k, v, logw, u,
                                                          s0, dy, dsT),
            "wkv6_bwd_dk": lambda: wops.wkv6_bwd_dk_plain(r, k, v, logw, u,
                                                          dy, dsT, a, du_part),
            "wkv6_bwd_dv": lambda: wops.wkv6_bwd_dv_plain(r, k, logw, u, dy,
                                                          dsT),
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
        # the one PyTorch call that computes dk's du
        records["wkv6_bwd_dk"]["du_library_ms"] = cuda_ms(
            torch, lambda: du_part.sum(0))
    return records


def slot_steps(events: list, steps: int, init: tuple[int, int]) -> int:
    """Slot shards that a run's ``steps`` training steps ran: a step at
    (p, mp) runs p x mp. A switch commits after step ``switch_step``, so
    that step ran at the old shape. A record names its mp only when one
    side's is not 1."""
    total, (p, mp), prev = 0, init, 0
    for e in sorted(events, key=lambda e: e["switch_step"]):
        total += (e["switch_step"] - prev) * p * mp
        p, mp, prev = e["to_p"], e.get("to_mp", 1), e["switch_step"]
    return total + (steps - prev) * p * mp


def warm_shards(events: list, init: tuple[int, int], virtual: bool) -> int:
    """Slot shards that a run's context preps warmed: the launch prep and
    each cold switch's prep warm one data group (all groups share the
    card), mp slot shards, or one virtual worker's shard in virtual
    mode."""
    mps = [init[1]] + [e.get("to_mp", 1) for e in events
                       if not e["cache_hit"]]
    return len(mps) if virtual else sum(mps)


def check_launches(name: str, launches: dict, warm: dict, kernels,
                   per_shard: dict, n_shards: int, n_warm: int) -> dict:
    """Fail unless every kernel of the path launched and no other did, the
    context preps' warm-ups launched ``n_warm`` shards' worth and the rest
    ``per_shard`` a shard over the ``n_shards`` shards stepped. Returns the
    launches per shard stepped."""
    missing = [k for k in kernels if launches[k] <= 0]
    strays = {k: n for k, n in launches.items() if k not in kernels and n}
    if missing or strays:
        fail(f"{name}: kernels of the path not launched: {missing}; kernels "
             f"off the path launched: {strays}")
    got = {k: (launches[k] - warm[k]) / n_shards for k in kernels}
    want_warm = {k: n_warm * per_shard[k] for k in kernels}
    if got != per_shard or {k: warm[k] for k in kernels} != want_warm:
        fail(f"{name}: launches differ from the prediction: warm-ups "
             f"{ {k: warm[k] for k in kernels} } (predicted {want_warm}), "
             f"per shard of a step {got} (predicted {per_shard})")
    return got


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
             loss_must_fall: bool = True, init=(MAIN_INIT_P, 1)):
    """Phases 4, 6 (a) and 8: the port's trainer through its entry point,
    starting at shape ``init`` = (p, mp), with the launch counts reset just
    before and read just after. ``per_shard`` predicts each kernel's
    launches per slot shard of a step (and of a warm-up); with
    ``loss_must_fall`` the last loss must be below the first. Returns a
    record of the run."""
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
    events = summary["scaling_events"]
    n_slot_steps = slot_steps(events, summary["steps"], init)
    n_preps = 1 + sum(not e["cache_hit"] for e in events)
    n_warm = warm_shards(events, init, virtual=False)
    per_slot_step = check_launches(summary["arch"], launches, warm, kernels,
                                   per_shard, n_slot_steps, n_warm)
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
          f"({n_preps} preps, {n_warm} slot shards warmed); {n_slot_steps} "
          f"slot shards stepped, so per slot shard of a step "
          f"{per_slot_step}, as predicted", flush=True)
    return {"arch": summary["arch"], "steps": steps, "seconds": seconds,
            "init_state_s": sum(init_s), "mean_step_ms": step_ms,
            "samples_per_s": summary["throughput"], "peak_gib": peak_gib,
            "losses": losses, "first_loss": summary["first_loss"],
            "final_loss": summary["final_loss"],
            "scaling_events": summary["scaling_events"],
            "launches": launches, "warmup_launches": warm,
            "launches_per_slot_step": per_slot_step}


def vw_run(torch, launches_of, train, name: str, extra: list, kernels,
           per_shard: dict) -> dict:
    """One virtual-worker run of the entry point (``VW_ARGS + extra``),
    with the launch counts reset just before and read just after. A step
    runs ``VW_K`` shards at every (p, mp), so each kernel launches
    ``per_shard x VW_K`` times a step; each context prep warms one shard
    (all slots share the card). Returns a record of the run."""
    gc.collect()
    torch.cuda.empty_cache()
    buf = io.StringIO()
    launches_of.reset()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = train.main(VW_ARGS + extra)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = launches_of.snapshot()
    warm = launches_of.snapshot(warm=True)
    if rc != 0:
        fail(f"virtual-worker run {name}: main returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = summary["losses"]
    if len(losses) < VW_STEPS or \
            not all(math.isfinite(x) for x in losses):
        fail(f"virtual-worker run {name}: losses {losses}")
    if summary["unique_sample_frac"] != 1.0:
        fail(f"virtual-worker run {name}: unique_sample_frac "
             f"{summary['unique_sample_frac']}")
    events = summary["scaling_events"]
    n_preps = 1 + sum(not e["cache_hit"] for e in events)
    per_step = {k: n * VW_K for k, n in check_launches(
        f"virtual-worker run {name}", launches, warm, kernels, per_shard,
        summary["steps"] * VW_K, n_preps).items()}
    step_ms = 1e3 * MAIN_BATCH / summary["throughput"]
    run = {"args": extra, "steps": summary["steps"], "seconds": seconds,
           "mean_step_ms": step_ms, "final_p": summary["final_p"],
           "losses": losses, "scaling_events": events, "n_preps": n_preps,
           "launches": {k: launches[k] for k in kernels},
           "launches_per_step": per_step,
           "warmup_launches": {k: warm[k] for k in kernels}}
    print(f"  ({name}) {' '.join(extra)}: {summary['steps']} steps in "
          f"{seconds:.2f} s, mean step {step_ms:.1f} ms, final p "
          f"{summary['final_p']}", flush=True)
    print(f"    losses {losses}", flush=True)
    print(f"    scaling_events {json.dumps(events)}", flush=True)
    print(f"    launches per step {per_step} (predicted {VW_K} x "
          f"layers), warm-ups {run['warmup_launches']} "
          f"({n_preps} preps)", flush=True)
    return run


def run_vw_path(torch, launches_of, train, kernels, per_shard: dict) -> dict:
    """Phase 5: the four virtual-worker runs of ``VW_RUNS`` through the
    entry point (``vw_run``). Returns a record of the runs."""
    runs = {name: vw_run(torch, launches_of, train, name, extra, kernels,
                         per_shard)
            for name, extra in VW_RUNS.items()}
    want = runs["static"]["losses"][:VW_STEPS]
    for name in ("elastic", "kill", "stop_resume"):
        if runs[name]["losses"][:VW_STEPS] != want:
            fail(f"virtual-worker run {name}'s losses differ from the static "
                 f"run's: {runs[name]['losses']} vs {want}")
    elastic = runs["elastic"]["scaling_events"]
    if [(e["op"], e["to_p"]) for e in elastic] != [("scale_out", 4),
                                                   ("scale_in", 2)]:
        fail(f"elastic run: expected 1 -> 4 -> 2, got {elastic}")
    if not all(e["stop_s"] < e["prep_s"] for e in elastic):
        fail(f"elastic run: a switch was not stop-free: {elastic}")
    kill = [e for e in runs["kill"]["scaling_events"] if e["op"] == "scale_in"]
    if runs["kill"]["final_p"] != 2 or not kill or \
            (kill[0]["from_p"], kill[0]["to_p"]) != (4, 2):
        fail(f"kill run: expected detection's scale-in 4 -> 2, got "
             f"{runs['kill']['scaling_events']}")
    sr = [e for e in runs["stop_resume"]["scaling_events"]
          if e["op"] == "stop_resume"]
    # the records round stop_s to STOP_RESOLUTION_S: compare the least the
    # stop-resume's stop can have been with the most the scale-out's can
    # have been, so a rounded 0.0 cannot pass any stop-resume
    out_stop = elastic[0]["stop_s"]
    out_most = out_stop + STOP_RESOLUTION_S / 2
    if len(sr) != 1 or not (sr[0]["stop_s"] - STOP_RESOLUTION_S / 2
                            > STOP_RESUME_RATIO * out_most):
        fail(f"stop-resume run: its stop must exceed {STOP_RESUME_RATIO}x "
             f"the scale-out's (at most {out_most} s): "
             f"{runs['stop_resume']['scaling_events']}")
    print(f"  losses of (elastic), (kill) and (stop_resume) == (static), "
          f"step for step; stop-resume's stop {sr[0]['stop_s']} s against "
          f"the stop-free scale-out's {out_stop} s (rounded; at most "
          f"{out_most} s)", flush=True)
    return {"virtual_workers": VW_K, "runs": runs, "losses_equal": True,
            "stop_resume_stop_s": sr[0]["stop_s"],
            "scale_out_stop_s": out_stop}


def run_reshape_path(torch, launches_of, kernels, per_shard: dict, *,
                     virtual_workers=None) -> dict:
    """Phase 6 (b) and (c): an ``ElasticTrainer`` on four slots of the card
    at (4, 1), driven through ``reshape`` to each shape of ``RESHAPES`` in
    turn while it trains (each prep runs in the background; the switch
    commits at a later mini-batch boundary), to ``VW_STEPS`` steps, with the
    launch counts reset just before and read just after. Each switch must
    commit stop-free as a reshape to its shape. Returns a record of the
    run."""
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer
    from repro_torch.devices import slot_devices
    from repro_torch.optim import adamw
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches_of.reset()
    t0 = time.monotonic()
    init = (4, 1)
    with ElasticTrainer(get_config("edl-paper"), global_batch=MAIN_BATCH,
                        seq_len=1024, init_parallelism=init[0],
                        optimizer=adamw(1e-3), n_samples=1024,
                        d_partitions=16, seed=0,
                        devices=slot_devices(4, "cuda"),
                        virtual_workers=virtual_workers) as t:
        t.run(3)
        for p, mp in RESHAPES:
            if t.reshape(p, mp) is not None:
                fail(f"reshape({p}, {mp}) committed without a prep")
            t.wait_for_scaling()
            t.run(1)
        t.run(max(0, VW_STEPS - t.step_idx))
        events = [r.summary() for r in t.controller.history]
        losses = [m["loss"] for m in t.metrics_log]
        throughput = t.throughput()
        steps = t.step_idx
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = launches_of.snapshot()
    warm = launches_of.snapshot(warm=True)
    name = "reshape" + ("_vw" if virtual_workers else "")
    if [(e["op"], e["to_p"], e.get("to_mp", 1)) for e in events] != \
            [("reshape", p, mp) for p, mp in RESHAPES]:
        fail(f"{name}: expected reshapes to {RESHAPES}, got {events}")
    if not all(e["stop_s"] < e["prep_s"] for e in events):
        fail(f"{name}: a switch was not stop-free: {events}")
    if len(losses) < VW_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: losses {losses}")
    if not virtual_workers and not losses[-1] < losses[0]:
        fail(f"{name}: loss did not fall: {losses}")
    if virtual_workers:
        n_shards = steps * virtual_workers
    else:
        n_shards = slot_steps(events, steps, init)
    n_warm = warm_shards(events, init, virtual=bool(virtual_workers))
    per_shard_got = check_launches(name, launches, warm, kernels, per_shard,
                                   n_shards, n_warm)
    step_ms = 1e3 * MAIN_BATCH / throughput
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    moves = [{k: e[k] for k in ("from_p", "from_mp", "to_p", "to_mp",
                                "prep_s", "stop_s", "stage_s",
                                "reshard_bytes_moved", "reshard_bytes_kept",
                                "bytes_moved_overlapped")}
             for e in events]
    print(f"  ({name}) (4, 1) -> " + " -> ".join(map(str, RESHAPES))
          + f": {steps} steps in {seconds:.2f} s, mean step {step_ms:.1f} ms"
          f" over the last {min(steps, 20)}, peak {peak_gib:.2f} GiB",
          flush=True)
    print(f"    losses {losses}", flush=True)
    for m in moves:
        print(f"    reshape {json.dumps(m)}", flush=True)
    print(f"    launches { {k: launches[k] for k in kernels} }, warm-ups "
          f"{ {k: warm[k] for k in kernels} } ({n_warm} shards warmed); "
          f"{n_shards} shards stepped, per shard {per_shard_got}, as "
          f"predicted", flush=True)
    return {"steps": steps, "seconds": seconds, "mean_step_ms": step_ms,
            "samples_per_s": throughput, "peak_gib": peak_gib,
            "virtual_workers": virtual_workers or 0, "losses": losses,
            "scaling_events": events, "reshapes": moves,
            "launches": {k: launches[k] for k in kernels},
            "warmup_launches": {k: warm[k] for k in kernels},
            "launches_per_shard_step": per_shard_got}


def check_tp_numbers(torch) -> dict:
    """Phase 6 (e): one step's loss and gradients of the full-width fp32
    edl_paper model on one batch, at (1, mp) for each mp of ``TP_MPS``
    (the tensor-parallel default step's ``group_loss_and_grads`` over mp
    slots of the card) against (1, 1): the loss within ``TP_LOSS_RTOL``,
    each gradient leaf norm-wise within ``TP_GRAD_RTOL``. The same step at
    bf16 compute must miss them. Returns the readings."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import ShardedParams, model_dims
    from repro_torch.training.step import group_loss_and_grads, \
        loss_and_grads, port_layout, shard_batch, split_tree
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("edl-paper")
    dev = torch.device("cuda:0")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab,
                                             (MAIN_BATCH, 1025))
    batch = shard_batch({"tokens": toks[:, :-1], "labels": toks[:, 1:]}, 1,
                        [dev])[0]
    loss1, _, grads1 = loss_and_grads(cfg, params, batch)
    want = dict(tree_leaves(grads1))

    def deviation(loss, grads) -> dict:
        errs = {k: float((grads[k] - g).norm() / g.norm())
                for k, g in want.items()}
        worst = max(errs, key=errs.get)
        return {"loss": float(loss),
                "loss_rel_err": abs(float(loss) - float(loss1))
                / abs(float(loss1)),
                "worst_leaf": worst, "worst_leaf_rel_err": errs[worst]}

    def within(r: dict) -> bool:
        return r["loss_rel_err"] <= TP_LOSS_RTOL and \
            r["worst_leaf_rel_err"] <= TP_GRAD_RTOL

    readings = {}
    for mp in TP_MPS:
        devs = [dev] * mp
        dims = model_dims(port_layout(cfg, adamw(1e-3), 1, mp))
        loss, _, grads = group_loss_and_grads(
            cfg, split_tree(params, dims, devs), dims, devs, batch)
        readings[f"mp{mp}"] = deviation(
            loss, dict(tree_leaves(ShardedParams(grads, dims,
                                                 tuple(devs)).whole())))
        del grads
    loss, _, grads = loss_and_grads(
        dataclasses.replace(cfg, compute_dtype="bfloat16"), params, batch)
    readings["bf16_control"] = deviation(
        loss, {k: g.float() for k, g in tree_leaves(grads)})
    del grads, grads1, want, params
    for name, r in readings.items():
        print(f"  (e) {name} against (1, 1): loss {r['loss']!r} "
              f"(rel err {r['loss_rel_err']:.3e}, tolerance {TP_LOSS_RTOL}); "
              f"worst gradient leaf {r['worst_leaf']}, norm-wise rel err "
              f"{r['worst_leaf_rel_err']:.3e} (tolerance {TP_GRAD_RTOL})",
              flush=True)
    bad = [name for name in readings if name != "bf16_control"
           and not within(readings[name])]
    if bad:
        fail(f"tensor-parallel step differs from (1, 1): {bad}: {readings}")
    if within(readings["bf16_control"]):
        fail(f"the bf16 control is within the tolerances, which so cannot "
             f"tell the runs apart: {readings['bf16_control']}")
    return {"loss_1_1": float(loss1), "loss_rtol": TP_LOSS_RTOL,
            "grad_rtol": TP_GRAD_RTOL, **readings}


def before_switch(run: dict) -> list:
    """The losses of a ``run_path`` record's steps before its first switch
    committed."""
    return run["losses"][:min(e["switch_step"]
                              for e in run["scaling_events"])]


def run_mp_path(torch, launches_of, train, kernels, per_shard: dict,
                mp1_run: dict, static_losses: list) -> dict:
    """Phase 6: (a) the entry point at mp = 2 through a stop-free scale-out,
    whose losses before the switch must hold ``mp1_run``'s (phase 4's, at
    (1, 1)) within ``TP_LOSS_RTOL`` at step 0;
    (b) and (c) ``reshape`` without and with virtual workers; (d) a
    stop-resume onto mp = 2 under virtual workers; (c)'s and (d)'s losses
    equal to ``static_losses`` (phase 5's static run) step for step; (e)
    one step at (1, 2) and (1, 4) against (1, 1) (``check_tp_numbers``).
    Returns a record of the runs."""
    print("  (a) python -m repro_torch.launch.train " + " ".join(MP_ARGS),
          flush=True)
    runs = {"scale_out_mp2": run_path(torch, launches_of, train, MP_ARGS,
                                      kernels, per_shard, init=MP_INIT)}
    got, want = before_switch(runs["scale_out_mp2"]), before_switch(mp1_run)
    n = min(len(got), len(want))
    errs = [abs(a - b) / abs(b) for a, b in zip(got[:n], want[:n])]
    print(f"  (a) its {n} steps before the switch against phase 4's at "
          f"(1, 1): loss rel errs {['%.3e' % e for e in errs]} (step 0 "
          f"held to {TP_LOSS_RTOL}; the later steps drift, see (e))",
          flush=True)
    if not errs[0] <= TP_LOSS_RTOL:
        fail(f"(1, 2)'s first loss {got[0]} differs from (1, 1)'s {want[0]}")
    print("  (b) ElasticTrainer at (4, 1), reshape to " + ", then ".join(
        map(str, RESHAPES)), flush=True)
    runs["reshape"] = run_reshape_path(torch, launches_of, kernels,
                                       per_shard)
    print(f"  (c) the same with virtual_workers={VW_K}", flush=True)
    runs["reshape_vw"] = run_reshape_path(torch, launches_of, kernels,
                                          per_shard, virtual_workers=VW_K)
    print("  (d) python -m repro_torch.launch.train " + " ".join(
        VW_ARGS + MP_STOP_RESUME), flush=True)
    runs["stop_resume_mp"] = vw_run(torch, launches_of, train,
                                    "stop_resume_mp", MP_STOP_RESUME,
                                    kernels, per_shard)
    sr = runs["stop_resume_mp"]["scaling_events"]
    if [(e["op"], e["to_p"], e.get("to_mp", 1)) for e in sr] != \
            [("stop_resume", 2, 2)]:
        fail(f"stop_resume_mp run: expected one stop-resume to (2, 2), got "
             f"{sr}")
    for name in ("reshape_vw", "stop_resume_mp"):
        if runs[name]["losses"][:VW_STEPS] != static_losses:
            fail(f"{name}'s losses differ from phase 5's static run's: "
                 f"{runs[name]['losses']} vs {static_losses}")
    print(f"  losses of (c) and (d) == phase 5's static run, step for step",
          flush=True)
    print(f"  (e) one step of the full-width model on one batch at (1, mp), "
          f"mp in {TP_MPS}, against (1, 1)", flush=True)
    return {"runs": runs, "losses_equal_static": True,
            "before_switch_loss_rel_errs": errs,
            "one_step": check_tp_numbers(torch)}


def refit_and_hold_out(torch, arch: str, steps: int = 4) -> dict:
    """Phase 8's learning checks, on the trainer that ``launch/train.py``
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


# phase 9: the cluster tier on CLUSTER_SLOTS slots of the card, tenants of
# full-width edl_paper at global batch 8, sequence 1024, AdamW 1e-3 (the
# trainer default_trainer_factory builds, from CONFIG). (a) throughput
# policy with telemetry and a trace; (b) Tiresias preempts the vw = 8
# tenant a to disk and re-admits it; (c) a worker of x dies and a slot of y
# is revoked; (d) the entry point with the reference's default jobs at
# their SMOKE width, for a few rounds
CLUSTER_SLOTS, CLUSTER_RESCHED = 4, 3
CLUSTER_JOB_KW = dict(batch=MAIN_BATCH, seq=1024, n_samples=1024,
                      d_partitions=16)
CLUSTER_RUNS = {
    "throughput": ("a=vgg19:2:16@0,b=resnet50:1:16@0,c=googlenet:1:10@4",
                   "throughput", {}),
    "tiresias": ("a=resnet50:2:12:vw=8@0,b=vgg19:4:8@3", "tiresias",
                 {"quanta": (0.1, 1000.0)}),
    "chaos": ("x=resnet50:2:14@0,y=googlenet:2:14@0", "static", {}),
}
CLUSTER_FAULTS = (dict(kind="kill_worker", at=2, jid=0, worker=1),
                  dict(kind="revoke_devices", at=4, jid=1, n_devices=1))
CLUSTER_MAIN_ARGS = ["--device", "cuda", "--devices", str(CLUSTER_SLOTS),
                     "--json", "--max-rounds", "12"]
# a switch whose prep was a cache lookup stops for the swap alone: it must
# stop for well under one full-width step (~210 ms, phase 4)
STOP_HIT_S = 0.05


@contextlib.contextmanager
def counted_warm_ups(groups: list):
    """Append, for each context prep's warm-up while the block runs, the
    data groups it warms: one shard each (all slots share the card), one
    launch of each attention kernel per layer."""
    from repro_torch.core.elastic_runtime import ElasticTrainer
    inner = ElasticTrainer._warm

    def warm(self, gs):
        groups.append(len(dict.fromkeys(gs)))
        return inner(self, gs)

    ElasticTrainer._warm = warm
    try:
        yield
    finally:
        ElasticTrainer._warm = inner


def cluster_tools(torch):
    """Phase 9's executor, checkpointer and trainer factory: the port's own
    with clocks on them. ``Tenants`` builds each trainer exactly as
    ``default_trainer_factory`` does, from CONFIG, and records it with its
    build seconds and the sample ids each of its steps consumed."""
    from repro_torch.cluster import ClusterExecutor, DiskCheckpointer
    from repro_torch.cluster.executor import default_trainer_factory

    class TimedExecutor(ClusterExecutor):
        """Records the wall clock at each round's start and at each
        finish, for JCTs in seconds."""

        def __init__(self, *args, **kw):
            self.round_t, self.finish_t = {}, {}
            super().__init__(*args, **kw)

        def _admit_arrivals(self):
            self.round_t.setdefault(self.round, time.monotonic())
            super()._admit_arrivals()

        def _finish(self, job):
            super()._finish(job)
            self.finish_t[job.jid] = time.monotonic()

    class TimedCheckpointer(DiskCheckpointer):
        def __init__(self):
            super().__init__()
            self.restore_s = []

        def restore(self, job, trainer):
            t0 = time.monotonic()
            super().restore(job, trainer)
            torch.cuda.synchronize()
            self.restore_s.append(time.monotonic() - t0)

    class Tenants:
        def __init__(self):
            self.built, self.ids = [], {}

        def __call__(self, spec, devices):
            t0 = time.monotonic()
            t = default_trainer_factory(spec, devices, smoke=False)
            torch.cuda.synchronize()
            self.built.append((spec.name, t, time.monotonic() - t0))
            ids, step = self.ids.setdefault(spec.name, []), t.step

            def counted_step():
                m = step()
                if m is not None:
                    ids.append(t._last_sample_ids)
                return m
            t.step = counted_step
            return t

        def metrics(self, name: str) -> list:
            return [m for n, t, _ in self.built if n == name
                    for m in t.metrics_log]

    return TimedExecutor, TimedCheckpointer, Tenants


def check_adjustment_spans(obs, n_committed: int) -> int:
    """Every committed switch's span tree in the trace: its root, with
    plan, prep, drain and stop_window inside it on its tenant's track and a
    ``commit`` instant at its end. Returns the trees found."""
    spans, marks = obs.tracer.spans, obs.tracer.instants
    roots = [s for s in spans if s["cat"] == "adjust" and "->" in s["name"]]
    for root in roots:
        kids = {s["name"] for s in spans if s["tid"] == root["tid"]
                and s is not root and s["cat"] == "adjust"
                and root["t0"] <= s["t0"] <= s["t1"] <= root["t1"]}
        commit = [m for m in marks if m["name"] == "commit"
                  and m["tid"] == root["tid"] and m["t"] == root["t1"]]
        if not {"plan", "prep", "drain", "stop_window"} <= kids or \
                not commit:
            fail(f"cluster trace: adjustment {root} lacks nested spans or "
                 f"its commit: {sorted(kids)}")
    if len(roots) != n_committed or not roots:
        fail(f"cluster trace: {len(roots)} adjustment trees for "
             f"{n_committed} committed switches")
    return len(roots)


def run_cluster(torch, launches_of, kernels, per_shard: dict, name: str,
                step_ms_ref: float, *, faults=None, obs=None) -> tuple:
    """One run of ``CLUSTER_RUNS[name]`` through ``ClusterExecutor`` on
    ``CLUSTER_SLOTS`` slots of the card, with the launch counts reset just
    before and read just after. Every tenant must finish its steps with
    finite losses and exactly-once data (a deterministic tenant's whole
    trajectory is checked by its caller), every committed switch must be
    stop-free, and the launches must equal the prediction: per layer, one
    of each attention kernel a shard stepped (p shards a step, K under
    virtual workers) and one a data group warmed. The executor asserts
    conservation every round. Returns a record and the executor."""
    from repro_torch.cluster import make_policy
    from repro_torch.devices import slot_devices
    from repro_torch.launch.cluster import parse_jobs
    TimedExecutor, TimedCheckpointer, Tenants = cluster_tools(torch)
    jobs, policy, policy_kw = CLUSTER_RUNS[name]
    specs = parse_jobs(jobs, **CLUSTER_JOB_KW)
    tenants, ckpt, warmed = Tenants(), TimedCheckpointer(), []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches_of.reset()
    t0 = time.monotonic()
    ex = TimedExecutor(specs, make_policy(policy, **policy_kw),
                       devices=slot_devices(CLUSTER_SLOTS, "cuda"),
                       resched_every=CLUSTER_RESCHED,
                       trainer_factory=tenants, checkpointer=ckpt,
                       faults=faults, obs=obs)
    with counted_warm_ups(warmed):
        try:
            stats = ex.run(max_rounds=400)
        finally:
            ex.close()
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = launches_of.snapshot()
    warm = launches_of.snapshot(warm=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if stats["finished"] != len(specs) or not stats["conserved"]:
        fail(f"cluster {name}: {stats['finished']} of {len(specs)} tenants "
             f"finished, conserved {stats['conserved']}: {stats['events']}")
    # a dead worker's partition replays from its start (the reference's
    # recovery; the dynamic pipeline's release(dead=True)): at-least-once
    killed = {e["job"] for e in stats["events"] if e["op"] == "worker_dead"}
    tenant_rows = {}
    for spec in specs:
        job = next(j for j in ex.jobs.values() if j.spec.name == spec.name)
        ms = tenants.metrics(spec.name)
        losses = [m["loss"] for m in ms]
        if len(losses) != spec.total_steps or \
                not all(math.isfinite(x) for x in losses):
            fail(f"cluster {name}: tenant {spec.name} losses {losses}")
        ids = [int(i) for b in tenants.ids[spec.name] for i in b]
        if not spec.virtual_workers and spec.name not in killed and \
                len(set(ids)) != len(ids):
            fail(f"cluster {name}: tenant {spec.name} saw a sample twice")
        arrived = ex.round_t[math.ceil(spec.arrival)]
        tenant_rows[spec.name] = {
            "jct_rounds": job.finish_time - job.arrival,
            "jct_s": ex.finish_t[job.jid] - arrived,
            "median_step_ms": 1e3 * sorted(
                m["step_time"] for m in ms)[len(ms) // 2],
            "losses": losses, "unique_samples": len(set(ids)),
            "samples": len(ids)}
    records = [(n, r.summary()) for n, t, _ in tenants.built
               for r in t.controller.history]
    for n, r in records:
        if r["cache_hit"] and not r["stop_s"] < STOP_HIT_S or \
                not r["cache_hit"] and not r["stop_s"] < r["prep_s"]:
            fail(f"cluster {name}: tenant {n}'s switch was not stop-free: "
                 f"{r}")
    n_shards = sum(t.n_virtual or m["p"] for _, t, _ in tenants.built
                   for m in t.metrics_log)
    per_shard_got = check_launches(f"cluster {name}", launches, warm,
                                   kernels, per_shard, n_shards,
                                   sum(warmed))
    print(f"  ({name}) {jobs}: policy {policy} {policy_kw or ''}, "
          f"{stats['rounds']} rounds in {seconds:.2f} s, peak "
          f"{peak_gib:.2f} GiB allocated", flush=True)
    for e in stats["events"]:
        print(f"    round {e['round']:3d} {e['op']:>15s} {e['job'] or '-':>2s}"
              f" p {e['from_p']} -> {e['to_p']} loaned {e['loaned']} "
              f"slots {e.get('devices')}", flush=True)
    for n, r in records:
        print(f"    {n} {r['op']} {r['from_p']} -> {r['to_p']}: stop_s "
              f"{r['stop_s']} prep_s {r['prep_s']} cache_hit "
              f"{r['cache_hit']} steps during prep "
              f"{r['steps_during_prep']}", flush=True)
    for n, row in tenant_rows.items():
        print(f"    tenant {n}: JCT {row['jct_rounds']} rounds, "
              f"{row['jct_s']:.2f} s; median step {row['median_step_ms']:.1f}"
              f" ms against phase 4's single-job {step_ms_ref:.1f} ms; "
              f"losses {row['losses'][0]:.4f} -> {row['losses'][-1]:.4f}; "
              f"{row['unique_samples']} distinct of {row['samples']} "
              f"samples", flush=True)
    print(f"    trainer builds (s): "
          f"{[(n, round(s, 2)) for n, _, s in tenants.built]}; launches "
          f"{ {k: launches[k] for k in kernels} }, warm-ups "
          f"{ {k: warm[k] for k in kernels} } ({sum(warmed)} shards "
          f"warmed); {n_shards} shards stepped, per shard {per_shard_got}, "
          f"as predicted", flush=True)
    record = {"jobs": jobs, "policy": policy, "seconds": seconds,
              "rounds": stats["rounds"], "peak_gib": peak_gib,
              "tenants": tenant_rows,
              "switches": [{"tenant": n, **r} for n, r in records],
              "events": stats["events"],
              "trainer_build_s": [(n, s) for n, _, s in tenants.built],
              "restore_s": ckpt.restore_s,
              "recovery_latencies_s": ex.recovery_latencies,
              "launches": {k: launches[k] for k in kernels},
              "warmup_launches": {k: warm[k] for k in kernels},
              "launches_per_shard_step": per_shard_got}
    return record, ex


def spans_named(obs, name: str) -> list:
    return [s["t1"] - s["t0"] for s in obs.tracer.spans if s["name"] == name]


def run_cluster_path(torch, launches_of, kernels, per_shard: dict,
                     step_ms_ref: float) -> dict:
    """Phase 9 (a)-(d). Returns a record of the runs."""
    import tempfile
    from repro_torch.chaos import FaultEvent, FaultPlan
    from repro_torch.launch import cluster
    from repro_torch.launch.cluster import parse_jobs
    from repro_torch.obs import Observability, report
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tel = os.path.join(tmp, "telemetry.jsonl")
        obs = Observability(telemetry_out=tel,
                            trace_out=os.path.join(tmp, "trace.json"))
        rec, ex = run_cluster(torch, launches_of, kernels, per_shard,
                              "throughput", step_ms_ref, obs=obs)
        obs.close()
        records = report.load(tel)
        problems = report.validate(records)
        if problems or not records:
            fail(f"cluster telemetry: {problems[:5]}")
        n_trees = check_adjustment_spans(obs, len(rec["switches"]))
    events = rec["events"]
    c_in = next((i for i, e in enumerate(events) if e["op"] == "scale_out"
                 and e["job"] == "c" and e["from_p"] == 0), None)
    # the shrinks that last handed back a slot c was admitted on, and
    # those of them whose prep was cold: stop_s < prep_s
    shrinks = set()
    for slot in events[c_in]["devices"] if c_in is not None else ():
        back = [e for e in events[:c_in] if slot in e.get("devices", ())
                and e["op"] in ("scale_out", "scale_in")]
        if back and back[-1]["op"] == "scale_in":
            shrinks.add((back[-1]["job"], back[-1]["from_p"],
                         back[-1]["to_p"]))
    funding = [r for r in rec["switches"] if r["op"] == "scale_in"
               and (r["tenant"], r["from_p"], r["to_p"]) in shrinks
               and not r["cache_hit"] and r["stop_s"] < r["prep_s"]]
    if c_in is None or not funding:
        fail(f"cluster throughput: c's admission was not funded by a "
             f"stop-free shrink: {events}")
    for n, row in rec["tenants"].items():
        if not row["losses"][-1] < row["losses"][0]:
            fail(f"cluster throughput: tenant {n}'s loss did not fall: "
                 f"{row['losses']}")
    print(f"    c admitted at round {events[c_in]['round']} on slots "
          f"{events[c_in]['devices']}, funded by {funding[0]['tenant']}'s "
          f"stop-free shrink (stop_s {funding[0]['stop_s']}, prep_s "
          f"{funding[0]['prep_s']}); telemetry: {len(records)} records, all "
          f"valid; trace: {n_trees} adjustment trees, each nested with its "
          f"commit", flush=True)
    out["throughput"] = {**rec, "telemetry_records": len(records),
                         "adjustment_trees": n_trees}
    del ex

    a_spec = parse_jobs(CLUSTER_RUNS["tiresias"][0], **CLUSTER_JOB_KW)[0]
    from repro_torch.cluster.executor import default_trainer_factory
    from repro_torch.devices import slot_devices
    with default_trainer_factory(a_spec, slot_devices(1, "cuda"),
                                 smoke=False) as t:
        static = [t.step()["loss"] for _ in range(a_spec.total_steps)]
    del t
    obs = Observability()
    rec, ex = run_cluster(torch, launches_of, kernels, per_shard,
                          "tiresias", step_ms_ref, obs=obs)
    ops = [(e["op"], e["job"]) for e in rec["events"]]
    pre = [e for e in rec["events"] if e["op"] == "preempt"
           and e["job"] == "a"]
    back = [e for e in rec["events"] if e["op"] == "readmit"
            and e["job"] == "a"]
    if not pre or not back or set(back[0]["devices"]) == \
            set(pre[0]["devices"]):
        fail(f"cluster tiresias: a was not preempted to disk and "
             f"re-admitted on other slots: {ops}")
    if rec["tenants"]["a"]["losses"] != static:
        fail(f"cluster tiresias: a's losses differ from its static run's: "
             f"{rec['tenants']['a']['losses']} vs {static}")
    saves = spans_named(obs, "checkpoint_save")
    builds = [s for n, s in rec["trainer_build_s"] if n == "a"]
    print(f"    a: checkpoint-stopped on slots {pre[0]['devices']}, "
          f"re-admitted on {back[0]['devices']}; its {len(static)} losses "
          f"== its static single-slot run's, step for step; checkpoint "
          f"saves (s) {[round(x, 2) for x in saves]}; re-admission prep: "
          f"trainer build {builds[-1]:.2f} s, restore "
          f"{[round(x, 2) for x in rec['restore_s']]} s", flush=True)
    out["tiresias"] = {**rec, "static_losses": static,
                       "checkpoint_save_s": saves, "losses_equal": True}
    del ex

    plan = FaultPlan(events=[FaultEvent(**e) for e in CLUSTER_FAULTS])
    obs = Observability()
    rec, ex = run_cluster(torch, launches_of, kernels, per_shard, "chaos",
                          step_ms_ref, faults=plan, obs=obs)
    dead = [e for e in rec["events"] if e["op"] == "worker_dead"]
    revoked = [e for e in rec["events"] if e["op"] == "revoke"]
    gone = set(range(CLUSTER_SLOTS)) - {s.id for s in ex.devices}
    if len(dead) != 1 or len(revoked) != 1 or \
            gone != set(dead[0]["devices"]) | set(revoked[0]["devices"]) \
            or ex.n_gpus != CLUSTER_SLOTS - 2 or \
            len(ex.recovery_latencies) != 2 or \
            (ex.workers_killed, ex.devices_revoked) != (1, 1):
        fail(f"cluster chaos: expected the dead worker's slot and the "
             f"revoked slot, and only those, to leave, with two recoveries:"
             f" {rec['events']}")
    print(f"    x's worker {dead[0]['workers']} died on slot "
          f"{dead[0]['devices']}, y's slot {revoked[0]['devices']} was "
          f"revoked; the pool lost exactly slots {sorted(gone)} "
          f"({CLUSTER_SLOTS} -> {ex.n_gpus}); recovery latencies (s) "
          f"{[round(x, 3) for x in ex.recovery_latencies]}", flush=True)
    out["chaos"] = {**rec, "slots_lost": sorted(gone),
                    "recovery_spans_s": spans_named(obs, "recovery")}
    del ex

    from repro_torch.configs import get_config
    smoke_layers = get_config("edl-paper", smoke=True).n_layers
    warmed = []
    gc.collect()
    torch.cuda.empty_cache()
    launches_of.reset()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf), counted_warm_ups(warmed):
        rc = cluster.main(CLUSTER_MAIN_ARGS)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = launches_of.snapshot()
    warm = launches_of.snapshot(warm=True)
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    strays = {k: n for k, n in launches.items() if k not in kernels and n}
    stepped = {k: launches[k] - warm[k] for k in kernels}
    if rc != 0 or not stats["conserved"] or strays or \
            warm != {**dict.fromkeys(launches, 0),
                     **{k: sum(warmed) * smoke_layers for k in kernels}} or \
            not all(n > 0 and n % smoke_layers == 0
                    for n in stepped.values()):
        fail(f"cluster main: rc {rc}, conserved {stats['conserved']}, "
             f"launches {launches}, warm-ups {warm} ({sum(warmed)} shards "
             f"warmed)")
    print(f"  (main) python -m repro_torch.launch.cluster "
          f"{' '.join(CLUSTER_MAIN_ARGS)}: {stats['rounds']} rounds in "
          f"{seconds:.2f} s, device conservation: OK; launches "
          f"{ {k: launches[k] for k in kernels} }, warm-ups "
          f"{ {k: warm[k] for k in kernels} } ({sum(warmed)} shards "
          f"warmed at {smoke_layers} layers)", flush=True)
    out["main"] = {"args": CLUSTER_MAIN_ARGS, "seconds": seconds,
                   "rounds": stats["rounds"], "conserved": True,
                   "events": stats["events"],
                   "launches": {k: launches[k] for k in kernels},
                   "warmup_launches": {k: warm[k] for k in kernels}}
    return out


def shape_record(r: dict) -> dict:
    """A kernel's record at one more timed shape, for its kernel entry."""
    return {**{k: r[k] for k in ("max_abs_err", "tolerance", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "bytes", "flops",
                                 "library_ms", "shape")},
            "share_of_bound": r["bound_ms"] / r["ms"]}


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
    print(f"[1/10] device: {kind} ({card}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    built = build.build_all(force=True)
    print(f"[2/10] built {sorted(built)} with {build.nvcc_path()} "
          f"{' '.join(build.NVCC_FLAGS)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    if sorted(built) != sorted(build.SOURCES):
        fail(f"built {sorted(built)}, sources {sorted(build.SOURCES)}")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3/10] attention kernels against their plain versions", flush=True)
    timed, pair = check_attention(torch, aops)
    records = dict(timed[ATT_MAIN_CASE[0]])

    edl = get_config("edl-paper")
    print("[4/10] edl_paper path: python -m repro_torch.launch.train "
          + " ".join(EDL_ARGS), flush=True)
    # forward, dq and dkdv once per layer and shard
    edl_shard = dict.fromkeys(aops.KERNELS, edl.n_layers)
    paths = {"edl-paper": run_path(
        torch, LAUNCHES, train, EDL_ARGS, aops.KERNELS, edl_shard)}

    print("[5/10] edl_paper virtual-worker path: python -m "
          "repro_torch.launch.train " + " ".join(VW_ARGS) + " with "
          + "; ".join(f"({n}) {' '.join(a)}" for n, a in VW_RUNS.items()),
          flush=True)
    vw = run_vw_path(torch, LAUNCHES, train, aops.KERNELS, edl_shard)

    print("[6/10] edl_paper model-parallel path on four slots of the card",
          flush=True)
    mp = run_mp_path(torch, LAUNCHES, train, aops.KERNELS, edl_shard,
                     paths["edl-paper"],
                     vw["runs"]["static"]["losses"][:VW_STEPS])

    print("[7/10] WKV6 kernels against their plain versions", flush=True)
    records.update(check_wkv(torch, wops))

    rwkv = get_config("rwkv6-1.6b")
    print("[8/10] rwkv6 path: python -m repro_torch.launch.train "
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
                "tolerance": r["tolerance"],
                "tolerance_scale": r["tolerance_scale"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                "share_of_bound": r["bound_ms"] / r["ms"], "bytes": r["bytes"],
                "flops": r["flops"], "library_ms": r["library_ms"],
                # the WKV6 kernels' compared error, dk's du yardstick
                **{k: r[k] for k in ("max_rel_err", "du_library_ms") if k in r},
                "shape": r["shape"], "card": card})
            if kname not in aops.KERNELS:
                continue
            kernels[-1]["virtual_worker_shape"] = {
                **shape_record(timed[ATT_VW_CASE[0]][kname]),
                "launches_per_step": vw["runs"]["static"][
                    "launches_per_step"][kname],
                "launches_static_run": vw["runs"]["static"]["steps"]
                * vw["runs"]["static"]["launches_per_step"][kname]}
            kernels[-1]["model_parallel_shapes"] = {
                case: shape_record(timed[case][kname])
                for case, *_ in ATT_MP_CASES}
            # each phase-6 run's launches, counted from 0 just before it
            kernels[-1]["model_parallel_path"] = {
                name: {"launches": run["launches"][kname],
                       "warmup_launches": run["warmup_launches"][kname]}
                for name, run in mp["runs"].items()}
    print(f"[9/10] the cluster tier on {CLUSTER_SLOTS} slots of the card: "
          f"ClusterExecutor with full-width edl_paper tenants, then "
          f"repro_torch.launch.cluster.main", flush=True)
    cluster = run_cluster_path(torch, LAUNCHES, aops.KERNELS, edl_shard,
                               paths["edl-paper"]["mean_step_ms"])
    for entry in kernels:
        if entry["name"] in aops.KERNELS:
            # each phase-9 run's launches, counted from 0 just before it
            entry["cluster_path"] = {
                name: {"launches": run["launches"][entry["name"]],
                       "warmup_launches":
                           run["warmup_launches"][entry["name"]]}
                for name, run in cluster.items()}
    print(f"  {card}", flush=True)
    print("[10/10] results; library_ms is F.scaled_dot_product_attention for "
          "the attention kernels (its forward for flash_attn_fwd, its whole "
          "backward for both backward kernels) and null for the WKV6 "
          "kernels, whose outputs no single PyTorch call computes; "
          "wkv6_bwd_dk's du_library_ms is du_part.sum(0), the one call that "
          "computes its du", flush=True)
    print(json.dumps({"backward_pair": {**pair, "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_paths": {
        **{name: {k: v for k, v in run.items()
                  if k not in ("launches", "warmup_launches")}
           for name, run in paths.items()},
        "virtual_workers": vw, "model_parallel": mp, "cluster": cluster},
        "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
