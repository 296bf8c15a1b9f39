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
3. kernels: call each kernel's wrapper on CUDA tensors at the training
   path's shape and at GQA, window, ragged, non-causal, head-dim and bf16
   cases, and hold it against its plain PyTorch version on the same inputs;
   time kernel, plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only: the port never calls it);
4. main path: ``repro_torch.launch.train.main`` trains the full-width
   ``edl_paper`` decoder through a stop-free scale-out, with the launch
   counts reset just before and read just after; the loss must be finite
   and fall, the scale-out commit stop-free, the data exactly-once, and every
   kernel launched. The launches made by the context preps' warm-ups are
   counted apart, and the rest over the slot shards stepped gives the
   launches per slot shard of a training step;
5. print ``{"kernels": [...]}``, the main path's step time, the card line,
   and last ``{"ok": true, "device": {...}}``.

Peaks for the bounds are NVIDIA's published H100 SXM figures at 700 W.
"""
import contextlib
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
REPLACES = "src/repro/kernels/attention/kernel.py:85"
SOURCE = "src/repro_torch/kernels/csrc/flash_attn.cu"

# name, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len, dtype
MAIN_CASE = ("main_p1", 8, 12, 12, 1024, 1024, 64, True, 0, None, "float32")
CASES = [
    MAIN_CASE,
    ("main_p2", 4, 12, 12, 1024, 1024, 64, True, 0, None, "float32"),
    ("gqa", 2, 8, 2, 512, 512, 64, True, 0, None, "float32"),
    ("window", 2, 4, 4, 1024, 1024, 64, True, 200, None, "float32"),
    ("ragged", 2, 4, 2, 1000, 1000, 64, True, 0, None, "float32"),
    ("kv_len_cross", 1, 4, 2, 300, 384, 32, False, 0, 333, "float32"),
    ("d128_bf16", 1, 4, 4, 384, 384, 128, True, 0, None, "bfloat16"),
    ("d16_window_gqa", 1, 8, 2, 200, 200, 16, True, 32, None, "float32"),
    ("bf16", 2, 12, 12, 1024, 1024, 64, True, 0, None, "bfloat16"),
]
TOL = {"float32": {"fwd": 2e-5, "bwd": 1e-4}, "bfloat16": {"fwd": 2e-2,
                                                         "bwd": 2e-2}}
MAIN_BATCH, MAIN_INIT_P = 8, 1
MAIN_ARGS = ["--arch", "edl-paper", "--batch", str(MAIN_BATCH), "--seq", "1024",
             "--devices", "2", "--init-p", str(MAIN_INIT_P),
             "--schedule", "out:1@3",
             "--steps", "12", "--n-samples", "1024", "--d-partitions", "16",
             "--json", "--device", "cuda"]


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


def check_kernels(torch, ops):
    """Phase 3. Returns per-kernel records at the main case's shape."""
    F = torch.nn.functional
    records = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (name, B, Hq, Hkv, Lq, Lk, D, causal, window, kv_len,
         dname) in CASES:
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
        tol = TOL[dname]
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
            if name == MAIN_CASE[0]:
                records[kname] = {"max_abs_err": err, "tolerance": t}

        if name != MAIN_CASE[0]:
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


def run_main_path(torch, ops, train):
    """Phase 4: the port's trainer through its entry point. Returns (summary,
    launches, warm-up launches, seconds)."""
    ops.LAUNCHES.reset()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = train.main(MAIN_ARGS)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = ops.LAUNCHES.snapshot()
    warm = ops.LAUNCHES.snapshot(warm=True)
    if rc != 0:
        fail(f"repro_torch.launch.train.main returned {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    losses = summary["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not summary["final_loss"] < summary["first_loss"]:
        fail(f"loss did not fall: {losses}")
    outs = [e for e in summary["scaling_events"] if e["op"] == "scale_out"]
    if len(outs) != 1 or summary["final_p"] != 2:
        fail(f"expected one committed scale_out to p=2: "
             f"{summary['scaling_events']}, final_p {summary['final_p']}")
    if not outs[0]["stop_s"] < outs[0]["prep_s"]:
        fail(f"scale_out was not stop-free: {outs[0]}")
    if summary["unique_sample_frac"] != 1.0:
        fail(f"unique_sample_frac {summary['unique_sample_frac']}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing}")
    return summary, launches, warm, seconds


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops
    from repro_torch.launch import train

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1/5] device: {kind} ({card}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    t0 = time.monotonic()
    built = build.build_all(force=True)
    print(f"[2/5] built {sorted(built)} with {build.nvcc_path()} "
          f"{' '.join(build.NVCC_FLAGS)} in {time.monotonic() - t0:.1f} s",
          flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("[3/5] kernels against their plain versions", flush=True)
    records = check_kernels(torch, ops)

    print("[4/5] main path: python -m repro_torch.launch.train "
          + " ".join(MAIN_ARGS), flush=True)
    summary, launches, warm, seconds = run_main_path(torch, ops, train)
    steps = summary["steps"]
    step_ms = 1e3 * MAIN_BATCH / summary["throughput"]
    n_slot_steps = slot_steps(summary, MAIN_INIT_P)
    # launches of the training steps alone, per slot shard of a step
    per_slot_step = {k: (launches[k] - warm[k]) / n_slot_steps
                     for k in launches}
    # a forward and its two backward kernels run once per layer each
    if len(set(per_slot_step.values())) != 1 or len(set(warm.values())) != 1:
        fail(f"the kernels' launches do not pair up: warm-ups {warm}, per "
             f"slot shard of a step {per_slot_step}")
    print(f"  losses {['%.4f' % x for x in summary['losses']]}")
    print(f"  scaling_events {json.dumps(summary['scaling_events'])}")
    print(f"  {steps} steps in {seconds:.2f} s; mean step {step_ms:.1f} ms, "
          f"{summary['throughput']:.2f} samples/s over the last "
          f"{min(steps, 20)} steps; launches {launches}, of which context-prep "
          f"warm-ups {warm}; {n_slot_steps} slot shards stepped, so per slot "
          f"shard of a step {per_slot_step} [{kind}; {card}]", flush=True)

    kernels = []
    for kname in ops.KERNELS:
        r = records[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches[kname],
            "warmup_launches": warm[kname],
            "launches_per_slot_step": per_slot_step[kname],
            "max_abs_err": r["max_abs_err"], "tolerance": r["tolerance"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bytes": r["bytes"], "flops": r["flops"],
            "library_ms": r["library_ms"], "shape": r["shape"], "card": card})
    print("[5/5] results; library_ms is F.scaled_dot_product_attention: its "
          "forward for flash_attn_fwd, its whole backward (dq, dk and dv in "
          "one call) for both backward kernels", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "steps": steps, "seconds": seconds, "mean_step_ms": step_ms,
        "samples_per_s": summary["throughput"],
        "first_loss": summary["first_loss"],
        "final_loss": summary["final_loss"],
        "scaling_events": summary["scaling_events"], "card": card}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
