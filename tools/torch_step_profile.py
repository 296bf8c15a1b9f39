#!/usr/bin/env python3
"""Where a training step of the PyTorch port goes on the card.

Builds the port's ``ElasticTrainer`` on a full-width architecture
(``--arch``: ``edl-paper``, ``rwkv6-1.6b`` or a zoo config, its depth cut
to ``--layers N`` as ``chip_smoke.py`` phase 11 cuts it; batch 8, sequence
1024, AdamW) at model-parallel degree ``--model-parallel M`` (default 1), then
at (p, mp) = (1, M) and again after a blocking scale-out to (2, M) (all
2 M slots on one card):

* times ``--steps`` steps with a host clock around work that ends in
  ``torch.cuda.synchronize()`` (the trainer's own step time);
* traces two more steps with ``torch.profiler`` and sums the device time of
  every kernel by group: each of the port's kernels, matrix products, and
  the rest; the device's idle share is one minus the union of kernel
  intervals over the traced window; the peak of allocated device memory
  is taken over the traced steps.

With ``--virtual-workers K`` the trainer runs the deterministic
virtual-worker step (K shards of batch / K at every (p, mp)) instead of
the default step.

Prints one JSON line per parallelism and writes the traces under
``build/profile/``. Run from the repo root on a machine with a card:

    python3 tools/torch_step_profile.py [--arch rwkv6-1.6b] [--steps 6] \
        [--virtual-workers 8] [--model-parallel 2] [--layers 2 --batch 4]
"""
import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

# first match wins: the WKV6 kernels' names contain "fwd_kernel" too
GROUPS = (("wkv6_fwd", "wkv6_fwd_kernel"), ("wkv6_bwd_dr", "wkv6_bwd_dr_kernel"),
          ("wkv6_bwd_dk", "wkv6_bwd_dk_kernel"),
          ("wkv6_bwd_dv", "wkv6_bwd_dv_kernel"),
          ("flash_attn_fwd_tc", "fwd_tc_kernel"),
          ("flash_attn_bwd_dq_tc", "bwd_dq_tc_kernel"),
          ("flash_attn_bwd_dkdv_tc", "bwd_dkdv_tc_kernel"),
          ("flash_attn_fwd", "fwd_kernel"), ("flash_attn_bwd_dq",
                                             "bwd_dq_kernel"),
          ("flash_attn_bwd_dkdv", "bwd_dkdv_kernel"))
MATMUL_MARKS = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "cublas", "nvjet")


def group_of(name: str) -> str:
    for group, mark in GROUPS:
        if mark in name:
            return group
    if any(m in name for m in MATMUL_MARKS):
        return "matmul"
    return "other"


def kernel_breakdown(trace_path: str) -> dict:
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no device kernels")
    by_group: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in kernels:
        g = group_of(e["name"])
        by_group[g] = by_group.get(g, 0.0) + e["dur"]
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    total = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"kernel_ms": {k: v / 1e3 for k, v in sorted(by_group.items())},
            "kernel_share": {k: v / total for k, v in sorted(
                by_group.items())},
            "busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "idle_share": 1.0 - busy / window, "n_kernels": len(kernels),
            "top": [(n[:90], v / 1e3) for n, v in top]}


def timed_steps(torch, trainer, n: int) -> list[float]:
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        trainer.step()
        torch.cuda.synchronize()
        out.append(time.monotonic() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="edl-paper")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--virtual-workers", type=int, default=0, metavar="K")
    ap.add_argument("--model-parallel", type=int, default=1, metavar="M")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="cut the depth to N layers (0: the config's own)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.core import ElasticTrainer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mp = args.model_parallel
    with ElasticTrainer(cfg, global_batch=args.batch, seq_len=args.seq,
                        init_parallelism=1, model_parallel=mp,
                        n_samples=4096, d_partitions=16,
                        devices=["cuda:0"] * (2 * mp), time_allowance_s=0,
                        virtual_workers=args.virtual_workers) as trainer:
        for p in (1, 2):
            if p == 2:
                trainer.scale_out(1, block=True)
            timed_steps(torch, trainer, 2)                  # warm
            times = timed_steps(torch, trainer, args.steps)
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                timed_steps(torch, trainer, 2)
            path = os.path.join(args.out, f"trace_{args.arch}_p{p}_mp{mp}"
                                f"_vw{args.virtual_workers}.json")
            prof.export_chrome_trace(path)
            rec = {"arch": cfg.name, "p": trainer.p,
                   "mp": trainer.model_parallel, "batch": args.batch,
                   "seq": args.seq, "virtual_workers": trainer.n_virtual,
                   "step_ms_median": 1e3 * statistics.median(times),
                   "step_ms": [1e3 * t for t in times],
                   "samples_per_s": args.batch / statistics.median(times),
                   "tokens_per_s": args.batch * args.seq
                   / statistics.median(times),
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "traced_steps": 2, **kernel_breakdown(path),
                   "card": card}
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
