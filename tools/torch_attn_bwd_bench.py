#!/usr/bin/env python3
"""Time the flash-attention backward kernels on the card, and an earlier source.

Builds ``src/repro_torch/kernels/csrc/flash_attn.cu`` with the flags of
``kernels/build.py`` and, with ``--baseline FILE``, another ``flash_attn.cu``
(for example an earlier commit's, from ``git show``). Each build is checked
against the plain versions, then ``flash_attn_bwd_dq``,
``flash_attn_bwd_dkdv`` and the pair are timed with CUDA events, the builds
in turns (A B B A) so that they share the card's state, beside
``F.scaled_dot_product_attention``'s backward on the same inputs (the
yardstick; the port never calls it). Shapes: the edl_paper path's slot
shard at p = 1 (B 8) and p = 2 (B 4), H 12, L 1024, D 64, fp32, causal.
Also prints how many blocks of each backward kernel fit on an SM. Prints
one JSON line per shape, then the whole record, which it also writes to
``build/attn_bwd_bench.json``. Run from the repo root on a machine with a
card:

    python3 tools/torch_attn_bwd_bench.py [--baseline FILE] [--reps 20]
"""
import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"p1": (8, 12, 1024, 64), "p2": (4, 12, 1024, 64)}
TOL = 1e-4   # chip_smoke.py's fp32 backward tolerance


def build_variants(build, baseline: str | None) -> dict:
    """{build name: loaded library}, one nvcc per source, all started
    together."""
    jobs = {"new": build.CSRC / "flash_attn.cu"}
    if baseline:
        jobs["baseline"] = Path(baseline).resolve()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    procs = {}
    for name, path in jobs.items():
        out = out_dir / f"libflash_attn-{name}.so"
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        if name == "new":
            for line in log.splitlines():
                if "entry function" in line or "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")
        lib = ctypes.CDLL(str(out))
        from repro_torch.kernels.attention import ops
        sigs = {**ops._SIGNATURES,
                "flash_attn_bwd_blocks_per_sm": [ctypes.c_void_p] * 2}
        for fn, argtypes in sigs.items():
            if hasattr(lib, fn):   # an earlier source may lack the occupancy query
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another flash_attn.cu to time")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.attention import ops
    F = torch.nn.functional
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    t0 = time.monotonic()
    libs = build_variants(build, args.baseline)
    print(f"built {sorted(libs)} in {time.monotonic() - t0:.1f} s; {card}",
          flush=True)

    def timed(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / args.reps

    result = {"card": card, "reps": args.reps, "shapes": {}}
    occ = (ctypes.c_int(), ctypes.c_int())
    err = libs["new"].flash_attn_bwd_blocks_per_sm(*(ctypes.addressof(x) for x in occ))
    if err:
        raise RuntimeError(f"flash_attn_bwd_blocks_per_sm: cudaError {err}")
    result["blocks_per_sm"] = {"dq": occ[0].value, "dkdv": occ[1].value}
    print(f"blocks per SM (fp32, D 64): {result['blocks_per_sm']}", flush=True)
    for sname, (B, H, L, D) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                       for _ in range(4))
        scale = D ** -0.5
        opts = dict(causal=True, window=0, scale=scale, kv_len=L)
        o, lse = ops.flash_attn_fwd_cuda(q, k, v, **opts)
        dims = [B, H, H, L, L, D, L, 1, 0]
        stream = torch.cuda.current_stream().cuda_stream
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty((B, H, L), device="cuda")

        def run(lib, which):
            if which in ("dq", "pair"):
                err = lib.flash_attn_bwd_dq(*[t.data_ptr() for t in (
                    q, k, v, o, do, lse, dq, delta)], *dims, scale, 0, stream)
                if err:
                    raise RuntimeError(f"flash_attn_bwd_dq: cudaError {err}")
            if which in ("dkdv", "pair"):
                err = lib.flash_attn_bwd_dkdv(*[t.data_ptr() for t in (
                    q, k, v, do, lse, delta, dk, dv)], *dims, scale, 0, stream)
                if err:
                    raise RuntimeError(f"flash_attn_bwd_dkdv: cudaError {err}")

        dq_p, delta_p = ops.flash_attn_bwd_dq_plain(q, k, v, o, lse, do, **opts)
        dk_p, dv_p = ops.flash_attn_bwd_dkdv_plain(q, k, v, lse, delta_p, do,
                                                   **opts)
        errs = {}
        for name, lib in libs.items():
            run(lib, "pair")
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in
                      ((dq, dq_p), (delta, delta_p), (dk, dk_p), (dv, dv_p)))
            ok = all(bool(((a - b).abs() <= TOL * (1 + b.abs())).all())
                     for a, b in ((dq, dq_p), (delta, delta_p), (dk, dk_p),
                                  (dv, dv_p)))
            if not ok:
                print(f"{name} disagrees with the plain versions at {sname}: "
                      f"max_abs_err {err:.3e}", file=sys.stderr)
                return 1
            errs[name] = err
        del dq_p, delta_p, dk_p, dv_p
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)

        order = list(libs) + list(libs)[::-1]
        times = {n: {w: [] for w in ("dq", "dkdv", "pair")} for n in libs}
        sdpa = []
        for name in order:
            for which in ("dq", "dkdv", "pair"):
                times[name][which].append(timed(lambda: run(libs[name], which)))
            sdpa.append(timed(lambda: torch.autograd.grad(
                out, (ql, kl, vl), do, retain_graph=True)))
        result["shapes"][sname] = {
            "B": B, "H": H, "L": L, "D": D, "max_abs_err": errs,
            "ms": {n: {w: sum(x) / len(x) for w, x in t.items()}
                   for n, t in times.items()},
            "ms_each_turn": times, "sdpa_bwd_ms": sum(sdpa) / len(sdpa),
            "sdpa_bwd_ms_each_turn": sdpa}
        print(json.dumps({sname: result["shapes"][sname]["ms"],
                          "sdpa_bwd_ms": result["shapes"][sname]["sdpa_bwd_ms"]}),
              flush=True)
    out = ROOT / "build" / "attn_bwd_bench.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
