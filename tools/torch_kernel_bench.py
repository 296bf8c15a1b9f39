#!/usr/bin/env python3
"""Time the port's hand-written kernels on the card against an earlier source.

Builds ``src/repro_torch/kernels/csrc/{flash_attn,flash_attn_tc,wkv6,adamw}.cu``
with the flags of ``kernels/build.py`` and, with ``--baseline-rev REV``,
the same files at git revision REV (read with ``git show``, and kept under
``build/kernel_bench/src-REV/`` so that a copy of the checkout without its
git history finds them there; a source that REV does not have is left
out), plus any ``--variant NAME=FILE`` (a ``flash_attn*.cu``,
``flash_attn_tc*.cu``, ``wkv6*.cu`` or ``adamw*.cu`` to try), one nvcc per source, all
started together. Prints each kernel's registers and spills from
``-Xptxas -v``, the blocks per SM that each build reports, and the
``HGMMA`` instructions that ``cuobjdump -sass`` finds in each tensor-core
kernel. Each build is
checked against the plain versions (and for the same bits on two runs) at
the main shapes, its fp32 outputs against this checkout's bit for bit,
then ``flash_attn_fwd``, the backward pair (dq then dkdv),
``wkv6_fwd``, ``wkv6_bwd_dr``, ``wkv6_bwd_dk`` and ``wkv6_bwd_dv`` are
timed with CUDA events, the builds in turns (A B B A)
so that they share the card's state, beside
``F.scaled_dot_product_attention``'s forward and backward on the same
inputs (a yardstick; the port never calls it). Shapes: one slot shard of
the edl_paper path (B 8 at p = 1, 4 at p = 2; H 12, L 1024, D 64, fp32,
causal) and of the rwkv6 path (B 8 / 4, L 1024, H 32, hd 64, fp32), where
each WKV6 kernel's bound by bytes is printed beside its times. In bf16,
at the zoo's five training shapes (B 4, L 1024, causal: phi3, nemo /
llava / mixtral, qwen2.5, starcoder2, musicgen), the window-4096 pair (B 1,
L 5120: starcoder2, mixtral) and mixtral's mp = 2 shard (B 4, H 16:4),
each build's bf16 forward, dQ and dK/dV (the tensor-core
``flash_attn_fwd_tc``, ``flash_attn_bwd_dq_tc`` and
``flash_attn_bwd_dkdv_tc`` where a build has them, else its
``flash_attn.cu`` ones at dtype 1, as ``flash_attn_bwd_dq`` at 28773cc)
are held against the plain versions on the same inputs, their worst
errors printed side by side, each run twice for the same bits, and all
timed in turns beside SDPA's forward and whole backward and the bf16
bound (4 D, 6 D and 8 D flops a visible pair at 989 TFLOP/s). A build
from before du was folded into dk (it has a ``wkv6_bwd_du`` kernel, as at
ec2815a) is driven through its own interface: its dk is timed alone and,
as ``wkv6_bwd_dk+du``, followed by its du kernel, the work that the folded
dk does in one launch. The optimizer (``--parts optim``): each build's
AdamW update (``adamw_update``) at the benchmark's phi3-mini-16l
(``edlbench/configs/phi3-mini-16l.json``: 12 bf16 leaves, 2.01 B
parameters, the cell's AdamW) on its largest leaf ([16, 3072, 8192]) and
over its whole tree, and the gradient norm's square-sum over the tree
(``grad_sq_sum`` a leaf, ``grad_sq_sum_final``), at each grid cap of
``--optim-grids`` blocks an SM, in turns, beside the eager formula's
update (``adamw_update_plain``, the "plain" column) and square-sum,
``torch._foreach_norm``'s norm of the tree in fp32, squared (the
"library" column, with its bits on two runs), and
the bound: 22 bytes a parameter (the square-sum 2) at 3.35 TB/s; each
build's update held bit for bit against the eager formula on the largest
leaf, and the same bits twice. Prints one JSON line per shape, then the
whole record, which it also writes to ``--out``. Run from the repo root
on a machine with a card:

    python3 tools/torch_kernel_bench.py [--baseline-rev REV] [--variant NAME=FILE] [--reps 20]
        [--parts fp32,bf16,wkv,optim] [--optim-grids 2,8]
"""
import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FAMILIES = {"flash_attn": "flash_attn.cu", "flash_attn_tc": "flash_attn_tc.cu",
            "wkv6": "wkv6.cu", "adamw": "adamw.cu"}
ATT_SHAPES = {"edl_p1": (8, 12, 1024, 64), "edl_p2": (4, 12, 1024, 64)}
# the zoo's bf16 shapes (chip_smoke.py's ATT_ZOO_CASES), causal: B, Hq, Hkv,
# L, D, window. The five training shapes at B 4 x L 1024; window 4096 at B 1
# x L 5120 (starcoder2, mixtral); mixtral's and jamba's mp = 2 shard
ZOO_SHAPES = {"phi3": (32, 32, 96), "nemo_llava_mixtral": (32, 8, 128),
              "qwen": (40, 8, 128), "starcoder2": (48, 4, 128),
              "musicgen": (24, 24, 64)}
BF16_SHAPES = {**{n: (4, Hq, Hkv, 1024, D, 0)
                  for n, (Hq, Hkv, D) in ZOO_SHAPES.items()},
               "starcoder2_w4096": (1, 48, 4, 5120, 128, 4096),
               "mixtral_w4096": (1, 32, 8, 5120, 128, 4096),
               "mixtral_jamba_mp2": (4, 16, 4, 1024, 128, 0)}
BF16_TOL = 2e-2                       # chip_smoke.py's bf16 tolerance
BF16_FLOPS = 989e12                   # H100 SXM, bf16 tensor cores, dense
WKV_SHAPES = {"rwkv_p1": (8, 1024, 32, 64), "rwkv_p2": (4, 1024, 32, 64)}
ATT_TOL = {"fwd": 2e-5, "bwd": 1e-4}   # chip_smoke.py's fp32 tolerances
WKV_TOL = 1e-4                        # of the plain output's largest entry
HBM_BYTES_S = 3.35e12                 # H100 SXM HBM3, as in chip_smoke.py
WKV_KERNELS = ("wkv6_fwd", "wkv6_bwd_dr", "wkv6_bwd_dk", "wkv6_bwd_dv")
_P, _I = ctypes.c_void_p, ctypes.c_int
# the interface of a build whose du is a kernel of its own: dk without
# du_part and du; du_part, du; B, H, head_dim
SPLIT_DU_SIGNATURES = {"wkv6_bwd_dk": [_P] * 11 + [_I] * 4 + [_P],
                       "wkv6_bwd_du": [_P] * 2 + [_I] * 3 + [_P]}
# the kernels whose registers are reported: fp32 at head dim 64
PTXAS_KERNELS = {"flash_attn": ("fwd_kernelILi64E", "bwd_dq_kernelILi64E",
                                "bwd_dkdv_kernelILi64E",
                                # the instances of a baseline whose kernels
                                # were templates on the type too (28773cc)
                                "fwd_kernelIfLi64E", "bwd_dq_kernelIfLi64E",
                                "bwd_dkdv_kernelIfLi64E",
                                *(f"{k}_kernelI13__nv_bfloat16Li{d}E"
                                  for k in ("fwd", "bwd_dq", "bwd_dkdv")
                                  for d in (64, 96, 128))),
                 "flash_attn_tc": tuple(f"{k}_tc_kernelILi{d}E"
                                        for k in ("fwd", "bwd_dq", "bwd_dkdv")
                                        for d in (16, 32, 64, 96, 128)),
                 "wkv6": ("wkv6_fwd_kernelILi64E", "wkv6_bwd_dr_kernelILi64E",
                          "wkv6_bwd_dk_kernelILi64E", "wkv6_bwd_dv_kernelILi64E"),
                 "adamw": ("adamw_update_kernelI13__nv_bfloat16E",
                           "adamw_update_kernelIfE", "grad_sq_sum_kernelI13",
                           "grad_sq_sum_final_kernel")}
# the benchmark's phi3-mini-16l and its cell's AdamW (edlbench/configs,
# edlbench/traffic/b2x8k.json)
PHI3_ARCH, PHI3_LAYERS = "phi3-mini-3.8b", 16
ADAMW = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)


def baseline_sources(rev: str) -> dict:
    """{family: path} of the sources at ``rev``, from git or from the copy
    an earlier run kept."""
    keep = ROOT / "build" / "kernel_bench" / f"src-{rev}"
    known = subprocess.run(["git", "-C", str(ROOT), "rev-parse", "--verify",
                            "--quiet", f"{rev}^{{commit}}"],
                           capture_output=True, text=True).returncode == 0
    out = {}
    for fam, fname in FAMILIES.items():
        path, absent = keep / fname, keep / f"{fname}.absent"
        got = subprocess.run(["git", "-C", str(ROOT), "show",
                              f"{rev}:src/repro_torch/kernels/csrc/{fname}"],
                             capture_output=True, text=True)
        if got.returncode == 0:
            keep.mkdir(parents=True, exist_ok=True)
            path.write_text(got.stdout)
        elif known:             # the revision has no such source
            keep.mkdir(parents=True, exist_ok=True)
            absent.write_text("")
            continue
        elif absent.exists():
            continue
        elif not path.exists():
            raise SystemExit(f"no {fname} at {rev}: no git history here and "
                             f"no copy in {keep} (run once with git to keep it)")
        out[fam] = path
    return out


def sass_hgmma(lib: Path, marks) -> dict:
    """{kernel mark: HGMMA instructions} in ``cuobjdump -sass`` of a built
    library."""
    from repro_torch.kernels import build as kbuild
    tool = Path(kbuild.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = next((k for k in marks if k in m.group(1)), None)
            if entry:
                out[entry] = 0
        elif entry and "HGMMA" in line:
            out[entry] += 1
    return out


def ptxas_summary(log: str, marks) -> dict:
    """{kernel mark: {"registers", "spill_stores", "spill_loads"}} from
    nvcc's ``-Xptxas -v`` log, with ``"notes"``: the lines where ptxas
    reports a performance loss (wgmma serialised, say)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = next((k for k in marks if k in m.group(1)), None)
            continue
        if entry is None:
            continue
        if "Performance Loss" in line or "serialized" in line:
            out.setdefault(entry, {}).setdefault("notes", []).append(
                line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(entry, {}).update(spill_stores=int(m.group(1)),
                                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(entry, {})["registers"] = int(m.group(1))
    return out


def build_all(builds: dict) -> dict:
    """Compile {build: {family: source}}; returns {build: {family: (CDLL,
    ptxas summary)}}."""
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild.nvcc_path()
    out_dir = ROOT / "build" / "kernel_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, fams in builds.items():
        for fam, src in fams.items():
            lib = out_dir / f"lib{fam}-{name}.so"
            cmd = [nvcc, *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
            procs[name, fam] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {name: {} for name in builds}
    for (name, fam), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name} {fam}:\n{log[-4000:]}")
        libs[name][fam] = (ctypes.CDLL(str(lib)),
                           ptxas_summary(log, PTXAS_KERNELS[fam]), lib)
    return libs


def split_du(lib) -> bool:
    """Whether a WKV6 build has du as a kernel of its own."""
    return hasattr(lib, "wkv6_bwd_du")


def typed(lib, fam):
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.optim import ops as oops
    from repro_torch.kernels.rwkv import ops as wops
    if fam == "adamw":
        sigs = oops._SIGNATURES
    elif fam == "flash_attn":
        sigs = aops._SIGNATURES
    elif fam == "flash_attn_tc":
        sigs = aops.TC_SIGNATURES
        # forward and dK/dV, and dQ where the build has it
        lib.flash_attn_tc_blocks_per_sm.argtypes = [_I] + [
            ctypes.POINTER(ctypes.c_int)] * (
                3 if hasattr(lib, "flash_attn_bwd_dq_tc") else 2)
        lib.flash_attn_tc_blocks_per_sm.restype = ctypes.c_int
    else:
        sigs = {**wops._SIGNATURES,
                **(SPLIT_DU_SIGNATURES if split_du(lib) else {})}
    for fn, argtypes in sigs.items():
        if not hasattr(lib, fn):    # an earlier build's tensor-core library
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


# the occupancy entry points a build may have, and the kernels each reports
OCCUPANCY = {"flash_attn": (("flash_attn_blocks_per_sm", ("fwd", "dq", "dkdv")),
                            ("flash_attn_bwd_blocks_per_sm", ("dq", "dkdv"))),
             "wkv6": (("wkv6_fwd_blocks_per_sm", ("wkv6_fwd",)),
                      ("wkv6_bwd_blocks_per_sm", ("wkv6_bwd_dr", "wkv6_bwd_dk")),
                      ("wkv6_bwd_dv_blocks_per_sm", ("wkv6_bwd_dv",)))}


def blocks_per_sm(lib, fam) -> dict | None:
    """What the build's occupancy entry points report: the first of the
    attention family's that it has, every one of the WKV6 family's, the
    tensor-core kernels' at the zoo's head dims."""
    out = {}
    if fam == "flash_attn_tc":
        keys = ("fwd_tc", "dkdv_tc", "dq_tc")[
            :len(lib.flash_attn_tc_blocks_per_sm.argtypes) - 1]
        for d in sorted({D for _, _, D in ZOO_SHAPES.values()}):
            n = [ctypes.c_int() for _ in keys]
            err = lib.flash_attn_tc_blocks_per_sm(d, *(ctypes.byref(x)
                                                       for x in n))
            if err:
                raise RuntimeError(f"flash_attn_tc_blocks_per_sm: cudaError "
                                   f"{err}")
            out.update({f"{k}_d{d}": x.value for k, x in zip(keys, n)})
        return out
    for fn, keys in OCCUPANCY.get(fam, ()):
        if not hasattr(lib, fn) or (fam == "flash_attn" and out):
            continue
        n = [ctypes.c_int() for _ in keys]
        err = getattr(lib, fn)(*(ctypes.byref(x) for x in n))
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")
        out.update({k: x.value for k, x in zip(keys, n)})
    return out or None


def call(lib, fn, *args):
    err = getattr(lib, fn)(*args)
    if err:
        raise RuntimeError(f"{fn}: cudaError {err}")


def bf16_entries(fams: dict):
    """A build's bf16 forward, dQ and dK/dV: {kernel: (lib, entry)}, the
    tensor-core kernels where it has them, else its ``flash_attn.cu`` ones
    (at dtype 1, as at 28773cc for dQ); None where it has neither
    library."""
    tc = fams.get("flash_attn_tc", (None,))[0]
    fa = fams.get("flash_attn", (None,))[0]
    if tc is None and fa is None:
        return None
    out = {}
    for kname, tc_entry, fa_entry in (
            ("fwd", "flash_attn_fwd_tc", "flash_attn_fwd"),
            ("dq", "flash_attn_bwd_dq_tc", "flash_attn_bwd_dq"),
            ("dkdv", "flash_attn_bwd_dkdv_tc", "flash_attn_bwd_dkdv")):
        if tc is not None and hasattr(tc, tc_entry):
            out[kname] = (tc, tc_entry)
        elif fa is not None:
            out[kname] = (fa, fa_entry)
    return out


def bench_bf16(torch, libs, order, timed, stream, result) -> bool:
    """The bf16 forward, dQ and dK/dV of each build at ``BF16_SHAPES``:
    held against the plain versions on the same inputs (o and lse; dq and
    the delta it writes; dk and dv on the plain o, lse and delta, the same
    for every build), each build's worst error printed beside the others',
    the same bits twice, and timed in turns beside SDPA's forward and whole
    backward and the bf16 bound (4 D, 6 D and 8 D flops a visible pair at
    989 TFLOP/s, or the bytes). False where a check fails."""
    from repro_torch.kernels.attention import ops as aops
    F = torch.nn.functional
    builds = {n: e for n in libs for e in (bf16_entries(libs[n]),) if e}
    for sname, (B, Hq, Hkv, L, D, window) in BF16_SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, do = rnd(B, Hq, L, D), rnd(B, Hq, L, D)
        k, v = rnd(B, Hkv, L, D), rnd(B, Hkv, L, D)
        scale = D ** -0.5
        opts = dict(causal=True, window=window, scale=scale, kv_len=L)
        dims = [B, Hq, Hkv, L, L, D, L, 1, window]
        o, lse = torch.empty_like(q), torch.empty((B, Hq, L), device="cuda")
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B, Hq, L), device="cuda")
        o_p, lse_p = aops.flash_attn_fwd_plain(q, k, v, **opts)
        dq_p, delta_p = aops.flash_attn_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                                     **opts)
        dk_p, dv_p = aops.flash_attn_bwd_dkdv_plain(q, k, v, lse_p, delta_p,
                                                    do, **opts)
        torch.cuda.synchronize()
        launch = {   # kernel: its pointers; dQ and dK/dV on the plain o, lse
            "fwd": lambda: (q, k, v, o, lse),
            "dq": lambda: (q, k, v, o_p, do, lse_p, dq, delta),
            "dkdv": lambda: (q, k, v, do, lse_p, delta_p, dk, dv)}
        want = {"fwd": (o_p, lse_p), "dq": (dq_p, delta_p),
                "dkdv": (dk_p, dv_p)}
        got = {"fwd": (o, lse), "dq": (dq, delta), "dkdv": (dk, dv)}

        def run(entry, kname):
            call(*entry, *[t.data_ptr() for t in launch[kname]()], *dims,
                 scale, 1, stream)

        errs = {}
        for name, entries in builds.items():
            errs[name] = {}
            for kname, entry in entries.items():
                runs = []
                for _ in range(2):
                    run(entry, kname)
                    torch.cuda.synchronize()
                    runs.append([t.clone() for t in got[kname]])
                pairs = [(a.float(), b.float())
                         for a, b in zip(runs[0], want[kname])]
                err = max(float((a - b).abs().max()) for a, b in pairs)
                if not all(bool(((a - b).abs() <= BF16_TOL * (1 + b.abs())).all())
                           for a, b in pairs):
                    print(f"{name} bf16 {kname} ({entry[1]}) at {sname} "
                          f"disagrees with its plain version: max_abs_err "
                          f"{err:.3e}", file=sys.stderr)
                    return False
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    print(f"{name}: two bf16 {kname} runs at {sname} differ",
                          file=sys.stderr)
                    return False
                errs[name][kname] = err
        del runs, pairs, dq_p, dk_p, dv_p
        pairs = B * Hq * aops.visible_pairs(L, L, True, window, L)
        work = aops.flash_work(q, k, True, window, L)
        bound = {kn: max(f / BF16_FLOPS, b / HBM_BYTES_S) * 1e3
                 for kn, (f, b) in (("fwd", work["flash_attn_fwd_tc"]),
                                    ("dq", work["flash_attn_bwd_dq_tc"]),
                                    ("dkdv", work["flash_attn_bwd_dkdv_tc"]))}
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        sdpa_args = dict(is_causal=window == 0, enable_gqa=Hq != Hkv)
        if window:   # the causal window as a boolean mask
            mask = aops._mask(L, L, True, window, L, q.device)
            sdpa_args = dict(attn_mask=mask, enable_gqa=Hq != Hkv)
        out = F.scaled_dot_product_attention(ql, kl, vl, **sdpa_args)
        times = {n: {kn: [] for kn in builds[n]} for n in builds}
        sdpa = {"fwd": [], "bwd": []}
        for name in order:
            if name not in builds:
                continue
            for kname, entry in builds[name].items():
                times[name][kname].append(timed(lambda: run(entry, kname)))
            sdpa["fwd"].append(timed(lambda: F.scaled_dot_product_attention(
                q, k, v, **sdpa_args)))
            sdpa["bwd"].append(timed(lambda: torch.autograd.grad(
                out, (ql, kl, vl), do, retain_graph=True)))
        del out, ql, kl, vl
        rec = result["shapes"][f"bf16_{sname}"] = {
            "B": B, "Hq": Hq, "Hkv": Hkv, "L": L, "D": D, "window": window,
            "pairs": pairs,
            "kernels": {n: {kn: e[1] for kn, e in builds[n].items()}
                        for n in builds},
            "ms": {n: {w: sum(x) / len(x) for w, x in t.items()}
                   for n, t in times.items()},
            "ms_each_turn": times, "max_abs_err": errs,
            "bound_ms": bound,
            "sdpa_ms": {w: sum(x) / len(x) for w, x in sdpa.items()},
            "sdpa_ms_each_turn": sdpa}
        print(json.dumps({f"bf16_{sname}": rec["ms"], "max_abs_err": errs,
                          "bound_ms": bound, "sdpa_ms": rec["sdpa_ms"]}),
              flush=True)
    return True


def bench_optim(torch, libs, timed, stream, result, grids) -> bool:
    """AdamW's update and the gradient norm's square-sum of each build with
    ``adamw.cu``, at each grid cap of ``grids`` blocks an SM, on phi3-mini-
    16l's tree (the module docstring): the update held bit for bit against
    the eager formula on the largest leaf and run twice for the same bits,
    then timed in turns with the eager update and square-sum. False where
    a check fails."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.optim import ops as oops
    from repro_torch.models.model import param_spec_tree
    from repro_torch.models.params import tree_leaves
    builds = [n for n in libs if "adamw" in libs[n]]
    if not builds:
        return True
    cfg = dataclasses.replace(get_config(PHI3_ARCH), n_layers=PHI3_LAYERS)
    shapes = [tuple(t.shape) for _, t in tree_leaves(param_spec_tree(cfg))]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    tree = [(rnd(s, 1.0).bfloat16(), rnd(s, 1e-2).bfloat16(), rnd(s, 1e-3),
             rnd(s, 1e-3).square_()) for s in shapes]
    outs = [(torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
            for p, _, m, v in tree]
    big = max(range(len(tree)), key=lambda i: tree[i][0].numel())
    h = ADAMW
    count = torch.full((), 3, dtype=torch.int32, device="cuda")
    bc1 = 1.0 - torch.full((), h["b1"], device="cuda") ** count
    bc2 = 1.0 - torch.full((), h["b2"], device="cuda") ** count
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    partial = torch.empty(len(tree) * sms * max(grids), device="cuda")
    total = torch.empty((), device="cuda")

    def update(lib, cap, leaves):
        for i in leaves:
            p, g, m, v = tree[i]
            ts = (p, g, m, v, *outs[i])
            n_vec, blocks = oops.launch_shape(p.numel(), ts, cap)
            call(lib, "adamw_update", *(t.data_ptr() for t in ts), p.numel(),
                 n_vec, blocks, bc1.data_ptr(), bc2.data_ptr(), h["b1"],
                 1 - h["b1"], h["b2"], 1 - h["b2"], h["lr"], h["eps"],
                 h["lr"] * h["weight_decay"], 1, 1, stream)

    def sq_sum(lib, cap):
        at = 0
        for _, g, _, _ in tree:
            n_vec, blocks = oops.launch_shape(g.numel(), (g,), cap)
            call(lib, "grad_sq_sum", g.data_ptr(), g.numel(), n_vec, blocks,
                 partial.data_ptr() + 4 * at, 1, stream)
            at += blocks
        call(lib, "grad_sq_sum_final", partial.data_ptr(), at,
             total.data_ptr(), stream)

    def plain(leaves):
        for i in leaves:
            oops.adamw_update_plain(*tree[i], bc1, bc2, **h)

    grads = [g for _, g, _, _ in tree]

    def library_sq_sum():
        # torch's multi-tensor norm (a yardstick: the port never calls it),
        # each leaf's in fp32, squared and summed
        return torch.stack(torch._foreach_norm(
            grads, 2, dtype=torch.float32)).square().sum()

    want = oops.adamw_update_plain(*tree[big], bc1, bc2, **h)
    norm_plain = float(oops.sq_sum_plain(grads, "cuda"))
    lib_runs = [library_sq_sum() for _ in range(2)]
    checks = {"library_sq_sum": {
        "same_bits_twice": bool(torch.equal(*lib_runs)),
        "rel_to_eager": abs(float(lib_runs[0]) - norm_plain) / norm_plain}}
    for name in builds:
        lib = libs[name]["adamw"][0]
        for cap in grids:
            runs, sums = [], []
            for _ in range(2):
                update(lib, cap * sms, [big])
                sq_sum(lib, cap * sms)
                torch.cuda.synchronize()
                runs.append([t.clone() for t in outs[big]])
                sums.append(total.clone())
            same = all(torch.equal(a, b) for a, b in zip(runs[0], want))
            if not same or not all(torch.equal(a, b)
                                   for a, b in zip(runs[0], runs[1])) \
                    or not torch.equal(sums[0], sums[1]):
                print(f"{name} at {cap} blocks an SM: the update differs from "
                      f"the eager formula's bits ({not same}) or two runs "
                      f"differ", file=sys.stderr)
                return False
            checks[f"{name}@{cap}"] = {
                "same_bits_as_eager": same,
                "sq_sum_rel_to_eager": abs(float(sums[0]) - norm_plain)
                / norm_plain}
            del runs
    del want
    every = range(len(tree))
    turns = [(n, c) for n in builds for c in grids]
    times = {f"{n}@{c}": {"leaf": [], "tree": [], "sq_sum": []}
             for n, c in turns}
    eager = {"leaf": [], "tree": [], "sq_sum": [], "library_sq_sum": []}
    for name, cap in turns + turns[::-1]:
        lib, t = libs[name]["adamw"][0], times[f"{name}@{cap}"]
        t["leaf"].append(timed(lambda: update(lib, cap * sms, [big])))
        t["tree"].append(timed(lambda: update(lib, cap * sms, every)))
        t["sq_sum"].append(timed(lambda: sq_sum(lib, cap * sms)))
        eager["leaf"].append(timed(lambda: plain([big])))
        eager["tree"].append(timed(lambda: plain(every)))
        eager["sq_sum"].append(timed(lambda: oops.sq_sum_plain(grads,
                                                               "cuda")))
        eager["library_sq_sum"].append(timed(library_sq_sum))
    n_big, n_all = tree[big][0].numel(), sum(p.numel() for p, *_ in tree)
    bound = {"leaf": 22 * n_big / HBM_BYTES_S * 1e3,
             "tree": 22 * n_all / HBM_BYTES_S * 1e3,
             "sq_sum": 2 * n_all / HBM_BYTES_S * 1e3}
    ms = {k: {w: sum(x) / len(x) for w, x in t.items()}
          for k, t in times.items()}
    rec = result["shapes"]["optim_phi3_16l"] = {
        "leaf_shape": list(tree[big][0].shape), "params": n_all,
        "leaves": len(tree), "hyper": h, "checks": checks, "ms": ms,
        "ms_each_turn": times, "bound_ms": bound,
        "share_of_bound": {k: {w: bound[w] / x for w, x in v.items()}
                           for k, v in ms.items()},
        "plain_ms": {w: sum(x) / len(x) for w, x in eager.items()},
        "plain_ms_each_turn": eager}
    print(json.dumps({"optim_phi3_16l": ms, "bound_ms": bound,
                      "plain_ms": rec["plain_ms"], "checks": checks}),
          flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-rev", help="git revision whose sources to time")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FILE: another flash_attn*.cu or wkv6*.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="fp32,bf16,wkv,optim",
                    help="which of fp32 (edl_paper attention), bf16 (the "
                         "zoo's attention), wkv and optim (AdamW and the "
                         "gradient norm) to run")
    ap.add_argument("--optim-grids", default="2,8",
                    help="grid caps to time the optimizer kernels at, "
                         "blocks an SM, comma-separated")
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_bench.json"))
    args = ap.parse_args(argv)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    builds = {"new": {f: csrc / n for f, n in FAMILIES.items()}}
    if args.baseline_rev:
        builds["base"] = baseline_sources(args.baseline_rev)
    for v in args.variant:
        name, path = v.split("=", 1)
        fam = next(f for f in sorted(FAMILIES, key=len, reverse=True)
                   if Path(path).name.startswith(f))
        builds[name] = {fam: Path(path).resolve()}
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import ops as aops
    from repro_torch.kernels.rwkv import ops as wops
    F = torch.nn.functional
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()

    t0 = time.monotonic()
    libs = build_all(builds)
    print(f"built {sorted(libs)} in {time.monotonic() - t0:.1f} s; {card}",
          flush=True)
    result = {"card": card, "reps": args.reps, "baseline_rev": args.baseline_rev,
              "sources": {n: {f: str(p) for f, p in b.items()}
                          for n, b in builds.items()},
              "ptxas": {}, "blocks_per_sm": {}, "hgmma": {}, "max_err": {},
              "shapes": {}}
    parts = set(args.parts.split(","))
    for name, fams in libs.items():
        for fam, (lib, ptx, path) in fams.items():
            typed(lib, fam)
            result["ptxas"].setdefault(name, {}).update(ptx)
            result["blocks_per_sm"].setdefault(name, {})[fam] = blocks_per_sm(lib, fam)
            if fam == "flash_attn_tc":
                result["hgmma"][name] = sass_hgmma(path, PTXAS_KERNELS[fam])
        print(f"  {name}: ptxas {result['ptxas'][name]}; blocks per SM "
              f"{result['blocks_per_sm'][name]}; HGMMA in the tensor-core "
              f"kernels {result['hgmma'].get(name)}", flush=True)

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

    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs) + list(libs)[::-1]
    for sname, (B, H, L, D) in ATT_SHAPES.items():
        att = [n for n in libs if "flash_attn" in libs[n]]
        if not att or "fp32" not in parts:
            break
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn((B, H, L, D), generator=gen, device="cuda")
                       for _ in range(4))
        scale = D ** -0.5
        opts = dict(causal=True, window=0, scale=scale, kv_len=L)
        dims = [B, H, H, L, L, D, L, 1, 0]
        o, lse = torch.empty_like(q), torch.empty((B, H, L), device="cuda")
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        delta = torch.empty((B, H, L), device="cuda")
        o_p, lse_p = aops.flash_attn_fwd_plain(q, k, v, **opts)

        def fwd(lib):
            call(lib, "flash_attn_fwd", *[t.data_ptr() for t in (q, k, v, o, lse)],
                 *dims, scale, 0, stream)

        def pair(lib):
            call(lib, "flash_attn_bwd_dq", *[t.data_ptr() for t in (
                q, k, v, o_p, do, lse_p, dq, delta)], *dims, scale, 0, stream)
            call(lib, "flash_attn_bwd_dkdv", *[t.data_ptr() for t in (
                q, k, v, do, lse_p, delta, dk, dv)], *dims, scale, 0, stream)

        if sname == "edl_p1":   # each build against the plain versions
            dq_p, delta_p = aops.flash_attn_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                                         **opts)
            dk_p, dv_p = aops.flash_attn_bwd_dkdv_plain(q, k, v, lse_p, delta_p,
                                                        do, **opts)
            first = {}   # build: its first run's outputs
            for name in att:
                lib = libs[name]["flash_attn"][0]
                runs = []
                for _ in range(2):
                    fwd(lib)
                    pair(lib)
                    torch.cuda.synchronize()
                    runs.append([t.clone() for t in (o, lse, dq, delta, dk, dv)])
                errs = {}
                for kname, got, want, tol in (
                        ("fwd", runs[0][:2], (o_p, lse_p), ATT_TOL["fwd"]),
                        ("pair", runs[0][2:], (dq_p, delta_p, dk_p, dv_p),
                         ATT_TOL["bwd"])):
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    ok = all(bool(((a - b).abs() <= tol * (1 + b.abs())).all())
                             for a, b in zip(got, want))
                    if not ok:
                        print(f"{name} {kname} disagrees with its plain version: "
                              f"max_abs_err {err:.3e}", file=sys.stderr)
                        return 1
                    errs[kname] = err
                if not all(torch.equal(a, b) for a, b in zip(*runs)):
                    print(f"{name}: two runs differ", file=sys.stderr)
                    return 1
                result["max_err"].setdefault(name, {}).update(errs)
                first[name] = runs[0]
            # the fp32 outputs of every build against this checkout's
            result["fp32_same_bits_as_new"] = {
                name: all(torch.equal(a, b) for a, b in zip(out, first["new"]))
                for name, out in first.items() if name != "new"}
            print(f"fp32 o, lse, dq, delta, dk, dv bit-identical to this "
                  f"checkout's: {result['fp32_same_bits_as_new']}", flush=True)
            del dq_p, delta_p, dk_p, dv_p, runs, first

        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        times = {n: {"fwd": [], "pair": []} for n in att}
        sdpa = {"fwd": [], "bwd": []}
        for name in order:
            if name not in att:
                continue
            lib = libs[name]["flash_attn"][0]
            times[name]["fwd"].append(timed(lambda: fwd(lib)))
            times[name]["pair"].append(timed(lambda: pair(lib)))
            sdpa["fwd"].append(timed(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)))
            sdpa["bwd"].append(timed(lambda: torch.autograd.grad(
                out, (ql, kl, vl), do, retain_graph=True)))
        del out, ql, kl, vl
        result["shapes"][sname] = {
            "B": B, "H": H, "L": L, "D": D,
            "ms": {n: {w: sum(x) / len(x) for w, x in t.items()}
                   for n, t in times.items()},
            "ms_each_turn": times,
            "sdpa_ms": {w: sum(x) / len(x) for w, x in sdpa.items()},
            "sdpa_ms_each_turn": sdpa}
        print(json.dumps({sname: result["shapes"][sname]["ms"],
                          "sdpa_ms": result["shapes"][sname]["sdpa_ms"]}),
              flush=True)

    if "bf16" in parts and not bench_bf16(torch, libs, order, timed, stream,
                                          result):
        return 1
    if "optim" in parts and not bench_optim(
            torch, libs, timed, stream, result,
            [int(x) for x in args.optim_grids.split(",")]):
        return 1

    for sname, (B, L, H, hd) in WKV_SHAPES.items():
        wkv = [n for n in libs if "wkv6" in libs[n]]
        if not wkv or "wkv" not in parts:
            break
        gen = torch.Generator().manual_seed(0)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen) * scale).cuda()

        r, k, v = rnd(B, L, H, hd), rnd(B, L, H, hd), rnd(B, L, H, hd)
        logw = -torch.exp(torch.clamp(rnd(B, L, H, hd, scale=2.0), -8.0, 4.0))
        u, s0 = rnd(H, hd, scale=0.5), rnd(B, H, hd, hd, scale=0.1)
        dy, dsT = rnd(B, L, H, hd), rnd(B, H, hd, hd, scale=0.1)
        y, dr, a, dk, dlogw, dv = (torch.empty_like(r) for _ in range(6))
        sT, ds0 = torch.empty_like(s0), torch.empty_like(s0)
        du_part = torch.empty((B, H, hd), device=r.device)
        du = torch.empty_like(u)

        def ptrs(*ts):
            return [t.data_ptr() for t in ts]

        def wkv_calls(lib) -> dict:
            """{entry: launch(es)} of one build, through its interface."""
            dims = (B, L, H, hd, stream)
            calls = {
                "wkv6_fwd": lambda: call(lib, "wkv6_fwd", *ptrs(
                    r, k, v, logw, u, s0, y, sT), *dims),
                "wkv6_bwd_dr": lambda: call(lib, "wkv6_bwd_dr", *ptrs(
                    r, k, v, logw, u, s0, dy, dsT, dr, a, du_part), *dims),
                "wkv6_bwd_dk": lambda: call(lib, "wkv6_bwd_dk", *ptrs(
                    r, k, v, logw, u, dy, dsT, a, du_part, dk, dlogw, ds0,
                    du), *dims),
                "wkv6_bwd_dv": lambda: call(lib, "wkv6_bwd_dv", *ptrs(
                    r, k, logw, u, dy, dsT, dv), *dims)}
            if split_du(lib):
                def dk_alone():
                    call(lib, "wkv6_bwd_dk", *ptrs(r, k, v, logw, u, dy, dsT,
                                                   a, dk, dlogw, ds0), *dims)

                def dk_then_du():
                    dk_alone()
                    call(lib, "wkv6_bwd_du", *ptrs(du_part, du), B, H, hd,
                         stream)
                calls.update({"wkv6_bwd_dk": dk_alone,
                              "wkv6_bwd_dk+du": dk_then_du})
            return calls

        if sname == "rwkv_p1":
            want = {"wkv6_fwd": wops.wkv6_fwd_plain(r, k, v, logw, u, s0),
                    "wkv6_bwd_dr": wops.wkv6_bwd_dr_plain(r, k, v, logw, u, s0,
                                                          dy, dsT),
                    "wkv6_bwd_dv": (wops.wkv6_bwd_dv_plain(r, k, logw, u, dy,
                                                           dsT),)}
            for name in wkv:
                calls = wkv_calls(libs[name]["wkv6"][0])
                dk_entry = ("wkv6_bwd_dk+du" if "wkv6_bwd_dk+du" in calls
                            else "wkv6_bwd_dk")
                runs = []
                for _ in range(2):
                    for fn in ("wkv6_fwd", "wkv6_bwd_dr", dk_entry,
                               "wkv6_bwd_dv"):
                        calls[fn]()
                    torch.cuda.synchronize()
                    runs.append({"wkv6_fwd": (y.clone(), sT.clone()),
                                 "wkv6_bwd_dr": (dr.clone(), a.clone(),
                                                 du_part.clone()),
                                 "wkv6_bwd_dk": (dk.clone(), dlogw.clone(),
                                                 ds0.clone(), du.clone()),
                                 "wkv6_bwd_dv": (dv.clone(),)})
                # dk on the inputs it was given: this build's a terms and du
                # partials
                want["wkv6_bwd_dk"] = wops.wkv6_bwd_dk_plain(
                    r, k, v, logw, u, dy, dsT, *runs[0]["wkv6_bwd_dr"][1:])
                for fn in WKV_KERNELS:
                    rel = max(float((g - w).abs().max() / w.abs().max())
                              for g, w in zip(runs[0][fn], want[fn]))
                    if not rel <= WKV_TOL:
                        print(f"{name} {fn} disagrees with its plain version: "
                              f"{rel:.3e} of the largest entry", file=sys.stderr)
                        return 1
                    if not all(torch.equal(g, h) for g, h in
                               zip(runs[0][fn], runs[1][fn])):
                        print(f"{name}: two {fn} runs differ", file=sys.stderr)
                        return 1
                    result["max_err"].setdefault(name, {})[f"{fn}_rel"] = rel
            del want, runs
        times = {n: {} for n in wkv}
        for name in order:
            if name in wkv:
                for fn, run in wkv_calls(libs[name]["wkv6"][0]).items():
                    times[name].setdefault(fn, []).append(timed(run))
        # bytes each kernel must move (chip_smoke.py's wkv_work): fwd 5, dr
        # 7, dk 8, dv 5 [B,L,H,hd] tensors, the states, u, du's partials and
        # du (dk reads the partials and writes du)
        seq, st, vec = B * L * H * hd * 4, B * H * hd * hd * 4, B * H * hd * 4
        uu = H * hd * 4
        nbytes = {"wkv6_fwd": 5 * seq + 2 * st + uu,
                  "wkv6_bwd_dr": 7 * seq + 2 * st + uu + vec,
                  "wkv6_bwd_dk": 8 * seq + 2 * st + 2 * uu + vec,
                  "wkv6_bwd_dv": 5 * seq + st + uu}
        result["shapes"][sname] = {
            "B": B, "L": L, "H": H, "hd": hd,
            "ms": {n: {fn: sum(x) / len(x) for fn, x in t.items()}
                   for n, t in times.items()},
            "ms_each_turn": times,
            "bytes_bound_ms": {fn: b / HBM_BYTES_S * 1e3
                               for fn, b in nbytes.items()}}
        print(json.dumps({sname: result["shapes"][sname]["ms"],
                          "bytes_bound_ms": result["shapes"][sname][
                              "bytes_bound_ms"]}), flush=True)

    print(f"max errors against the plain versions: {json.dumps(result['max_err'])}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
