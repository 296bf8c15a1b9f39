#!/usr/bin/env python3
"""The port's dry-run flop count against XLA's, on the CPU (imports the
JAX package).

For the SMOKEs of edl_paper, rwkv6 and jamba at a batch of 4 x 64 in each
mode (train, prefill, decode against a 64-slot cache), at (1, 1) and
(1, 2): the flops ``repro_torch.launch.dryrun.dryrun`` counts on ``meta``
(FlopCounterMode's aten formulas plus the kernels' formula counts), the
group's total over mp and its busiest slot's; and the reference's
``hlo_flops_per_device`` by its own Phase B (``repro.launch.dryrun``:
``cost_analysis()`` of the step compiled at one and two layer periods,
unrolled, extrapolated in depth) on a (1, mp) mesh of forced host
devices, in a subprocess. Prints one JSON line: each case's counts and
their ratio, port over XLA. Run from the repo root:

    python3 tools/torch_dryrun_xla.py
"""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCHS = ("edl-paper", "rwkv6-1.6b", "jamba-v0.1-52b")
MODES = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64

_JAX_FLOPS = r"""
import json
from repro.configs import get_config
from repro.configs.base import InputShape
from repro.launch.dryrun import _cost_cfg, _extract_costs, _lower
from repro.launch.mesh import make_mesh
out = {{}}
for arch in {archs}:
    cfg = get_config(arch, smoke=True)
    for mode in {modes}:
        shape = InputShape(mode + "_small", {seq}, {batch}, mode)
        for mp in (1, 2):
            mesh = make_mesh(1, mp)
            cfg1, n_periods = _cost_cfg(cfg, shape, 1)
            cfg2, _ = _cost_cfg(cfg, shape, 2)
            c1 = _extract_costs(_lower(cfg1, shape, mesh).compile())
            c2 = _extract_costs(_lower(cfg2, shape, mesh).compile())
            out[arch + "/" + mode + "/" + str(mp)] = c1["flops"] + (
                n_periods - 1) * (c2["flops"] - c1["flops"])
print(json.dumps(out))
"""


def main() -> int:
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import dryrun
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    run = subprocess.run(
        [sys.executable, "-c", _JAX_FLOPS.format(
            archs=ARCHS, modes=MODES, seq=SEQ, batch=BATCH)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=1800)
    if run.returncode:
        raise RuntimeError(run.stderr[-3000:])
    xla = json.loads(run.stdout.strip().splitlines()[-1])
    cases = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        for mode in MODES:
            for mp in (1, 2):
                r = dryrun(cfg, InputShape(f"{mode}_small", SEQ, BATCH, mode),
                           (1, mp))
                key = f"{arch}/{mode}/{mp}"
                mean = sum(r["flops_by_slot"]) / mp
                cases[key] = {"port_mean_per_slot": mean,
                              "port_busiest_slot": r["flops_per_slot"],
                              "xla_per_device": xla[key],
                              "ratio": mean / xla[key]}
    ratios = [c["ratio"] for c in cases.values()]
    print(json.dumps({"batch": BATCH, "seq": SEQ, "cases": cases,
                      "ratio_min": min(ratios), "ratio_max": max(ratios)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
