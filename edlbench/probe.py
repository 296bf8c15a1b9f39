#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the cell's cards at its
own sizes, in one process (the set-up is long):

* the program: the set-up of a run (``run.start``) once, then its checked
  steps (``run.checked``) from the weights and rows of each of
  ``--seeds``, against the reference: the lower readings;
* the control: the reference computed in float8 (``low=True``) in the
  program's place, on ``--control-seeds``;
* a fault planted in the reference put in the program's place, on the
  same seeds: half of each batch left out (the mean over the rest).

    python3 edlbench/probe.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --out build/edlbench/probe.json

Needs the cell's cards; writes one JSON record and prints each reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from edlbench import reference, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    control = [int(x) for x in args.control_seeds.split(",") if x]
    files = run.cell_files(args.workload)
    reference.kind(files["model"])      # a kind with no module: refused
    run.set_cache_dirs()
    import torch
    from edlbench import check
    from edlbench.reference import model as ref
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} card(s)", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    model, traffic = files["model"], files["traffic"]
    o, rows = traffic["optimizer"], traffic["reference_rows"]
    trainer, drv = run.start(files, seeds[0], devices)
    out = {"workload": args.workload, "program": {}, "control": {},
           "half_batch": {}, "seconds": {}}

    def record(kind, seed, a, b):
        cmp = check.compare(a, b)
        out[kind][seed] = dict(cmp, loss=a["loss"], reference_loss=b["loss"])
        print(kind, seed, json.dumps(cmp["values"]),
              json.dumps(cmp["worst_leaf"]), flush=True)

    refs = {}
    for seed in seeds:
        t0 = time.monotonic()
        prog, ids = run.checked(drv, files, seed)
        trainer.state = None
        gc.collect()
        torch.cuda.empty_cache()
        batches = run.reference_batches(ids, files, seed)
        t1 = time.monotonic()
        refs[seed] = (batches, ref.train(model, o, seed, batches, devices,
                                         rows=rows))
        out["seconds"].setdefault("program", []).append(t1 - t0)
        out["seconds"].setdefault("reference", []).append(
            time.monotonic() - t1)
        record("program", seed, prog, refs[seed][1])
        if seed not in control:
            del refs[seed]
    trainer.close()
    del trainer, drv
    gc.collect()
    torch.cuda.empty_cache()
    for seed in control:
        batches, base = refs[seed]
        t0 = time.monotonic()
        record("control", seed, ref.train(model, o, seed, batches, devices,
                                          rows=rows, low=True), base)
        out["seconds"].setdefault("control", []).append(
            time.monotonic() - t0)
        half = [(t[:len(t) // 2], lab[:len(lab) // 2]) for t, lab in batches]
        record("half_batch", seed, ref.train(model, o, seed, half, devices,
                                             rows=rows), base)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for kind in ("program", "control", "half_batch"):
        if out[kind]:
            for k in ("loss_gap", "loss1_gap", "grad_gap", "change_gap"):
                vals = [c["values"][k] for c in out[kind].values()]
                print(f"{kind:12s} {k:10s} min {min(vals):.4g} "
                      f"max {max(vals):.4g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
